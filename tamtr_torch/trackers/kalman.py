"""Kalman filter for box tracking (a copy of the JAX package's
`tamtr_tpu/trackers/kalman.py`, numpy): constant velocity over the 8-D state
(x, y, a, h, vx, vy, va, vh), observation (x, y, a, h), the measurement and
process noise scaled by the box height, as the reference's
`trackers/utils/kalman_filter.py:KalmanFilterXYAH`.
"""

from __future__ import annotations

import numpy as np


class KalmanFilterXYAH:
    def __init__(self) -> None:
        ndim, dt = 4, 1.0
        self._F = np.eye(2 * ndim)
        for i in range(ndim):
            self._F[i, ndim + i] = dt
        self._H = np.eye(ndim, 2 * ndim)
        self._std_weight_position = 1.0 / 20
        self._std_weight_velocity = 1.0 / 160

    def initiate(self, measurement: np.ndarray):
        mean = np.zeros(8)
        mean[:4] = measurement
        h = measurement[3]
        wp, wv = self._std_weight_position, self._std_weight_velocity
        std = [2 * wp * h, 2 * wp * h, 1e-2, 2 * wp * h, 10 * wv * h, 10 * wv * h, 1e-5, 10 * wv * h]
        return mean, np.diag(np.square(std))

    def predict(self, mean: np.ndarray, cov: np.ndarray):
        h = mean[3]
        wp, wv = self._std_weight_position, self._std_weight_velocity
        q = np.square([wp * h, wp * h, 1e-2, wp * h, wv * h, wv * h, 1e-5, wv * h])
        mean = self._F @ mean
        cov = self._F @ cov @ self._F.T + np.diag(q)
        return mean, cov

    def update(self, mean: np.ndarray, cov: np.ndarray, measurement: np.ndarray):
        h = mean[3]
        wp = self._std_weight_position
        r = np.square([wp * h, wp * h, 1e-1, wp * h])
        S = self._H @ cov @ self._H.T + np.diag(r)
        K = np.linalg.solve(S.T, (cov @ self._H.T).T).T
        innovation = measurement - self._H @ mean
        mean = mean + K @ innovation
        cov = cov - K @ S @ K.T
        return mean, cov
