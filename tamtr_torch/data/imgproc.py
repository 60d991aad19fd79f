"""The cv2 image operations of the augmentation pipeline, in numpy.

The JAX package augments with cv2 (`tamtr_tpu/data/augment.py`); the port
has no cv2, so each call is rewritten here to give cv2's uint8 results:

- `resize_linear` = `cv2.resize(..., interpolation=cv2.INTER_LINEAR)`:
  half-pixel centres, no antialias, cv2's fixed point (11-bit coefficients,
  its vector rounding of the vertical pass, unclamped vertical weights at
  the edges). Bitwise cv2's on every shape the tests try.
- `warp_affine` / `warp_perspective` = `cv2.warpAffine` /
  `cv2.warpPerspective` with INTER_LINEAR and a constant border: the inverse
  map sampled bilinearly in float32, as OpenCV 5's warp kernels do; within
  one level of cv2's on >= 99.9% of pixels (`tests/test_torch_data.py`).
- `bgr2hsv` / `hsv2bgr` = `cv2.cvtColor` BGR<->HSV for uint8 (H in
  [0, 180)): the integer forward conversion and the float32 backward one
  with its fused multiply-adds and its two roundings (OpenCV 5 on x86:
  rows truncated in blocks of 32 pixels, the tail rounded); bitwise cv2's
  on all 2^24 colours and all 180 x 2^16 HSV triples.
- `rotation_matrix` = `cv2.getRotationMatrix2D`.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

_F32 = np.float32


def _linear_taps(dsize: int, ssize: int, clamp: bool):
    """Source taps and 11-bit weights of one axis (cv2 `resize` INTER_LINEAR)."""
    scale = 1.0 / (dsize / ssize)
    f = ((np.arange(dsize) + 0.5) * scale - 0.5).astype(_F32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(_F32)
    if clamp:  # horizontal: cv2 clamps the tap and zeroes its weight at the edges
        f = np.where(s < 0, _F32(0), f)
        s = np.maximum(s, 0)
        hi = s >= ssize - 1
        f = np.where(hi, _F32(0), f)
        s = np.where(hi, ssize - 1, s)
    a1 = np.rint(f * _F32(2048)).astype(np.int32)
    a0 = np.rint((_F32(1) - f) * _F32(2048)).astype(np.int32)
    return np.clip(s, 0, ssize - 1), np.clip(s + 1, 0, ssize - 1), a0, a1


def resize_linear(img: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of a uint8 (H, W) or (H, W, C) image to dsize = (w, h)."""
    nw, nh = dsize
    h, w = img.shape[:2]
    x0, x1, ax0, ax1 = _linear_taps(nw, w, clamp=True)
    y0, y1, ay0, ay1 = _linear_taps(nh, h, clamp=False)
    col = (1, -1) + (1,) * (img.ndim - 2)
    row = (-1,) + (1,) * (img.ndim - 1)
    src = img.astype(np.int32)
    hx = (src[:, x0] * ax0.reshape(col) + src[:, x1] * ax1.reshape(col)) >> 4
    out = (((ay0.reshape(row) * hx[y0]) >> 16) + ((ay1.reshape(row) * hx[y1]) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def _sample_bilinear(img: np.ndarray, sx: np.ndarray, sy: np.ndarray, border: int) -> np.ndarray:
    """img sampled at float32 source coordinates (sx, sy) of the output's
    pixels, corners outside the image taking `border`."""
    h, w = img.shape[:2]
    ch = img.shape[2:]
    # two border pixels around the image: with the top-left corner clipped
    # to [-2, w] x [-2, h], all four corners of a sample off the image land
    # on the border
    c = img.shape[2] if ch else 1
    # pixels padded to 4 bytes, gathered as one uint32 each
    pad = np.full((h + 4, w + 4, 4), border, np.uint8)
    pad[2:-2, 2:-2, :c] = img.reshape(h, w, c)
    flat = pad.view(np.uint32).reshape(-1)
    ix, iy = np.floor(sx), np.floor(sy)
    al, be = (sx - ix)[..., None], (sy - iy)[..., None]
    base = (np.clip(iy, -2, h).astype(np.int32) + 2) * (w + 4) + np.clip(ix, -2, w).astype(np.int32) + 2

    def corner(offset: int) -> np.ndarray:
        return flat[base + offset].view(np.uint8).reshape(sx.shape + (4,))[..., :c].astype(_F32)

    p00, p01, p10, p11 = corner(0), corner(1), corner(w + 4), corner(w + 5)
    v0 = p00 + al * (p01 - p00)
    v1 = p10 + al * (p11 - p10)
    v = v0 + be * (v1 - v0)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8).reshape(sx.shape + ch)


def warp_affine(img: np.ndarray, M: np.ndarray, dsize: Tuple[int, int], border: int = 114) -> np.ndarray:
    """`cv2.warpAffine(img, M, dsize, borderValue=(border,) * 3)`, M (2, 3) forward."""
    w, h = dsize
    M = np.asarray(M, np.float64)
    d = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = M[1, 1] * d, M[0, 0] * d, -M[0, 1] * d, -M[1, 0] * d
    inv = np.array([[a11, a12, -a11 * M[0, 2] - a12 * M[1, 2]],
                    [a21, a22, -a21 * M[0, 2] - a22 * M[1, 2]]]).astype(_F32)
    x = np.arange(w, dtype=_F32)[None]
    y = np.arange(h, dtype=_F32)[:, None]
    sx = (inv[0, 1] * y + inv[0, 2]) + inv[0, 0] * x
    sy = (inv[1, 1] * y + inv[1, 2]) + inv[1, 0] * x
    return _sample_bilinear(img, sx, sy, border)


def warp_perspective(img: np.ndarray, M: np.ndarray, dsize: Tuple[int, int], border: int = 114) -> np.ndarray:
    """`cv2.warpPerspective(img, M, dsize, borderValue=(border,) * 3)`, M (3, 3) forward."""
    w, h = dsize
    inv = np.linalg.inv(np.asarray(M, np.float64)).astype(_F32)
    x = np.arange(w, dtype=_F32)[None]
    y = np.arange(h, dtype=_F32)[:, None]
    X = (inv[0, 1] * y + inv[0, 2]) + inv[0, 0] * x
    Y = (inv[1, 1] * y + inv[1, 2]) + inv[1, 0] * x
    W = (inv[2, 1] * y + inv[2, 2]) + inv[2, 0] * x
    W = np.where(W != 0, _F32(1) / np.where(W != 0, W, _F32(1)), _F32(0))
    return _sample_bilinear(img, X * W, Y * W, border)


def rotation_matrix(angle: float, center: Tuple[float, float], scale: float) -> np.ndarray:
    """`cv2.getRotationMatrix2D(center, angle, scale)`: (2, 3), angle in degrees."""
    a = angle * math.pi / 180
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


_HSV_SHIFT = 12
_levels = np.arange(256, dtype=np.float64)
with np.errstate(divide="ignore"):
    _SDIV = np.where(_levels > 0, np.rint((255 << _HSV_SHIFT) / _levels), 0).astype(np.int32)
    _HDIV = np.where(_levels > 0, np.rint((180 << _HSV_SHIFT) / (6.0 * _levels)), 0).astype(np.int32)
# the (b, g, r) entries of cv2's HSV2RGB table per hue sector
_SECTOR = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def bgr2hsv(img: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(img, cv2.COLOR_BGR2HSV)` for (H, W, 3) uint8."""
    b, g, r = (img[..., k].astype(np.int32) for k in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = (diff * _SDIV[v] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def _hsv_factors() -> np.ndarray:
    """(180 * 256, 3) float32: the factor of V for the (b, g, r) output of
    each (H, S) in cv2's HSV2RGB: one of 1, 1 - s, 1 - s h, 1 - s (1 - h)
    by the hue's sector, each a float32 fused multiply-add as cv2 computes
    it (the float64 product of two float32s is exact, then one rounding)."""
    h = np.arange(180, dtype=_F32)[:, None] * _F32(6 / 180.0)
    s = np.arange(256, dtype=_F32)[None, :] * _F32(1 / 255.0)
    sector = np.floor(h)
    h = h - sector
    tab = np.stack(np.broadcast_arrays(
        _F32(1), _F32(1) - s,
        (-s.astype(np.float64) * h + 1.0).astype(_F32),
        (-s.astype(np.float64) * (_F32(1) - h) + 1.0).astype(_F32)), -1)  # (180, 256, 4)
    idx = np.broadcast_to(_SECTOR[sector.astype(np.int64)[:, 0] % 6][:, None], (180, 256, 3))
    return np.take_along_axis(tab, idx, -1).reshape(180 * 256, 3).astype(_F32)


_HSV_FACTORS = _hsv_factors()


def hsv2bgr(hsv: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)` for (H, W, 3) uint8, H in [0, 180)."""
    v = hsv[..., 2].astype(_F32) * _F32(1 / 255.0)
    f = _HSV_FACTORS[hsv[..., 0].astype(np.int32) * 256 + hsv[..., 1]]
    out = v[..., None] * f * _F32(255)
    # cv2's vector loop truncates each row's pixels in blocks of 32; its
    # scalar loop rounds the rest of the row
    vec = np.arange(out.shape[-2]) < out.shape[-2] // 32 * 32
    out = np.where(vec[:, None], np.trunc(out), np.rint(out))
    return np.clip(out, 0, 255).astype(np.uint8)
