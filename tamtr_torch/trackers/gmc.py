"""Global motion compensation (GMC) for BoT-SORT, a port of the JAX
package's `tamtr_tpu/trackers/bot_sort.py:GMC`, which calls cv2.

`GMC.apply(frame)` returns the 2x3 affine map from the previous frame to
this one: the identity on the first frame and wherever the estimate fails.
Each cv2 call of the JAX package is a function here, on torch tensors on
the device `GMC` was given:

- sparseOptFlow: `good_features_to_track` (cv2.goodFeaturesToTrack, 1000
  corners, quality 0.01, min distance 1, block 3), then
  `calc_optical_flow_pyr_lk` (cv2.calcOpticalFlowPyrLK, window 21, 3
  levels, 30 iterations, epsilon 0.01) from the previous frame's corners;
- ecc: `find_transform_ecc` (cv2.findTransformECC, MOTION_EUCLIDEAN, 5000
  iterations, epsilon 1e-6, no smoothing), which raises where cv2 raises;
- orb: `fast_keypoints` (cv2.FastFeatureDetector_create(20)) and
  `orb_descriptors` (cv2.ORB_create().compute on those keypoints);
- sift: `sift_detect` and `sift_descriptors` (cv2.SIFT_create(
  nOctaveLayers=3, contrastThreshold=0.02, edgeThreshold=20));
- orb and sift match with `knn_match` (cv2.BFMatcher(...).knnMatch, k 2,
  Hamming or L2), gated on the host as the JAX package does;
- `estimate_affine_partial_2d` (cv2.estimateAffinePartial2D, RANSAC) fits
  the 4-parameter similarity on the host in numpy: cv2's RANSAC with its
  random stream, then the least-squares fit on the inliers that cv2's
  Levenberg-Marquardt refinement converges to.

The frame's gray image, blur and downscale are `data/imgproc.py`'s bitwise
rewrites of cv2.cvtColor, cv2.GaussianBlur and cv2.resize.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from tamtr_torch.data.imgproc import (cvt_bgr2gray, gaussian_blur_u8, pyr_down_u8, reflect101_index, resize_linear,
                                      resize_linear_f32, resize_nearest, scharr_i16, sobel_f32, warp_affine_f32)
from tamtr_torch.trackers.orb_pattern import BIT_PATTERN_31

F32 = torch.float32

# cv2's arguments as the JAX package's GMC passes them (cv2's defaults where it passes none)
_MAX_CORNERS, _QUALITY = 1000, 0.01  # goodFeaturesToTrack: maxCorners, qualityLevel
_LK_WIN, _LK_LEVELS = 21, 3  # calcOpticalFlowPyrLK: winSize, maxLevel
_LK_ITERS, _LK_EPS, _LK_MIN_EIG = 30, 0.01, 1e-4  # its criteria (COUNT | EPS) and minEigThreshold
# estimateAffinePartial2D: ransacReprojThreshold, maxIters, confidence
_RANSAC_THRESH, _RANSAC_ITERS, _RANSAC_CONF = 3.0, 2000, 0.99
_ECC_ITERS, _ECC_EPS = 5000, 1e-6  # findTransformECC's criteria (COUNT | EPS)
_FAST_THRESH = 20  # FastFeatureDetector_create: threshold
_FAST_ANGLE = -1.0  # the angle of FAST's keypoints, which ORB's compute keeps
_ORB_BORDER = 31  # ORB_create: edgeThreshold
_SIFT_CONTRAST, _SIFT_EDGE, _SIFT_SIGMA = 0.02, 20.0, 1.6  # SIFT_create: contrastThreshold, edgeThreshold, sigma


# ------------------------------------------------------------------ corners


def corner_min_eigen_val(gray: torch.Tensor) -> torch.Tensor:
    """`cv2.cornerMinEigenVal(gray, blockSize=3, ksize=3)` of a uint8
    (H, W) tensor: the Sobel derivatives scaled by 1 / (4 * 3 * 255), their
    products summed over 3x3 (BORDER_REFLECT_101), the smaller eigenvalue
    of each 2x2 matrix, in float32."""
    h, w = gray.shape
    dev = gray.device
    scale = 1.0 / (4 * 3 * 255)
    dx = sobel_f32(gray, 1, 0, scale)
    dy = sobel_f32(gray, 0, 1, scale)
    cov = torch.stack([dx * dx, dx * dy, dy * dy])
    p = cov[:, :, reflect101_index(w, 1, 1, dev)]
    p = (p[:, :, :-2] + p[:, :, 1:-1]) + p[:, :, 2:]
    p = p[:, reflect101_index(h, 1, 1, dev)]
    cov = (p[:, :-2] + p[:, 1:-1]) + p[:, 2:]
    a, b, c = cov[0] * 0.5, cov[1], cov[2] * 0.5
    return (a + c) - torch.sqrt((a - c) * (a - c) + b * b)


def good_features_to_track(gray: torch.Tensor) -> Optional[torch.Tensor]:
    """`cv2.goodFeaturesToTrack(gray, maxCorners=1000, qualityLevel=0.01,
    minDistance=1, blockSize=3)` of a uint8 (H, W) tensor: (N, 2) float32
    corners (x, y) or None. The min-eigenvalue response at or below 0.01 *
    max is dropped, a pixel stays where it equals the 3x3 maximum (pixels
    on the image's edge never do), and the corners run by response, a later
    pixel first on a tie (cv2 sorts pointers into the response image). A
    minimum distance of 1 rejects no corner."""
    eig = corner_min_eigen_val(gray)
    h, w = eig.shape
    thresh = np.float32(float(eig.max()) * _QUALITY)
    eig = torch.where(eig > float(thresh), eig, torch.zeros((), dtype=F32, device=eig.device))
    dil = torch.nn.functional.max_pool2d(eig[None, None], 3, 1, 1)[0, 0]
    keep = (eig != 0) & (eig == dil)
    keep[0], keep[-1], keep[:, 0], keep[:, -1] = False, False, False, False
    idx = torch.nonzero(keep.reshape(-1)).reshape(-1).flip(0)  # flat index, descending
    if idx.numel() == 0:
        return None
    order = torch.sort(eig.reshape(-1)[idx], descending=True, stable=True).indices
    idx = idx[order[:_MAX_CORNERS]]
    return torch.stack([idx % w, idx // w], 1).to(F32)


# ------------------------------------------------------------ optical flow

_W_BITS = 14


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def _bilinear_weights(pt: torch.Tensor):
    """cv2's 14-bit bilinear weights of float32 points (N, 2) and their
    integer corners."""
    ip = torch.floor(pt)
    a, b = (pt - ip).unbind(1)
    one = torch.ones((), dtype=F32, device=pt.device)
    iw00 = torch.round((one - a) * (one - b) * (1 << _W_BITS)).to(torch.int32)
    iw01 = torch.round(a * (one - b) * (1 << _W_BITS)).to(torch.int32)
    iw10 = torch.round((one - a) * b * (1 << _W_BITS)).to(torch.int32)
    iw11 = (1 << _W_BITS) - iw00 - iw01 - iw10
    return ip.to(torch.int64), [w[:, None, None] for w in (iw00, iw01, iw10, iw11)]


def _window(img: torch.Tensor, corner: torch.Tensor, win: int) -> torch.Tensor:
    """(N, win + 1, win + 1, ...) of `img` from each corner (x, y), clamped
    into the image."""
    h, w = img.shape[:2]
    r = torch.arange(win + 1, device=img.device)
    ys = (corner[:, 1, None] + r).clamp(0, h - 1)
    xs = (corner[:, 0, None] + r).clamp(0, w - 1)
    return img[ys[:, :, None], xs[:, None, :]]


def _interp(win: torch.Tensor, iw, n: int) -> torch.Tensor:
    """cv2's fixed-point bilinear of a (N, s + 1, s + 1) window, descaled
    by n bits."""
    v = win.to(torch.int32)
    return _descale(v[:, :-1, :-1] * iw[0] + v[:, :-1, 1:] * iw[1] + v[:, 1:, :-1] * iw[2]
                    + v[:, 1:, 1:] * iw[3], n)


def build_flow_pyramid(gray: torch.Tensor) -> List[torch.Tensor]:
    """The levels `cv2.buildOpticalFlowPyramid(gray, (21, 21), 3)` makes:
    `cv2.pyrDown` per level, stopping where a level would be no larger than
    the window."""
    levels = [gray]
    h, w = gray.shape
    for _ in range(_LK_LEVELS):
        h, w = (h + 1) // 2, (w + 1) // 2
        if w <= _LK_WIN or h <= _LK_WIN:
            break
        levels.append(pyr_down_u8(levels[-1]))
    return levels


def calc_optical_flow_pyr_lk(prev: torch.Tensor, nxt: torch.Tensor,
                             pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`cv2.calcOpticalFlowPyrLK(prev, nxt, pts, None)` (winSize 21,
    maxLevel 3, 30 iterations, epsilon 0.01, minEigThreshold 1e-4) for
    uint8 (H, W) tensors and (N, 2) float32 points: (next points, status).
    Per level, coarse to fine: the previous image's window
    (BORDER_REFLECT_101) and its Scharr derivatives (zero off the image) at
    cv2's 14-bit bilinear weights, then Lucas-Kanade steps until a step is
    under epsilon, or undoes the last one (then half of it is taken back),
    or the 30th. A point whose window leaves the image or whose gradient
    matrix has a minimum eigenvalue under 1e-4 gets status False at level
    0."""
    dev = pts.device
    win = _LK_WIN
    levels_prev = build_flow_pyramid(prev)
    levels_next = build_flow_pyramid(nxt)
    top = min(len(levels_prev), len(levels_next)) - 1
    n = pts.shape[0]
    status = torch.ones(n, dtype=torch.bool, device=dev)
    half = torch.tensor([(win - 1) * 0.5] * 2, dtype=F32, device=dev)
    flt_scale = np.float32(1.0 / (1 << 20))
    next_pts = pts.clone()
    for level in range(top, -1, -1):
        I, J = levels_prev[level], levels_next[level]
        h, w = I.shape
        ry, rx = reflect101_index(h, win, win, dev), reflect101_index(w, win, win, dev)
        Ipad = I[ry][:, rx]
        Jpad = J[ry][:, rx]
        dpad = torch.zeros((h + 2 * win, w + 2 * win, 2), dtype=torch.int16, device=dev)
        dpad[win:win + h, win:win + w] = scharr_i16(I)
        prev_pt = pts * np.float32(1.0 / (1 << level))
        next_pt = prev_pt.clone() if level == top else next_pts * 2
        next_pts = next_pt.clone()
        pp = prev_pt - half
        ip, iw = _bilinear_weights(pp)
        inside = ((ip[:, 0] >= -win) & (ip[:, 0] < w) & (ip[:, 1] >= -win) & (ip[:, 1] < h))
        if level == 0:
            status &= inside
        Iw = _interp(_window(Ipad, ip + win, win), iw, _W_BITS - 5)
        dwin = _window(dpad, ip + win, win)
        dx = _interp(dwin[..., 0], iw, _W_BITS)
        dy = _interp(dwin[..., 1], iw, _W_BITS)
        A11 = (dx * dx).sum((1, 2), dtype=torch.int64).to(F32) * flt_scale
        A12 = (dx * dy).sum((1, 2), dtype=torch.int64).to(F32) * flt_scale
        A22 = (dy * dy).sum((1, 2), dtype=torch.int64).to(F32) * flt_scale
        D = A11 * A22 - A12 * A12
        eig = (A22 + A11 - torch.sqrt((A11 - A22) * (A11 - A22) + 4 * A12 * A12)) / np.float32(2 * win * win)
        good = (eig >= _LK_MIN_EIG) & (D >= np.finfo(np.float32).eps)
        if level == 0:
            status &= ~inside | good
        active = inside & good
        Dinv = 1 / torch.where(good, D, torch.ones_like(D))
        pt = next_pt - half
        prev_delta = torch.zeros_like(pt)
        for j in range(_LK_ITERS):
            # the points still iterating, as a subset
            sub = torch.nonzero(active).reshape(-1)
            if sub.numel() == 0:
                break
            inx, jw = _bilinear_weights(pt[sub])
            ok = (inx[:, 0] >= -win) & (inx[:, 0] < w) & (inx[:, 1] >= -win) & (inx[:, 1] < h)
            diff = _interp(_window(Jpad, inx + win, win), jw, _W_BITS - 5) - Iw[sub]
            b1 = (diff * dx[sub]).sum((1, 2), dtype=torch.int64).to(F32) * flt_scale
            b2 = (diff * dy[sub]).sum((1, 2), dtype=torch.int64).to(F32) * flt_scale
            a11, a12, a22, dinv = A11[sub], A12[sub], A22[sub], Dinv[sub]
            delta = torch.stack([(a12 * b2 - a22 * b1) * dinv, (a12 * b1 - a11 * b2) * dinv], 1)
            delta = torch.where(ok[:, None], delta, torch.zeros_like(delta))
            new_pt = pt[sub] + delta
            pt[sub] = torch.where(ok[:, None], new_pt, pt[sub])
            moved = new_pt + half
            d64 = delta.double()
            small = (d64 * d64).sum(1) <= _LK_EPS * _LK_EPS
            undo = ((delta + prev_delta[sub]).abs().double() < 0.01).all(1) & (j > 0) & ~small
            moved = torch.where(undo[:, None], moved - delta * np.float32(0.5), moved)
            next_pts[sub] = torch.where(ok[:, None], moved, next_pts[sub])
            if level == 0:
                status[sub] &= ok
            active[sub] = ok & ~small & ~undo
            prev_delta[sub] = delta
    return next_pts, status


# ------------------------------------------------------- affine estimation

_RNG_COEFF = 4164903690


class CvRNG:
    """cv2's `cv::RNG`: a multiply-with-carry generator on 64 bits, seeded
    as cv2 seeds it (all ones)."""

    def __init__(self):
        self.state = (1 << 64) - 1

    def next(self) -> int:
        self.state = ((self.state & 0xFFFFFFFF) * _RNG_COEFF + (self.state >> 32)) & ((1 << 64) - 1)
        return self.state & 0xFFFFFFFF

    def uniform(self, a: int, b: int) -> int:
        return a if a == b else self.next() % (b - a) + a


def _similarity_from_two(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The 4-parameter similarity through two point pairs (cv2's
    `AffinePartial2DEstimatorCallback::runKernel`), in float64."""
    (x1, y1), (x2, y2) = src.astype(np.float64)
    (X1, Y1), (X2, Y2) = dst.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        d = 1.0 / ((x1 - x2) * (x1 - x2) + (y1 - y2) * (y1 - y2))
        S0 = d * ((X1 - X2) * (x1 - x2) + (Y1 - Y2) * (y1 - y2))
        S1 = d * ((Y1 - Y2) * (x1 - x2) - (X1 - X2) * (y1 - y2))
        S2 = d * ((Y1 - Y2) * (x1 * y2 - x2 * y1) - (X1 * y2 - X2 * y1) * (y1 - y2) - (X1 * x2 - X2 * x1) * (x1 - x2))
        S3 = d * (-(X1 - X2) * (x1 * y2 - x2 * y1) - (Y1 * x2 - Y2 * x1) * (x1 - x2) - (Y1 * y2 - Y2 * y1) * (y1 - y2))
    return np.array([[S0, -S1, S2], [S1, S0, S3]])


def _sq_errors(M: np.ndarray, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    F = M.astype(np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        a = F[0, 0] * src[:, 0] + F[0, 1] * src[:, 1] + F[0, 2] - dst[:, 0]
        b = F[1, 0] * src[:, 0] + F[1, 1] * src[:, 1] + F[1, 2] - dst[:, 1]
        return a * a + b * b


def _ransac_iters(confidence: float, outlier_ratio: float, model_points: int, max_iters: int) -> int:
    """cv2's `RANSACUpdateNumIters`."""
    p = min(max(confidence, 0.0), 1.0)
    ep = min(max(outlier_ratio, 0.0), 1.0)
    num = max(1.0 - p, np.finfo(np.float64).tiny)
    denom = 1.0 - (1.0 - ep) ** model_points
    if denom < np.finfo(np.float64).tiny:
        return 0
    num, denom = math.log(num), math.log(denom)
    return max_iters if denom >= 0 or -num >= max_iters * (-denom) else int(np.rint(num / denom))


def estimate_affine_partial_2d(src: np.ndarray, dst: np.ndarray) -> Optional[np.ndarray]:
    """`cv2.estimateAffinePartial2D(src, dst, method=cv2.RANSAC)` (threshold
    3 px, 2000 iterations, confidence 0.99) of (N, 2) float32 point arrays:
    the (2, 3) float64 similarity, or None. RANSAC as cv2 runs it (its
    generator seeded with all ones, two distinct points a sample, a squared
    error in float32 at or under 3^2 an inlier, the iteration count cut as
    the inliers grow), then the least-squares
    similarity of the best model's inliers, the minimum that cv2's
    Levenberg-Marquardt refinement converges to."""
    src = np.ascontiguousarray(src, np.float32).reshape(-1, 2)
    dst = np.ascontiguousarray(dst, np.float32).reshape(-1, 2)
    count = len(src)
    if count < 2:
        return None
    rng = CvRNG()
    niters, best, best_mask, best_count = _RANSAC_ITERS, None, None, 0
    t = np.float32(_RANSAC_THRESH * _RANSAC_THRESH)
    it = 0
    while it < niters:
        if count > 2:
            i0 = rng.uniform(0, count)
            i1 = rng.uniform(0, count)
            while i1 == i0:
                i1 = rng.uniform(0, count)
            pick = [i0, i1]
        else:
            pick = [0, 1]
        M = _similarity_from_two(src[pick], dst[pick])
        mask = _sq_errors(M, src, dst) <= t
        good = int(mask.sum())
        if good > max(best_count, 1):
            best, best_mask, best_count = M, mask, good
            niters = _ransac_iters(_RANSAC_CONF, (count - good) / count, 2, niters)
        it += 1
    if best is None:
        return None
    if count <= 2:
        return best
    s = src[best_mask].astype(np.float64)
    d = dst[best_mask].astype(np.float64)
    A = np.zeros((2 * len(s), 4))
    A[0::2] = np.stack([s[:, 0], -s[:, 1], np.ones(len(s)), np.zeros(len(s))], 1)
    A[1::2] = np.stack([s[:, 1], s[:, 0], np.zeros(len(s)), np.ones(len(s))], 1)
    a, b, tx, ty = np.linalg.lstsq(A, d.reshape(-1), rcond=None)[0]
    return np.array([[a, -b, tx], [b, a, ty]])


# ---------------------------------------------------------------------- ECC


class ECCError(RuntimeError):
    """cv2.findTransformECC's StsNoConv: the iteration cannot go on."""


def find_transform_ecc(template: torch.Tensor, image: torch.Tensor, warp: np.ndarray) -> np.ndarray:
    """`cv2.findTransformECC(template, image, warp, cv2.MOTION_EUCLIDEAN,
    (COUNT | EPS, 5000, 1e-6), None, 1)` of uint8 (H, W) tensors: the
    (2, 3) float32 Euclidean warp that maximises the enhanced correlation
    coefficient. Per iteration the image and its gradients ((-0.5, 0, 0.5),
    BORDER_REFLECT_101) are warped back (INTER_LINEAR, WARP_INVERSE_MAP,
    zero outside), both images made zero-mean over the warped mask, and a
    Gauss-Newton step with cv2's illumination factor taken; the loop ends
    when the coefficient moves by less than 1e-6. The dot products are in
    float64, rounded to float32 where cv2 stores them. Raises ECCError where
    cv2 raises: a NaN coefficient, or a step that would lower the
    correlation ("images may be uncorrelated or non-overlapped")."""
    dev = template.device
    hs, ws = template.shape
    hd, wd = image.shape
    tmpl = template.to(F32)
    img = image.to(F32)
    half = np.float32(0.5)
    px = img[:, reflect101_index(wd, 1, 1, dev)]
    gx = px[:, 2:] * half + px[:, :-2] * -half
    py = img[reflect101_index(hd, 1, 1, dev)]
    gy = py[2:] * half + py[:-2] * -half
    src = torch.stack([img, gx, gy, torch.ones_like(img)])
    xg = torch.arange(ws, dtype=F32, device=dev)[None].expand(hs, ws)
    yg = torch.arange(hs, dtype=F32, device=dev)[:, None].expand(hs, ws)
    tmpl64 = tmpl.double()
    M = np.asarray(warp, np.float32).copy()
    rho, last_rho = -1.0, -_ECC_EPS
    i = 1
    while i <= _ECC_ITERS and abs(rho - last_rho) >= _ECC_EPS:
        Mt = torch.from_numpy(M)
        warped, gxw, gyw = (warp_affine_f32(t, Mt, (ws, hs)) for t in src[:3])
        mask = warp_affine_f32(src[3], Mt, (ws, hs), nearest=True) != 0
        m64 = mask.double()
        w64 = warped.double()
        n, sw, sww, st, stt = torch.stack([m64.sum(), (w64 * m64).sum(), (w64 * w64 * m64).sum(),
                                          (tmpl64 * m64).sum(), (tmpl64 * tmpl64 * m64).sum()]).tolist()
        if n == 0:
            raise ECCError("findTransformECC: the warped mask is empty")
        img_mean, tmp_mean = sw / n, st / n
        img_std = math.sqrt(max(sww / n - img_mean * img_mean, 0.0))
        tmp_std = math.sqrt(max(stt / n - tmp_mean * tmp_mean, 0.0))
        warped = torch.where(mask, (w64 - img_mean).float(), warped)
        tzm = torch.where(mask, (tmpl64 - tmp_mean).float(), torch.zeros((), dtype=F32, device=dev))
        tmp_norm = math.sqrt(n * tmp_std * tmp_std)
        img_norm = math.sqrt(n * img_std * img_std)
        h0, h1 = np.float32(M[0, 0]), np.float32(M[1, 0])
        hat_x = -(xg * h1) - (yg * h0)
        hat_y = (xg * h0) - (yg * h1)
        jac = torch.stack([gxw * hat_x + gyw * hat_y, gxw, gyw]).reshape(3, -1).double()
        other = torch.stack([warped, tzm]).reshape(2, -1).double()
        # (3, 6): jac . jac (3), jac . warped, jac . tzm, and the correlation tzm . warped
        dots = torch.cat([jac @ torch.cat([jac, other]).T, (other[1] @ other[0]).reshape(1, 1).expand(3, 1)], 1)
        dots = dots.cpu().numpy()
        H = dots[:, :3].astype(np.float32)
        try:
            Hinv = np.linalg.inv(H.astype(np.float64)).astype(np.float32)
        except np.linalg.LinAlgError:
            Hinv = np.zeros((3, 3), np.float32)
        correlation = float(dots[0, 5])
        last_rho = rho
        rho = correlation / (img_norm * tmp_norm) if img_norm * tmp_norm else float("nan")
        if math.isnan(rho):
            raise ECCError("findTransformECC: NaN encountered")
        img_proj = dots[:, 3].astype(np.float32).astype(np.float64)
        tmp_proj = dots[:, 4].astype(np.float32).astype(np.float64)
        img_proj_h = (Hinv.astype(np.float64) @ img_proj).astype(np.float32).astype(np.float64)
        lambda_n = img_norm * img_norm - float(img_proj @ img_proj_h)
        lambda_d = correlation - float(tmp_proj @ img_proj_h)
        if lambda_d <= 0.0:
            raise ECCError("findTransformECC: the algorithm stopped before its convergence; the correlation "
                           "is going to be minimized; images may be uncorrelated or non-overlapped")
        lam = lambda_n / lambda_d
        # jac . (lam * tzm - warped), from the products already taken
        err_proj = (lam * dots[:, 4] - dots[:, 3]).astype(np.float32)
        dp = (Hinv.astype(np.float64) @ err_proj.astype(np.float64)).astype(np.float32)
        theta = float(dp[0]) + math.asin(float(M[1, 0]))
        M[0, 2] = np.float32(M[0, 2] + dp[1])
        M[1, 2] = np.float32(M[1, 2] + dp[2])
        M[0, 0] = M[1, 1] = np.float32(math.cos(theta))
        M[1, 0] = np.float32(math.sin(theta))
        M[0, 1] = -M[1, 0]
        i += 1
    return M


# ------------------------------------------------------------------ FAST, ORB

# the 16-pixel circle of radius 3, (x, y), in cv2's order
_CIRCLE = ((0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
           (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3))


def _arc_min9(d: torch.Tensor) -> torch.Tensor:
    """The largest over the 16 arcs of 9 contiguous circle pixels of the
    smallest value on the arc; d (16, ...)."""
    e = torch.cat([d, d[:8]])  # 24
    m2 = torch.minimum(e[:-1], e[1:])  # 23
    m4 = torch.minimum(m2[:-2], m2[2:])  # 21
    m8 = torch.minimum(m4[:-4], m4[4:])  # 17
    return torch.minimum(m8[:16], e[8:24]).amax(0)


def fast_keypoints(gray: torch.Tensor) -> torch.Tensor:
    """`cv2.FastFeatureDetector_create(20).detect(gray)` of a uint8
    (H, W) tensor: FAST-9 on the 16-pixel circle with non-maximum
    suppression; (N, 2) int64 (x, y) in raster order. A pixel at least 3
    from the edge is a corner where 9 contiguous circle pixels are all
    brighter than it by more than 20 or all darker; its score is
    the largest such margin less one (cv2's `cornerScore`), and it stays
    where its score is above all 8 neighbours' (0 off corners)."""
    h, w = gray.shape
    v = gray.to(torch.int32)
    core = v[3:h - 3, 3:w - 3]
    d = torch.stack([core - v[3 + y:h - 3 + y, 3 + x:w - 3 + x] for x, y in _CIRCLE])
    up, down = _arc_min9(d), _arc_min9(-d)
    corner = (up > _FAST_THRESH) | (down > _FAST_THRESH)
    score = torch.where(corner, torch.clamp(torch.maximum(up, down), min=_FAST_THRESH) - 1, 0)
    full = torch.zeros((h, w), dtype=torch.int32, device=gray.device)
    full[3:h - 3, 3:w - 3] = score
    nb = torch.nn.functional.pad(full, (1, 1, 1, 1))
    best = torch.stack([nb[1 + dy:h + 1 + dy, 1 + dx:w + 1 + dx] for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                        if dx or dy]).amax(0)
    keep = (full > 0) & (full > best)
    yx = torch.nonzero(keep)
    return yx.flip(1)


def orb_descriptors(gray: torch.Tensor, pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`cv2.ORB_create().compute(gray, keypoints)` for keypoints at level 0
    with one angle (FAST's keypoints carry -1 degrees, and ORB's compute
    keeps a given keypoint's angle): (kept points (N, 2), descriptors
    (N, 32) uint8). Keypoints within 31 of the edge go; each bit
    compares two pixels of the 7x7 sigma-2 blur at ORB's test pairs
    rotated by the angle and rounded."""
    h, w = gray.shape
    x, y = pts[:, 0], pts[:, 1]
    b = _ORB_BORDER
    keep = (x >= b) & (x < w - b) & (y >= b) & (y < h - b)
    pts = pts[keep]
    pat = np.asarray(BIT_PATTERN_31, np.float32).reshape(512, 2)
    ang = np.float32(np.float32(_FAST_ANGLE) * np.float32(math.pi / 180))
    a, b = np.float32(math.cos(ang)), np.float32(math.sin(ang))
    px = np.rint(pat[:, 0] * a - pat[:, 1] * b).astype(np.int64)
    py = np.rint(pat[:, 0] * b + pat[:, 1] * a).astype(np.int64)
    # ORB's 7x7 blur is cv2's float one rounded, not its bit-exact 8-bit path
    blur = torch.round(gaussian_blur_f32(gray.to(F32), 2.0, ksize=7)).to(torch.uint8)
    dev = gray.device
    cx = pts[:, 0].round().to(torch.int64)[:, None] + torch.from_numpy(px).to(dev)
    cy = pts[:, 1].round().to(torch.int64)[:, None] + torch.from_numpy(py).to(dev)
    vals = blur[cy, cx]
    bits = (vals[:, 0::2] < vals[:, 1::2]).to(torch.int32).reshape(-1, 32, 8)
    desc = (bits << torch.arange(8, device=dev, dtype=torch.int32)).sum(2).to(torch.uint8)
    return pts, desc


def knn_match2(query: torch.Tensor, train: torch.Tensor, hamming: bool) -> Tuple[np.ndarray, np.ndarray]:
    """`cv2.BFMatcher(NORM_HAMMING or NORM_L2).knnMatch(query, train, 2)`:
    (indices (Q, 2), distances (Q, 2) float32) of each query's two nearest
    train rows, the lower index first on a tie. Hamming on uint8 bytes; L2
    on float32 rows (exact: the bit counts, and SIFT's entries, are whole
    numbers)."""
    if hamming:
        def bits(t):
            b = (t.to(torch.int32)[..., None] >> torch.arange(8, device=t.device)) & 1
            return b.reshape(t.shape[0], -1).float()

        q, t = bits(query), bits(train)
        d = q.sum(1)[:, None] + t.sum(1)[None] - 2 * q @ t.T
    else:
        q, t = query.double(), train.double()
        d = torch.sqrt(((q * q).sum(1)[:, None] + (t * t).sum(1)[None] - 2 * q @ t.T).clamp(min=0))
    d = d.float()
    k = min(2, d.shape[1])
    order = torch.sort(d, dim=1, stable=True).indices[:, :k]
    return order.cpu().numpy(), torch.gather(d, 1, order).cpu().numpy()


# ---------------------------------------------------------------------- SIFT

_SIFT_LAYERS = 3
_SIFT_BORDER = 5
_SIFT_CHUNK = 256  # descriptors computed together, of keypoints of like radius


def _gaussian_kernel_f32(sigma: float, ksize: int = 0) -> np.ndarray:
    """cv2's float Gaussian kernel; for ksize 0 of size round(8 sigma + 1) | 1."""
    n = ksize or int(np.rint(sigma * 8 + 1)) | 1
    x = np.arange(n) - (n - 1) / 2
    k = np.exp(-x * x / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur_f32(img: torch.Tensor, sigma: float, ksize: int = 0) -> torch.Tensor:
    """`cv2.GaussianBlur(img, (ksize, ksize), sigma)` of a float32 (H, W)
    tensor, BORDER_REFLECT_101, as two 1-D convolutions in full fp32 (TF32
    off whatever the caller set)."""
    k = torch.from_numpy(_gaussian_kernel_f32(sigma, ksize)).to(img.device)
    r = (k.numel() - 1) // 2
    h, w = img.shape
    p = img[reflect101_index(h, r, r, img.device)][:, reflect101_index(w, r, r, img.device)]
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                     allow_tf32=False):
        p = torch.nn.functional.conv2d(p[None, None], k.view(1, 1, 1, -1))
        return torch.nn.functional.conv2d(p, k.view(1, 1, -1, 1))[0, 0]


def sift_pyramid(gray: torch.Tensor, first_octave: int, n_octaves: int) -> List[torch.Tensor]:
    """SIFT's Gaussian scale space as cv2 builds it: per octave a
    (layers + 3, h, w) float32 tensor; octave -1 is the image doubled
    (INTER_LINEAR), each octave's base the previous octave's layer `layers`
    halved (INTER_NEAREST), each layer blurred from the last by the sigma
    that adds one step of 2^(1/layers)."""
    sigma = _SIFT_SIGMA
    g = gray.to(F32)
    if first_octave < 0:
        sig_diff = math.sqrt(max(sigma * sigma - 0.25 * 4, 0.01))
        g = resize_linear_f32(g, (g.shape[1] * 2, g.shape[0] * 2))
    else:
        sig_diff = math.sqrt(max(sigma * sigma - 0.25, 0.01))
    base = gaussian_blur_f32(g, sig_diff)
    k = 2 ** (1.0 / _SIFT_LAYERS)
    sig = [sigma] + [math.sqrt((k ** i * sigma) ** 2 - (k ** (i - 1) * sigma) ** 2)
                     for i in range(1, _SIFT_LAYERS + 3)]
    octaves = []
    for o in range(n_octaves):
        if o == 0:
            layer = base
        else:
            src = octaves[-1][_SIFT_LAYERS]
            layer = resize_nearest(src, (src.shape[1] // 2, src.shape[0] // 2))
        layers = [layer]
        for i in range(1, _SIFT_LAYERS + 3):
            layers.append(gaussian_blur_f32(layers[-1], sig[i]))
        octaves.append(torch.stack(layers))
    return octaves


def _orientation_peaks(img: torch.Tensor, r: torch.Tensor, c: torch.Tensor, scl: torch.Tensor):
    """SIFT's 36-bin orientation histogram around each point (radius
    round(4.5 scl), Gaussian weight sigma 1.5 scl), smoothed by (1 4 6 4 1)
    / 16; (point index, angle in degrees) of each local peak at >= 0.8 of
    the highest, interpolated by a parabola (cv2's `calcOrientationHist`)."""
    n = 36
    dev = img.device
    rows, cols = img.shape
    radius = torch.round(scl * 4.5).to(torch.int64)
    R = int(radius.max()) if radius.numel() else 0
    off = torch.arange(-R, R + 1, device=dev)
    oy, ox = off[:, None].expand(2 * R + 1, 2 * R + 1), off[None].expand(2 * R + 1, 2 * R + 1)
    y = r[:, None, None] + oy
    x = c[:, None, None] + ox
    inside = (oy.abs() <= radius[:, None, None]) & (ox.abs() <= radius[:, None, None]) & \
        (y > 0) & (y < rows - 1) & (x > 0) & (x < cols - 1)
    yc, xc = y.clamp(1, rows - 2), x.clamp(1, cols - 2)
    dx = img[yc, xc + 1] - img[yc, xc - 1]
    dy = img[yc - 1, xc] - img[yc + 1, xc]
    sig = scl * 1.5
    wgt = torch.exp((oy * oy + ox * ox).to(F32) * (-1.0 / (2.0 * sig * sig))[:, None, None])
    ori = torch.rad2deg(torch.atan2(dy, dx)) % 360.0
    mag = torch.sqrt(dx * dx + dy * dy)
    b = torch.round(ori * (n / 360.0)).to(torch.int64) % n
    hist = torch.zeros((r.numel(), n), dtype=F32, device=dev)
    hist.scatter_add_(1, b.reshape(r.numel(), -1), (wgt * mag * inside).reshape(r.numel(), -1))
    ext = torch.cat([hist[:, -2:], hist, hist[:, :2]], 1)
    sm = ((ext[:, :-4] + ext[:, 4:]) * (1.0 / 16) + (ext[:, 1:-3] + ext[:, 3:-1]) * (4.0 / 16)
          + ext[:, 2:-2] * (6.0 / 16))
    left, right = sm.roll(1, 1), sm.roll(-1, 1)
    peak = (sm > left) & (sm > right) & (sm >= sm.amax(1, keepdim=True) * 0.8)
    ki, bi = torch.nonzero(peak, as_tuple=True)
    l, m, rr = left[ki, bi], sm[ki, bi], right[ki, bi]
    bin_ = bi.to(F32) + 0.5 * (l - rr) / (l - 2 * m + rr)
    bin_ = torch.where(bin_ < 0, bin_ + n, torch.where(bin_ >= n, bin_ - n, bin_))
    angle = 360.0 - (360.0 / n) * bin_
    angle = torch.where((angle - 360.0).abs() < np.finfo(np.float32).eps, torch.zeros_like(angle), angle)
    return ki, angle


def _max26(d: torch.Tensor) -> torch.Tensor:
    """The 3x3x3 maximum around each sample of a (layers, h, w) stack (the
    end layers over two layers)."""
    m = torch.nn.functional.max_pool2d(d[:, None], 3, 1, 1)[:, 0]
    out = m.clone()
    out[1:] = torch.maximum(out[1:], m[:-1])
    out[:-1] = torch.maximum(out[:-1], m[1:])
    return out


def sift_detect(gray: torch.Tensor, mask: torch.Tensor) -> dict:
    """`cv2.SIFT_create(nOctaveLayers=3, contrastThreshold=0.02,
    edgeThreshold=20).detect(gray, mask)` of a uint8 (H, W) tensor: the
    keypoints as numpy arrays (`x`, `y`, `size`, `angle`, `octave` as cv2
    packs it, `response`). Extrema of the difference of Gaussians over
    their 26 neighbours (5 pixels from the edge), refined by up to 5
    quadratic steps, kept above the contrast threshold / 3 and under the
    edge ratio, one keypoint per orientation peak; sorted and deduplicated
    as cv2's `removeDuplicatedSorted`, then masked."""
    dev = gray.device
    h, w = gray.shape
    n_oct = int(np.rint(math.log(min(2 * w, 2 * h)) / math.log(2.0) - 2)) + 1
    gpyr = sift_pyramid(gray, -1, n_oct)
    img_scale = 1.0 / 255
    out = {k: [] for k in ("x", "y", "size", "angle", "octave", "response")}
    for o, g in enumerate(gpyr):
        dog = g[1:] - g[:-1]  # (layers + 2, h, w)
        L, rows, cols = dog.shape
        mx, mn = (_max26(dog), -_max26(-dog))
        cand = ((dog > 0) & (dog >= mx)) | ((dog < 0) & (dog <= mn))
        cand[0], cand[-1] = False, False
        cand[:, :_SIFT_BORDER], cand[:, rows - _SIFT_BORDER:] = False, False
        cand[:, :, :_SIFT_BORDER], cand[:, :, cols - _SIFT_BORDER:] = False, False
        lay, r, c = torch.nonzero(cand, as_tuple=True)
        if lay.numel() == 0:
            continue
        alive = torch.ones_like(lay, dtype=torch.bool)
        done = torch.zeros_like(alive)
        X = torch.zeros((lay.numel(), 3), dtype=F32, device=dev)

        def derivs(lay, r, c):
            D = lambda dl, dr, dc: dog[(lay + dl).clamp(0, L - 1), (r + dr).clamp(0, rows - 1),
                                       (c + dc).clamp(0, cols - 1)]
            v2 = D(0, 0, 0) * 2
            dD = torch.stack([(D(0, 0, 1) - D(0, 0, -1)) * (img_scale * 0.5),
                              (D(0, 1, 0) - D(0, -1, 0)) * (img_scale * 0.5),
                              (D(1, 0, 0) - D(-1, 0, 0)) * (img_scale * 0.5)], 1)
            dxx = (D(0, 0, 1) + D(0, 0, -1) - v2) * img_scale
            dyy = (D(0, 1, 0) + D(0, -1, 0) - v2) * img_scale
            dss = (D(1, 0, 0) + D(-1, 0, 0) - v2) * img_scale
            q = img_scale * 0.25
            dxy = (D(0, 1, 1) - D(0, 1, -1) - D(0, -1, 1) + D(0, -1, -1)) * q
            dxs = (D(1, 0, 1) - D(1, 0, -1) - D(-1, 0, 1) + D(-1, 0, -1)) * q
            dys = (D(1, 1, 0) - D(1, -1, 0) - D(-1, 1, 0) + D(-1, -1, 0)) * q
            H = torch.stack([torch.stack([dxx, dxy, dxs], 1), torch.stack([dxy, dyy, dys], 1),
                             torch.stack([dxs, dys, dss], 1)], 1)
            return dD, H, dxx, dyy, dxy, D(0, 0, 0)

        for _ in range(5):
            act = alive & ~done
            if not bool(act.any()):
                break
            dD, H, *_ = derivs(lay, r, c)
            sol = torch.linalg.solve_ex(H.double(), dD.double()[..., None])
            Xn = torch.where((sol.info == 0)[:, None], -sol.result[..., 0], torch.zeros((), dtype=torch.float64,
                                                                                         device=dev)).float()
            X = torch.where(act[:, None], Xn, X)
            conv = act & (X.abs() < 0.5).all(1)
            done |= conv
            move = act & ~conv
            big = (X.abs() > float(2 ** 31 // 3)).any(1)
            alive &= ~(move & big)
            Xr = torch.round(X).clamp(-1e6, 1e6).to(torch.int64)
            c = torch.where(move, c + Xr[:, 0], c)
            r = torch.where(move, r + Xr[:, 1], r)
            lay = torch.where(move, lay + Xr[:, 2], lay)
            out_of = (lay < 1) | (lay > _SIFT_LAYERS) | (c < _SIFT_BORDER) | (c >= cols - _SIFT_BORDER) | \
                (r < _SIFT_BORDER) | (r >= rows - _SIFT_BORDER)
            alive &= ~(move & out_of)
        alive &= done
        lay, r, c, X = lay[alive], r[alive], c[alive], X[alive]
        if lay.numel() == 0:
            continue
        dD, _, dxx, dyy, dxy, val = derivs(lay, r, c)
        contr = val * img_scale + (dD * X).sum(1) * 0.5
        tr = dxx + dyy
        det = dxx * dyy - dxy * dxy
        edge = _SIFT_EDGE
        ok = (contr.abs() * _SIFT_LAYERS >= _SIFT_CONTRAST) & (det > 0) & (tr * tr * edge < (edge + 1) ** 2 * det)
        lay, r, c, X, contr = lay[ok], r[ok], c[ok], X[ok], contr[ok]
        if lay.numel() == 0:
            continue
        xc, xr, xi = X.unbind(1)
        size = _SIFT_SIGMA * torch.pow(2.0, (lay.to(F32) + xi) / _SIFT_LAYERS) * (1 << o) * 2
        scl_octv = size * 0.5 / (1 << o)
        # each keypoint's orientation histogram on its own layer
        ki_all, ang_all = [], []
        for layer in range(1, _SIFT_LAYERS + 1):
            sel = torch.nonzero(lay == layer).reshape(-1)
            if sel.numel():
                ki, ang = _orientation_peaks(g[layer], r[sel], c[sel], scl_octv[sel])
                ki_all.append(sel[ki])
                ang_all.append(ang)
        ki = torch.cat(ki_all)
        ang = torch.cat(ang_all)
        scale = float(1 << o)
        out["x"].append(((c[ki].to(F32) + xc[ki]) * scale).cpu().numpy())
        out["y"].append(((r[ki].to(F32) + xr[ki]) * scale).cpu().numpy())
        out["size"].append(size[ki].cpu().numpy())
        out["angle"].append(ang.cpu().numpy())
        code = o + (lay[ki] << 8) + (torch.round((xi[ki].double() + 0.5) * 255).to(torch.int64) << 16)
        out["octave"].append(code.cpu().numpy())
        out["response"].append(contr[ki].abs().cpu().numpy())
    kp = {k: (np.concatenate(v) if v else np.zeros(0, np.int64 if k == "octave" else np.float32))
          for k, v in out.items()}
    order = np.lexsort((-kp["octave"], -kp["response"], kp["angle"], -kp["size"], kp["y"], kp["x"]))
    kp = {k: v[order] for k, v in kp.items()}
    if len(kp["x"]) > 1:
        same = (np.diff(kp["x"]) == 0) & (np.diff(kp["y"]) == 0) & (np.diff(kp["size"]) == 0) & \
            (np.diff(kp["angle"]) == 0)
        keep = np.concatenate([[True], ~same])
        kp = {k: v[keep] for k, v in kp.items()}
    # from the doubled image's octave -1 to the image's pixels
    kp["x"], kp["y"], kp["size"] = (kp["x"] * np.float32(0.5), kp["y"] * np.float32(0.5),
                                    kp["size"] * np.float32(0.5))
    kp["octave"] = (kp["octave"] & ~255) | ((kp["octave"] - 1) & 255)
    if len(kp["x"]):
        m = mask.cpu().numpy()
        keep = m[(kp["y"] + 0.5).astype(np.int64), (kp["x"] + 0.5).astype(np.int64)] != 0
        kp = {k: v[keep] for k, v in kp.items()}
    return kp


def sift_descriptors(gray: torch.Tensor, kp: dict) -> torch.Tensor:
    """`cv2.SIFT_create(...).compute(gray, keypoints)`: (N, 128) float32,
    4 x 4 cells of 8 orientation bins, each sample trilinearly spread with
    a Gaussian weight, the vector clipped at 0.2 of its norm, renormalised
    to 512 and rounded to whole numbers in [0, 255] (cv2's uchar scaling)."""
    dev = gray.device
    n = len(kp["x"])
    if n == 0:
        return torch.zeros((0, 128), dtype=F32, device=dev)
    octv = kp["octave"] & 255
    octv = np.where(octv < 128, octv, octv | -128)
    layer = (kp["octave"] >> 8) & 255
    first = min(int(octv.min()), 0)
    gpyr = sift_pyramid(gray, first, int(octv.max()) - first + 1)
    scale = np.where(octv >= 0, 1.0 / (1 << np.maximum(octv, 0)), (1 << np.maximum(-octv, 0))).astype(np.float32)
    size = kp["size"] * scale
    ptx, pty = kp["x"] * scale, kp["y"] * scale
    angle = np.float32(360) - kp["angle"]
    angle = np.where(np.abs(angle - 360) < np.finfo(np.float32).eps, np.float32(0), angle)
    d, nb = 4, 8
    out = torch.zeros((n, d * d * nb), dtype=F32, device=dev)
    for oi, g in enumerate(gpyr):
        for li in range(g.shape[0]):
            sel = np.nonzero((octv - first == oi) & (layer == li))[0]
            sel = sel[np.argsort(size[sel], kind="stable")]  # chunks of like radius
            for s in range(0, len(sel), _SIFT_CHUNK):
                idx = sel[s:s + _SIFT_CHUNK]
                out[torch.from_numpy(idx).to(dev)] = _sift_cells(
                    g[li], ptx[idx], pty[idx], angle[idx], size[idx] * np.float32(0.5), d, nb)
    return out


def _sift_cells(img: torch.Tensor, ptx, pty, ori, scl, d: int, n: int) -> torch.Tensor:
    """cv2's `calcSIFTDescriptor` for a batch of points on one layer."""
    dev = img.device
    rows, cols = img.shape
    k = len(ptx)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    cx, cy = torch.round(t(ptx)).to(torch.int64), torch.round(t(pty)).to(torch.int64)
    rad = t(ori) * np.float32(math.pi / 180)
    hist_width = 3.0 * t(scl)
    radius = torch.round(hist_width * 1.4142135623730951 * (d + 1) * 0.5).to(torch.int64)
    radius = radius.clamp(max=int(math.sqrt(cols * cols + rows * rows)))
    cos_t, sin_t = torch.cos(rad) / hist_width, torch.sin(rad) / hist_width
    R = int(radius.max())
    off = torch.arange(-R, R + 1, device=dev)
    i = off[:, None].expand(2 * R + 1, 2 * R + 1).to(F32)[None]
    j = off[None].expand(2 * R + 1, 2 * R + 1).to(F32)[None]
    c_rot = j * cos_t[:, None, None] - i * sin_t[:, None, None]
    r_rot = j * sin_t[:, None, None] + i * cos_t[:, None, None]
    rbin = r_rot + d / 2 - 0.5
    cbin = c_rot + d / 2 - 0.5
    rr = cy[:, None, None] + off[:, None]
    cc = cx[:, None, None] + off[None]
    inside = (rbin > -1) & (rbin < d) & (cbin > -1) & (cbin < d) & (rr > 0) & (rr < rows - 1) & \
        (cc > 0) & (cc < cols - 1) & (off[:, None].abs() <= radius[:, None, None]) & \
        (off[None].abs() <= radius[:, None, None])
    ry, rx = rr.clamp(1, rows - 2), cc.clamp(1, cols - 2)
    dx = img[ry, rx + 1] - img[ry, rx - 1]
    dy = img[ry - 1, rx] - img[ry + 1, rx]
    wgt = torch.exp((c_rot * c_rot + r_rot * r_rot) * (-1.0 / (d * d * 0.5)))
    ori_s = torch.rad2deg(torch.atan2(dy, dx)) % 360.0
    mag = torch.sqrt(dx * dx + dy * dy) * wgt * inside
    obin = (ori_s - t(ori)[:, None, None]) * (n / 360.0)
    r0, c0, o0 = torch.floor(rbin), torch.floor(cbin), torch.floor(obin)
    fr, fc, fo = rbin - r0, cbin - c0, obin - o0
    o0 = o0.to(torch.int64) % n
    r0, c0 = r0.to(torch.int64).clamp(-1, d - 1), c0.to(torch.int64).clamp(-1, d - 1)
    hist = torch.zeros((k, (d + 2) * (d + 2) * (n + 2)), dtype=F32, device=dev)
    for dr, wr in ((0, 1 - fr), (1, fr)):
        for dc, wc in ((0, 1 - fc), (1, fc)):
            for do, wo in ((0, 1 - fo), (1, fo)):
                idx = ((r0 + 1 + dr) * (d + 2) + c0 + 1 + dc) * (n + 2) + o0 + do
                hist.scatter_add_(1, idx.reshape(k, -1), (mag * wr * wc * wo).reshape(k, -1))
    hist = hist.reshape(k, d + 2, d + 2, n + 2)[:, 1:d + 1, 1:d + 1]
    cells = hist[..., :n].clone()
    cells[..., 0] += hist[..., n]
    cells[..., 1] += hist[..., n + 1]
    v = cells.reshape(k, -1)
    thr = torch.sqrt((v * v).sum(1, keepdim=True)) * 0.2
    v = torch.minimum(v, thr)
    nrm = 512.0 / torch.sqrt((v * v).sum(1, keepdim=True)).clamp(min=np.finfo(np.float32).eps)
    return torch.round(v * nrm).clamp(0, 255)


# ---------------------------------------------------------------------- GMC


class GMC:
    """Global motion compensation between consecutive frames (the JAX
    package's `GMC`): `apply(frame_bgr)` returns the 2x3 float32 affine map
    from the previous frame to this one, the identity on the first frame
    and on failure. Each frame is taken to gray and shrunk by `downscale`
    (blurred 3x3, sigma 1.5, first for "ecc"); the map's translation is in
    the frame's pixels. The dense work runs on `device` (the card when
    none is given; a machine without one needs device='cpu'); method
    "none" needs no device."""

    METHODS = ("sparseOptFlow", "orb", "sift", "ecc", "none")

    def __init__(self, method: str = "sparseOptFlow", downscale: int = 2,
                 device: Union[str, torch.device, None] = None):
        if method in (None, "None"):
            method = "none"
        if method not in self.METHODS:
            raise ValueError(f"unknown GMC method {method!r}; one of {self.METHODS}")
        self.method = method
        self.downscale = max(1, int(downscale))
        if method != "none" and device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(f"no CUDA device: pass device='cpu' to run GMC {method!r} on the CPU")
            device = "cuda"
        self.device = None if method == "none" else torch.device(device)
        self.prev_gray: Optional[torch.Tensor] = None
        self.prev_pts: Optional[torch.Tensor] = None
        self.prev_kp: Optional[np.ndarray] = None
        self.prev_desc: Optional[torch.Tensor] = None

    def _prep(self, frame_bgr: np.ndarray) -> torch.Tensor:
        img = torch.from_numpy(np.ascontiguousarray(frame_bgr)).to(self.device)
        gray = cvt_bgr2gray(img)
        if self.downscale > 1:
            if self.method == "ecc":
                gray = gaussian_blur_u8(gray, 3, 1.5)
            h, w = gray.shape
            gray = resize_linear(gray, (w // self.downscale, h // self.downscale))
        return gray

    def apply(self, frame_bgr: np.ndarray) -> np.ndarray:
        H = np.eye(2, 3, dtype=np.float32)
        if self.method == "none":
            return H
        gray = self._prep(frame_bgr)
        if self.method == "sparseOptFlow":
            H = self._apply_sparse_flow(gray, H)
        elif self.method == "ecc":
            H = self._apply_ecc(gray, H)
        else:
            H = self._apply_features(gray, H)
        if self.method != "ecc":  # ECC scales its own translation
            H = H.copy()
            H[:, 2] *= self.downscale
        return H

    def _apply_sparse_flow(self, gray: torch.Tensor, H: np.ndarray) -> np.ndarray:
        pts = good_features_to_track(gray)
        if self.prev_gray is not None and self.prev_pts is not None and pts is not None:
            nxt, status = calc_optical_flow_pyr_lk(self.prev_gray, gray, self.prev_pts)
            status = status.cpu().numpy()
            M = self._affine(self.prev_pts.cpu().numpy()[status], nxt.cpu().numpy()[status])
            if M is not None:
                H = M.astype(np.float32)
        self.prev_gray, self.prev_pts = gray, pts
        return H

    @staticmethod
    def _affine(prev_pts: np.ndarray, cur_pts: np.ndarray) -> Optional[np.ndarray]:
        if len(prev_pts) < 4:
            return None
        return estimate_affine_partial_2d(prev_pts, cur_pts)

    def _apply_ecc(self, gray: torch.Tensor, H: np.ndarray) -> np.ndarray:
        if self.prev_gray is not None:
            try:
                M = find_transform_ecc(self.prev_gray, gray, H.copy())
                M[:, 2] *= self.downscale
                H = M
            except ECCError:
                pass  # the identity where cv2 raises, as the JAX package does
        self.prev_gray = gray
        return H

    def _apply_features(self, gray: torch.Tensor, H: np.ndarray) -> np.ndarray:
        """ORB or SIFT keypoints matched to the previous frame's, Lowe's
        0.9 ratio test, a 0.25 (w, h) gate on the shift and a 2.5 sigma cut
        around the mean shift, then the similarity of the survivors."""
        h, w = gray.shape
        mask = torch.zeros((h, w), dtype=torch.bool, device=gray.device)
        mask[int(0.02 * h):int(0.98 * h), int(0.02 * w):int(0.98 * w)] = True
        if self.method == "orb":
            pts = fast_keypoints(gray)
            pts = pts[mask[pts[:, 1], pts[:, 0]]]
            pts, desc = orb_descriptors(gray, pts)
            kp = pts.cpu().numpy().astype(np.float32)
        else:
            det = sift_detect(gray, mask)
            desc = sift_descriptors(gray, det)
            kp = np.stack([det["x"], det["y"]], 1).astype(np.float32)
        if (self.prev_gray is not None and self.prev_desc is not None and len(desc) > 0
                and len(self.prev_desc) > 1):
            idx, dist = knn_match2(self.prev_desc, desc, hamming=self.method == "orb")
            if idx.shape[1] == 2:
                max_sd = 0.25 * np.array([w, h])
                good = dist[:, 0] < 0.9 * dist[:, 1].astype(np.float64)
                p = self.prev_kp[np.nonzero(good)[0]].astype(np.float64)
                q = kp[idx[good, 0]].astype(np.float64)
                sd = p - q
                gate = (np.abs(sd[:, 0]) < max_sd[0]) & (np.abs(sd[:, 1]) < max_sd[1])
                p, q, sd = p[gate], q[gate], sd[gate]
                if len(sd):
                    inl = np.all(np.abs(sd - sd.mean(0)) < 2.5 * (sd.std(0) + 1e-9), axis=1)
                    M = self._affine(p[inl].astype(np.float32), q[inl].astype(np.float32))
                    if M is not None:
                        H = M.astype(np.float32)
        self.prev_gray, self.prev_kp, self.prev_desc = gray, kp, desc
        return H
