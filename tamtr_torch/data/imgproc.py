"""The cv2 image operations of the augmentation pipeline, in numpy.

The JAX package augments with cv2 (`tamtr_tpu/data/augment.py`); the port
has no cv2, so each call is rewritten here to give cv2's uint8 results:

- `resize_linear` = `cv2.resize(..., interpolation=cv2.INTER_LINEAR)`:
  half-pixel centres, no antialias, cv2's fixed point (11-bit coefficients,
  its vector rounding of the vertical pass, unclamped vertical weights at
  the edges). Bitwise cv2's on every shape the tests try. Torch ops, on
  a tensor's device or, for a numpy image, on the CPU (as is
  `resize_linear_f32`).
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
- `resize_linear_f32` = `cv2.resize` INTER_LINEAR of a float32 (H, W) map
  or (H, W, C) image: cv2's float coefficients (no fixed point), each tap
  product and sum rounded to float32. cv2 itself runs float resizes
  through IPP, which rounds up to one ulp apart from this (OpenCV's own
  float path).
- `fill_poly` = `cv2.fillPoly(img, [poly], value)` with 8-connected edges
  and shift 0: OpenCV's edge list (`CollectPolyEdges`,
  `FillEdgeCollection`: 16-bit fixed-point x steps, the polygon's outline
  drawn by its 8-connected line iterator, spans [x1, x2] between pairs of
  active edges). Bitwise cv2's on the tests' polygons.
- `find_external_contours` = `cv2.findContours(mask, cv2.RETR_EXTERNAL,
  cv2.CHAIN_APPROX_SIMPLE)[0]`: Suzuki-Abe border following as OpenCV
  does it (a zero frame around the image; the raster scan with its last
  marked border pixel `lnbd`, which skips components inside another's
  hole; each border traced counterclockwise from its first pixel, the
  right-bound pixels marked; a point kept where the chain code turns; the
  list in reverse order of discovery), and `contour_area` =
  `cv2.contourArea` (the shoelace sum in double). Bitwise cv2's on the
  tests' masks.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

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


def resize_linear(img, dsize: Tuple[int, int]):
    """Bilinear resize of a uint8 (H, W) or (H, W, C) image to dsize = (w, h):
    a numpy array on the host, or a tensor on its own device, given back as
    the same kind."""
    if isinstance(img, np.ndarray):
        return resize_linear(torch.from_numpy(np.require(img, requirements="CW")), dsize).numpy()
    nw, nh = dsize
    h, w = img.shape[:2]
    x0, x1, ax0, ax1 = (torch.from_numpy(a).to(img.device) for a in _linear_taps(nw, w, clamp=True))
    y0, y1, ay0, ay1 = (torch.from_numpy(a).to(img.device) for a in _linear_taps(nh, h, clamp=False))
    col = (1, -1) + (1,) * (img.ndim - 2)
    row = (-1,) + (1,) * (img.ndim - 1)
    src = img.to(torch.int32)
    hx = (src[:, x0] * ax0.reshape(col) + src[:, x1] * ax1.reshape(col)) >> 4
    out = (((ay0.reshape(row) * hx[y0]) >> 16) + ((ay1.reshape(row) * hx[y1]) >> 16) + 2) >> 2
    return out.clamp(0, 255).to(torch.uint8)


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


def _linear_taps_f32(dsz: int, ssz: int, clamp: bool):
    """Source taps and float32 weights of one axis (cv2 `resize` INTER_LINEAR
    of float input): (s0, s1, w0, w1)."""
    f = ((np.arange(dsz) + 0.5) * (1.0 / (dsz / ssz)) - 0.5).astype(_F32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(_F32)
    if clamp:
        f = np.where(s < 0, _F32(0), f)
        s = np.maximum(s, 0)
        hi = s >= ssz - 1
        f = np.where(hi, _F32(0), f)
        s = np.where(hi, ssz - 1, s)
    return np.clip(s, 0, ssz - 1), np.clip(s + 1, 0, ssz - 1), _F32(1) - f, f


def resize_linear_f32(img, dsize: Tuple[int, int]):
    """Bilinear resize of a float32 (H, W) map or (H, W, C) image to dsize = (w, h), as
    `cv2.resize(img, dsize)` computes it for float input: half-pixel
    centres, float32 weights (the horizontal tap clamped at the edges, the
    vertical weights not), the horizontal pass then the vertical one. A
    numpy array on the host, or a tensor on its own device, given back as
    the same kind."""
    if isinstance(img, np.ndarray):
        return resize_linear_f32(torch.from_numpy(np.require(img, _F32, "CW")), dsize).numpy()
    nw, nh = dsize
    h, w = img.shape[:2]
    x0, x1, ax0, ax1 = (torch.from_numpy(np.asarray(a)).to(img.device) for a in _linear_taps_f32(nw, w, True))
    y0, y1, ay0, ay1 = (torch.from_numpy(np.asarray(a)).to(img.device) for a in _linear_taps_f32(nh, h, False))
    src = img.to(torch.float32)
    col = (1, -1) + (1,) * (src.ndim - 2)
    row = (-1,) + (1,) * (src.ndim - 1)
    hx = src[:, x0] * ax0.reshape(col) + src[:, x1] * ax1.reshape(col)
    return hx[y0] * ay0.reshape(row) + hx[y1] * ay1.reshape(row)


_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _tdiv(a: int, b: int) -> int:
    """C's integer division (truncated towards zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's `clipLine` to the (w, h) image: (inside, x1, y1, x2, y2)."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line8(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, value) -> None:
    """OpenCV's 8-connected `Line` (its `LineIterator`, left to right), clipped."""
    h, w = img.shape[:2]
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        ok, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not ok:
            return
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:  # left to right
        dx, dy, x1, y1 = -dx, -dy, x2, y2
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy, sx, sy = dy, dx, sy, sx
    err, plus, minus = dx - (dy + dy), dx + dx, -(dy + dy)
    # each step moves by `sx` along the major axis, and by `sy` along the
    # minor one when err was negative
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = value
        step = err < 0
        err += minus + (plus if step else 0)
        if vert:
            y += sx
            x += sy if step else 0
        else:
            x += sx
            y += sy if step else 0


def fill_poly(img: np.ndarray, poly: np.ndarray, value) -> np.ndarray:
    """`cv2.fillPoly(img, [poly], value)` for an int (n, 2) polygon of (x, y)
    pixels, 8-connected, shift 0: writes `img` in place and returns it."""
    h, w = img.shape[:2]
    pts = [(int(x), int(y)) for x, y in np.asarray(poly).reshape(-1, 2)]
    edges = []  # [y0, y1, x, dx] in 16.16 fixed point
    if pts:
        px, py = pts[-1]
        px <<= _XY_SHIFT
    for qx, qy in pts:
        qx <<= _XY_SHIFT
        t0x, t1x = (px + (_XY_ONE >> 1)) >> _XY_SHIFT, (qx + (_XY_ONE >> 1)) >> _XY_SHIFT
        _line8(img, t0x, py, t1x, qy, value)
        p0x, p0y, p1x, p1y = px, py, qx, qy
        if not (0 <= t0x < w and 0 <= t1x < w and 0 <= py < h and 0 <= qy < h):
            # the clipped end points make a more accurate edge
            _, c0x, c0y, c1x, c1y = _clip_line(w, h, t0x, py, t1x, qy)
            p0x, p1x = c0x << _XY_SHIFT, c1x << _XY_SHIFT
            if c0y != c1y:
                p0y, p1y = c0y, c1y
        if py != qy:
            dx = _tdiv(p1x - p0x, p1y - p0y)
            if py < qy:
                edges.append([py, qy, p0x + (py - p0y) * dx, dx])
            else:
                edges.append([qy, py, p1x + (qy - p1y) * dx, dx])
        px, py = qx, qy
    if len(edges) < 2:
        return img
    ends = [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    y_min, y_max = min(e[0] for e in edges), max(e[1] for e in edges)
    x_min, x_max = min(min(e[2] for e in edges), min(ends)), max(max(e[2] for e in edges), max(ends))
    if y_max < 0 or y_min >= h or x_max < 0 or x_min >= (w << _XY_SHIFT):
        return img
    edges.sort(key=lambda e: (e[0], e[2], e[3]))
    active: list = []  # sorted by x
    i, n = 0, len(edges)
    for y in range(edges[0][0], min(y_max, h)):
        active = [e for e in active if e[1] != y]
        j = 0
        while i < n and edges[i][0] == y:  # a new edge goes before the first active edge of x >= its x,
            e = edges[i]  # after the edges inserted before it
            while j < len(active) and active[j][2] < e[2]:
                j += 1
            active.insert(j, e)
            i, j = i + 1, j + 1
        for a, b in zip(active[0::2], active[1::2]):
            if y >= 0:
                lo, hi = (b[2], a[2]) if a[2] > b[2] else (a[2], b[2])
                x1, x2 = (lo + _XY_ONE - 1) >> _XY_SHIFT, hi >> _XY_SHIFT  # ceil, floor
                if x1 < w and x2 >= 0:
                    img[y, max(x1, 0):min(x2, w - 1) + 1] = value
            a[2] += a[3]
            b[2] += b[3]
        active.sort(key=lambda e: e[2])
    return img


# chain code k -> (dx, dy), and the flat offset of each direction (twice over)
_CODE_DELTAS = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1))
_RIGHT_BOUND = -126  # OpenCV's `nbd | -128` as a signed char, nbd = 2


def _follow_border(img: np.ndarray, i0: int, W: int) -> np.ndarray:
    """The border of the component whose outer border starts at flat index
    i0 of the framed image (`icvFetchContour`, CHAIN_APPROX_SIMPLE):
    counterclockwise, its pixels marked 2 or right-bound; (n, 2) int32
    points in the unframed image's (x, y)."""
    deltas = (1, -W + 1, -W, -W - 1, -1, W - 1, W, W + 1) * 2
    pt = [i0 % W - 1, i0 // W - 1]
    s = s_end = 4
    while True:  # clockwise to the first nonzero neighbour
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if img[i1] != 0 or s == s_end:
            break
    if s == s_end:  # a single pixel
        img[i0] = _RIGHT_BOUND
        return np.asarray([pt], np.int32)
    pts = []
    i3, prev_s = i0, s ^ 4
    while True:
        s_end = s
        while s < 15:  # counterclockwise from the pixel we came from
            s += 1
            i4 = i3 + deltas[s]
            if img[i4] != 0:
                break
        s &= 7
        if 1 <= s <= s_end:  # the search passed the right neighbour, a zero
            img[i3] = _RIGHT_BOUND
        elif img[i3] == 1:
            img[i3] = 2
        if s != prev_s:
            pts.append(list(pt))
            prev_s = s
        pt[0] += _CODE_DELTAS[s][0]
        pt[1] += _CODE_DELTAS[s][1]
        if i4 == i0 and i3 == i1:
            break
        i3 = i4
        s = (s + 4) & 7
    return np.asarray(pts, np.int32)


def find_external_contours(mask: np.ndarray) -> List[np.ndarray]:
    """The outer borders of the nonzero components of a 2-D mask that lie
    in no other component's hole, as (n, 2) int32 (x, y) point arrays:
    `cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)`'s
    contours (each (n, 1, 2) there), in its order."""
    m = np.asarray(mask) != 0
    h, w = m.shape
    W = w + 2
    framed = np.zeros((h + 2, W), np.int16)  # OpenCV's signed chars: 0, 1, 2 and right-bound marks
    framed[1:-1, 1:-1] = m
    img = framed.ravel()
    found = []
    for y in range(1, h + 1):
        base = y * W
        x, prev, lnbd = 1, 0, base  # lnbd: the last marked border pixel the scan passed on this row
        while x <= w:
            step = np.flatnonzero(img[base + x:base + w + 1] != prev)
            if not len(step):
                break
            x += int(step[0])
            p = int(img[base + x])
            is_hole = False
            if not (prev == 0 and p == 1):  # not an outer border's start
                if p != 0 or prev < 1:
                    prev, lnbd, x = p, base + x if p not in (0, 1) else lnbd, x + 1
                    continue
                if prev not in (0, 1):
                    lnbd = base + x - 1
                is_hole = True
            if is_hole or img[lnbd] > 0:  # a hole, or a component inside another: not external
                prev, lnbd, x = p, base + x if p not in (0, 1) else lnbd, x + 1
                continue
            found.append(_follow_border(img, base + x, W))
            prev, x = int(img[base + x]), x + 1
    return found[::-1]


def contour_area(contour: np.ndarray) -> float:
    """`cv2.contourArea(contour)`: the absolute shoelace area, in double."""
    c = np.asarray(contour, np.float64).reshape(-1, 2)
    if len(c) < 3:
        return 0.0
    x, y = c[:, 0], c[:, 1]
    return abs(float(np.sum(np.roll(x, 1) * y - np.roll(y, 1) * x)) * 0.5)


# ---------------------------------------------------------------- on tensors
# The pieces of cv2 that camera-motion compensation (`trackers/gmc.py`)
# calls, as torch ops on the tensor's own device. Where cv2's arithmetic is
# integer the result is bitwise cv2's; the float ones follow cv2's order of
# operations in float32.


def reflect101_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """The source indices of positions -lo .. n - 1 + hi of an axis of
    length n under BORDER_REFLECT_101 (cv2's `borderInterpolate`, also for
    a border longer than the axis)."""
    i = torch.arange(-lo, n + hi, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = i.remainder(period)
    return torch.where(i >= n, period - i, i)


def cvt_bgr2gray(img: torch.Tensor) -> torch.Tensor:
    """`cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)` of a uint8 (H, W, 3) tensor:
    cv2's 15-bit fixed-point weights (3735, 19235, 9798), rounded."""
    c = img.to(torch.int32)
    return ((c[..., 0] * 3735 + c[..., 1] * 19235 + c[..., 2] * 9798 + (1 << 14)) >> 15).to(torch.uint8)


def gaussian_kernel_u8(ksize: int, sigma: float) -> List[int]:
    """cv2's bit-exact 8-bit Gaussian kernel (`getGaussianKernelBitExact`
    with 8 fraction bits): the sampled Gaussian scaled by 256 and rounded
    from the edge inwards with the error carried, the centre taking what
    is left of 256."""
    x = [i - (ksize - 1) / 2 for i in range(ksize)]
    g = [math.exp(-t * t / (2 * sigma * sigma)) for t in x]
    total = sum(g)
    k = [0] * ksize
    err = 0.0
    for i in range(ksize // 2):
        v = g[i] / total * 256 + err
        k[i] = k[ksize - 1 - i] = int(np.rint(v))
        err = v - k[i]
    k[ksize // 2] = 256 - 2 * sum(k[:ksize // 2])
    return k


def gaussian_blur_u8(img: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """`cv2.GaussianBlur(img, (ksize, ksize), sigma)` of a uint8 (H, W)
    tensor, BORDER_REFLECT_101: cv2's fixed-point path (the 8-bit kernel of
    `gaussian_kernel_u8` on both axes, the sum rounded at 16 bits)."""
    k = gaussian_kernel_u8(ksize, sigma)
    r = ksize // 2
    h, w = img.shape
    src = img.to(torch.int32)
    p = src[:, reflect101_index(w, r, r, img.device)]
    hx = sum(k[i] * p[:, i:i + w] for i in range(ksize))
    p = hx[reflect101_index(h, r, r, img.device)]
    v = sum(k[i] * p[i:i + h] for i in range(ksize))
    return ((v + (1 << 15)) >> 16).to(torch.uint8)


def resize_nearest(img: torch.Tensor, dsize: Tuple[int, int]) -> torch.Tensor:
    """`cv2.resize(img, dsize, interpolation=cv2.INTER_NEAREST)` of an
    (H, W) tensor: source index floor(x * src / dst)."""
    nw, nh = dsize
    h, w = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(nw) * (w / nw)).astype(np.int64), w - 1)
    ys = np.minimum(np.floor(np.arange(nh) * (h / nh)).astype(np.int64), h - 1)
    return img[torch.from_numpy(ys).to(img.device)][:, torch.from_numpy(xs).to(img.device)]


def pyr_down_u8(img: torch.Tensor) -> torch.Tensor:
    """`cv2.pyrDown` of a uint8 (H, W) tensor: the 5-tap (1, 4, 6, 4, 1)
    filter on both axes, BORDER_REFLECT_101, every second pixel, the sum
    rounded at 8 bits; ((H + 1) // 2, (W + 1) // 2)."""
    h, w = img.shape
    oh, ow = (h + 1) // 2, (w + 1) // 2
    k = (1, 4, 6, 4, 1)
    p = img.to(torch.int32)[:, reflect101_index(w, 2, 2, img.device)]
    hx = sum(k[i] * p[:, i:i + 2 * ow - 1:2] for i in range(5))
    p = hx[reflect101_index(h, 2, 2, img.device)]
    v = sum(k[i] * p[i:i + 2 * oh - 1:2] for i in range(5))
    return ((v + 128) >> 8).to(torch.uint8)


def scharr_i16(img: torch.Tensor) -> torch.Tensor:
    """The derivatives `cv2.calcOpticalFlowPyrLK` takes of a uint8 (H, W)
    tensor (its `calcSharrDeriv`): (H, W, 2) int16, x then y, each the
    3-tap difference of the (3, 10, 3) smoothing across, BORDER_REFLECT_101."""
    h, w = img.shape
    s = img.to(torch.int32)[reflect101_index(h, 1, 1, img.device)]
    t0 = (s[:-2] + s[2:]) * 3 + s[1:-1] * 10
    t1 = s[2:] - s[:-2]
    xs = reflect101_index(w, 1, 1, img.device)
    t0, t1 = t0[:, xs], t1[:, xs]
    dx = t0[:, 2:] - t0[:, :-2]
    dy = (t1[:, 2:] + t1[:, :-2]) * 3 + t1[:, 1:-1] * 10
    return torch.stack([dx, dy], -1).to(torch.int16)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of float32 tensors rounded once, as a fused multiply-add
    (the product of two float32 is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def sobel_f32(img: torch.Tensor, dx: int, dy: int, scale: float) -> torch.Tensor:
    """`cv2.Sobel(img, cv2.CV_32F, dx, dy, ksize=3, scale=scale)` of a
    uint8 (H, W) tensor, BORDER_REFLECT_101, one of dx, dy 1: the
    difference tap (-1, 0, 1) and the smoothing tap (1, 2, 1) with `scale`
    folded into it, in float32 with cv2's fused multiply-adds on x86 with
    AVX-512 (bitwise cv2's there)."""
    h, w = img.shape
    dev = img.device
    s = torch.tensor(scale, dtype=torch.float32, device=dev)
    s2 = s * 2
    p = img.to(torch.float32)[:, reflect101_index(w, 1, 1, dev)]
    if dx:
        r = (p[:, 2:] - p[:, :-2])[reflect101_index(h, 1, 1, dev)]
        return fma_f32(r[:-2] + r[2:], s, r[1:-1] * s2)
    r = fma_f32(p[:, 2:], s, fma_f32(p[:, 1:-1], s2, p[:, :-2] * s))
    # cv2's row pass runs 32 columns at a time with FMA, the rest without
    tail = (w // 32) * 32
    r[:, tail:] = (p[:, tail:-2] * s + p[:, tail + 1:-1] * s2) + p[:, tail + 2:] * s
    r = r[reflect101_index(h, 1, 1, dev)]
    return r[2:] - r[:-2]


def warp_affine_f32(img: torch.Tensor, M: torch.Tensor, dsize: Tuple[int, int], nearest: bool = False) -> torch.Tensor:
    """`cv2.warpAffine(img, M, dsize, flags=cv2.INTER_LINEAR |
    cv2.WARP_INVERSE_MAP)` of an (H, W) tensor (INTER_NEAREST with
    `nearest`): each output pixel (x, y) samples the input at
    M @ (x, y, 1), computed in float32, taps off the image reading 0
    (BORDER_CONSTANT)."""
    w, h = dsize
    ih, iw = img.shape
    dev = img.device
    M = M.to(dev, torch.float32)
    x = torch.arange(w, device=dev, dtype=torch.float32)[None]
    y = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    sx = M[0, 0] * x + (M[0, 1] * y + M[0, 2])
    sy = M[1, 0] * x + (M[1, 1] * y + M[1, 2])
    pad = torch.zeros((ih + 4, iw + 4), dtype=img.dtype, device=dev)
    pad[2:-2, 2:-2] = img
    if nearest:
        ix = torch.round(sx).clamp(-2, iw + 1).to(torch.int64) + 2
        iy = torch.round(sy).clamp(-2, ih + 1).to(torch.int64) + 2
        return pad[iy, ix]
    fx, fy = torch.floor(sx), torch.floor(sy)
    ax, ay = sx - fx, sy - fy
    # a corner pair off the image reads the two-pixel zero frame
    ix = fx.clamp(-2, iw).to(torch.int64) + 2
    iy = fy.clamp(-2, ih).to(torch.int64) + 2
    p00, p01, p10, p11 = pad[iy, ix], pad[iy, ix + 1], pad[iy + 1, ix], pad[iy + 1, ix + 1]
    v0 = p00 + ax * (p01 - p00)
    v1 = p10 + ax * (p11 - p10)
    return v0 + ay * (v1 - v0)
