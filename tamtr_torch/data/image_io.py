"""Image files without cv2 or PIL: PNG and `.npy` in, PNG out.

`imread` returns what `cv2.imread(path, cv2.IMREAD_COLOR)` returns for the
files it reads: (H, W, 3) uint8 in BGR order (a gray image repeated into
three channels, an alpha channel dropped), or None when the file is missing
or empty. So the dataset and augmentation code stays a line-for-line copy of
the JAX package's, which reads through cv2 (`tamtr_tpu/utils/patches.py`).

PNG: non-interlaced, 8-bit gray, RGB or RGBA. The IDAT stream is inflated
with `zlib`; rows are unfiltered by `csrc/png_unfilter.cpp` (all five
filter types; cv2's writer uses every one), built by the host C++ compiler
on first use. JPEG is not decoded yet: a `.jpg` raises NotImplementedError.
`imwrite_png` writes filter-0 rows, which cv2 reads back bitwise.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # PNG color type -> samples per pixel: gray, RGB, RGBA


def _chunks(data: bytes):
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    p = 8
    while p + 8 <= len(data):
        (n,) = struct.unpack(">I", data[p:p + 4])
        yield data[p + 4:p + 8], data[p + 8:p + 8 + n]
        p += 12 + n


def _ihdr(body: bytes) -> Tuple[int, int, int]:
    """(h, w, samples per pixel) of an IHDR chunk this reader supports."""
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise NotImplementedError(
            f"PNG with bit depth {depth}, color type {ctype}, interlace {interlace}: only "
            "non-interlaced 8-bit gray, RGB and RGBA are decoded")
    return h, w, _CHANNELS[ctype]


def png_shape(path: str | Path) -> Tuple[int, int]:
    """(h, w) of a PNG from its header, without decoding pixels."""
    with open(path, "rb") as f:
        head = f.read(33)
    tag, body = next(_chunks(head))
    if tag != b"IHDR":
        raise ValueError(f"{path}: PNG without a leading IHDR chunk")
    w, h = struct.unpack(">II", body[:8])
    return h, w


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, C) uint8 in the file's channel order (gray, RGB or RGBA)."""
    from tamtr_torch.kernels import _build

    shape, idat = None, []
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            shape = _ihdr(body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if shape is None:
        raise ValueError("PNG without an IHDR chunk")
    h, w, c = shape
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (w * c + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, expected {h * (w * c + 1)}")
    out = np.empty((h, w, c), np.uint8)
    fn = _build.load("png_unfilter").png_unfilter
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    bad = fn(raw, out.ctypes.data, h, w, c)
    if bad:
        raise ValueError(f"PNG row {bad - 1} has an unknown filter type")
    return out


def imread(filename: str | Path) -> Optional[np.ndarray]:
    """(H, W, 3) uint8 BGR, as `cv2.imread(filename, cv2.IMREAD_COLOR)`;
    None when the file is missing or empty."""
    path = Path(filename)
    suffix = path.suffix.lower()
    if suffix in (".jpg", ".jpeg"):
        raise NotImplementedError(f"{path}: no JPEG decoder in tamtr_torch yet (PNG and .npy only)")
    if suffix == ".npy":
        return np.load(path) if path.is_file() else None
    try:
        data = path.read_bytes()
    except OSError:
        return None
    if not data:
        return None
    img = decode_png(data)
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., 2::-1])  # RGB(A) -> BGR


def imwrite_png(filename: str | Path, img: np.ndarray, level: int = 6) -> None:
    """Write (H, W) gray or (H, W, 3) BGR uint8 as an 8-bit PNG (filter 0)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"imwrite_png takes (H, W) or (H, W, 3) uint8, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    rows = img if img.ndim == 2 else img[..., ::-1]  # BGR -> RGB
    raw = np.zeros((h, 1 + rows[0].size), np.uint8)
    raw[:, 1:] = rows.reshape(h, -1)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    ctype = 0 if img.ndim == 2 else 2
    png = (PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + chunk(b"IEND", b""))
    Path(filename).write_bytes(png)
