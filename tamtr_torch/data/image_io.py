"""Image files without cv2 or PIL: PNG, baseline JPEG, 24-bit BMP and
`.npy` in, PNG out.

`imread` returns what `cv2.imread(path, cv2.IMREAD_COLOR)` returns for the
files it reads: (H, W, 3) uint8 in BGR order (a gray image repeated into
three channels, an alpha channel dropped), or None when the file is missing
or empty. So the dataset and augmentation code stays a line-for-line copy of
the JAX package's, which reads through cv2 (`tamtr_tpu/utils/patches.py`).
The format is told by the file's first bytes, as cv2 tells it.

PNG: non-interlaced, 8-bit gray, RGB or RGBA. The IDAT stream is inflated
with `zlib`; rows are unfiltered by `csrc/png_unfilter.cpp` (all five
filter types; cv2's writer uses every one), built by the host C++ compiler
on first use.

JPEG: `csrc/jpeg_decode.cpp`, built the same way, decodes Huffman-coded
sequential 8-bit files (gray or YCbCr, any integral sampling, restart
intervals) bitwise as `cv2.imdecode` does (libjpeg-turbo's defaults: the
accurate integer IDCT, fancy upsampling, fixed-point YCbCr -> RGB); the EXIF
orientation (APP1 tag 0x0112) is applied here, as `cv2.imdecode` applies it.
Progressive, arithmetic-coded, lossless, hierarchical, 12-bit and CMYK files
raise NotImplementedError naming the file and the mode. `jpeg_shape` reads
the frame header and the orientation tag without decoding.

BMP: uncompressed 24-bit (cv2's writer for colour images). WebP and TIFF
raise NotImplementedError. `imwrite_png` writes filter-0 rows, which cv2
reads back bitwise.
"""

from __future__ import annotations

import ctypes
import io
import struct
import zlib
from pathlib import Path
from typing import BinaryIO, Dict, Optional, Tuple

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


# SOFn markers of the modes `decode_jpeg` refuses
_JPEG_MODES = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical progressive",
               0xC7: "hierarchical lossless", 0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
               0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical",
               0xCE: "arithmetic-coded hierarchical progressive", 0xCF: "arithmetic-coded hierarchical lossless"}


def exif_orientation(app1: bytes) -> int:
    """The orientation tag (0x0112) of IFD0 in the body of the first APP1
    segment, read as OpenCV's ExifReader reads it (the 6 bytes of
    "Exif\\0\\0" skipped, the value field's first u16), or 1 without one."""
    tiff = app1[6:]
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    (ifd,) = struct.unpack(e + "I", tiff[4:8])
    if ifd + 2 > len(tiff):
        return 1
    (count,) = struct.unpack(e + "H", tiff[ifd:ifd + 2])
    for k in range(count):
        entry = tiff[ifd + 2 + 12 * k:ifd + 14 + 12 * k]
        if len(entry) < 12:
            break
        if struct.unpack(e + "H", entry[:2])[0] == 0x0112:
            return struct.unpack(e + "H", entry[8:10])[0]
    return 1


def _jpeg_header(f: BinaryIO, name: str) -> Dict[str, int]:
    """Walk a JPEG's marker segments up to its first scan: (h, w) of the
    frame and the EXIF orientation. Raises NotImplementedError naming `name`
    and the mode for files `decode_jpeg` does not take."""
    if f.read(2) != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file")
    info: Dict[str, int] = {"orientation": 1}
    seen_app1 = False
    while True:
        b = f.read(1)
        if not b:
            raise ValueError(f"{name}: JPEG without a scan")
        if b != b"\xff":
            continue
        m = f.read(1)
        while m == b"\xff":
            m = f.read(1)
        if not m:
            raise ValueError(f"{name}: JPEG without a scan")
        marker = m[0]
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:
            raise ValueError(f"{name}: JPEG without a scan")
        (n,) = struct.unpack(">H", f.read(2))
        body = f.read(n - 2)
        if marker == 0xE1 and not seen_app1:
            info["orientation"], seen_app1 = exif_orientation(body), True
        elif marker == 0xCC:
            raise NotImplementedError(f"{name}: arithmetic-coded JPEG is not decoded (baseline Huffman only)")
        elif 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8):
            if marker in _JPEG_MODES:
                raise NotImplementedError(f"{name}: {_JPEG_MODES[marker]} JPEG is not decoded "
                                          "(baseline Huffman only)")
            precision, h, w, nc = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise NotImplementedError(f"{name}: {precision}-bit JPEG is not decoded (8-bit only)")
            if nc not in (1, 3):
                raise NotImplementedError(f"{name}: {'CMYK/YCCK' if nc == 4 else f'{nc}-component'} JPEG is not "
                                          "decoded (gray and YCbCr/RGB only)")
            info.update(h=h, w=w, components=nc)
        elif marker == 0xDA:
            if "h" not in info:
                raise ValueError(f"{name}: JPEG scan before its frame header")
            return info


def _oriented(shape: Tuple[int, int], orientation: int) -> Tuple[int, int]:
    return shape[::-1] if 5 <= orientation <= 8 else shape


def jpeg_shape(path: str | Path) -> Tuple[int, int]:
    """(h, w) of a JPEG as `imread` returns it (EXIF orientation applied),
    from its headers, without decoding pixels."""
    with open(path, "rb") as f:
        info = _jpeg_header(f, str(path))
    return _oriented((info["h"], info["w"]), info["orientation"])


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """`img` as OpenCV's ExifTransform turns it for an EXIF orientation
    (1-8; any other value leaves it as it is)."""
    t = img.transpose(1, 0, 2) if 5 <= orientation <= 8 else img
    flip = {2: (slice(None), slice(None, None, -1)), 3: (slice(None, None, -1),) * 2, 4: (slice(None, None, -1),),
            6: (slice(None), slice(None, None, -1)), 7: (slice(None, None, -1),) * 2, 8: (slice(None, None, -1),)}
    return np.ascontiguousarray(t[flip[orientation]] if orientation in flip else t)


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 BGR, bitwise `cv2.imdecode(data, cv2.IMREAD_COLOR)`
    for the JPEGs this reader takes (see the module docstring); `name`
    names the source in errors."""
    from tamtr_torch.kernels import _build

    info = _jpeg_header(io.BytesIO(data), name)
    h, w = info["h"], info["w"]
    out = np.empty((h, w, 3), np.uint8)
    fn = _build.load("jpeg_decode").jpeg_decode
    fn.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
                   ctypes.c_int]
    fn.restype = ctypes.c_int
    msg = ctypes.create_string_buffer(256)
    rc = fn(data, len(data), out.ctypes.data, h, w, msg, len(msg))
    if rc == 2:
        raise NotImplementedError(f"{name}: {msg.value.decode()} JPEG is not decoded")
    if rc:
        raise ValueError(f"{name}: {msg.value.decode()}")
    return apply_orientation(out, info["orientation"])


def decode_bmp(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 BGR of an uncompressed 24-bit BMP, as cv2 reads it
    (rows bottom-up unless the height is negative, each padded to 4 bytes)."""
    offset, = struct.unpack("<I", data[10:14])
    w, h, planes, bpp, compression = struct.unpack("<iiHHI", data[18:34])
    if bpp != 24 or compression != 0:
        raise NotImplementedError(f"{name}: {bpp}-bit BMP with compression {compression} is not decoded "
                                  "(uncompressed 24-bit only)")
    stride = (w * 3 + 3) // 4 * 4
    rows = np.frombuffer(data, np.uint8, stride * abs(h), offset).reshape(abs(h), stride)[:, :w * 3]
    img = rows.reshape(abs(h), w, 3)
    return np.ascontiguousarray(img[::-1] if h > 0 else img)


def imread(filename: str | Path) -> Optional[np.ndarray]:
    """(H, W, 3) uint8 BGR, as `cv2.imread(filename, cv2.IMREAD_COLOR)`;
    None when the file is missing or empty."""
    path = Path(filename)
    suffix = path.suffix.lower()
    if suffix == ".npy":
        return np.load(path) if path.is_file() else None
    try:
        data = path.read_bytes()
    except OSError:
        return None
    if not data:
        return None
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data, str(path))
    if data[:2] == b"BM":
        return decode_bmp(data, str(path))
    if data[:8] != PNG_SIGNATURE:
        raise NotImplementedError(f"{path}: only PNG, baseline JPEG, 24-bit BMP and .npy are decoded "
                                  f"(not WebP, TIFF or other formats)")
    img = decode_png(data)
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., 2::-1])  # RGB(A) -> BGR


def image_shape(path: str | Path) -> Tuple[int, int]:
    """(h, w) of an image file as `imread` returns it, from its headers
    where the format has them (PNG, JPEG), else by decoding."""
    suffix = Path(path).suffix.lower()
    if suffix == ".png":
        return png_shape(path)
    if suffix in (".jpg", ".jpeg"):
        return jpeg_shape(path)
    img = imread(path)
    if img is None:
        raise FileNotFoundError(f"cannot read image {path}")
    return img.shape[:2]


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
