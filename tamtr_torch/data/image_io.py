"""Image files without cv2 or PIL: PNG, JPEG (baseline and progressive), BMP,
TIFF, WebP and `.npy` in; JPEG, PNG, BMP, TIFF and lossless WebP out.

`imread` returns what `cv2.imread(path, cv2.IMREAD_COLOR)` returns for the
files it reads: (H, W, 3) uint8 in BGR order (a gray image repeated into
three channels, an alpha channel dropped), or None when the file is missing
or empty. So the dataset and augmentation code stays a line-for-line copy of
the JAX package's, which reads through cv2 (`tamtr_tpu/utils/patches.py`).
The format is told by the file's first bytes, as cv2 tells it.

PNG: every standard mode, as cv2 reads it through libpng: gray at 1, 2,
4, 8 and 16 bits (the low depths scaled to 8 bits), gray + alpha, RGB,
RGBA, palette (PLTE expanded, tRNS dropped), 16-bit samples cut to their
high byte, alpha dropped, Adam7 interlace. The IDAT stream is inflated
with `zlib`; rows are unfiltered by `csrc/png_unfilter.cpp` (all five
filter types), built by the host C++ compiler on first use.

JPEG: `csrc/jpeg_decode.cpp`, built the same way, decodes Huffman-coded
sequential and progressive 8-bit files (gray or YCbCr, any integral
sampling, restart intervals) bitwise as `cv2.imdecode` does (libjpeg-turbo's
defaults: the accurate integer IDCT, fancy upsampling, fixed-point YCbCr ->
RGB); the EXIF orientation (APP1 tag 0x0112) is applied here, as
`cv2.imdecode` applies it. Arithmetic-coded, lossless, hierarchical, 12-bit
and CMYK files, and a progressive file whose scans leave coefficient bits
missing (libjpeg smooths those blocks), raise NotImplementedError naming
the file and the mode. `jpeg_shape` reads the frame header and the
orientation tag without decoding.

BMP: what OpenCV's BMP reader takes from a BITMAPINFOHEADER or later:
1, 4 and 8-bit palette, 16-bit 555 and 565, 24-bit, 32-bit (alpha
dropped), RLE4 and RLE8, bottom-up and top-down rows, each transcribed from
OpenCV (`grfmt_bmp.cpp`) and held bitwise to it.

TIFF (`decode_tiff`): the first page as libtiff's RGBA interface gives it
to cv2: strips or tiles, chunky or planar, either byte order, no
compression, LZW, Deflate or PackBits (`csrc/tiff_decode.cpp` for LZW and
PackBits, `zlib` for Deflate) with the horizontal predictor, gray,
bilevel, RGB(A) and palette at 1-16 bits, 16 bits cut to 8 as libtiff
cuts them, the Orientation tag applied. WebP (`decode_webp`): the lossy
VP8 and lossless VP8L decoders of `csrc/webp_decode.cpp`, bitwise
libwebp's `WebPDecodeBGR`. Both built like the JPEG decoder; other TIFF
compressions, CMYK, YCbCr and float samples, and animated WebP, raise
NotImplementedError naming the file and the mode.

Out: `imencode(ext, img)` / `imwrite(path, img)` choose the format by the
suffix, as cv2 does. `.jpg`, `.jpeg` and `.jpe` go to `encode_jpeg`
(`csrc/jpeg_encode.cpp`), whose bytes equal `cv2.imencode`'s at any
quality; `.bmp` to `encode_bmp`, byte-equal to cv2's; `.png` to
`encode_png`, filter-0 rows that cv2 reads back bitwise (its
bytes are not cv2's); `.tif` and `.tiff` to `encode_tiff` (LZW strips coded
by `csrc/tiff_encode.cpp`), byte-equal to cv2's; `.webp` to `encode_webp`
(`csrc/webp_encode.cpp`), lossless VP8L as cv2 writes by default, which
cv2 and `decode_webp` read back exactly (its bytes are not cv2's). cv2's
lossy WebP (a quality of 100 or below) is not ported and raises
NotImplementedError naming the file.
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
# PNG color type -> samples per pixel, and the bit depths the type allows
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunks(data: bytes):
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    p = 8
    while p + 8 <= len(data):
        (n,) = struct.unpack(">I", data[p:p + 4])
        yield data[p + 4:p + 8], data[p + 8:p + 8 + n]
        p += 12 + n


def _ihdr(body: bytes) -> Tuple[int, int, int, int, int]:
    """(h, w, bit depth, color type, interlace) of a valid IHDR chunk."""
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body[:13])
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype] or interlace > 1 or not w or not h:
        raise ValueError(f"PNG with bit depth {depth}, color type {ctype}, interlace {interlace}, size {w}x{h}: "
                         "not a valid PNG header")
    return h, w, depth, ctype, interlace


def png_shape(path: str | Path) -> Tuple[int, int]:
    """(h, w) of a PNG from its header, without decoding pixels."""
    with open(path, "rb") as f:
        head = f.read(33)
    tag, body = next(_chunks(head))
    if tag != b"IHDR":
        raise ValueError(f"{path}: PNG without a leading IHDR chunk")
    w, h = struct.unpack(">II", body[:8])
    return h, w


def _png_samples(raw: memoryview, h: int, w: int, depth: int, c: int) -> np.ndarray:
    """(h, w, c) samples of h filtered rows of w pixels at `depth` bits:
    uint8, the 16-bit ones cut to their high byte (libpng's strip_16)."""
    from tamtr_torch.kernels import _build

    stride = (w * c * depth + 7) // 8
    if len(raw) < h * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, expected {h * (stride + 1)}")
    rows = np.empty((h, stride), np.uint8)
    fn = _build.load("png_unfilter").png_unfilter
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_int]
    fn.restype = ctypes.c_int
    bad = fn(bytes(raw[:h * (stride + 1)]), rows.ctypes.data, h, stride, max(1, c * depth // 8))
    if bad:
        raise ValueError(f"PNG row {bad - 1} has an unknown filter type")
    if depth == 16:
        return np.ascontiguousarray(rows.reshape(h, w, c, 2)[..., 0])
    if depth == 8:
        return rows.reshape(h, w, c)
    bits = np.unpackbits(rows, axis=1)[:, :w * c * depth].reshape(h, w * c, depth)
    vals = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(-1, dtype=np.uint8)
    return vals.reshape(h, w, c)


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 BGR, bitwise `cv2.imdecode(data, cv2.IMREAD_COLOR)`
    (libpng with OpenCV's transforms: palette and gray expanded, 16 bits cut
    to 8, alpha and tRNS dropped)."""
    header, palette, idat = None, None, []
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            header = _ihdr(body)
        elif tag == b"PLTE":
            palette = np.zeros((256, 3), np.uint8)
            n = min(len(body) // 3, 256)
            palette[:n] = np.frombuffer(body, np.uint8, 3 * n).reshape(n, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    h, w, depth, ctype, interlace = header
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    c = _CHANNELS[ctype]
    raw = memoryview(zlib.decompress(b"".join(idat)))
    if not interlace:
        px = _png_samples(raw, h, w, depth, c)
    else:
        px = np.empty((h, w, c), np.uint8)
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue  # an empty pass has no rows, not even filter bytes
            px[y0::dy, x0::dx] = _png_samples(raw, ph, pw, depth, c)
            raw = raw[ph * ((pw * c * depth + 7) // 8 + 1):]
    if ctype == 3:
        return np.ascontiguousarray(palette[px[..., 0]][..., ::-1])
    if ctype in (0, 4):
        gray = px[..., 0]
        if depth < 8:  # png_set_expand_gray_1_2_4_to_8: 1 -> 255, 2 -> 85, 4 -> 17 per step
            gray = gray * np.uint8(255 // ((1 << depth) - 1))
        return np.repeat(gray[..., None], 3, axis=2)
    return np.ascontiguousarray(px[..., 2::-1])  # RGB(A) -> BGR


# SOFn markers of the modes `decode_jpeg` refuses
_JPEG_MODES = {0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical progressive",
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
            raise NotImplementedError(f"{name}: arithmetic-coded JPEG is not decoded (Huffman-coded only)")
        elif 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8):
            if marker in _JPEG_MODES:
                raise NotImplementedError(f"{name}: {_JPEG_MODES[marker]} JPEG is not decoded "
                                          "(Huffman-coded baseline and progressive only)")
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


def _bmp_fill(out: np.ndarray, pos: int, line_end: int, y: int, count: int, w: int, h: int,
              colour: np.ndarray) -> Tuple[int, int, int]:
    """OpenCV's `FillUniColor` over the flat (h * w, 3) rows in decode order:
    `count` pixels of `colour` from `pos`, wrapping to the next row at each
    row end (at least one wrap check, even for count 0)."""
    while True:
        end = min(pos + count, line_end)
        count -= end - pos
        out[pos:end] = colour
        pos = end
        if pos >= line_end:
            line_end += w
            pos = line_end - w
            y += 1
            if y >= h:
                break
        if count <= 0:
            break
    return pos, line_end, y


def _bmp_rle(data: bytes, at: int, w: int, h: int, palette: np.ndarray, four: bool) -> np.ndarray:
    """(h * w, 3) BGR rows in decode order of an RLE8 or RLE4 stream, as
    OpenCV's `BmpDecoder::readData` decodes it: skipped pixels (end of line,
    delta, end of bitmap) take palette entry 0, an RLE4 delta moves along
    the row only, a run past its row's end stops the decode."""
    out = np.zeros((h * w, 3), np.uint8)
    pos, line_end, y, ended_row = 0, w, 0, 0
    n = len(data)
    while at + 2 <= n:
        count, code = data[at], data[at + 1]
        at += 2
        if count:  # encoded mode: a run of one index (RLE4: two alternating)
            if pos + count > line_end:
                break
            if four:
                out[pos:pos + count:2] = palette[code >> 4]
                out[pos + 1:pos + count:2] = palette[code & 15]
                pos += count
            else:
                prev_y = y
                pos, line_end, y = _bmp_fill(out, pos, line_end, y, count, w, h, palette[code])
                ended_row = y - prev_y
                if y >= h:
                    break
        elif code > 2:  # absolute mode: `code` indices, padded to a word
            if pos + code > line_end:
                break
            if four:
                size = (((code + 1) >> 1) + 1) & ~1
                packed = np.frombuffer(data, np.uint8, min(size, n - at), at)
                idx = np.stack([packed >> 4, packed & 15], 1).reshape(-1)[:code]
            else:
                size = (code + 1) & ~1
                idx = np.frombuffer(data, np.uint8, min(code, n - at), at)
            if len(idx) < code:
                break
            out[pos:pos + code] = palette[idx]
            pos += code
            at += size
            ended_row = 0
        elif four:  # end of line, end of bitmap (rest of the row), delta (dx only)
            shift = line_end - pos
            if code == 2:
                shift = data[at] if at < n else 0
                at += 2
            pos, line_end, y = _bmp_fill(out, pos, line_end, y, shift, w, h, palette[0])
            if y >= h:
                break
        else:  # end of line (none right after a run that ended the row), end of bitmap, delta
            shift, rows = line_end - pos, h - y
            if code or not ended_row or shift < w:
                if code == 2:
                    shift, rows = (data[at], data[at + 1]) if at + 1 < n else (0, 0)
                    at += 2
                if code:
                    shift += rows * w
                pos, line_end, y = _bmp_fill(out, pos, line_end, y, shift, w, h, palette[0])
                if y >= h:
                    break
            ended_row = 0
    return out


def decode_bmp(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 BGR, bitwise `cv2.imdecode(data, cv2.IMREAD_COLOR)`,
    for a BMP with a BITMAPINFOHEADER or a later header: 1, 4 or 8-bit
    palette, 16-bit (555, or 565 by its bit fields; each field shifted to the
    top of its byte, as OpenCV widens it), 24-bit, 32-bit (the fourth byte
    dropped, any bit fields ignored), RLE8 and RLE4; rows bottom-up unless
    the height is negative, each padded to 4 bytes. The bit fields and the
    palette are read after the header, where OpenCV reads them."""
    if len(data) < 54:
        raise ValueError(f"{name}: BMP shorter than its headers")
    offset, size = struct.unpack("<II", data[10:18])
    if size < 36:
        raise NotImplementedError(f"{name}: BMP with a {size}-byte (OS/2) header is not decoded")
    w, h, _, bpp, comp = struct.unpack("<iiHHI", data[18:34])
    (colours,) = struct.unpack("<I", data[46:50])
    at = 14 + size
    ok = w > 0 and h != 0 and (
        (bpp in (1, 4, 8, 24, 32) and comp == 0) or (bpp in (16, 32) and comp in (0, 3))
        or (bpp == 4 and comp == 2) or (bpp == 8 and comp == 1))
    if not ok:
        raise NotImplementedError(f"{name}: {bpp}-bit BMP with compression {comp} is not decoded")
    palette = np.zeros((256, 3), np.uint8)
    if bpp <= 8:
        if colours > 256:
            raise ValueError(f"{name}: BMP palette of {colours} colours")
        k = colours or 1 << bpp
        entries = np.frombuffer(data, np.uint8, 4 * k, at).reshape(k, 4)
        palette[:k] = entries[:, :3]
    elif bpp == 16:
        if comp == 3:
            red, green, blue = struct.unpack("<III", data[at:at + 12])
            if (red, green, blue) == (0x7C00, 0x3E0, 0x1F):
                bpp = 15
            elif (red, green, blue) != (0xF800, 0x7E0, 0x1F):
                raise NotImplementedError(f"{name}: 16-bit BMP with bit fields {red:#x}, {green:#x}, {blue:#x} "
                                          "is not decoded (555 and 565 only)")
        else:
            bpp = 15
    ah = abs(h)
    if comp in (1, 2):
        img = _bmp_rle(data, offset, w, ah, palette, four=comp == 2).reshape(ah, w, 3)
    else:
        pitch = ((w * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & -4
        rows = np.frombuffer(data, np.uint8, pitch * ah, offset).reshape(ah, pitch)
        if bpp == 1:
            img = palette[np.unpackbits(rows, axis=1)[:, :w]]
        elif bpp == 4:
            img = palette[np.stack([rows >> 4, rows & 15], 2).reshape(ah, -1)[:, :w]]
        elif bpp == 8:
            img = palette[rows[:, :w]]
        elif bpp in (15, 16):
            t = rows[:, :2 * w].copy().view("<u2").astype(np.int32)
            if bpp == 15:  # icvCvt_BGR5552BGR_8u_C2C3R
                img = np.stack([t << 3, (t >> 2) & ~7, (t >> 7) & ~7], -1) & 0xFF
            else:  # icvCvt_BGR5652BGR_8u_C2C3R
                img = np.stack([t << 3, (t >> 3) & ~3, (t >> 8) & ~7], -1) & 0xFF
            img = img.astype(np.uint8)
        else:
            img = rows[:, :w * bpp // 8].reshape(ah, w, bpp // 8)[..., :3]
    return np.ascontiguousarray(img[::-1] if h > 0 else img)


# ---------------------------------------------------------------------- TIFF

_TIFF_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i", 16: "Q"}
_TIFF_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 16: 8}
_TIFF_CODECS = {1: "none", 5: "LZW", 8: "Deflate", 32946: "Deflate", 32773: "PackBits"}


def _tiff_ifd(data: bytes, name: str) -> Tuple[str, Dict[int, Tuple[int, ...]]]:
    """The byte order and the first IFD's integer tags of a TIFF file."""
    if data[:4] not in (b"II*\0", b"MM\0*"):
        if data[:2] in (b"II", b"MM") and data[2:4] in (b"+\0", b"\0+"):
            raise NotImplementedError(f"{name}: BigTIFF is not decoded")
        raise ValueError(f"{name}: not a TIFF file")
    bo = "<" if data[:2] == b"II" else ">"
    (at,) = struct.unpack_from(bo + "I", data, 4)
    (n,) = struct.unpack_from(bo + "H", data, at)
    tags: Dict[int, Tuple[int, ...]] = {}
    for i in range(n):
        tag, typ, count, value = struct.unpack_from(bo + "HHI4s", data, at + 2 + 12 * i)
        if typ not in _TIFF_TYPES:
            continue
        size = _TIFF_SIZES[typ] * count
        raw = value if size <= 4 else data[struct.unpack(bo + "I", value)[0]:][:size]
        tags[tag] = struct.unpack(bo + _TIFF_TYPES[typ] * count, raw[:size])
    return bo, tags


def tiff_shape(path: str | Path) -> Tuple[int, int]:
    """(h, w) of a TIFF file's first page as `imread` returns it, from its IFD."""
    with open(path, "rb") as f:
        data = f.read(1 << 16)
    try:
        _, tags = _tiff_ifd(data, str(path))
    except struct.error:  # the IFD lies past the first 64 KiB
        _, tags = _tiff_ifd(Path(path).read_bytes(), str(path))
    return _oriented((tags[257][0], tags[256][0]), tags.get(274, (1,))[0])


def _tiff_chunk(data: bytes, comp: int, size: int, name: str) -> bytes:
    """One strip's or tile's bytes, decompressed to at most `size`."""
    if comp == 1:
        return data[:size]
    if comp in (8, 32946):
        return zlib.decompressobj().decompress(data, size)
    from tamtr_torch.kernels import _build

    fn = getattr(_build.load("tiff_decode"), "tiff_lzw_decode" if comp == 5 else "tiff_packbits_decode")
    fn.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long]
    fn.restype = ctypes.c_long
    out = np.zeros(size, np.uint8)
    n = fn(data, len(data), out.ctypes.data, size)
    if n < 0:
        raise ValueError(f"{name}: corrupt {_TIFF_CODECS[comp]} data")
    return out.tobytes()


def decode_tiff(data: bytes, name: str = "<bytes>") -> Optional[np.ndarray]:
    """(H, W, 3) uint8 BGR of a TIFF file's first page, as cv2.imread reads
    it through libtiff's RGBA interface: strips or tiles, chunky or planar
    samples, either byte order; no compression, LZW, Deflate (8 and 32946)
    or PackBits, with or without the horizontal predictor; gray (MinIsBlack
    or MinIsWhite) at 1, 2, 4, 8 or 16 bits, RGB at 8 or 16 bits, a palette
    of 1-8 bits (16-bit entries cut to their high byte unless all are under
    256). 16-bit RGB becomes (v + 128) // 257, 16-bit gray its high byte;
    an unassociated alpha premultiplies the colour ((c a + 127) // 255),
    any other alpha is dropped. The Orientation tag is applied as
    cv2.imdecode applies it (`apply_orientation`). Other compressions, photometric
    interpretations (CMYK, YCbCr, ...) and sample formats (float, signed)
    raise NotImplementedError naming the file and the mode."""
    bo, t = _tiff_ifd(data, name)
    w, h = t[256][0], t[257][0]
    spp = t.get(277, (1,))[0]
    bits = t.get(258, (1,))
    comp = t.get(259, (1,))[0]
    photo = t.get(262, (None,))[0]
    planar = t.get(284, (1,))[0]
    pred = t.get(317, (1,))[0]
    orient = t.get(274, (1,))[0]
    if comp not in _TIFF_CODECS:
        raise NotImplementedError(f"{name}: TIFF compression {comp} is not decoded "
                                  f"(none, LZW, Deflate and PackBits only)")
    if photo not in (0, 1, 2, 3):
        raise NotImplementedError(f"{name}: TIFF photometric interpretation {photo} is not decoded "
                                  f"(gray, RGB and palette only)")
    if any(f != 1 for f in t.get(339, (1,))):
        raise NotImplementedError(f"{name}: TIFF sample format {t[339][0]} is not decoded (unsigned integers only)")
    bps = bits[0]
    if any(b != bps for b in bits) or bps not in (1, 2, 4, 8, 16) or (bps == 16 and photo == 3) \
            or (bps < 8 and photo == 2):
        raise NotImplementedError(f"{name}: TIFF with {bits} bits per sample is not decoded")
    if pred not in (1, 2):
        raise NotImplementedError(f"{name}: TIFF predictor {pred} is not decoded")
    tiled = 322 in t
    cw, ch = (t[322][0], t[323][0]) if tiled else (w, min(t.get(278, (h,))[0], h))
    offsets, counts = (t[324], t[325]) if tiled else (t[273], t[279])
    nplanes = spp if planar == 2 else 1
    cs = 1 if planar == 2 else spp  # samples in a chunk's pixel
    row_bytes = (cw * cs * bps + 7) // 8
    dt = np.dtype(bo + "u2") if bps == 16 else np.dtype(np.uint8)
    across, down = -(-w // cw), -(-h // ch)
    img = np.zeros((h, w, spp), np.uint16 if bps == 16 else np.uint8)
    for k, (off, cnt) in enumerate(zip(offsets, counts)):
        plane, rest = divmod(k, across * down)
        if plane >= nplanes:
            break
        cy, cx = divmod(rest, across) if tiled else (rest, 0)
        y0, x0 = cy * ch, cx * cw
        rows = ch if tiled else min(ch, h - y0)
        raw = _tiff_chunk(data[off:off + cnt], comp, row_bytes * rows, name)
        raw = raw.ljust(row_bytes * rows, b"\0")
        if bps < 8:
            px = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(rows, row_bytes), axis=1)
            px = px.reshape(rows, -1, bps)
            px = (px * (1 << np.arange(bps - 1, -1, -1, dtype=np.uint8))).sum(2, dtype=np.uint8)
            px = px[:, :cw * cs].reshape(rows, cw, cs)
        else:
            px = np.frombuffer(raw, dt).reshape(rows, cw, cs).astype(img.dtype)
        if pred == 2:
            px = np.cumsum(px, axis=1, dtype=img.dtype)
        hh, ww = min(rows, h - y0), min(cw, w - x0)
        sl = slice(plane, plane + 1) if planar == 2 else slice(0, spp)
        img[y0:y0 + hh, x0:x0 + ww, sl] = px[:hh, :ww]
    extra = t.get(338, ())
    if photo in (0, 1):
        g = img[..., 0].astype(np.int32)
        if bps == 16:
            g = g >> 8
        elif bps < 8:
            g = g * 255 // ((1 << bps) - 1)
        if photo == 0:
            g = 255 - g
        rgb = np.repeat(g.astype(np.uint8)[..., None], 3, 2)
    elif photo == 3:
        cmap = np.asarray(t[320], np.int64).reshape(3, 1 << bps).T
        if (cmap >= 256).any():
            cmap = cmap >> 8
        rgb = cmap.astype(np.uint8)[img[..., 0]]
    else:
        c = img[..., :3].astype(np.int32)
        a = img[..., 3].astype(np.int32) if spp > 3 else None
        if bps == 16:
            c = (c + 128) // 257
            a = None if a is None else (a + 128) // 257
        if a is not None and extra and extra[0] == 2:
            c = (c * a[..., None] + 127) // 255
        rgb = c.astype(np.uint8)
    return np.ascontiguousarray(apply_orientation(rgb[..., ::-1], orient))


# ---------------------------------------------------------------------- WebP

def _webp_chunks(data: bytes, name: str):
    """(fourcc, payload) of each chunk of a RIFF WebP file."""
    if data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError(f"{name}: not a WebP file")
    end = min(len(data), 8 + struct.unpack_from("<I", data, 4)[0])
    at = 12
    while at + 8 <= end:
        tag, size = data[at:at + 4], struct.unpack_from("<I", data, at + 4)[0]
        yield tag, data[at + 8:at + 8 + size]
        at += 8 + size + (size & 1)


def _webp_image(data: bytes, name: str) -> Tuple[bytes, bytes, int]:
    """The fourcc and payload of a still WebP's image chunk (VP8 or VP8L),
    and the EXIF orientation cv2 applies (1 without one); an animation
    raises NotImplementedError."""
    image, exif_flag, orientation = None, False, 1
    for tag, body in _webp_chunks(data, name):
        if tag == b"VP8X":
            if body[0] & 0x02:
                raise NotImplementedError(f"{name}: animated WebP is not decoded")
            exif_flag = bool(body[0] & 0x08)
        elif tag in (b"ANIM", b"ANMF"):
            raise NotImplementedError(f"{name}: animated WebP is not decoded")
        elif tag in (b"VP8 ", b"VP8L") and image is None:
            image = (tag, body)
        elif tag == b"EXIF" and exif_flag and body[:4] in (b"II*\0", b"MM\0*"):
            # cv2 reads a bare TIFF header here (not one behind "Exif\0\0")
            orientation = exif_orientation(bytes(6) + body)
    if image is None:
        raise ValueError(f"{name}: WebP file without an image chunk")
    return image[0], image[1], orientation


def _webp_size(tag: bytes, body: bytes, name: str) -> Tuple[int, int]:
    """(h, w) from a VP8 frame header or a VP8L header."""
    if tag == b"VP8 ":
        if len(body) < 10 or body[3:6] != b"\x9d\x01\x2a":
            raise ValueError(f"{name}: bad VP8 frame header")
        return (struct.unpack_from("<H", body, 8)[0] & 0x3FFF, struct.unpack_from("<H", body, 6)[0] & 0x3FFF)
    if len(body) < 5 or body[0] != 0x2F:
        raise ValueError(f"{name}: bad VP8L header")
    (bits,) = struct.unpack_from("<I", body, 1)
    return ((bits >> 14) & 0x3FFF) + 1, (bits & 0x3FFF) + 1


def webp_shape(path: str | Path) -> Tuple[int, int]:
    """(h, w) of a WebP file as `imread` returns it, from its image chunk's
    header and its EXIF orientation."""
    with open(path, "rb") as f:
        data = f.read(1 << 16)
    tag, body, orientation = _webp_image(Path(path).read_bytes() if len(data) == 1 << 16 else data, str(path))
    return _oriented(_webp_size(tag, body, str(path)), orientation)


def decode_webp(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 BGR of a still WebP file, bitwise what cv2.imread
    gives (libwebp's `WebPDecodeBGR`): lossy VP8 (fancy upsampling) or
    lossless VP8L, simple or extended (VP8X) container; an ALPH chunk, and
    a lossless image's alpha, are dropped as IMREAD_COLOR drops them; the
    ICC profile is not applied (nor by cv2); an EXIF orientation is, where
    cv2 applies it (the VP8X EXIF flag set, the chunk a bare TIFF header).
    `csrc/webp_decode.cpp` decodes the image chunk. An animation raises
    NotImplementedError."""
    from tamtr_torch.kernels import _build

    tag, body, orientation = _webp_image(data, name)
    h, w = _webp_size(tag, body, name)
    lib = _build.load("webp_decode")
    fn = lib.webp_vp8_decode if tag == b"VP8 " else lib.webp_vp8l_decode
    fn.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = np.empty((h, w, 3), np.uint8)
    rc = fn(body, len(body), w, h, out.ctypes.data)
    if rc != 0:
        raise ValueError(f"{name}: corrupt {tag.decode().strip()} data (code {rc})")
    return apply_orientation(out, orientation)


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
    if data[:4] in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+"):
        return decode_tiff(data, str(path))
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return decode_webp(data, str(path))
    if data[:8] != PNG_SIGNATURE:
        raise NotImplementedError(f"{path}: only PNG, JPEG, BMP, TIFF, WebP and .npy are decoded")
    return decode_png(data)


def image_shape(path: str | Path) -> Tuple[int, int]:
    """(h, w) of an image file as `imread` returns it, from its headers
    where the format has them (PNG, JPEG, TIFF, WebP), else by decoding."""
    suffix = Path(path).suffix.lower()
    if suffix == ".png":
        return png_shape(path)
    if suffix in (".jpg", ".jpeg"):
        return jpeg_shape(path)
    if suffix in (".tif", ".tiff"):
        return tiff_shape(path)
    if suffix == ".webp":
        return webp_shape(path)
    img = imread(path)
    if img is None:
        raise FileNotFoundError(f"cannot read image {path}")
    return img.shape[:2]


def _image_u8(img: np.ndarray, what: str) -> np.ndarray:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3) \
            or not img.shape[0] or not img.shape[1]:
        raise ValueError(f"{what} takes (H, W) or (H, W, 3) uint8, got {img.shape} {img.dtype}")
    return img


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W) gray or (H, W, 3) BGR uint8 as an 8-bit PNG (filter-0 rows)."""
    img = _image_u8(img, "encode_png")
    h, w = img.shape[:2]
    rows = img if img.ndim == 2 else img[..., ::-1]  # BGR -> RGB
    raw = np.zeros((h, 1 + rows[0].size), np.uint8)
    raw[:, 1:] = rows.reshape(h, -1)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    ctype = 0 if img.ndim == 2 else 2
    return (PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + chunk(b"IEND", b""))


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """(H, W) gray or (H, W, 3) BGR uint8 as a baseline JPEG: the bytes of
    `cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])` (4:2:0
    for colour, one component for gray; `csrc/jpeg_encode.cpp`)."""
    from tamtr_torch.kernels import _build

    img = _image_u8(img, "encode_jpeg")
    if img.shape[0] > 65535 or img.shape[1] > 65535:
        raise ValueError(f"encode_jpeg: {img.shape[:2]} is larger than JPEG's 65535 x 65535")
    fn = _build.load("jpeg_encode").jpeg_encode
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_long]
    fn.restype = ctypes.c_long
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else 3
    out = np.empty(img.size // 2 + 2048, np.uint8)
    n = fn(img.ctypes.data, h, w, c, int(quality), out.ctypes.data, out.size)
    if n > out.size:
        out = np.empty(n, np.uint8)
        n = fn(img.ctypes.data, h, w, c, int(quality), out.ctypes.data, out.size)
    if n < 0:
        raise ValueError(f"encode_jpeg: bad image {img.shape}")
    return out[:n].tobytes()


def encode_bmp(img: np.ndarray) -> bytes:
    """(H, W) gray or (H, W, 3) BGR uint8 as OpenCV's BMP writer writes it:
    a 40-byte header, 8 bits with a gray palette or 24 bits, rows bottom-up
    padded to 4 bytes."""
    img = _image_u8(img, "encode_bmp")
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else 3
    step = (w * c + 3) & -4
    head = 14 + 40 + (1024 if c == 1 else 0)
    out = bytearray(b"BM" + struct.pack("<III", step * h + head, 0, head))
    out += struct.pack("<IiiHHIIIIII", 40, w, h, 1, 8 * c, 0, 0, 0, 0, 0, 0)
    if c == 1:  # FillGrayPalette: (i, i, i, 0)
        palette = np.zeros((256, 4), np.uint8)
        palette[:, :3] = np.arange(256, dtype=np.uint8)[:, None]
        out += palette.tobytes()
    rows = np.zeros((h, step), np.uint8)
    rows[:, :w * c] = img.reshape(h, w * c)
    return bytes(out) + rows[::-1].tobytes()


def _tiff_lzw(data: bytes) -> bytes:
    """One strip coded by `csrc/tiff_encode.cpp` (libtiff's LZW stream)."""
    from tamtr_torch.kernels import _build

    fn = _build.load("tiff_encode").tiff_lzw_encode
    fn.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long]
    fn.restype = ctypes.c_long
    out = np.empty(len(data) * 3 // 2 + 16, np.uint8)  # 12-bit codes of single bytes, Clear and EOI
    n = fn(data, len(data), out.ctypes.data, out.size)
    if n > out.size:
        raise RuntimeError(f"LZW strip of {n} bytes overran its {out.size}-byte buffer")
    return out[:n].tobytes()


def encode_tiff(img: np.ndarray) -> bytes:
    """(H, W) gray or (H, W, 3) BGR uint8 as a TIFF: the bytes of
    `cv2.imencode(".tif", img)` (libtiff through OpenCV's writer). One
    little-endian page of RGB (or MinIsBlack gray) samples, LZW with the
    horizontal predictor, strips of `max(1, min(H, 8192 // (W * C)))`
    rows each coded on its own by `csrc/tiff_encode.cpp`; the strips from
    byte 8, then the IFD (12 tags, word-aligned) and the values that do not
    fit in it, in libtiff's order: BitsPerSample, StripByteCounts,
    StripOffsets, SampleFormat. The byte counts are SHORT where libtiff
    writes them so (several strips of under 6553 raw bytes each), else
    LONG."""
    img = _image_u8(img, "encode_tiff")
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else 3
    rows = (img if c == 1 else img[..., ::-1]).reshape(h, w * c)  # BGR -> RGB
    diff = rows.copy()
    diff[:, c:] -= rows[:, :-c]  # Predictor 2: each sample less its left neighbour's, mod 256
    rps = max(1, min(h, 8192 // (w * c)))
    strips = [_tiff_lzw(diff[y:y + rps].tobytes()) for y in range(0, h, rps)]
    data = b"".join(strips)
    ifd_at = 8 + len(data) + (len(data) & 1)  # word-aligned
    SHORT, LONG = 3, 4
    # libtiff writes the byte counts of several strips as SHORT when an LZW
    # strip of `rps` rows could not pass 0xFFFF bytes even at 10x its raw size
    counts_type = SHORT if len(strips) > 1 and rps * w * c < 0xFFFF // 10 else LONG

    def dim(v: int) -> Tuple[int, list]:
        return (SHORT, [v]) if v <= 0xFFFF else (LONG, [v])

    tags = {256: dim(w), 257: dim(h), 258: (SHORT, [8] * c), 259: (SHORT, [5]), 262: (SHORT, [1 if c == 1 else 2]),
            273: (LONG, np.cumsum([8] + [len(s) for s in strips[:-1]]).tolist()), 277: (SHORT, [c]), 278: dim(rps),
            279: (counts_type, [len(s) for s in strips]), 284: (SHORT, [1]), 317: (SHORT, [2]), 339: (SHORT, [1] * c)}
    body = {t: struct.pack("<" + ("H" if typ == SHORT else "I") * len(v), *v) for t, (typ, v) in tags.items()}
    extra, where = b"", {}
    for t in (258, 279, 273, 339):  # the values that do not fit in the IFD, in libtiff's order
        if len(body[t]) > 4:
            where[t] = ifd_at + 2 + 12 * len(tags) + 4 + len(extra)
            extra += body[t]
    ifd = struct.pack("<H", len(tags))
    for t, (typ, v) in tags.items():
        value = struct.pack("<I", where[t]) if t in where else body[t].ljust(4, b"\0")
        ifd += struct.pack("<HHI", t, typ, len(v)) + value
    return b"II*\0" + struct.pack("<I", ifd_at) + data + b"\0" * (len(data) & 1) + ifd + struct.pack("<I", 0) + extra


WEBP_MAX_SIDE = 16383  # libwebp's WEBP_MAX_DIMENSION: cv2's writer fails above it


def encode_webp(img: np.ndarray, name: str = "<bytes>") -> bytes:
    """(H, W) gray or (H, W, 3) BGR uint8 as a lossless WebP, what
    `cv2.imencode(".webp", img)` writes with no parameters: a simple RIFF
    container holding one VP8L image (a gray image written as BGR), which
    `cv2.imdecode` and `decode_webp` give back exactly. `csrc/webp_encode.cpp`
    codes it (subtract-green, per-tile predictors, cross-colour, colour
    indexing, LZ77, colour cache; see its header). Its bytes are not
    libwebp's: libwebp's encoder is thousands of lines of heuristics, and
    its files are somewhat smaller. A side above 16383 raises ValueError
    naming `name`, where cv2 fails."""
    from tamtr_torch.kernels import _build

    img = _image_u8(img, "encode_webp")
    h, w = img.shape[:2]
    if h > WEBP_MAX_SIDE or w > WEBP_MAX_SIDE:
        raise ValueError(f"{name}: {h}x{w} is larger than WebP's {WEBP_MAX_SIDE} pixels a side")
    bgr = np.ascontiguousarray(np.repeat(img[..., None], 3, 2) if img.ndim == 2 else img)
    fn = _build.load("webp_encode").webp_vp8l_encode
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_long]
    fn.restype = ctypes.c_long
    out = np.empty(bgr.size * 5 // 4 + 4096, np.uint8)
    n = fn(bgr.ctypes.data, w, h, out.ctypes.data, out.size)
    if n > out.size:
        out = np.empty(n, np.uint8)
        n = fn(bgr.ctypes.data, w, h, out.ctypes.data, out.size)
    if n < 0:
        raise ValueError(f"{name}: cannot encode a {h}x{w} image as WebP")
    body = out[:n].tobytes() + b"\0" * (n & 1)
    chunk = b"VP8L" + struct.pack("<I", n) + body
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk


def imencode(ext: str, img: np.ndarray, quality: int = 95, webp_quality: Optional[float] = None,
             name: Optional[str] = None) -> bytes:
    """The bytes of `img` ((H, W) gray or (H, W, 3) BGR uint8) in the format
    of `ext`, as cv2 tells it: ".jpg", ".jpeg" or ".jpe" (`quality`),
    ".png", ".bmp", ".tif" or ".tiff", ".webp" (lossless: `webp_quality`
    None or above 100, as cv2's default; cv2's lossy VP8 at 100 or below is
    not ported and raises NotImplementedError). `name` names the file in
    errors; another suffix raises NotImplementedError naming it."""
    ext = ext.lower() if ext.startswith(".") else "." + ext.lower()
    name = "imencode" if name is None else name
    if ext in (".jpg", ".jpeg", ".jpe"):
        return encode_jpeg(img, quality)
    if ext == ".png":
        return encode_png(img)
    if ext == ".bmp":
        return encode_bmp(img)
    if ext in (".tif", ".tiff"):
        return encode_tiff(img)
    if ext == ".webp":
        if webp_quality is not None and webp_quality <= 100:
            raise NotImplementedError(f"{name}: lossy WebP (quality {webp_quality}) is not written; "
                                      "lossless only (webp_quality None or above 100)")
        return encode_webp(img, name)
    raise NotImplementedError(f"{name}: writing {ext!r} images is not ported "
                              "(JPEG, PNG, BMP, TIFF and WebP only)")


def imwrite(filename: str | Path, img: np.ndarray, quality: int = 95, webp_quality: Optional[float] = None) -> bool:
    """Write `img` at `filename` in the format its suffix names (`imencode`),
    through Python's file API, so any path works (the JAX package's
    `utils/patches.py:imwrite`); True once written."""
    data = imencode(Path(filename).suffix, img, quality, webp_quality, name=str(filename))
    Path(filename).write_bytes(data)
    return True
