"""The port's PNG and BMP readers and writers (`tamtr_torch/data/image_io.py`)
against cv2, bitwise, in every mode cv2 reads.

cv2 writes neither palette, low-depth, Adam7 nor RLE files, so the test
writes them with a small struct/zlib writer:
- PNG: gray at 1, 2, 4, 8 and 16 bits, gray + alpha, RGB and RGBA at 8 and
  16 bits, palette at 1, 2, 4 and 8 bits with a tRNS chunk, each plain and
  Adam7-interlaced, every row under a filter type drawn from a seed, IDAT
  split in two; the 16-bit sample 0x7FFF reads as 127 (cv2 cuts 16-bit
  samples to their high byte, it does not round);
- BMP: 1, 4 and 8-bit palette, 16-bit 555 (plain and by bit fields) and 565,
  32-bit (plain and bit fields), RLE8 and RLE4 streams drawn from a seed
  (runs, absolute runs, deltas, ends of line, end of bitmap), bottom-up
  and top-down rows.
`decode_png` / `decode_bmp` / `imread` equal `cv2.imdecode(..., IMREAD_COLOR)`
on each; `encode_bmp` and `imencode(".bmp")` equal `cv2.imencode`'s bytes,
`imencode(".png")` reads back through cv2 as the image, another suffix
raises NotImplementedError naming it.
"""

import struct
import zlib

import cv2
import numpy as np
import pytest

from tamtr_torch.data.image_io import decode_bmp, decode_png, encode_bmp, imencode, imread, imwrite, png_shape

PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
SIZES = [(1, 1), (3, 5), (7, 13), (17, 9), (20, 33)]


def cv2_decode(data: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def assert_bitwise(got: np.ndarray, data: bytes):
    want = cv2_decode(data)
    assert want is not None and got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want)
    assert np.array_equal(got, want), f"{int((diff > 0).sum())} samples differ, max {diff.max()}"


# ---------------------------------------------------------------- PNG writer
def _chunk(tag: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, c) samples -> (h, row bytes) at `depth` bits, big-endian."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = np.unpackbits(flat.astype(np.uint8)[..., None], axis=-1)[..., 8 - depth:].reshape(h, -1)
    return np.packbits(bits, axis=1)


def _filter_rows(rows: np.ndarray, bpp: int, rng) -> bytes:
    """Each row under a filter type 0-4 drawn from `rng` (PNG spec, 9)."""
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for r in rows.astype(np.int64):
        t = int(rng.integers(0, 5))
        f = np.zeros_like(r)
        for i in range(len(r)):
            a = r[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = (0, a, b, (a + b) >> 1, a if pa <= pb and pa <= pc else (b if pb <= pc else c))[t]
            f[i] = (r[i] - pred) & 255
        out.append(bytes([t]) + f.astype(np.uint8).tobytes())
        prev = r
    return b"".join(out)


def make_png(samples, depth, ctype, palette=None, trns=None, interlace=0, seed=0) -> bytes:
    """A PNG of (h, w, c) integer samples at `depth` bits."""
    rng = np.random.default_rng(seed)
    h, w = samples.shape[:2]
    bpp = max(1, PNG_CHANNELS[ctype] * depth // 8)
    if interlace:
        raw = b"".join(_filter_rows(_pack_rows(samples[y0::dy, x0::dx], depth), bpp, rng)
                       for x0, y0, dx, dy in ADAM7 if samples[y0::dy, x0::dx].size)
    else:
        raw = _filter_rows(_pack_rows(samples, depth), bpp, rng)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    z = zlib.compress(raw, 6)
    return out + _chunk(b"IDAT", z[:len(z) // 2]) + _chunk(b"IDAT", z[len(z) // 2:]) + _chunk(b"IEND", b"")


PNG_MODES = [(ctype, depth) for ctype, depths in PNG_DEPTHS.items() for depth in depths]


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype,depth", PNG_MODES, ids=[f"type{c}-{d}bit" for c, d in PNG_MODES])
def test_png_modes_match_cv2(ctype, depth, interlace, tmp_path):
    rng = np.random.default_rng(ctype * 100 + depth * 2 + interlace)
    for h, w in SIZES:
        samples = rng.integers(0, 1 << depth, (h, w, PNG_CHANNELS[ctype]))
        palette = trns = None
        if ctype == 3:  # a palette of every index, tRNS for some of them
            palette = rng.integers(0, 256, (1 << depth, 3))
            trns = rng.integers(0, 256, min(3, 1 << depth), dtype=np.uint8).tobytes()
        data = make_png(samples, depth, ctype, palette, trns, interlace, seed=h * w)
        assert_bitwise(decode_png(data), data)
        path = tmp_path / f"{h}x{w}.png"
        path.write_bytes(data)
        assert np.array_equal(imread(path), cv2.imread(str(path), cv2.IMREAD_COLOR))
        assert png_shape(path) == (h, w)


def test_png_16bit_cuts_to_the_high_byte():
    data = make_png(np.array([[[0x7FFF, 0x80FF, 0x01FF]]]), 16, 2)
    assert decode_png(data)[0, 0].tolist() == [1, 128, 127] == cv2_decode(data)[0, 0].tolist()


# ---------------------------------------------------------------- BMP writer
def make_bmp(pixels: bytes, w, h, bpp, comp=0, palette=None, masks=None, top_down=False) -> bytes:
    """A BMP with a 40-byte header, then the bit fields and the palette."""
    pal = b"" if palette is None else np.asarray(palette, np.uint8).tobytes()
    extra = b"" if masks is None else struct.pack("<III", *masks)
    header = struct.pack("<IiiHHIIIIII", 40, w, -h if top_down else h, 1, bpp, comp, len(pixels), 2835, 2835,
                         len(pal) // 4, 0)
    body = header + extra + pal + pixels
    return b"BM" + struct.pack("<IHHI", 14 + len(body), 0, 0, 14 + 40 + len(extra) + len(pal)) + body


def rle_stream(w, h, four, rng) -> bytes:
    """A well-formed RLE8 (RLE4 with `four`) stream that covers every pixel:
    encoded runs, absolute runs (word-padded), deltas (RLE8: also down),
    ends of line, then end of bitmap."""
    out, p, top = bytearray(), 0, 16 if four else 256
    while p < w * h:
        x = p % w
        rem, r = w - x, rng.random()
        if r < 0.4:
            n = int(rng.integers(1, min(rem, 255) + 1))
            out += bytes([n, int(rng.integers(0, 256))])
        elif r < 0.7 and rem >= 3:
            n = int(rng.integers(3, min(rem, 255) + 1))
            idx = rng.integers(0, top, n).astype(np.uint8)
            if four:
                packed = ((idx[0::2] << 4) | np.pad(idx[1::2], (0, n % 2))).astype(np.uint8).tobytes()
                size = (((n + 1) >> 1) + 1) & ~1
            else:
                packed, size = idx.tobytes(), (n + 1) & ~1
            out += bytes([0, n]) + packed + b"\0" * (size - len(packed))
        elif r < 0.8 and rem >= 2:
            dx = int(rng.integers(0, rem - 1))
            dy = 0 if four or p // w >= h - 1 else int(rng.integers(0, min(2, h - 1 - p // w) + 1))
            out += bytes([0, 2, dx, dy])
            p += dx + dy * w
            continue
        elif r < 0.85 and x > 0:
            out += bytes([0, 0])
            p = (p // w + 1) * w
            continue
        else:
            continue
        p += n
        if p % w == 0:  # the row is full: end of line
            out += bytes([0, 0])
    return bytes(out + bytes([0, 1]))


def _palette(rng, n):
    return np.concatenate([rng.integers(0, 256, (n, 3)), np.zeros((n, 1), int)], 1)


@pytest.mark.parametrize("top_down", [False, True], ids=["bottom-up", "top-down"])
@pytest.mark.parametrize("bpp", [1, 4, 8])
def test_bmp_palette_modes_match_cv2(bpp, top_down):
    rng = np.random.default_rng(bpp + 10 * top_down)
    for h, w in SIZES:
        idx = rng.integers(0, 1 << bpp, (h, w, 1))
        pitch = ((w * bpp + 7) // 8 + 3) & -4
        rows = np.zeros((h, pitch), np.uint8)
        packed = _pack_rows(idx, bpp)
        rows[:, :packed.shape[1]] = packed
        data = make_bmp(rows.tobytes(), w, h, bpp, palette=_palette(rng, 1 << bpp), top_down=top_down)
        assert_bitwise(decode_bmp(data), data)


@pytest.mark.parametrize("mode", ["555", "555-bitfields", "565", "32", "32-bitfields"])
def test_bmp_16_and_32_bit_match_cv2(mode):
    """16-bit fields widened by a shift (no low bits replicated), as cv2
    widens them; the fourth byte of 32-bit pixels dropped."""
    rng = np.random.default_rng(len(mode))
    masks = {"555-bitfields": (0x7C00, 0x3E0, 0x1F), "565": (0xF800, 0x7E0, 0x1F),
             "32-bitfields": (0xFF0000, 0xFF00, 0xFF)}.get(mode)
    bpp = 32 if mode.startswith("32") else 16
    for top_down in (False, True):
        for h, w in SIZES:
            pitch = (w * bpp // 8 + 3) & -4
            rows = rng.integers(0, 256, (h, pitch), dtype=np.uint8)
            data = make_bmp(rows.tobytes(), w, h, bpp, comp=3 if masks else 0, masks=masks, top_down=top_down)
            assert_bitwise(decode_bmp(data), data)


@pytest.mark.parametrize("four", [False, True], ids=["rle8", "rle4"])
def test_bmp_rle_matches_cv2(four):
    rng = np.random.default_rng(7 + four)
    for trial in range(24):
        w, h = int(rng.integers(1, 40)), int(rng.integers(1, 12))
        data = make_bmp(rle_stream(w, h, four, rng), w, h, 4 if four else 8, comp=2 if four else 1,
                        palette=_palette(rng, 16 if four else 256), top_down=trial % 3 == 0)
        assert_bitwise(decode_bmp(data), data)


@pytest.mark.parametrize("gray", [False, True], ids=["bgr", "gray"])
def test_bmp_and_png_writers_match_cv2(gray, tmp_path):
    rng = np.random.default_rng(3)
    for h, w in SIZES:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if gray:
            img = img[..., 0]
        want = cv2.imencode(".bmp", img)[1].tobytes()
        assert encode_bmp(img) == imencode(".bmp", img) == imencode("BMP", img) == want
        assert imwrite(tmp_path / "a.bmp", img) and (tmp_path / "a.bmp").read_bytes() == want
        back = cv2.imdecode(np.frombuffer(imencode(".png", img), np.uint8), cv2.IMREAD_UNCHANGED)
        assert np.array_equal(back, img)
    with pytest.raises(NotImplementedError, match=r"\.jp2"):
        imencode(".jp2", img)
    with pytest.raises(ValueError):
        imencode(".jpg", np.zeros((4, 4, 3), np.float32))
