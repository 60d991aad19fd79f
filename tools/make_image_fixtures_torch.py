#!/usr/bin/env python
"""Write the WebP and TIFF fixtures of the port's readers
(`tests/torch_data/webp/`, `tests/torch_data/tiff/`) and the oracles of its
writers (`tests/torch_data/encode/expected.json`).

Needs cv2, so it runs where cv2 is installed (not on the card's machine):

    python tools/make_image_fixtures_torch.py [--out tests/torch_data]

WebP files are written by `cv2.imencode(".webp", ...)`: lossy at quality
10, 50 and 95 on odd sizes, lossy with alpha, lossless (quality 101) with
and without alpha, a few-colour image (the colour-indexing transform), and
two rewrapped with an EXIF orientation (`with_exif`).
TIFF files are written by `cv2.imencode(".tiff", ...)` in each compression
it writes (none, LZW, Adobe and old Deflate, PackBits), 16-bit, gray, BGRA
and two pages (`cv2.imencodemulti`), and by this tool's own writer
(`tiff_file`) where cv2 writes no such file: tiles, planar samples,
big-endian, a palette, 1-bit bilevel in both polarities, 8-bit
MinIsWhite, 16-bit gray, unassociated alpha, 4-bit palette and the
Orientation tag. `expected.json` in each folder holds each file's shape
and the sha256 of `cv2.imdecode(..., cv2.IMREAD_COLOR)`: the oracles the
card's machine, which has no cv2, checks `tamtr_torch.data.image_io.imread`
against (`chip_smoke.py`). Rerunning writes the same bytes.

`encode/expected.json` holds, for the decode of each WebP and TIFF fixture,
of the 1360x765 JPEG fixture and of a plot drawn over that JPEG by
`tamtr_torch.utils.plotting.annotate_image` (the boxes stored with it),
the sha256 of `cv2.imencode(".tif", img)` and the byte size of
`cv2.imencode(".webp", img)` (lossless): what `chip_smoke.py` holds the
port's `encode_tiff` (byte-equal) and `encode_webp` (at most 1.5x the size)
to on the card's machine.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import struct
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "tests" / "torch_data"


def scene(h: int, w: int, seed: int, c: int = 3) -> np.ndarray:
    """(h, w, c) uint8: sinusoidal gradients, a checker of hard edges,
    Gaussian noise of sigma 4."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(x / (13 + 5 * k) + k) * np.cos(y / (17 - 3 * k) - k) for k in range(c)], -1)
    img[(x // 24 + y // 18) % 2 == 0] += 45
    img += rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


# ----------------------------------------------------------------------- TIFF

def packbits(data: bytes) -> bytes:
    """PackBits: runs of 3 or more equal bytes as (1 - n, byte), the rest as
    literal blocks (n - 1, bytes) of at most 128."""
    out, i, n = bytearray(), 0, len(data)
    lit = bytearray()

    def flush():
        while lit:
            chunk = lit[:128]
            out.append(len(chunk) - 1)
            out.extend(chunk)
            del lit[:128]

    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j - i >= 2:
            flush()
            out.append((1 - (j - i + 1)) & 0xFF)
            out.append(data[i])
            i = j + 1
        else:
            lit.append(data[i])
            i += 1
    flush()
    return bytes(out)


def _chunk_bytes(a: np.ndarray, bits: int, bo: str) -> bytes:
    """Rows of one strip or tile, (rows, cols, samples) or (rows, cols), as
    TIFF stores them: bit-packed rows for bits < 8, 16-bit in `bo`."""
    if bits < 8:
        a = a.reshape(a.shape[0], -1)
        per = 8 // bits
        cols = a.shape[1]
        padded = np.zeros((a.shape[0], -(-cols // per) * per), np.uint8)
        padded[:, :cols] = a
        v = padded.reshape(a.shape[0], -1, per).astype(np.uint16)
        shifts = np.arange(per - 1, -1, -1) * bits
        return (v << shifts).sum(2).astype(np.uint8).tobytes()
    if bits == 16:
        return a.astype(bo + "u2").tobytes()
    return a.astype(np.uint8).tobytes()


def _predict(a: np.ndarray) -> np.ndarray:
    """Horizontal differencing (Predictor 2) along each row, per sample."""
    d = a.copy()
    d[:, 1:] = a[:, 1:] - a[:, :-1]  # wraps in the unsigned dtype
    return d


def tiff_file(img: np.ndarray, *, bits: int = 8, photometric: int = 2, bo: str = "<", compression: int = 1,
              predictor: int = 1, rows_per_strip: Optional[int] = None, tile: Optional[Sequence[int]] = None,
              planar: int = 1, colormap: Optional[np.ndarray] = None, orientation: Optional[int] = None,
              extra_samples: Optional[int] = None) -> bytes:
    """One-page TIFF of `img` ((h, w) or (h, w, samples), uint8 or uint16,
    samples in file order), written as the keywords say."""
    a = img if img.ndim == 3 else img[..., None]
    h, w, spp = a.shape
    chunks: List[np.ndarray] = []
    planes = [a] if planar == 1 else [a[..., s:s + 1] for s in range(spp)]
    if tile:
        tw, th = tile
        for p in planes:
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    t = np.zeros((th, tw, p.shape[2]), a.dtype)
                    blk = p[ty:ty + th, tx:tx + tw]
                    t[:blk.shape[0], :blk.shape[1]] = blk
                    chunks.append(t)
    else:
        rps = rows_per_strip or h
        for p in planes:
            for y in range(0, h, rps):
                chunks.append(p[y:y + rps])
    data = []
    for c in chunks:
        c = c[..., 0] if (c.shape[2] == 1 and bits < 8) else c
        if predictor == 2:
            c = _predict(c)
        raw = _chunk_bytes(c, bits, bo)
        if compression in (8, 32946):
            raw = zlib.compress(raw, 6)
        elif compression == 32773:
            row = len(raw) // max(c.shape[0], 1)
            raw = b"".join(packbits(raw[i:i + row]) for i in range(0, len(raw), row))
        data.append(raw)
    entries = []  # (tag, type, values)
    SHORT, LONG = 3, 4
    entries.append((256, LONG, [w]))
    entries.append((257, LONG, [h]))
    entries.append((258, SHORT, [bits] * spp))
    entries.append((259, SHORT, [compression]))
    entries.append((262, SHORT, [photometric]))
    if orientation:
        entries.append((274, SHORT, [orientation]))
    entries.append((277, SHORT, [spp]))
    if not tile:
        entries.append((278, LONG, [rows_per_strip or h]))
    entries.append((284, SHORT, [planar]))
    if predictor != 1:
        entries.append((317, SHORT, [predictor]))
    if colormap is not None:
        entries.append((320, SHORT, [int(v) for v in colormap.T.reshape(-1)]))
    if tile:
        entries.append((322, SHORT, [tile[0]]))
        entries.append((323, SHORT, [tile[1]]))
    if extra_samples is not None:
        entries.append((338, SHORT, [extra_samples]))
    off_tag, cnt_tag = (324, 325) if tile else (273, 279)
    entries.append((off_tag, LONG, [0] * len(data)))
    entries.append((cnt_tag, LONG, [len(d) for d in data]))
    entries.sort()
    # layout: header, image data, then the IFD and its out-of-line values
    out = bytearray((b"II" if bo == "<" else b"MM") + struct.pack(bo + "HI", 42, 0))
    offsets = []
    for d in data:
        offsets.append(len(out))
        out += d
        if len(out) % 2:
            out += b"\0"
    entries = [(t, ty, offsets if t == off_tag else v) for t, ty, v in entries]
    ifd_at = len(out)
    n = len(entries)
    extra_at = ifd_at + 2 + 12 * n + 4
    ifd = bytearray(struct.pack(bo + "H", n))
    extra = bytearray()
    for tag, ty, vals in entries:
        fmt = "H" if ty == SHORT else "I"
        body = struct.pack(bo + fmt * len(vals), *vals)
        if len(body) <= 4:
            ifd += struct.pack(bo + "HHI", tag, ty, len(vals)) + body.ljust(4, b"\0")
        else:
            ifd += struct.pack(bo + "HHII", tag, ty, len(vals), extra_at + len(extra))
            extra += body
            if len(extra) % 2:
                extra += b"\0"
    ifd += struct.pack(bo + "I", 0)
    out += ifd + extra
    out[4:8] = struct.pack(bo + "I", ifd_at)
    return bytes(out)


def tiff_fixtures():
    """(file name, bytes) of every TIFF fixture."""
    import cv2

    C = cv2.IMWRITE_TIFF_COMPRESSION

    def enc(img, *params):
        ok, buf = cv2.imencode(".tiff", img, list(params))
        assert ok
        return buf.tobytes()

    rgb = scene(45, 67, 11)
    yield "lzw_bgr.tif", enc(rgb)
    yield "none_bgr.tif", enc(scene(33, 50, 12), C, 1)
    yield "adobe_deflate_bgr.tif", enc(scene(41, 59, 13), C, 8)
    yield "deflate_bgr.tif", enc(scene(29, 71, 14), C, 32946)
    yield "packbits_bgr.tif", enc(scene(38, 55, 15), C, 32773)
    yield "lzw_gray.tiff", enc(scene(40, 61, 16)[..., 0])
    bgra = np.dstack([scene(36, 48, 17), np.linspace(0, 255, 36 * 48).reshape(36, 48).astype(np.uint8)])
    yield "lzw_bgra.tif", enc(bgra)
    wide = (scene(31, 43, 18).astype(np.uint16) * 257 + np.arange(31 * 43 * 3).reshape(31, 43, 3) % 257)
    yield "lzw_16bit.tif", enc(wide.astype(np.uint16))
    ok, buf = cv2.imencodemulti(".tiff", [scene(30, 40, 19), scene(20, 25, 20)])
    assert ok
    yield "two_pages.tif", buf.tobytes()
    # this tool's writer: RGB in file order
    rgb_file = scene(50, 70, 21)
    yield "tiled_deflate_pred.tif", tiff_file(rgb_file, compression=8, predictor=2, tile=(32, 16))
    yield "planar_packbits.tif", tiff_file(rgb_file[:37, :53], compression=32773, planar=2, rows_per_strip=10)
    yield "bigendian_deflate_pred.tif", tiff_file(rgb_file[:35, :47], bo=">", compression=32946, predictor=2,
                                                  rows_per_strip=8)
    yield "bigendian_16bit_planar.tif", tiff_file(
        (rgb_file[:26, :39].astype(np.uint16) * 251 + 7), bits=16, bo=">", planar=2, rows_per_strip=9)
    yield "gray16_pred.tif", tiff_file(rgb_file[:28, :33, 0].astype(np.uint16) * 256 + 99, bits=16,
                                       photometric=1, compression=32946, predictor=2)
    rng = np.random.default_rng(22)
    idx = (scene(34, 45, 23)[..., 0] // 32).astype(np.uint8)
    cmap = (rng.integers(0, 256, (256, 3)) * 257).astype(np.uint16)
    yield "palette8.tif", tiff_file(idx, photometric=3, colormap=cmap, compression=32773)
    cmap4 = (rng.integers(0, 256, (16, 3)) * 257).astype(np.uint16)
    yield "palette4.tif", tiff_file(idx, bits=4, photometric=3, colormap=cmap4, rows_per_strip=5)
    bw = (scene(27, 37, 24)[..., 1] > 128).astype(np.uint8)
    yield "bilevel_minisblack.tif", tiff_file(bw, bits=1, photometric=1, compression=32773)
    yield "bilevel_miniswhite.tif", tiff_file(bw, bits=1, photometric=0, rows_per_strip=4)
    yield "gray_miniswhite.tif", tiff_file(scene(25, 31, 25)[..., 2], photometric=0)
    rgba = np.dstack([rgb_file[:30, :44], np.linspace(0, 255, 30 * 44).reshape(30, 44).astype(np.uint8)])
    yield "rgba_unassoc.tif", tiff_file(rgba, extra_samples=2, compression=8)
    yield "rgba_assoc.tif", tiff_file(rgba, extra_samples=1)
    for o in (2, 3, 4):
        yield f"orient{o}.tif", tiff_file(rgb_file[:24, :35], orientation=o, rows_per_strip=7 if o == 4 else None)


# ----------------------------------------------------------------------- WebP

def webp_fixtures():
    """(file name, bytes) of every WebP fixture."""
    import cv2

    Q = cv2.IMWRITE_WEBP_QUALITY

    def enc(img, q):
        ok, buf = cv2.imencode(".webp", img, [Q, q])
        assert ok
        return buf.tobytes()

    yield "lossy_q10.webp", enc(scene(61, 83, 31), 10)
    yield "lossy_q50.webp", enc(scene(97, 131, 32), 50)
    yield "lossy_q95.webp", enc(scene(120, 160, 33), 95)
    yield "lossy_odd.webp", enc(scene(17, 23, 34), 75)
    yield "lossy_tiny.webp", enc(scene(1, 1, 35), 80)
    alpha = np.linspace(0, 255, 48 * 64).reshape(48, 64).astype(np.uint8)
    yield "lossy_alpha.webp", enc(np.dstack([scene(48, 64, 36), alpha]), 70)
    yield "lossless.webp", enc(scene(45, 59, 37), 101)
    yield "lossless_alpha.webp", enc(np.dstack([scene(40, 52, 38), alpha[:40, :52]]), 101)
    few = np.array([[0, 0, 255], [0, 200, 0], [255, 0, 0], [30, 30, 30], [250, 250, 250]], np.uint8)
    yield "lossless_palette.webp", enc(few[(scene(50, 70, 39)[..., 0] // 52).clip(0, 4)], 101)
    yy, xx = np.mgrid[0:48, 0:64]
    yield "lossless_gradient.webp", enc(np.dstack([xx * 3, yy * 5, np.full((48, 64), 21)]).astype(np.uint8), 101)
    yield "lossy_large.webp", enc(scene(240, 320, 40), 80)
    yield "lossless_exif6.webp", with_exif(enc(scene(30, 44, 41), 101), 6)
    yield "lossy_exif3.webp", with_exif(enc(scene(27, 35, 42), 60), 3)


def with_exif(webp: bytes, orientation: int) -> bytes:
    """A simple-format WebP rewrapped in an extended (VP8X) container with
    the EXIF flag and an EXIF chunk: a bare TIFF header whose IFD0 holds
    the orientation tag (what cv2 reads and applies)."""
    tag, size = webp[12:16], struct.unpack("<I", webp[16:20])[0]
    chunk = webp[12:20 + size + (size & 1)]
    body = chunk[8:8 + size]
    if tag == b"VP8 ":
        w, h = struct.unpack("<H", body[6:8])[0] & 0x3FFF, struct.unpack("<H", body[8:10])[0] & 0x3FFF
    else:
        bits = struct.unpack("<I", body[1:5])[0]
        w, h = (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
    tiff = b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1)
    tiff += struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack("<I", 0)
    vp8x = b"VP8X" + struct.pack("<I", 10) + bytes([0x08, 0, 0, 0]) + struct.pack("<I", w - 1)[:3] \
        + struct.pack("<I", h - 1)[:3]
    riff = b"WEBP" + vp8x + chunk + b"EXIF" + struct.pack("<I", len(tiff)) + tiff + b"\0" * (len(tiff) & 1)
    return b"RIFF" + struct.pack("<I", len(riff)) + riff


def expected(files: Dict[str, bytes]) -> Dict[str, dict]:
    import cv2

    out = {}
    for name, data in files.items():
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        assert img is not None, name
        out[name] = {"shape": list(img.shape), "sha256": hashlib.sha256(img.tobytes()).hexdigest()}
    return out


# the plot drawn over the 1360x765 JPEG fixture for `encode/expected.json`
PLOT_SOURCE = "jpeg/visdrone_1360x765_q85.jpg"


def plot_spec() -> dict:
    """12 boxes spread over a 1360x765 frame, with scores, labels and class
    names, drawn by `annotate_image` (`plot_image`)."""
    rng = np.random.default_rng(51)
    xy = rng.uniform([20, 40], [1200, 680], (12, 2))
    wh = rng.uniform([30, 20], [160, 90], (12, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, [1359, 764])], 1).round(1)
    return {"boxes": boxes.tolist(), "scores": rng.uniform(0.3, 0.99, 12).round(3).tolist(),
            "labels": rng.integers(0, 10, 12).tolist(), "names": [f"class{i}" for i in range(10)]}


def plot_image(img: np.ndarray, spec: dict) -> np.ndarray:
    import sys

    sys.path.insert(0, str(REPO))
    from tamtr_torch.utils.plotting import annotate_image

    return annotate_image(img, np.asarray(spec["boxes"], np.float32), np.asarray(spec["scores"], np.float32),
                          np.asarray(spec["labels"]), spec["names"])


def encode_expected(root: Path) -> Dict[str, dict]:
    """The `encode/expected.json` entries: key, the source under `root`
    (and the plot drawn over it), the input's shape and sha256, cv2's TIFF
    sha256 and lossless WebP size."""
    import cv2

    out = {}
    sources = [f"{sub}/{name}" for sub in ("webp", "tiff")
               for name in sorted(json.loads((root / sub / "expected.json").read_text()))]
    for key in sources + [PLOT_SOURCE, PLOT_SOURCE + "+plot"]:
        src = key.split("+")[0]
        img = cv2.imread(str(root / src), cv2.IMREAD_COLOR)
        entry = {"source": src}
        if key.endswith("+plot"):
            entry["plot"] = plot_spec()
            img = plot_image(img, entry["plot"])
        ok_t, tif = cv2.imencode(".tif", img)
        ok_w, webp = cv2.imencode(".webp", img)
        assert ok_t and ok_w, key
        out[key] = {**entry, "shape": list(img.shape), "sha256": hashlib.sha256(img.tobytes()).hexdigest(),
                    "tiff_sha256": hashlib.sha256(tif.tobytes()).hexdigest(), "webp_bytes": int(webp.size)}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args(argv)
    for sub, gen in (("tiff", tiff_fixtures), ("webp", webp_fixtures)):
        d = args.out / sub
        d.mkdir(parents=True, exist_ok=True)
        files = dict(gen())
        for name, data in files.items():
            (d / name).write_bytes(data)
        (d / "expected.json").write_text(json.dumps(expected(files), indent=1) + "\n")
        print(f"{d}: {len(files)} files, {sum(map(len, files.values()))} bytes")
    d = args.out / "encode"
    d.mkdir(parents=True, exist_ok=True)
    entries = encode_expected(args.out)
    (d / "expected.json").write_text("{\n" + ",\n".join(f"{json.dumps(k)}: {json.dumps(v)}" for k, v in entries.items())
                                     + "\n}\n")
    print(f"{d}: the cv2 encodes of {len(entries)} images")


if __name__ == "__main__":
    main()
