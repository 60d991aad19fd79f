#!/usr/bin/env python
"""Write the JPEG fixtures of the port's reader (`tests/torch_data/jpeg/`).

Needs cv2, so it runs where cv2 is installed (not on the card's machine):

    python tools/make_jpeg_fixtures_torch.py [--out tests/torch_data/jpeg]

Each image is a smooth gradient with hard edges and mild noise, written by
`cv2.imencode` at quality 75-95 in each chroma sampling mode (4:4:4, 4:2:2,
4:2:0, 4:4:0), in gray, with a restart interval, with an EXIF orientation
tag (6: rotate 90 degrees clockwise) spliced in, at VisDrone's 1360x765
frame size, and progressive (`IMWRITE_JPEG_PROGRESSIVE`: 4:4:4, 4:2:0,
gray, and 4:2:0 with a restart interval). `expected.json` beside them holds
each file's shape, the sha256 of `cv2.imdecode(..., cv2.IMREAD_COLOR)`
(`sha256`) and the sha256 of `cv2.imencode(".jpg", <that decode>)` at the
default quality 95 (`imencode_sha256`): the oracles the card's machine,
which has no cv2, checks `tamtr_torch.data.image_io.decode_jpeg` and
`encode_jpeg` against (`chip_smoke.py`, `tests/test_torch_cuda.py`).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import struct
from pathlib import Path

import numpy as np

OUT = Path(__file__).resolve().parent.parent / "tests" / "torch_data" / "jpeg"


def scene(h: int, w: int, seed: int) -> np.ndarray:
    """(h, w, 3) uint8 BGR: sinusoidal gradients, a checker of hard edges,
    Gaussian noise of sigma 4."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(x / (23 + 7 * c) + c) * np.cos(y / (31 - 5 * c) - c) for c in range(3)], -1)
    img[(x // 48 + y // 36) % 2 == 0] += 45
    img += rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def exif_app1(orientation: int, big_endian: bool = False) -> bytes:
    """An APP1 segment holding a TIFF header and one IFD0 entry: the
    orientation tag (0x0112, SHORT)."""
    e = ">" if big_endian else "<"
    tiff = (b"MM" if big_endian else b"II") + struct.pack(e + "HI", 42, 8)
    tiff += struct.pack(e + "H", 1) + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0)
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def splice_after_app0(jpeg: bytes, segment: bytes) -> bytes:
    """`segment` inserted after SOI and the JFIF APP0 segment (if any)."""
    p = 2
    if jpeg[2:4] == b"\xff\xe0":
        p = 4 + struct.unpack(">H", jpeg[4:6])[0]
    return jpeg[:p] + segment + jpeg[p:]


def fixtures():
    """(file name, encoded bytes) of every fixture."""
    import cv2

    S, Q = cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_QUALITY

    def enc(img, *params):
        ok, buf = cv2.imencode(".jpg", img, list(params))
        assert ok
        return buf.tobytes()

    yield "s444_q95.jpg", enc(scene(240, 320, 1), Q, 95, S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
    yield "s422_q85.jpg", enc(scene(241, 317, 2), Q, 85, S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422)
    yield "s420_q75.jpg", enc(scene(239, 321, 3), Q, 75, S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)
    yield "s440_q90.jpg", enc(scene(245, 310, 4), Q, 90, S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440)
    yield "gray_q85.jpg", enc(scene(200, 280, 5)[..., 1], Q, 85)
    yield "rst_q80.jpg", enc(scene(190, 270, 6), Q, 80, cv2.IMWRITE_JPEG_RST_INTERVAL, 5)
    yield "exif6_q90.jpg", splice_after_app0(enc(scene(210, 300, 7), Q, 90), exif_app1(6))
    yield "visdrone_1360x765_q85.jpg", enc(scene(765, 1360, 8), Q, 85)
    P = cv2.IMWRITE_JPEG_PROGRESSIVE
    yield "prog444_q90.jpg", enc(scene(150, 200, 9), Q, 90, P, 1, S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
    yield "prog420_q85.jpg", enc(scene(157, 203, 10), Q, 85, P, 1, S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)
    yield "proggray_q80.jpg", enc(scene(141, 187, 11)[..., 0], Q, 80, P, 1)
    yield "progrst_q85.jpg", enc(scene(133, 171, 12), Q, 85, P, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 4)


def main(argv=None) -> int:
    import cv2

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(OUT))
    out = Path(ap.parse_args(argv).out)
    out.mkdir(parents=True, exist_ok=True)
    expected, total = {}, 0
    for name, data in fixtures():
        (out / name).write_bytes(data)
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        expected[name] = {"shape": list(img.shape), "sha256": hashlib.sha256(img.tobytes()).hexdigest(),
                          "imencode_sha256": hashlib.sha256(cv2.imencode(".jpg", img)[1].tobytes()).hexdigest()}
        total += len(data)
    (out / "expected.json").write_text(json.dumps(expected, indent=1) + "\n")
    print(f"wrote {len(expected)} fixtures, {total} bytes, to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
