#!/usr/bin/env python
"""Recover ORB's test-pair table (`tamtr_torch/trackers/orb_pattern.py`)
from an installed cv2, and check it against cv2.ORB.

OpenCV keeps the table (`bit_pattern_31_` of its `orb.cpp`) in its compiled
module as 1024 32-bit ints: 256 tests (x1, y1, x2, y2), each coordinate in
[-13, 12]. Where OpenCV's sources are not at hand the table is read from
there: the module's binary is searched for the first three tests as
`orb.cpp` prints them, (8, -3, 9, 5), (4, 2, 7, -12), (-11, 9, -8, 2), stored
as little-endian int32, and the 1024 ints from that address are taken. They
are then held against cv2 itself: `cv2.ORB_create().compute` of keypoints at
three angles on a smoothed random image must give, bit for bit, the bits
that the table gives on ORB's 7x7 sigma-2 blur of that image (cv2's float
Gaussian rounded to uint8, not its bit-exact 8-bit path).

    python tools/extract_orb_pattern.py           # check the committed table
    python tools/extract_orb_pattern.py --write   # and write orb_pattern.py
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tamtr_torch/trackers/orb_pattern.py"
ANCHOR = (8, -3, 9, 5, 4, 2, 7, -12, -11, 9, -8, 2)

HEADER = '''"""ORB's 256 binary tests on a 31x31 patch, each (x1, y1, x2, y2): a
descriptor bit is 1 where the smoothed patch is darker at (x1, y1) than at
(x2, y2). The table is OpenCV's (`bit_pattern_31_` of its `orb.cpp`),
learnt by Rublee et al. (ICCV 2011). `tools/extract_orb_pattern.py` read it
out of cv2's compiled module (found by the first three tests as `orb.cpp`
prints them) and checked the descriptors it gives against cv2.ORB's;
`tests/test_torch_gmc.py` holds them bit for bit."""

BIT_PATTERN_31 = (
'''


def find_table() -> np.ndarray:
    import cv2

    hits = []
    for so in sorted(Path(cv2.__file__).parent.rglob("cv2*.so")):
        blob = so.read_bytes()
        at = blob.find(np.asarray(ANCHOR, "<i4").tobytes())
        if at >= 0:
            hits.append(np.frombuffer(blob, "<i4", 1024, at).reshape(256, 4).copy())
    if len(hits) != 1:
        sys.exit(f"found the table's first tests in {len(hits)} modules of cv2, not one")
    table = hits[0]
    if np.abs(table).max() > 13:
        sys.exit("the ints after the first tests are not a table of offsets within the 31x31 patch")
    return table


def check_against_orb(table: np.ndarray) -> int:
    """The number of descriptor bits where the table disagrees with cv2.ORB."""
    import cv2

    rng = np.random.default_rng(0)
    img = cv2.GaussianBlur(rng.integers(0, 256, (120, 160), np.uint8), (0, 0), 2)
    img = cv2.normalize(img, None, 0, 255, cv2.NORM_MINMAX)
    blur = cv2.GaussianBlur(img.astype(np.float32), (7, 7), 2, 2, borderType=cv2.BORDER_REFLECT_101)
    blur = np.rint(blur).astype(np.uint8)
    pairs = table.reshape(512, 2).astype(np.float32)
    wrong = 0
    for angle in (-1.0, 0.0, 30.0):
        kps = [cv2.KeyPoint(float(x), float(y), 7, angle, 10, 0) for x, y in ((50, 50), (80, 60), (100, 40))]
        kps, want = cv2.ORB_create().compute(img, kps)
        for k, w in zip(kps, want):
            a = np.float32(k.angle * np.float32(np.pi / 180))
            c, s = np.float32(np.cos(a)), np.float32(np.sin(a))
            ix = np.rint(pairs[:, 0] * c - pairs[:, 1] * s).astype(int)
            iy = np.rint(pairs[:, 0] * s + pairs[:, 1] * c).astype(int)
            v = blur[int(round(k.pt[1])) + iy, int(round(k.pt[0])) + ix]
            bits = (v[0::2] < v[1::2]).astype(np.uint8).reshape(32, 8)
            wrong += int(np.unpackbits(np.packbits(bits[:, ::-1], axis=1) ^ w[:, None], axis=1).sum())
    return wrong


def render(table: np.ndarray) -> str:
    lines, line = [], "   "
    for t in table.tolist():
        item = f" ({t[0]}, {t[1]}, {t[2]}, {t[3]}),"
        if len(line) + len(item) > 112:
            lines.append(line)
            line = "   "
        line += item
    lines.append(line)
    return HEADER + "\n".join(lines) + "\n)\n"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true", help=f"write {OUT.relative_to(ROOT)}")
    args = ap.parse_args()
    table = find_table()
    wrong = check_against_orb(table)
    if wrong:
        sys.exit(f"the table disagrees with cv2.ORB on {wrong} descriptor bits")
    print("the table gives cv2.ORB's descriptors bit for bit")
    if args.write:
        OUT.write_text(render(table))
        print(f"wrote {OUT.relative_to(ROOT)}")
    else:
        sys.path.insert(0, str(ROOT))
        from tamtr_torch.trackers.orb_pattern import BIT_PATTERN_31

        same = np.array_equal(np.asarray(BIT_PATTERN_31), table)
        print(f"{OUT.relative_to(ROOT)} {'equals' if same else 'differs from'} cv2's table")
        sys.exit(0 if same else 1)


if __name__ == "__main__":
    main()
