#!/usr/bin/env python
"""Convert an extracted VisDrone2019-DET tree into the YOLO layout the port
trains on, without downloading and without cv2 (the conversion half of
`tools/get_visdrone.py`, through `tamtr_torch.data.converter`).

`<root>` holds VisDrone2019-DET-train/, -val/ and -test-dev/, each with
images/ and annotations/ as the official zips unpack. Each split gets a
labels/ directory, and `<root>/visdrone.yaml` points train at DET-train
and val at DET-test-dev (the reference's protocol).

    python tools/convert_visdrone_torch.py --root /data/visdrone
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tamtr_torch.data.converter import VISDRONE_SPLITS, convert_split, write_yaml  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="the directory holding the extracted splits")
    root = Path(ap.parse_args(argv).root)
    total = 0
    for split in VISDRONE_SPLITS:
        n = convert_split(root / split)
        print(f"{split}: {n} label files")
        total += n
    if total == 0:
        print("no split converted: are the images and annotations under --root?", file=sys.stderr)
        return 1
    print(f"wrote {write_yaml(root)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
