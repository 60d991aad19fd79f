#!/usr/bin/env python
"""End-to-end learning check of the PyTorch port: train TAM-TR on a
generated box dataset and report the mAP curve (the counterpart of
`tools/smoke_train.py`, through `tamtr_torch` only).

The dataset is class-coloured rectangles (red, green, blue, jittered) on a
noise background, drawn with numpy from the same seeds and draws as
`tools/smoke_train.py:make_dataset`, so the label files are equal and the
pixels are the arrays that tool encodes; they are written as PNG (the port
decodes no JPEG yet) with a `data.json`. A healthy pipeline drives mAP50
towards 1. The run exercises the whole training path: the augmentations
(perspective, HSV, flips), the text-contrastive heads on hash text
embeddings, CDN, the auction matcher, the RIOU loss, the EMA weights for
val, and the conf/NMS val protocol.

Usage (on the card; `--device cpu` to run on the CPU):
  python tools/smoke_train_torch.py --root build/smoke --epochs 240 --text-check

The exit code is non-zero when the final mAP50 < --pass-map50 (default
0.5), or, with --text-check, when the mAP50 with the class text rows
shuffled is above --text-check-ratio times the trained one.
"""

from __future__ import annotations

import argparse
import csv
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CLASS_COLORS = {0: (40, 40, 200), 1: (40, 200, 40), 2: (200, 40, 40)}  # BGR
NAMES = {0: "red box", 1: "green box", 2: "blue box"}


def make_images(n: int, imgsz: int, seed: int):
    """(BGR image, YOLO label lines) per image, drawn as
    `tools/smoke_train.py:make_dataset` draws them (its `cv2.rectangle`
    fills the closed pixel range [x1, x2] x [y1, y2])."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = rng.integers(90, 150, (imgsz, imgsz, 3), dtype=np.uint8)
        lines = []
        for _ in range(int(rng.integers(2, 7))):
            c = int(rng.integers(0, 3))
            w, h = rng.uniform(0.08, 0.3, 2)
            cx = rng.uniform(w / 2, 1 - w / 2)
            cy = rng.uniform(h / 2, 1 - h / 2)
            x1, y1 = int((cx - w / 2) * imgsz), int((cy - h / 2) * imgsz)
            x2, y2 = int((cx + w / 2) * imgsz), int((cy + h / 2) * imgsz)
            color = tuple(int(np.clip(v + rng.integers(-30, 30), 0, 255)) for v in CLASS_COLORS[c])
            img[max(y1, 0):y2 + 1, max(x1, 0):x2 + 1] = color
            lines.append(f"{c} {cx:.4f} {cy:.4f} {w:.4f} {h:.4f}")
        out.append((img, lines))
    return out


def make_dataset(root: Path, n_train: int, n_val: int, imgsz: int, seed: int = 0) -> Path:
    """Write YOLO-layout PNG images and labels, and data.json, under `root`."""
    from tamtr_torch.data.image_io import imwrite_png

    for split, n, s in (("train", n_train, seed), ("val", n_val, seed + 1)):
        (root / split / "images").mkdir(parents=True, exist_ok=True)
        (root / split / "labels").mkdir(parents=True, exist_ok=True)
        for i, (img, lines) in enumerate(make_images(n, imgsz, s)):
            imwrite_png(root / split / "images" / f"im{i:03d}.png", img)
            (root / split / "labels" / f"im{i:03d}.txt").write_text("\n".join(lines))
    data = root / "data.json"
    data.write_text(json.dumps({"path": str(root), "train": "train/images", "val": "val/images",
                                "nc": 3, "names": NAMES}))
    return data


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default="build/smoke_torch")
    ap.add_argument("--model", default="tamtr.yaml")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--epochs", type=int, default=240)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--n-train", type=int, default=16)
    ap.add_argument("--n-val", type=int, default=8)
    ap.add_argument("--max-gt", type=int, default=32)
    ap.add_argument("--warmup", type=int, default=100, help="warmup iterations")
    ap.add_argument("--val-interval", type=int, default=20)
    ap.add_argument("--pass-map50", type=float, default=0.5)
    # a learning-curve canary, not the parity protocol: the reference's
    # conf 0.4 hides every detection until the scores calibrate late
    ap.add_argument("--conf", type=float, default=0.05)
    # nominal batch: the recipe's 64 would step the optimizer once per 16
    # batches of a 16-image set; 0 steps it every batch
    ap.add_argument("--nbs", type=int, default=0, help="0 = same as --batch")
    ap.add_argument("--name", default="smoke")
    # text dependence: re-validate with the class embedding rows rolled by
    # one; if the contrastive heads score regions against the text, mAP
    # must collapse (the classes swap labels)
    ap.add_argument("--text-check", action="store_true")
    ap.add_argument("--text-check-ratio", type=float, default=0.5,
                    help="fail if shuffled mAP50 > ratio * trained mAP50")
    args = ap.parse_args(argv)

    import torch

    from tamtr_torch.api import TAMTR

    if args.device != "cpu":
        if not torch.cuda.is_available():
            print("smoke_train_torch: no CUDA device (pass --device cpu to run on the CPU)", file=sys.stderr)
            return 2
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True)
        print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    root = Path(args.root)
    data = make_dataset(root, args.n_train, args.n_val, args.imgsz)
    t0 = time.time()
    model = TAMTR(args.model, nc=len(NAMES), device=args.device, imgsz=args.imgsz, max_gt=args.max_gt)
    metrics = model.train(
        data=str(data), epochs=args.epochs, batch=args.batch,
        warmup_epochs=args.warmup,  # the reference reads it in iterations
        val_interval=args.val_interval, save_interval=args.val_interval, conf=args.conf,
        nbs=args.nbs or args.batch, name=args.name, project=str(root / "runs"), exist_ok=True,
        workers=2,  # the loader count of tools/smoke_train.py: two spawned processes
        plots=False,
    )
    wall = time.time() - t0
    eng = model._lazy_engine()

    csv_path = root / "runs" / args.name / "results.csv"
    print("\nmAP curve (epoch, mAP50, mAP50-95, fitness):")
    with open(csv_path) as f:
        for row in csv.DictReader(f):
            if row.get("mAP50"):
                print(f"  {row['epoch']:>4} {row['mAP50']:>8} {row['mAP50-95']:>8} {row['fitness']:>8}")
    steps, waits = np.asarray(eng.timing["step_ms"]), np.asarray(eng.timing["wait_ms"])
    print(f"\nsteps {len(steps)}: step ms median {np.median(steps[2:]):.1f}, mean {steps[2:].mean():.1f}; "
          f"loader wait ms median {np.median(waits[2:]):.2f}, mean {waits[2:].mean():.2f}, share of "
          f"step + wait {waits[2:].sum() / (waits[2:].sum() + steps[2:].sum()):.4f}; wall {wall:.1f} s "
          f"(the first 2 steps, worker start and compile, left out)")
    print("final:", {k: round(v, 4) for k, v in metrics.items() if isinstance(v, float)})
    good = metrics.get("mAP50", 0.0)
    ok = good >= args.pass_map50
    print(("PASS" if ok else "FAIL") + f": mAP50 {good:.3f} vs gate {args.pass_map50}")
    if args.text_check and ok:
        names = [NAMES[i] for i in range(len(NAMES))]
        eng.set_classes(names, np.roll(np.asarray(eng.txt_feats, np.float32), 1, axis=0))
        bad = model.val(data=str(data), conf=args.conf, plots=False).get("mAP50", 0.0)
        crater = bad <= args.text_check_ratio * good
        print(f"text-check: trained mAP50 {good:.3f} -> shuffled-text {bad:.3f} "
              f"({'PASS' if crater else 'FAIL'}: contrastive heads {'do' if crater else 'do NOT'} "
              "depend on the text rows)")
        return 0 if crater else 1
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
