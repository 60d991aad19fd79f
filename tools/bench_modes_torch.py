#!/usr/bin/env python
"""Serve-request and training-step times of one tree of the port, on the
card, to compare two trees (a parent and its change) in one call.

    python3 tools/bench_modes_torch.py [--root DIR] [--label NAME] [--rounds 5] [--out FILE]

From DIR's tree (this repo when not given), with TF32 off as `chip_smoke.py`
runs:

- serve: the full-width `tamtr.yaml` model (nc 10, seed 0, the head spread
  by DIR's `chip_smoke.py:spread_scores`), `TAMTR.predict` of 1360x765
  uint8 frames with 10 text rows, at batch 1 and 4, in each mode the tree
  takes: fp32, fuse=True, half=True and fuse=True with half=True (a mode
  the tree refuses is left out). After a warm-up request of each, the
  modes run in turns for --rounds rounds; host ms per request (each ends in
  a copy to the host), the median;
- train: `Trainer.step` of the same config at 640 px, batch 4, max_gt 300
  (`chip_smoke.py:synthetic_batch`), in fp32 and, where the tree takes
  `TAMTRModel(dtype=...)`, in bf16: a fresh trainer, 2 warm-up steps, then
  the median host ms of the next 4 (each step ends in a host copy of its
  metrics).

Prints the card's name and power limit, then one JSON line (also written
to --out). Host times on that machine drift between processes: run the
trees in turns, each in its own process (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch


def serve_ms(det, text, rounds: int) -> dict:
    rng = np.random.default_rng(24)
    frames = [rng.integers(0, 256, (765, 1360, 3), dtype=np.uint8) for _ in range(4)]
    modes = {}
    for name, kw in (("fp32", {}), ("fuse", {"fuse": True}), ("half", {"half": True}),
                     ("fuse+half", {"fuse": True, "half": True})):
        try:
            det.predict(frames[0], text, **kw)
            det.predict(frames, text, **kw)
        except NotImplementedError:
            continue
        modes[name] = kw
    times = {f"{m}_b{b}": [] for m in modes for b in (1, 4)}
    for i in range(rounds):
        for m, kw in modes.items():
            for b, images in ((1, frames[i % 4]), (4, frames)):
                t0 = time.perf_counter()
                det.predict(images, text, **kw)
                times[f"{m}_b{b}"].append((time.perf_counter() - t0) * 1e3)
    return {k: float(np.median(v)) for k, v in times.items()}


def step_ms(smoke, dtype) -> float:
    from tamtr_torch.nn.graph import TAMTRModel
    from tamtr_torch.train.trainer import Trainer, TrainConfig
    from tamtr_torch.weights import init_parameters

    kw = {} if dtype is None else {"dtype": dtype}
    model = TAMTRModel.from_cfg("tamtr.yaml", nc=10, max_gt=smoke.TRAIN_MAX_GT, **kw)
    init_parameters(model, 0)
    tr = Trainer(model, TrainConfig(batch_size=smoke.TRAIN_BATCH, accumulate=1), device="cuda", seed=0)
    batches = [smoke.synthetic_batch(300 + i, smoke.TRAIN_BATCH, smoke.TRAIN_IMGSZ, smoke.TRAIN_MAX_GT,
                                     smoke.TRAIN_VALID) for i in range(6)]
    times = []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        tr.step(b)
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    del tr, model
    torch.cuda.empty_cache()
    return float(np.median(times))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--label", default=None)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", type=Path)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_modes_torch: no CUDA device", file=sys.stderr)
        return 1
    root = a.root.resolve()
    os.chdir(root)
    sys.path.insert(0, str(root))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as smoke
    from tamtr_torch import TAMTR

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    det = TAMTR("tamtr.yaml", nc=10, seed=0)
    smoke.spread_scores(det.model, seed=1)
    text = np.random.default_rng(24).standard_normal((10, 512)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    out = {"tree": a.label or str(root), "card": card, "serve_ms": serve_ms(det, text, a.rounds)}
    del det
    torch.cuda.empty_cache()
    out["step_ms"] = {"fp32": step_ms(smoke, None)}
    try:
        out["step_ms"]["bf16"] = step_ms(smoke, torch.bfloat16)
    except TypeError:  # a tree without the compute dtype
        pass
    line = json.dumps(out)
    print(line, flush=True)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
