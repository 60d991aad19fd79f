"""Time the SS2D scan forward (`ss2d_scan`, kernel B1) at the 640 px levels on one GPU.

Run from the repo root on a machine with an NVIDIA card:
    python3 tools/bench_ss2d_fwd.py [--root DIR] [--batch 1 4] [--iters 20] [--out FILE]

`--root` names the checkout whose `tamtr_torch` is imported (default: the
one that holds this script), so that two trees are timed on the same
inputs: one CPU generator seeded per level and batch makes the layouts, the
x_proj result that dts_raw, Bs and Cs are split from, and the weights with
the model's init of dt_b, A and Ds. Per level and batch: the kernel's
largest error against `ss2d_scan_ref`, whether two calls are bitwise equal,
and the mean ms of `--iters` back-to-back calls by CUDA events after a
warm-up. Prints one JSON object with the card's name and power limit, and
writes it to --out when given. TF32 stays off.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

LEVELS_640 = [(160, 160, 128), (80, 80, 256), (40, 40, 512)]


def scan_inputs(seed: int, B: int, H: int, W: int, C: int, dev):
    from tamtr_torch.weights import dt_bias_init

    g = torch.Generator().manual_seed(seed)
    L, D, R, N = H * W, 2 * C, math.ceil(C / 16), 16
    layouts = torch.randn(B, 2, L, D, generator=g)
    x_dbl = torch.randn(B, 2, 2, L, R + 2 * N, generator=g) * 0.6
    dt_w = (torch.rand(4, D, R, generator=g) * 2 - 1) * R**-0.5
    dt_b = dt_bias_init((4, D), g)
    A = -torch.arange(1, N + 1, dtype=torch.float32).expand(4, D, N).contiguous()
    dts_raw, Bs, Cs = x_dbl.to(dev).split([R, N, N], -1)
    return [layouts.to(dev), dts_raw, dt_w.to(dev), dt_b.to(dev), A.to(dev), Bs, Cs, torch.ones(4, D, device=dev)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", type=Path)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_ss2d_fwd: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(a.root.resolve()))
    from tamtr_torch.kernels.selective_scan import ss2d_scan, ss2d_scan_ref

    dev = torch.device("cuda")
    rows = []
    for B in a.batch:
        for lvl, (H, W, C) in enumerate(LEVELS_640):
            args = scan_inputs(100 * B + lvl, B, H, W, C, dev)
            with torch.no_grad():
                y, again, want = ss2d_scan(*args), ss2d_scan(*args), ss2d_scan_ref(*args)
                torch.cuda.synchronize()
                for _ in range(2):
                    ss2d_scan(*args)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(a.iters):
                    ss2d_scan(*args)
                end.record()
                end.synchronize()
            rows.append(dict(batch=B, level=lvl, L=H * W, D=2 * C, ms=start.elapsed_time(end) / a.iters,
                             max_abs_err=(y - want).abs().max().item(), bitwise_repeat=torch.equal(y, again),
                             finite=bool(torch.isfinite(y).all())))
            print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
            del args, y, again, want
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    res = {"card": smi, "root": str(a.root), "iters": a.iters, "rows": rows,
           "ms_over_levels": {B: sum(r["ms"] for r in rows if r["batch"] == B) for B in a.batch}}
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
