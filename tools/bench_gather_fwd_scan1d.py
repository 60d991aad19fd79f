"""Time the deformable pair gather forward (kernel B2) and the one-direction
S6 scan (kernel B6) on one GPU.

Run from the repo root on a machine with an NVIDIA card:
    python3 tools/bench_gather_fwd_scan1d.py [--root DIR] [--pairs FILE] [--iters 20] [--hash] [--out FILE]

`--root` names the checkout whose `tamtr_torch` is imported (default: the
one that holds this script), so that two trees are timed on the same inputs,
made here from seeded CPU generators:
  - B2 at value (1, 33600, 8, 64), Q = 100 (the serve shape), at
    (4, 33600, 8, 64), Q = 700 on uniform pairs (the training shape, dn
    queries included), and with `--pairs` on the pairs of a training step
    that `tools/bench_gather_bwd_auction.py --capture` saved (its three
    decoder layers, a seeded value): the largest error against the plain
    pair form, whether two calls are bitwise equal, `ms`, the mean of
    `--iters` back-to-back calls by CUDA events (the host's enqueue
    included: at the serve shape that is the wrapper's host time), and
    `ms_device`, the kernel's own time per call by torch.profiler.
  - B6, `selective_scan` at the three 640 px levels (G = 4: one image x 4
    directions, N = 16): the largest error against `selective_scan_ref`,
    whether two calls are bitwise equal, the call's ms by CUDA events, and
    each kernel's device ms per call by torch.profiler (the three phases
    where the tree has them).
  - With `--hash`, sha256 digests of B1's output (`ss2d_scan`, the three
    levels at batch 1) and of B3's eight gradients (`ss2d_scan_bwd`, the
    three levels at batch 1) on seeded inputs: two trees whose digests are
    equal give bitwise-equal outputs.
Prints one JSON object with the card's name and power limit, and writes it
to --out when given. TF32 stays off.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import torch

LEVELS_640 = [(160, 160, 128), (80, 80, 256), (40, 40, 512)]


def cuda_ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, iters: int) -> dict:
    """Device ms per call of each CUDA kernel `fn` launches (torch.profiler),
    by kernel name (without its namespace and arguments)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            name = re.sub(r"^void |\(anonymous namespace\)::", "", evt.name)
            name = re.split(r"[<(]", name)[0]
            times[name] = times.get(name, 0.0) + evt.device_time / 1e3 / iters
    return times


def pairs_ref(value, idx2, w_pairs, ppq: int):
    """The pair form, plainly: sum over a query's pairs of wa value[i] +
    wb value[i + 1], pairs on the global last row shifted up one row with
    their weights swapped."""
    B, Lv, nh, c = value.shape
    nU2 = idx2.shape[1]
    at_end = idx2 >= Lv - 1
    i0 = torch.where(at_end, Lv - 2, idx2).long()[..., None].expand(B, nU2, nh, c)
    w = torch.where(at_end[..., None], w_pairs.flip(-1), w_pairs)
    rows = w[..., :1] * value.gather(1, i0) + w[..., 1:] * value.gather(1, i0 + 1)
    return rows.view(B, nU2 // ppq, ppq, nh, c).sum(2)


def gather_inputs(seed: int, B: int, Q: int, dev, nh=8, c=64, P=4):
    """value, pair starts and weight pairs at the decoder's 640 px shapes,
    uniform sample points, one in the global last pixel cell."""
    from tamtr_torch.nn.decoder import deform_sampling_pairs

    shapes = [(h, w) for h, w, _ in LEVELS_640]
    g = torch.Generator().manual_seed(seed)
    nl = len(shapes)
    Lv = sum(h * w for h, w in shapes)
    value = torch.randn(B, Lv, nh, c, generator=g)
    loc = torch.rand(B, Q, nh, nl, P, 2, generator=g) * 1.1 - 0.05
    loc[0, 0, 0, 2, 0] = torch.tensor([1 - 0.2 / 40, 1 - 0.2 / 40])
    w_att = torch.rand(B, Q, nh, nl, P, generator=g)
    w_att = w_att / w_att.sum((-1, -2), keepdim=True)
    _, w_pairs, idx2 = deform_sampling_pairs(shapes, loc.to(dev), w_att.to(dev))
    return value.to(dev), idx2, w_pairs


def step_pairs(path: Path, dev):
    """The captured step's calls, each with a seeded random value."""
    g = torch.Generator().manual_seed(12)
    return [(torch.randn(*c["value_shape"], generator=g).to(dev), c["idx2"].to(dev), c["w_pairs"].to(dev),
             c["dout"].shape[1]) for c in torch.load(path)]


def bench_b2(ds, calls, iters: int) -> dict:
    """B2 over `calls` [(value, idx2, w_pairs, Q)]: per call means."""
    row = dict(calls=len(calls), shape=list(calls[0][0].shape), Q=calls[0][3], max_abs_err=0.0, bitwise_repeat=True)
    for value, idx2, w_pairs, Q in calls:
        P = idx2.shape[1] // Q // 2
        out = ds._gather_fwd_cuda(value, idx2, w_pairs, P)
        again = ds._gather_fwd_cuda(value, idx2, w_pairs, P)
        want = pairs_ref(value, idx2, w_pairs, 2 * P)
        row["max_abs_err"] = max(row["max_abs_err"], (out - want).abs().max().item())
        row["bitwise_repeat"] &= torch.equal(out, again)
        del out, again, want
    every = lambda: [ds._gather_fwd_cuda(v, i, w, i.shape[1] // q // 2) for v, i, w, q in calls]  # noqa: E731
    row["ms"] = cuda_ms(every, iters) / len(calls)
    row["kernel_ms"] = {k: t / len(calls) for k, t in kernel_ms(every, iters).items()}
    row["ms_device"] = sum(row["kernel_ms"].values())
    return row


def scan1d_inputs(seed: int, L: int, Din: int, dev, G: int = 4, N: int = 16):
    from tamtr_torch.weights import dt_bias_init

    g = torch.Generator().manual_seed(seed)
    u = torch.randn(G, L, Din, generator=g)
    dt = torch.randn(G, L, Din, generator=g) * 0.1 + dt_bias_init((G, 1, Din), g)
    delta = dt.clamp(min=0) + torch.log1p(torch.exp(-dt.abs()))
    A = -torch.arange(1, N + 1, dtype=torch.float32).expand(G, Din, N).contiguous()
    Bs, Cs = torch.randn(G, L, N, generator=g), torch.randn(G, L, N, generator=g)
    return [t.to(dev) for t in (u, delta, A, Bs, Cs, torch.ones(G, Din))]


def bench_b6(ss, dev, iters: int) -> list:
    rows = []
    for lvl, (H, W, C) in enumerate(LEVELS_640):
        args = scan1d_inputs(200 + lvl, H * W, 2 * C, dev)
        with torch.no_grad():
            y, again, want = ss.selective_scan(*args), ss.selective_scan(*args), ss.selective_scan_ref(*args)
            torch.cuda.synchronize()
            row = dict(level=lvl, G=4, L=H * W, Din=2 * C, max_abs_err=(y - want).abs().max().item(),
                       bitwise_repeat=torch.equal(y, again), finite=bool(torch.isfinite(y).all()))
            del y, again, want
            row["ms"] = cuda_ms(lambda: ss.selective_scan(*args), iters)
            row["kernel_ms"] = kernel_ms(lambda: ss.selective_scan(*args), iters)
        rows.append(row)
        print(json.dumps({"B6": row}), file=sys.stderr, flush=True)
        del args
    return rows


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def ss2d_hashes(ss, dev) -> dict:
    """sha256 of B1's y and of B3's eight gradients per level, batch 1."""
    from tamtr_torch.weights import dt_bias_init

    out = {}
    for lvl, (H, W, C) in enumerate(LEVELS_640):
        g = torch.Generator().manual_seed(300 + lvl)
        L, D, R, N = H * W, 2 * C, math.ceil(C / 16), 16
        layouts = torch.randn(1, 2, L, D, generator=g)
        x_dbl = torch.randn(1, 2, 2, L, R + 2 * N, generator=g) * 0.6
        dt_w = (torch.rand(4, D, R, generator=g) * 2 - 1) * R**-0.5
        dt_b = dt_bias_init((4, D), g)
        A = -torch.arange(1, N + 1, dtype=torch.float32).expand(4, D, N).contiguous()
        dy = torch.randn(1, 4, L, D, generator=g)
        dts_raw, Bs, Cs = x_dbl.to(dev).split([R, N, N], -1)
        args = [layouts.to(dev), dts_raw, dt_w.to(dev), dt_b.to(dev), A.to(dev), Bs, Cs, torch.ones(4, D, device=dev)]
        with torch.no_grad():
            out[f"b1_level{lvl}"] = digest([ss.ss2d_scan(*args)])
            out[f"b3_level{lvl}"] = digest(ss.ss2d_scan_bwd(*args, dy.to(dev)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--pairs", type=Path)
    ap.add_argument("--hash", action="store_true")
    ap.add_argument("--out", type=Path)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_gather_fwd_scan1d: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(a.root.resolve()))
    ds = importlib.import_module("tamtr_torch.kernels.deform_scatter")
    ss = importlib.import_module("tamtr_torch.kernels.selective_scan")

    dev = torch.device("cuda")
    b2 = {}
    for case in ("serve", "train") + (("step",) if a.pairs else ()):
        if case == "step":
            calls = step_pairs(a.pairs, dev)
        else:
            B, Q = (1, 100) if case == "serve" else (4, 700)
            calls = [(*gather_inputs(100 + B, B, Q, dev), Q)]
        b2[case] = bench_b2(ds, calls, a.iters * (5 if case == "serve" else 1))
        del calls
        print(json.dumps({"B2": {case: b2[case]}}), file=sys.stderr, flush=True)
    b6 = bench_b6(ss, dev, a.iters)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    res = {"card": smi, "root": str(a.root), "iters": a.iters, "B2": b2, "B6": b6,
           "B6_ms_sum": sum(r["ms"] for r in b6)}
    if a.hash:
        res["hashes"] = ss2d_hashes(ss, dev)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
