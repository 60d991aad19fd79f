"""Time the row scatter (kernel B7), the pair scatter (B8) and the gather
backward (B4), which share the buckets launch and the rows pass of
`tamtr_torch/csrc/row_buckets.cuh`, on one GPU at the 640 px decoder shapes.

Run from the repo root on a machine with an NVIDIA card:
    python3 tools/bench_scatter_rows.py [--root DIR] [--pairs FILE] [--iters 20] [--out FILE]

`--root` names the checkout whose `tamtr_torch` is imported (default: the
one that holds this script), so that two trees are timed on the same inputs,
made here from seeded CPU generators: value (4, 33600, 8, 64), Q = 700 (the
decoder with its dn queries) and sampling pairs from `deform_sampling_pairs`
at uniform random points ("uniform") and at points whose last level is
snapped to 3 x 3 cell centres ("clustered": hundreds of pairs on a start
row), the same inputs as `tools/bench_gather_bwd_auction.py`; with `--pairs`
also on the pairs of a training step that its `--capture` saved ("step": the
three decoder layers' calls). From each (idx2, w_pairs, dout):
  - B4, `bilinear_gather_bwd` as the step calls it, and the sha256 of its
    dvalue and dw (a tree that keeps B4's arithmetic gives the same digests);
  - B8, `scatter_acc_pairs` on the pairs after the last-row shift, per
    (b, h) group: G = 32, L2 = 33600, 24 pairs a query;
  - B7, `scatter_acc` on the pairs' rows, idx2 and idx2 + 1 with their
    weights (p4 = 48), on value's rows.
Each against its plain version (max error) and against itself over two
calls (bitwise); mean ms of `--iters` back-to-back calls by CUDA events after
a warm-up, the buckets launch alone where the tree has it
(`pair_buckets`, `scatter_acc_buckets`, `scatter_acc_pairs_buckets`), each
kernel's own device ms per call (torch.profiler, `kernel_ms`), and
`scatter_add_` of the same updates (`library_ms`). Prints one JSON object
with the card's name and power limit, and writes it to --out when given.
TF32 stays off.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

LEVELS_640 = [(160, 160), (80, 80), (40, 40)]


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
    by kernel name."""
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
            times[evt.name[:60]] = times.get(evt.name[:60], 0.0) + evt.device_time / 1e3 / iters
    return times


def sha256(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def gather_inputs(dev, clustered: bool, B=4, Q=700, nh=8, c=64, P=4):
    """value, idx2, w_pairs, dout as `tools/bench_gather_bwd_auction.py`
    makes them (seed 12)."""
    from tamtr_torch.nn.decoder import deform_sampling_pairs

    g = torch.Generator().manual_seed(12)
    nl = len(LEVELS_640)
    Lv = sum(h * w for h, w in LEVELS_640)
    value = torch.randn(B, Lv, nh, c, generator=g)
    loc = torch.rand(B, Q, nh, nl, P, 2, generator=g) * 1.1 - 0.05
    if clustered:
        loc[:, :, :, 2] = (torch.floor(loc[:, :, :, 2].clamp(0, 0.999) * 3) + 0.5) / 3
    loc[0, 0, 0, 2, 0] = torch.tensor([1 - 0.2 / 40, 1 - 0.2 / 40])  # the global last pixel cell
    w_att = torch.rand(B, Q, nh, nl, P, generator=g)
    w_att = w_att / w_att.sum((-1, -2), keepdim=True)
    dout = torch.randn(B, Q, nh, c, generator=g)
    _, w_pairs, idx2 = deform_sampling_pairs(LEVELS_640, loc, w_att)
    return [t.to(dev) for t in (value, idx2, w_pairs, dout)]


def step_inputs(path: Path, dev):
    """The captured step's calls, each with a seeded random value."""
    g = torch.Generator().manual_seed(12)
    return [[t.to(dev) for t in (torch.randn(*c["value_shape"], generator=g), c["idx2"], c["w_pairs"], c["dout"])]
            for c in torch.load(path)]


def scatter_inputs(value, idx2, w_pairs, dout):
    """B7's (idx, w, dout, L) on the pairs' two rows and B8's (idx2, wa, wb,
    dout, L2) per (b, h) group, both after the last-row shift."""
    B, Lv, nh, c = value.shape
    nU2, Q = idx2.shape[1], dout.shape[1]
    at_end = idx2 >= Lv - 1
    i2 = torch.where(at_end, Lv - 2, idx2)
    wp = torch.where(at_end[..., None], w_pairs.flip(-1), w_pairs)
    rows = torch.stack([i2, i2 + 1], 2).reshape(B, 2 * nU2, nh).contiguous()
    w = wp.transpose(2, 3).reshape(B, 2 * nU2, nh).contiguous()
    per_g = lambda t: t.transpose(1, 2).reshape(B * nh, nU2).contiguous()  # noqa: E731
    pairs = (per_g(i2), per_g(wp[..., 0]), per_g(wp[..., 1]), dout.transpose(1, 2).reshape(B * nh, Q, c).contiguous())
    return (rows, w, dout, Lv), (*pairs, Lv)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--pairs", type=Path)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_scatter_rows: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(a.root.resolve()))
    ds = importlib.import_module("tamtr_torch.kernels.deform_scatter")
    dev = torch.device("cuda")
    res = {}
    for case in ("uniform", "clustered") + (("step",) if a.pairs else ()):
        calls = step_inputs(a.pairs, dev) if case == "step" else [gather_inputs(dev, case == "clustered")]
        row = {k: dict(max_abs_err=0.0, bitwise_repeat=True) for k in ("B4", "B7", "B8")}
        b4_digests, jobs = [], {"B4": [], "B7": [], "B8": []}
        for value, idx2, w_pairs, dout in calls:
            rows_args, pairs_args = scatter_inputs(value, idx2, w_pairs, dout)
            work = {"B4": (ds.bilinear_gather_bwd, ds.bilinear_gather_bwd_ref, (value, idx2, w_pairs, dout)),
                    "B7": (ds.scatter_acc, ds.scatter_acc_ref, rows_args),
                    "B8": (ds.scatter_acc_pairs, ds.scatter_acc_pairs_ref, pairs_args)}
            for k, (fn, ref, args) in work.items():
                got, again, want = fn(*args), fn(*args), ref(*args)
                got, again, want = ((t,) if torch.is_tensor(t) else t for t in (got, again, want))
                row[k]["bitwise_repeat"] &= all(torch.equal(x, y) for x, y in zip(got, again))
                row[k]["max_abs_err"] = max(row[k]["max_abs_err"],
                                            max((x - y).abs().max().item() for x, y in zip(got, want)))
                if k == "B4":
                    b4_digests.append(sha256(*got))
                jobs[k].append(args)
                del got, again, want
        row["B4"]["sha256_dvalue_dw"] = b4_digests
        # the buckets launch alone, from each call's arguments
        buckets = {"B4": ("pair_buckets", lambda v, i2, w, d: (i2, w, v.shape[1])),
                   "B7": ("scatter_acc_buckets", lambda i, w, d, L: (i, w, L)),
                   "B8": ("scatter_acc_pairs_buckets", lambda i, wa, wb, d, L: (i, wa, wb, L))}
        for k, fn in (("B4", ds.bilinear_gather_bwd), ("B7", ds.scatter_acc), ("B8", ds.scatter_acc_pairs)):
            per = len(jobs[k])
            row[k]["ms"] = cuda_ms(lambda: [fn(*x) for x in jobs[k]], a.iters) / per
            name, pick = buckets[k]
            if hasattr(ds, name):
                launch = getattr(ds, name)
                row[k]["ms_buckets"] = cuda_ms(lambda: [launch(*pick(*x)) for x in jobs[k]], a.iters) / per
                row[k]["ms_rows"] = row[k]["ms"] - row[k]["ms_buckets"]
            row[k]["kernel_ms"] = {n: t / per for n, t in kernel_ms(lambda: [fn(*x) for x in jobs[k]], a.iters).items()}
        # the library call: scatter_add_ of B7's and B8's updates into a zeroed output
        lib = []
        for idx, w, d, L in jobs["B7"]:
            B, n, nh = idx.shape
            upd = w[..., None] * d.repeat_interleave(n // d.shape[1], 1)
            index = idx.long()[..., None].expand(B, n, nh, d.shape[-1])
            lib.append((index, upd, (B, L, nh, d.shape[-1])))
        row["B7"]["library_ms"] = cuda_ms(lambda: [torch.zeros(s, device=dev).scatter_add_(1, i, u) for i, u, s in lib],
                                          max(a.iters // 4, 3)) / len(lib)
        lib = []
        for idx2, wa, wb, d, L2 in jobs["B8"]:
            G, n = idx2.shape
            dd = d.repeat_interleave(n // d.shape[1], 1)
            ia = idx2.long()[..., None].expand(G, n, d.shape[-1])
            lib.append((ia, wa[..., None] * dd, wb[..., None] * dd, (G, L2, d.shape[-1])))
        row["B8"]["library_ms"] = cuda_ms(
            lambda: [torch.zeros(s, device=dev).scatter_add_(1, i, ua).scatter_add_(1, i + 1, ub) for i, ua, ub, s in lib],
            max(a.iters // 4, 3)) / len(lib)
        del lib, jobs, calls
        res[case] = row
        print(json.dumps({case: row}), file=sys.stderr, flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"card": smi, "root": str(a.root), "iters": a.iters, **res}
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
