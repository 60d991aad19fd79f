"""Time the deformable-gather backward (kernel B4) and the matcher's assignment
(kernel B5) on one GPU, at the training step's shapes.

Run from the repo root on a machine with an NVIDIA card:
    python3 tools/bench_gather_bwd_auction.py [--root DIR] [--pairs FILE] [--iters 20] [--out FILE]
    python3 tools/bench_gather_bwd_auction.py --capture FILE

`--root` names the checkout whose `tamtr_torch` is imported (default: the
one that holds this script), so that two trees are timed on the same inputs,
made here from seeded CPU generators:
  - B4, `bilinear_gather_bwd` at value (4, 33600, 8, 64), Q = 700 (the 640 px
    decoder with its dn queries), on sampling pairs from
    `deform_sampling_pairs` at uniform random points and at points whose
    last level is clustered (a few hundred pairs on a start row, as a
    training step's decoder at initialisation gives), and with `--pairs` on
    the pairs of a training step that `--capture` saved; where the tree has
    `pair_buckets`, its two launches are also timed apart (the rows pass as
    the call less the buckets). dvalue and dw against
    `bilinear_gather_bwd_ref`, and whether two calls give bitwise-equal
    dvalue.
  - B5, `tamtr_torch.losses.matcher.auction_assignment` on the matcher's cost
    (16, 100, 300): 4 matched layers x 4 images with 250, 80, 30 and 60 valid
    gts of 300 slots (one over-full, one contested). Besides the CUDA-event
    mean, the host wall of one call that ends in a synchronize.
`--capture FILE` runs three training steps of `tamtr.yaml` (640 px, batch 4,
max_gt 300, `chip_smoke.py`'s seeded batches) with this checkout's
`tamtr_torch` and saves the sampling pairs (idx2, w_pairs) and dout that
reach the gather backward of the last decoder layer in the third; `--pairs`
times B4 on them, with value drawn from a seeded generator.
Mean ms of `--iters` back-to-back calls by CUDA events after a warm-up, and
each kernel's own device ms per call from torch.profiler (`kernel_ms`).
Prints one JSON object with the card's name and power limit, and writes it
to --out when given. TF32 stays off.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

LEVELS_640 = [(160, 160), (80, 80), (40, 40)]
VALID = (250, 80, 30, 60)


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


def wall_ms(fn, iters: int) -> float:
    """Median host ms of one call that ends in a synchronize."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def kernel_ms(fn, iters: int) -> dict:
    """Device ms per call of each CUDA kernel `fn` launches (torch.profiler),
    by kernel name: the launches' own time, without the host's."""
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


def gather_bwd_inputs(dev, B=4, Q=700, nh=8, c=64, P=4, clustered=False):
    """Sampling pairs at the decoder's 640 px shapes; `clustered` snaps the
    last level's points to 3 x 3 cell centres, so a few hundred pairs share
    a start row, as in a training step's decoder at initialisation."""
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


def capture_step_pairs(path: Path) -> None:
    import chip_smoke
    from tamtr_torch import TAMTR
    from tamtr_torch.train.trainer import TrainConfig

    det = TAMTR("tamtr.yaml", nc=10, seed=0, max_gt=chip_smoke.TRAIN_MAX_GT)
    tr = det.trainer(TrainConfig(batch_size=chip_smoke.TRAIN_BATCH, accumulate=1), seed=0)
    seen = []
    for i in range(3):
        seen.clear()
        with chip_smoke.recording_gather_bwd(seen):
            tr.step(chip_smoke.synthetic_batch(100 + i, chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_IMGSZ,
                                               chip_smoke.TRAIN_MAX_GT, chip_smoke.TRAIN_VALID))
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save([dict(value_shape=list(v.shape), idx2=i.cpu(), w_pairs=w.cpu(), dout=d.cpu()) for v, i, w, d in seen],
               path)
    print(json.dumps(dict(captured=str(path), layers=len(seen), value_shape=list(seen[0][0].shape),
                          most_terms_on_a_row=[most_terms_on_a_row(i, v.shape[1]) for v, i, _, _ in seen])))


def step_pairs(path: Path, dev):
    """The captured step's calls, each with a seeded random value."""
    g = torch.Generator().manual_seed(12)
    return [[t.to(dev) for t in (torch.randn(*c["value_shape"], generator=g), c["idx2"], c["w_pairs"], c["dout"])]
            for c in torch.load(path)]


def most_terms_on_a_row(idx2, Lv: int) -> int:
    """The most terms a dvalue row of one (b, h) sums: the pairs starting on
    it and on the row above (after the last-row shift)."""
    s = torch.where(idx2 >= Lv - 1, Lv - 2, idx2).long()
    n = torch.zeros((idx2.shape[0], Lv + 1, idx2.shape[2]), device=idx2.device).scatter_add_(
        1, s, torch.ones_like(s, dtype=torch.float32))
    return int((n[:, 1:] + n[:, :-1]).max())


def matcher_cost(dev, M=300, nq=100, n_images=4):
    from tamtr_torch.losses.matcher import match_cost

    rng = np.random.default_rng(13)
    g = torch.Generator().manual_seed(13)
    mask = torch.from_numpy(np.arange(M)[None] < np.asarray(VALID)[:, None]).repeat(4, 1)
    boxes = np.concatenate([rng.uniform(0.03, 0.97, (n_images, M, 2)), rng.uniform(0.005, 0.08, (n_images, M, 2))], -1)
    gt_b = torch.from_numpy(boxes.astype(np.float32)).repeat(4, 1, 1) * mask[..., None]
    gt_c = torch.from_numpy(rng.integers(0, 10, (n_images, M)).astype(np.int32)).repeat(4, 1)
    n = 4 * n_images
    pred_b = torch.cat([torch.rand(n, nq, 2, generator=g), torch.rand(n, nq, 2, generator=g) * 0.1 + 0.005], -1)
    pred_s = torch.randn(n, nq, 10, generator=g) * 2 - 3
    return match_cost(pred_b.to(dev), pred_s.to(dev), gt_b.to(dev), gt_c.to(dev)), mask.to(dev)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--pairs", type=Path)
    ap.add_argument("--capture", type=Path)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_gather_bwd_auction: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(a.root.resolve()))
    if a.capture:
        capture_step_pairs(a.capture)
        return 0
    ds = importlib.import_module("tamtr_torch.kernels.deform_scatter")
    from tamtr_torch.losses.matcher import auction_assignment

    dev = torch.device("cuda")
    b4 = {}
    for case in ("uniform", "clustered") + (("step",) if a.pairs else ()):
        # a list of calls: the step's are its three decoder layers' (last first)
        calls = step_pairs(a.pairs, dev) if case == "step" else [
            gather_bwd_inputs(dev, clustered=case == "clustered")]
        row = dict(shape=list(calls[0][0].shape), Q=calls[0][3].shape[1], calls=len(calls), most_terms_on_a_row=0,
                   max_abs_err=0.0, bitwise_repeat=True)
        for value, idx2, w_pairs, dout in calls:
            dv, dw = ds.bilinear_gather_bwd(value, idx2, w_pairs, dout)
            dv2, _ = ds.bilinear_gather_bwd(value, idx2, w_pairs, dout)
            dv_ref, dw_ref = ds.bilinear_gather_bwd_ref(value, idx2, w_pairs, dout)
            row["most_terms_on_a_row"] = max(row["most_terms_on_a_row"], most_terms_on_a_row(idx2, value.shape[1]))
            row["max_abs_err"] = max(row["max_abs_err"], (dv - dv_ref).abs().max().item(),
                                     (dw - dw_ref).abs().max().item())
            row["bitwise_repeat"] &= torch.equal(dv, dv2)
            del dv, dw, dv2, dv_ref, dw_ref

        def b4_calls(fn):
            return lambda: [fn(*args) for args in calls]

        per = len(calls)
        row["ms"] = cuda_ms(b4_calls(ds.bilinear_gather_bwd), a.iters) / per
        if hasattr(ds, "pair_buckets"):
            row["ms_buckets"] = cuda_ms(b4_calls(lambda v, i, w, d: ds.pair_buckets(i, w, v.shape[1])), a.iters) / per
            row["ms_rows"] = row["ms"] - row["ms_buckets"]
        row["kernel_ms"] = {k: t / per for k, t in kernel_ms(b4_calls(ds.bilinear_gather_bwd), a.iters).items()}
        b4[case] = row
        del calls
        print(json.dumps({"B4": {case: row}}), file=sys.stderr, flush=True)

    C, mask = matcher_cost(dev)
    first = auction_assignment(C, mask)
    same = torch.equal(auction_assignment(C, mask), first)
    b5_row = dict(same_as_first=same, assigned=(first[:4] >= 0).sum(1).tolist(),
                  ms=cuda_ms(lambda: auction_assignment(C, mask), a.iters),
                  wall_ms=wall_ms(lambda: auction_assignment(C, mask), a.iters),
                  kernel_ms=kernel_ms(lambda: auction_assignment(C, mask), a.iters))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    res = {"card": smi, "root": str(a.root), "iters": a.iters, "B4": b4, "B5": b5_row}
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
