"""Smoke run of the PyTorch port (`tamtr_torch`) on one NVIDIA H100.

Run from the root of a checkout: `python3 chip_smoke.py`. Phases:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions. Without a card the script exits non-zero and prints no result.
2. build: nvcc over `tamtr_torch/csrc/*.cu` (one process per source, all
   started together); prints the seconds and the ptxas register lines.
3. kernels: each hand-written kernel against its plain PyTorch version at the
   640 px main-path shapes: the SS2D scan forward (B1: segment summaries,
   the combine across segments, the output pass) at its three levels, B=1
   and B=4 (1e-4), two calls bitwise equal, the call and each launch timed
   and bounded with its resident blocks per SM; the bilinear pair gather (B2)
   at value (1, 33600, 8, 64), Q=100, and (4, 33600, 8, 64), Q=700 (1e-5),
   two calls bitwise equal, timed (CUDA events, and device time by
   torch.profiler) and bounded at both (and again in the train phase on the
   training step's own pairs); the scan backward (B3a
   segment summaries, the combine across segments, B3b segment walk) at the
   three levels, B=4, all eight gradients (2e-3), two calls bitwise equal,
   each launch timed and bounded on its own with its resident blocks per SM;
   the gather backward (B4: pair buckets, then the row-owned pass) at value
   (4, 33600, 8, 64), Q=700, dvalue, dw and the gradient to sampling
   locations and attention weights (1e-5), the buckets equal to their plain
   version, dvalue bitwise over two calls and equal to the plain row-owned
   version, also on a row of 1440 terms, each launch timed (and again in
   the train phase on the training step's own pairs: hundreds of terms on
   a row); the matcher's
   assignment (B5, `auction_assignment`, one launch) at cost (16, 100, 300)
   from the matcher's cost over a VisDrone-like batch with an over-full and a
   contested image, identical to the CPU's, with no host sync, and
   `auction_match` (two launches) identical to its plain version. Times
   from CUDA events, warm; the bound from this run's bytes and operations.
   Then the kernels of the one-direction scan and the scatters, and the
   auction at any size: B6 `selective_scan` (segment summaries, the combine
   across segments, the output pass) at G = 4 (one image x 4 directions)
   and (L, Din) = (25600, 256), (6400, 512), (1600, 1024), N = 16, and at a
   ragged L = 1619, Din = 1000 without D (1e-4), two calls bitwise equal,
   three launches a call, the call and each launch timed and bounded with
   its resident blocks per SM; B7 `scatter_acc` (the value gradient of
   `weighted_gather`: buckets, then the rows pass) at value
   (4, 33600, 8, 64), Q = 700, p4 = 48, and B8 `scatter_acc_pairs` (the
   same two launches) at G = 32, L2 = 33600, c = 64, Q = 700, 24 pairs per
   query, each on uniform and on clustered sampling points: 1e-5 from the
   plain version (uniform), bitwise over two calls and bitwise the plain
   row-owned version, the buckets equal to theirs, within each row's fp32
   summation bound of the fp64 sum; the call and the buckets launch timed,
   beside `scatter_add_` of the same updates; B5 (`auction_assignment` and
   `auction_match`) at 160 problems of (100, 300) and 16 of (100, 600),
   beyond a block's shared memory, over-full problems in both (identical
   assignments).
4. ops: the public ops off the model paths, with every launch counter
   zeroed just before and read just after: `nn.ssm.selective_scan` forward
   (one call, three launches) and backward at the three level shapes, `weighted_gather` forward and
   backward and `scatter_acc_pairs` at the decoder shapes, `auction_match`
   (batch-wide stop, row mask) on the transposed train cost. Each of B6-B8
   and `auction_match` must have launched; serve and train count 0 for
   them.
5. parity: the full-width `tamtr.yaml` model (nc=10) at 128 px, batch 2,
   on the card and on the CPU with the same state dict, compared as a
   tie-robust set at 1e-3. The whole run keeps TF32 off (full fp32).
6. train parity: the same model at 128 px, batch 2, max_gt 8, CDN noise
   and DropPath off: loss components, assignments, gradients and the
   parameters after one `Trainer.step`, card against CPU; the gradients with
   the CPU's assignment and top-k order held fixed, bounded against the fp32
   noise floor a CPU fp64 pass measures (`check_train_parity`).
7. serve: `TAMTR("tamtr.yaml", nc=10)` on the card answers a warm-up
   request at batch 1 and at batch 4, then 5 batch-1 requests and one
   batch-4 request of 1360x765 uint8 images (resized to 640 px on the card).
   Every launch counter is zeroed just before and read just after: each
   must equal `FORWARD_LAUNCHES` times the forwards.
8. train: `TAMTR(...).trainer()` on `tamtr.yaml` at 640 px, batch 4,
   max_gt 300, accumulate 1, seeded synthetic batches (uint8 frames, 10
   classes, 30-250 valid gts per image, one over-full image); 2 warm-up
   steps, then every launch counter is zeroed, 5 timed steps run, and the
   counters must equal `TRAIN_LAUNCHES_PER_STEP` times 5.
9. fit: the dataset path. `Engine.train` on the generated dataset of
   `tools/smoke_train_torch.py` (640 px PNGs, 16 train and 8 val images,
   max_gt 32) with `tamtr.yaml` (nc 3): 2 epochs at batch 4, 2 loader
   workers, warmup 4, val and `last` each epoch; then `resume=True` for a
   third epoch, and `Engine.val` on `best`. Losses finite, metrics in
   [0, 1], 3 rows in results.csv, the resumed run's epoch, ni, count and
   generator those of the checkpoint; the launch counters (zeroed before
   train and before val) equal the per-step and per-forward counts times
   the steps and forwards; the card's val forward on 2 val images equal to
   the CPU's with the same EMA weights (`same_set`). One JSON line: step ms,
   loader wait, val images/s, mAP, peak memory.
10. One JSON line of per-kernel numbers (`launches_fit`: the fit phase's),
   then the result line `{"ok": true, "device": {...}}` last.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# the model's per-level shapes at 640 px: (H, W) and channels of the SS2D mixers
LEVELS_640 = [(160, 160, 128), (80, 80, 256), (40, 40, 512)]
# the training path: 4 images of 640 px, 300 gt slots; image 0 holds more
# valid gts than the 100 queries (over-full), image 1 >= 70 (contested)
TRAIN_BATCH, TRAIN_IMGSZ, TRAIN_MAX_GT = 4, 640, 300
TRAIN_VALID = (250, 80, 30, 60)
WARMUP_STEPS, TIMED_STEPS = 2, 5
# launches per forward of the model: the scan (`ss2d_scan`, one a call, and
# its three launches: summaries, combine, output) once per VSS level, the
# gather once per decoder layer
FORWARD_LAUNCHES = {
    "ss2d_scan_fwd": 3, "ss2d_scan_fwd_summaries": 3, "ss2d_scan_fwd_combine": 3, "ss2d_scan_fwd_output": 3,
    "bilinear_gather_fwd": 3,
}
# launches per training step: the forward's, and the backward kernels of the
# scan (summaries, combine, walk) and the gather (buckets, rows) once per VSS
# level / decoder layer; the assignment once for the 4 matched layers x 4
# images in one launch (the over-full image solved transposed in it)
TRAIN_LAUNCHES_PER_STEP = {
    **FORWARD_LAUNCHES, "ss2d_scan_carriers": 3, "ss2d_scan_combine": 3, "ss2d_scan_bwd_walk": 3,
    "pair_buckets": 3, "bilinear_gather_bwd": 3, "auction_assignment": 1, "auction_match": 0,
    "selective_scan_fwd": 0, "selective_scan_fwd_summaries": 0, "selective_scan_fwd_combine": 0,
    "selective_scan_fwd_output": 0, "scatter_acc_buckets": 0, "scatter_acc": 0, "scatter_acc_pairs_buckets": 0,
    "scatter_acc_pairs": 0,
}
# calls of the ops phase: the scan at the three levels (one a call, and its
# three launches: summaries, combine, output), one weighted gather's
# backward and one pair scatter (each two launches: buckets, rows), one
# `auction_match` (two launches)
OPS_LAUNCHES = {"selective_scan_fwd": 3, "selective_scan_fwd_summaries": 3, "selective_scan_fwd_combine": 3,
                "selective_scan_fwd_output": 3, "scatter_acc_buckets": 1, "scatter_acc": 1,
                "scatter_acc_pairs_buckets": 1, "scatter_acc_pairs": 1, "auction_match": 1}
# the fit phase: the generated dataset of tools/smoke_train_torch.py
FIT_TRAIN, FIT_VAL, FIT_MAX_GT = 16, 8, 32
# the decoder's sampling at 640 px: batch 4, Q = 700 (dn queries included)
DEFORM_B, DEFORM_Q = 4, 700


def launch_counters():
    """Every kernel wrapper of the port, by kernel name."""
    from tamtr_torch.kernels.auction import auction_assignment, auction_match
    from tamtr_torch.kernels.deform_scatter import (
        bilinear_gather, bilinear_gather_bwd, pair_buckets, scatter_acc, scatter_acc_buckets, scatter_acc_pairs,
        scatter_acc_pairs_buckets,
    )
    from tamtr_torch.kernels.selective_scan import (
        selective_scan, selective_scan_fwd_combine, selective_scan_fwd_output, selective_scan_fwd_summaries,
        ss2d_scan, ss2d_scan_bwd_walk, ss2d_scan_carriers, ss2d_scan_combine, ss2d_scan_fwd_combine,
        ss2d_scan_fwd_output, ss2d_scan_fwd_summaries,
    )

    return {"ss2d_scan_fwd": ss2d_scan, "ss2d_scan_fwd_summaries": ss2d_scan_fwd_summaries,
            "ss2d_scan_fwd_combine": ss2d_scan_fwd_combine, "ss2d_scan_fwd_output": ss2d_scan_fwd_output,
            "bilinear_gather_fwd": bilinear_gather,
            "ss2d_scan_carriers": ss2d_scan_carriers, "ss2d_scan_combine": ss2d_scan_combine,
            "ss2d_scan_bwd_walk": ss2d_scan_bwd_walk,
            "pair_buckets": pair_buckets, "bilinear_gather_bwd": bilinear_gather_bwd,
            "auction_assignment": auction_assignment, "auction_match": auction_match,
            "selective_scan_fwd": selective_scan, "selective_scan_fwd_summaries": selective_scan_fwd_summaries,
            "selective_scan_fwd_combine": selective_scan_fwd_combine,
            "selective_scan_fwd_output": selective_scan_fwd_output, "scatter_acc_buckets": scatter_acc_buckets,
            "scatter_acc": scatter_acc, "scatter_acc_pairs_buckets": scatter_acc_pairs_buckets,
            "scatter_acc_pairs": scatter_acc_pairs}


def zero_counters():
    counters = launch_counters()
    for f in counters.values():
        f.launches = 0
    return counters


def synthetic_batch(seed: int, B: int, imgsz: int, M: int, n_valid, nc: int = 10, hd: int = 512):
    """A seeded VisDrone-like training batch: uint8 frames, small boxes
    (cxcywh, normalized), nc classes, n_valid[i] valid gts of M slots,
    unit-norm class text embeddings."""
    rng = np.random.default_rng(seed)
    mask = np.arange(M)[None] < np.asarray(n_valid)[:, None]
    boxes = np.concatenate([rng.uniform(0.03, 0.97, (B, M, 2)), rng.uniform(0.005, 0.08, (B, M, 2))], -1)
    txt = rng.standard_normal((1, nc, hd)).astype(np.float32)
    return {"img": rng.integers(0, 256, (B, imgsz, imgsz, 3), dtype=np.uint8),
            "txt_feats": txt / np.linalg.norm(txt, axis=-1, keepdims=True),
            "cls": rng.integers(0, nc, (B, M)).astype(np.int32),
            "bboxes": (boxes * mask[..., None]).astype(np.float32), "mask": mask}


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean ms of `fn` over `iters` back-to-back launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Device ms per call of the CUDA kernels `fn` launches, summed, by
    torch.profiler: the launches' own time, without the host's enqueue
    (which CUDA events over back-to-back calls include once a kernel is
    shorter than its wrapper's host time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session now and then records no kernel at all
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.device_time for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / iters
    raise AssertionError("torch.profiler recorded no device time in three sessions")


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_inputs(g, B, H, W, C, dev):
    """Scan inputs at one level as SS2D passes them (dts_raw/Bs/Cs split
    from one x_proj result), with the model's init for dt_b, A and Ds, and a
    random dy for the backward."""
    from tamtr_torch.weights import dt_bias_init

    L, D, R, N = H * W, 2 * C, math.ceil(C / 16), 16
    layouts = torch.randn(B, 2, L, D, generator=g)
    x_dbl = torch.randn(B, 2, 2, L, R + 2 * N, generator=g) * 0.6
    dt_w = (torch.rand(4, D, R, generator=g) * 2 - 1) * R**-0.5
    dt_b = dt_bias_init((4, D), g)
    A = -torch.arange(1, N + 1, dtype=torch.float32).expand(4, D, N).contiguous()
    Ds = torch.ones(4, D)
    dy = torch.randn(B, 4, L, D, generator=g)
    dts_raw, Bs, Cs = x_dbl.to(dev).split([R, N, N], -1)
    return [layouts.to(dev), dts_raw, dt_w.to(dev), dt_b.to(dev), A.to(dev), Bs, Cs, Ds.to(dev)], dy.to(dev)


def deform_inputs(g, B, Q, shapes, dev, nh=8, c=64, nl=3, P=4):
    """value, sampling locations and attention weights at the decoder's
    shapes, with a point in the global last pixel cell, one at x0 < 0 and
    one on a level boundary."""
    Lv = sum(h * w for h, w in shapes)
    value = torch.randn(B, Lv, nh, c, generator=g)
    loc = torch.rand(B, Q, nh, nl, P, 2, generator=g) * 1.1 - 0.05
    H2, W2 = shapes[2]
    loc[0, 0, 0, 2, 0] = torch.tensor([1 - 0.2 / W2, 1 - 0.2 / H2])  # last pixel cell of level 2
    loc[0, 1, 1, 0, 2] = torch.tensor([0.2 / shapes[0][1], 0.5])  # x0 < 0
    loc[0, 2, 0, 0, 3] = torch.tensor([1 - 0.3 / shapes[0][1], 1 - 0.3 / shapes[0][0]])  # level boundary
    w_att = torch.rand(B, Q, nh, nl, P, generator=g)
    w_att = w_att / w_att.sum((-1, -2), keepdim=True)
    return value.to(dev), loc.to(dev), w_att.to(dev)


def check_ss2d_scan(dev, batches=(1, TRAIN_BATCH)):
    """Kernel B1 vs its plain version at the three 640 px levels, batch 1 and
    4: within 1e-4, and a second call bitwise equal to the first. The call
    and each of its launches (segment summaries, the combine across
    segments, the output pass) timed alone, with their bounds and resident
    blocks per SM."""
    from tamtr_torch.kernels.selective_scan import (
        SEG_STEPS, fwd_occupancy, ss2d_scan, ss2d_scan_fwd_combine, ss2d_scan_fwd_output, ss2d_scan_fwd_summaries,
        ss2d_scan_ref,
    )

    g = torch.Generator().manual_seed(1)
    rows, err = [], 0.0
    for B in batches:
        for H, W, C in LEVELS_640:
            args, _ = scan_inputs(g, B, H, W, C, dev)
            L, D, R, N = H * W, 2 * C, args[2].shape[-1], 16
            S = -(-L // SEG_STEPS)
            y, again, want = ss2d_scan(*args), ss2d_scan(*args), ss2d_scan_ref(*args)
            torch.cuda.synchronize()
            e = (y - want).abs().max().item()
            ok = torch.allclose(y, want, atol=1e-4, rtol=1e-4) and bool(torch.isfinite(y).all())
            bitwise = torch.equal(y, again)
            del y, again, want
            ms = cuda_ms(lambda: ss2d_scan(*args), iters=5)
            plain = cuda_ms(lambda: ss2d_scan_ref(*args), iters=2) if B == 1 else \
                cuda_ms(lambda: ss2d_scan_ref(*args), iters=1, warmup=0)
            h_loc, sdt = ss2d_scan_fwd_summaries(*args[:7])
            ms_sum = cuda_ms(lambda: ss2d_scan_fwd_summaries(*args[:7]), iters=5)
            copies = iter([h_loc.clone() for _ in range(6)])  # the combine works in place
            ms_comb = cuda_ms(lambda: ss2d_scan_fwd_combine(args[4], next(copies), sdt, L), iters=5)
            h_in = ss2d_scan_fwd_combine(args[4], h_loc, sdt, L)
            ms_out = cuda_ms(lambda: ss2d_scan_fwd_output(*args, h_in), iters=5)
            occ = fwd_occupancy(R)
            del copies, h_loc, h_in, sdt
            # The function: layouts, x_dbl's dts_raw, B and C and the weights
            # read once, y written once; per (b, k, l, d) the dt projection
            # and softplus, per state lane the exp, the state update and C h,
            # and the D skip.
            x_in = 2 * B * L * D + 4 * B * L * (R + 2 * N) + 4 * D * (R + N + 2)
            b_fn = bound(4 * (x_in + 4 * B * L * D), 4 * B * L * D * (2 * R + 8 * N + 3))
            # Each launch alone, with the segment design's own traffic, the
            # (B, 4, S, D, 16) states and (B, 4, S, D) sums of dt. The
            # summaries read u, dts_raw, B and the weights and write both;
            # the combine reads both and rewrites the states; the output reads
            # the inputs and the states and writes y. Operations per (b, k, l,
            # d): the dt projection and softplus (2R + 5) in both passes; per
            # state lane the exp and ~4 in the summaries, ~6 in the output (C h
            # too); ~4 per (b, k, segment, d, n) in the combine.
            states, sums = 4 * B * S * D * N, 4 * B * S * D
            b_sum = bound(4 * (2 * B * L * D + 4 * B * L * (R + N) + 4 * D * (R + N + 1) + states + sums),
                          4 * B * L * D * (2 * R + 7 + 5 * N))
            b_comb = bound(4 * (2 * states + sums), 4 * states)
            b_out = bound(4 * (x_in + states + 4 * B * L * D), 4 * B * L * D * (2 * R + 10 + 7 * N))
            rows.append(dict(B=B, L=L, D=D, S=S, ms=ms, ms_summaries=ms_sum, ms_combine=ms_comb, ms_output=ms_out,
                             plain_ms=plain, bound_ms=b_fn[0], bound_by=b_fn[1], bound_summaries_ms=b_sum[0],
                             bound_summaries_by=b_sum[1], bound_combine_ms=b_comb[0], bound_combine_by=b_comb[1],
                             bound_output_ms=b_out[0], bound_output_by=b_out[1], blocks_per_sm=occ,
                             max_abs_err=e, bitwise_repeat=bitwise))
            print(f"ss2d_scan_fwd B={B} L={L} D={D} R={R} segments={S}: max_abs_err={e:.3g} bitwise repeat {bitwise} "
                  f"ms={ms:.4f} (summaries {ms_sum:.4f} + combine {ms_comb:.4f} + output {ms_out:.4f}) "
                  f"plain_ms={plain:.3f} bound_ms={b_fn[0]:.4f} ({b_fn[1]}); each launch with the segment states' "
                  f"traffic: summaries {b_sum[0]:.4f} ({b_sum[1]}) combine {b_comb[0]:.4f} ({b_comb[1]}) output "
                  f"{b_out[0]:.4f} ({b_out[1]}); blocks/SM {occ}", flush=True)
            if not (ok and bitwise):
                raise AssertionError(f"ss2d_scan kernel at B={B}, L={L}: max error {e}, bitwise repeat {bitwise}")
            err = max(err, e)
            del args
    return rows, err


def grid_sample_deform(value, shapes, loc, w_att):
    """The reference's per-level `F.grid_sample` formulation of the same
    gather (zeros padding, align_corners=False); a yardstick only."""
    import torch.nn.functional as F

    B, _, nh, c = value.shape
    _, Q, _, nl, P, _ = loc.shape
    levels = value.split([h * w for h, w in shapes], 1)
    sampled = []
    for lvl, (h, w) in enumerate(shapes):
        vl = levels[lvl].permute(0, 2, 3, 1).reshape(B * nh, c, h, w)
        grid = (2 * loc[:, :, :, lvl] - 1).transpose(1, 2).reshape(B * nh, Q, P, 2)
        sampled.append(F.grid_sample(vl, grid, mode="bilinear", padding_mode="zeros", align_corners=False))
    s = torch.stack(sampled, -2).flatten(-2)
    wt = w_att.transpose(1, 2).reshape(B * nh, 1, Q, nl * P)
    return (s * wt).sum(-1).view(B, nh, c, Q).permute(0, 3, 1, 2)


def gather_fwd_bound(value, idx2, w_pairs, Q: int):
    """B2's bound on these inputs: the value rows the pairs touch (after the
    last-row shift), idx2 and w_pairs read once, the output written once;
    two multiply-adds per pair and channel."""
    B, Lv, nh, c = value.shape
    rows = torch.cat([idx2.clamp(max=Lv - 2), idx2.clamp(max=Lv - 2) + 1], 1).long()
    touched = torch.unique((torch.arange(B, device=value.device)[:, None, None] * Lv + rows) * nh
                           + torch.arange(nh, device=value.device)).numel()
    nbytes = touched * c * 4 + idx2.numel() * 4 + w_pairs.numel() * 4 + B * Q * nh * c * 4
    return bound(nbytes, idx2.numel() * c * 4)


def time_gather_fwd(value, idx2, w_pairs, Q: int, plain, iters: int = 50):
    """B2 on (value, idx2, w_pairs): two calls bitwise equal, within 1e-5 of
    `plain()`; `ms`, the mean of back-to-back `bilinear_gather` calls by
    CUDA events (the host's enqueue included), as for every kernel;
    `ms_device`, the kernel's own time by the profiler; the plain version's
    ms and the bound."""
    from tamtr_torch.kernels.deform_scatter import bilinear_gather

    P = idx2.shape[1] // Q // 2
    call = lambda: bilinear_gather(value, None, w_pairs, idx2, P)  # noqa: E731 (idx4 is the CPU's)
    out, again, want = call(), call(), plain()
    torch.cuda.synchronize()
    e = (out - want).abs().max().item()
    ok = torch.allclose(out, want, atol=1e-5, rtol=1e-5) and bool(torch.isfinite(out).all())
    bitwise = torch.equal(out, again)
    del out, again, want
    ms = cuda_ms(call, iters=iters)
    ms_device = device_ms(call, iters=iters)
    plain_ms = cuda_ms(plain, iters=max(iters // 10, 2))
    b_ms, b_by = gather_fwd_bound(value, idx2, w_pairs, Q)
    return dict(ms=ms, ms_device=ms_device, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=e,
                bitwise_repeat=bitwise), ok and bitwise


def check_bilinear_gather(dev):
    """Kernel B2 vs its plain version at the 640 px serve shape, value
    (1, 33600, 8, 64), Q = 100 (1e-5), two calls bitwise equal, and the
    per-level `F.grid_sample` formulation beside it. At this size `ms`
    (CUDA events over back-to-back calls) is the wrapper's host time; the
    kernel's own is `ms_device` (profiler)."""
    from tamtr_torch.kernels.deform_scatter import bilinear_gather_ref
    from tamtr_torch.nn.decoder import deform_sampling_pairs

    shapes = [(h, w) for h, w, _ in LEVELS_640]
    B, Q, nl, P = 1, 100, 3, 4
    Lv = sum(h * w for h, w in shapes)
    value, loc, w_att = deform_inputs(torch.Generator().manual_seed(2), B, Q, shapes, dev)
    idx4, w_pairs, idx2 = deform_sampling_pairs(shapes, loc, w_att)
    if int(idx2.max()) != Lv - 1:
        raise AssertionError("the last-cell sample point did not reach the global last row")
    row, ok = time_gather_fwd(value, idx2, w_pairs, Q, lambda: bilinear_gather_ref(value, idx4, w_pairs, idx2, nl * P))
    lib = grid_sample_deform(value, shapes, loc, w_att)
    e_lib = (bilinear_gather_ref(value, idx4, w_pairs, idx2, nl * P) - lib).abs().max().item()
    lib_ms = cuda_ms(lambda: grid_sample_deform(value, shapes, loc, w_att), iters=20)
    print(f"bilinear_gather_fwd B={B} Lv={Lv} Q={Q}: max_abs_err={row['max_abs_err']:.3g} (plain vs grid_sample "
          f"{e_lib:.3g}), bitwise over two calls {row['bitwise_repeat']}; ms={row['ms']:.4f} (events over "
          f"back-to-back calls) ms_device={row['ms_device']:.5f} (profiler) plain_ms={row['plain_ms']:.4f} "
          f"library_ms={lib_ms:.4f} bound_ms={row['bound_ms']:.5f} ({row['bound_by']}; one launch costs more)",
          flush=True)
    if not (ok and e_lib < 1e-4):
        raise AssertionError(f"bilinear_gather kernel disagrees: {row} (grid_sample {e_lib})")
    return dict(**row, library_ms=lib_ms)


def check_ss2d_scan_bwd(dev, B: int = TRAIN_BATCH, levels=LEVELS_640):
    """Kernels B3a (segment summaries), the combine and B3b (segment walk)
    vs the plain backward at the three 640 px levels, batch 4: all eight
    gradients within 2e-3 (the JAX package's bound for its Pallas backward,
    `tests/test_pallas_scan.py:163-165`), and a second call bitwise equal to
    the first. Each launch is timed alone, with its resident blocks per SM."""
    from tamtr_torch.kernels.selective_scan import (
        SEG_STEPS, bwd_occupancy, ss2d_scan_bwd, ss2d_scan_bwd_ref, ss2d_scan_bwd_walk, ss2d_scan_carriers,
        ss2d_scan_combine,
    )

    g = torch.Generator().manual_seed(11)
    rows, err = [], 0.0
    for H, W, C in levels:
        args, dy = scan_inputs(g, B, H, W, C, dev)
        L, D, R, N = H * W, 2 * C, args[2].shape[-1], 16
        S = -(-L // SEG_STEPS)
        got = ss2d_scan_bwd(*args, dy)
        again = ss2d_scan_bwd(*args, dy)
        want = ss2d_scan_bwd_ref(*args, dy, chunk=512)  # 512-step chunks: fewer launches, same sums
        torch.cuda.synchronize()
        e = max((a - b).abs().max().item() for a, b in zip(got, want))
        ok = all(torch.allclose(a, b, atol=2e-3, rtol=2e-3) and bool(torch.isfinite(a).all())
                 for a, b in zip(got, want))
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        plain = cuda_ms(lambda: ss2d_scan_bwd_ref(*args, dy, chunk=512), iters=1, warmup=0)
        layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, _ = args
        summ = ss2d_scan_carriers(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, dy)
        ms_sum = cuda_ms(lambda: ss2d_scan_carriers(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, dy), iters=3)
        copies = iter([[t.clone() for t in summ[:2]] for _ in range(4)])  # the combine works in place
        ms_comb = cuda_ms(lambda: ss2d_scan_combine(A, *next(copies), summ[2], L), iters=3)
        h_in, carry = ss2d_scan_combine(A, *summ, L)
        ms_walk = cuda_ms(lambda: ss2d_scan_bwd_walk(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, dy, h_in, carry),
                          iters=3)
        whole = cuda_ms(lambda: ss2d_scan_bwd(*args, dy), iters=3)
        occ = bwd_occupancy(R)
        # The function's bound, for the kernels' pair: layouts,
        # x_dbl, dy and the weights read once; du, dz, dB, dC, dA written once.
        # Operations per (b, k, l, d): the dt projection and softplus in both
        # passes, and per state lane two exps and ~26 multiply-adds (state
        # update twice, g, ddA, dA, the four sums).
        x_in = 2 * B * L * D + 4 * B * L * (R + 2 * N) + 4 * B * L * D + 4 * D * (R + N + 2)
        grads = 2 * 4 * B * L * D + 2 * 4 * B * L * N + 4 * D * N
        b_fn = bound(4 * (x_in + grads), 4 * B * L * D * (4 * R + 28 * N + 10))
        # Each launch alone, with the segment design's own traffic: the
        # (B, 4, S, D, 16) summaries h_loc and r. B3a + combine read the
        # inputs and write the summaries (the combine's in-place pass counted
        # once); B3b reads the inputs and the summaries and writes the
        # gradients. Operations per (b, k, l, d): the dt projection and
        # softplus (2R + 5) in each; per state lane, B3a one exp and ~8
        # (state update, prod a, r), B3b one exp and ~18 (the state update,
        # g, ddA, dA, the four sums); the combine ~4 per (b, k, segment, d, n).
        summaries = 2 * 4 * B * S * D * N
        b_a = bound(4 * (x_in + summaries), 4 * B * L * D * (2 * R + 5 + 9 * N) + 4 * summaries)
        b_b = bound(4 * (x_in + summaries + grads), 4 * B * L * D * (2 * R + 10 + 19 * N))
        rows.append(dict(L=L, D=D, S=S, ms=ms_sum + ms_comb + ms_walk, ms_summaries=ms_sum, ms_combine=ms_comb,
                         ms_walk=ms_walk, ms_with_assembly=whole, plain_ms=plain, blocks_per_sm=occ,
                         bound_ms=b_fn[0], bound_by=b_fn[1], bound_b3a_ms=b_a[0], bound_b3a_by=b_a[1],
                         bound_b3b_ms=b_b[0], bound_b3b_by=b_b[1], max_abs_err=e, bitwise_repeat=bitwise))
        print(f"ss2d_scan_bwd B={B} L={L} D={D} R={R} segments={S}: max_abs_err={e:.3g} bitwise repeat {bitwise} "
              f"ms={ms_sum + ms_comb + ms_walk:.4f} (B3a summaries {ms_sum:.4f} + combine {ms_comb:.4f}, "
              f"B3b walk {ms_walk:.4f}; with the torch assembly {whole:.4f}) plain_ms={plain:.3f} "
              f"bound_ms {b_fn[0]:.4f} ({b_fn[1]}); each launch with the summaries' traffic: "
              f"B3a {b_a[0]:.4f} ({b_a[1]}) B3b {b_b[0]:.4f} ({b_b[1]}); blocks/SM {occ}", flush=True)
        if not (ok and bitwise):
            raise AssertionError(f"ss2d_scan backward kernels at L={L}: max error {e}, bitwise repeat {bitwise}")
        err = max(err, e)
        del args, dy, got, want, summ, h_in, carry
    return rows, err


def check_bilinear_gather_bwd(dev, B: int = TRAIN_BATCH, Q: int = 700):
    """Kernel B4's two launches (`pair_buckets`, then the rows pass) vs the
    plain backward at the 640 px training shape (dn queries included):
    dvalue and dw within 1e-5 of the scatter-add form; the buckets equal
    `pair_buckets_ref`; dvalue bitwise equal over two calls and to the plain
    row-owned version (the same multiply and add per term in pair order),
    here and on a hot row (all pairs of one image and head on one start
    row, 1440 terms); the gradient to value, sampling locations and attention weights
    through `ms_deform_attn_core` against autodiff of the plain 4-corner
    gather within 1e-5 of each tensor's largest entry. The forward kernel B2
    is held against its plain version at this shape first (1e-5, two calls
    bitwise equal), which covers its per-image offsets, and timed and
    bounded there. Each launch timed and bounded alone."""
    from tamtr_torch.kernels.deform_scatter import (
        bilinear_gather_bwd, bilinear_gather_bwd_ref, bilinear_gather_bwd_rows_ref, bilinear_gather_ref,
        pair_buckets, pair_buckets_ref,
    )
    from tamtr_torch.nn.decoder import deform_sampling_pairs, ms_deform_attn_core

    shapes = [(h, w) for h, w, _ in LEVELS_640]
    nh, c, nl, P = 8, 64, 3, 4
    Lv = sum(h * w for h, w in shapes)
    g = torch.Generator().manual_seed(12)
    value, loc, w_att = deform_inputs(g, B, Q, shapes, dev)
    dout = torch.randn(B, Q, nh, c, generator=g).to(dev)
    idx4, w_pairs, idx2 = deform_sampling_pairs(shapes, loc, w_att)
    if int(idx2.max()) != Lv - 1:
        raise AssertionError("the last-cell sample point did not reach the global last row")
    b2, b2_ok = time_gather_fwd(value, idx2, w_pairs, Q, lambda: bilinear_gather_ref(value, idx4, w_pairs, idx2, nl * P),
                                iters=20)
    b2["library_ms"] = cuda_ms(lambda: grid_sample_deform(value, shapes, loc, w_att), iters=5)
    print(f"bilinear_gather_fwd B={B} Lv={Lv} Q={Q}: max_abs_err={b2['max_abs_err']:.3g}, bitwise over two calls "
          f"{b2['bitwise_repeat']}; ms={b2['ms']:.4f} (events) ms_device={b2['ms_device']:.5f} (profiler) "
          f"plain_ms={b2['plain_ms']:.4f} library_ms={b2['library_ms']:.4f} (F.grid_sample) "
          f"bound_ms={b2['bound_ms']:.5f} ({b2['bound_by']})", flush=True)
    if not b2_ok:
        raise AssertionError(f"bilinear_gather kernel disagrees with its plain version at B={B}, Q={Q}: {b2}")
    dv, dw = bilinear_gather_bwd(value, idx2, w_pairs, dout)
    dv2, dw2 = bilinear_gather_bwd(value, idx2, w_pairs, dout)
    dv_ref, dw_ref = bilinear_gather_bwd_ref(value, idx2, w_pairs, dout)
    buckets, buckets_ref = pair_buckets(idx2, w_pairs, Lv), pair_buckets_ref(idx2, w_pairs, Lv)
    dv_rows = bilinear_gather_bwd_rows_ref(value, idx2, w_pairs, dout)[0]
    repeat = torch.equal(dv, dv2) and torch.equal(dw, dw2)
    same_buckets = all(torch.equal(a, b) for a, b in zip(buckets, buckets_ref))
    rows_bitwise = torch.equal(dv, dv_rows)
    del dv2, dw2, dv_rows
    hot = idx2.clone()
    hot[1, :1440, 5] = 12345  # the pairs of 60 queries on one start row: 1440 terms
    dv_hot = bilinear_gather_bwd(value, hot, w_pairs, dout)[0]
    hot_repeat = torch.equal(dv_hot, bilinear_gather_bwd(value, hot, w_pairs, dout)[0])
    hot_rows = torch.equal(dv_hot, bilinear_gather_bwd_rows_ref(value, hot, w_pairs, dout)[0])
    del dv_hot, hot

    def grads(kernel: bool):
        ts = [t.detach().clone().requires_grad_() for t in (value, loc, w_att)]
        if kernel:
            out = ms_deform_attn_core(ts[0], shapes, ts[1], ts[2]).view(B, Q, nh, c)
        else:
            i4, wp, i2 = deform_sampling_pairs(shapes, ts[1], ts[2])
            out = bilinear_gather_ref(ts[0], i4, wp, i2, nl * P)
        return torch.autograd.grad(out, ts, dout)

    g_kernel, g_plain = grads(True), grads(False)
    torch.cuda.synchronize()
    e = max((a - b).abs().max().item() for a, b in ((dv, dv_ref), (dw, dw_ref)))
    ok = torch.allclose(dv, dv_ref, atol=1e-5, rtol=1e-5) and torch.allclose(dw, dw_ref, atol=1e-5, rtol=1e-5)
    # the location gradient sums the four corners' terms with opposite signs
    # (each up to W x |dw|): its error is bounded relative to the tensor's
    # largest entry, not entry by entry
    chain = [(a - b).abs().max().item() / max(b.abs().max().item(), 1e-30) for a, b in zip(g_kernel, g_plain)]
    ok = ok and max(chain) < 1e-5 and repeat and same_buckets and rows_bitwise and hot_repeat and hot_rows
    ms = cuda_ms(lambda: bilinear_gather_bwd(value, idx2, w_pairs, dout), iters=20)
    ms_buckets = cuda_ms(lambda: pair_buckets(idx2, w_pairs, Lv), iters=20)
    # the buckets wrapper's host time exceeds its kernel's: device time too
    ms_device = device_ms(lambda: bilinear_gather_bwd(value, idx2, w_pairs, dout), iters=20)
    ms_buckets_device = device_ms(lambda: pair_buckets(idx2, w_pairs, Lv), iters=20)
    plain = cuda_ms(lambda: bilinear_gather_bwd_ref(value, idx2, w_pairs, dout), iters=5)
    lib_in = [t.detach().clone().requires_grad_() for t in (value, loc, w_att)]
    lib_out = grid_sample_deform(lib_in[0], shapes, lib_in[1], lib_in[2])
    lib_g = torch.autograd.grad(lib_out, lib_in, dout, retain_graph=True)
    e_lib = (lib_g[0] - g_plain[0]).abs().max().item()
    lib_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, lib_in, dout, retain_graph=True), iters=5)
    b_ms, b_by, b_buckets, b_rows = gather_bwd_bounds(value, idx2, w_pairs, dout, buckets)
    print(f"bilinear_gather_bwd B={B} Lv={Lv} Q={Q}: max_abs_err={e:.3g} (dvalue, dw); buckets equal the plain "
          f"version {same_buckets}; dvalue bitwise over two calls {repeat}, bitwise the plain row-owned version "
          f"{rows_bitwise}; hot row: bitwise over two calls {hot_repeat}, the plain row-owned version {hot_rows}; "
          f"through the core, max error / max entry of d(value, loc, w_att) {[float(f'{c:.3g}') for c in chain]}; "
          f"dvalue vs grid_sample {e_lib:.3g}; ms={ms:.4f} (events; buckets alone {ms_buckets:.4f}) ms_device="
          f"{ms_device:.4f} (profiler; buckets {ms_buckets_device:.4f} bound {b_buckets:.5f}, rows "
          f"{ms_device - ms_buckets_device:.4f} bound {b_rows:.5f}) plain_ms={plain:.4f} library_ms={lib_ms:.4f} "
          f"(F.grid_sample backward) bound_ms={b_ms:.5f} ({b_by})", flush=True)
    if not ok:
        raise AssertionError(f"bilinear_gather backward kernel disagrees: {e}, repeat {repeat}, buckets "
                             f"{same_buckets}, rows {rows_bitwise}, hot {hot_repeat} {hot_rows}")
    return dict(ms=ms, ms_buckets=ms_buckets, ms_device=ms_device, ms_buckets_device=ms_buckets_device,
                ms_rows_device=ms_device - ms_buckets_device, plain_ms=plain, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, bound_buckets_ms=b_buckets, bound_rows_ms=b_rows,
                max_abs_err=e, bitwise_repeat=repeat and hot_repeat), b2


def gather_bwd_bounds(value, idx2, w_pairs, dout, buckets):
    """B4's bound on these inputs, and each launch's alone: the function
    reads the touched value rows, dout, idx2 and w_pairs and writes dvalue
    and dw; the buckets read idx2 and w_pairs and write the offsets, the
    sorted ids and their weights; the rows pass reads those besides the
    function's own bytes."""
    B, Lv, nh, c = value.shape
    Q = dout.shape[1]
    rows = torch.cat([idx2.clamp(max=Lv - 2), idx2.clamp(max=Lv - 2) + 1], 1).long()
    touched = torch.unique((torch.arange(B, device=value.device)[:, None, None] * Lv + rows) * nh
                           + torch.arange(nh, device=value.device)).numel()
    nbytes = (touched * c * 4 + dout.numel() * 4 + idx2.numel() * 4 + w_pairs.numel() * 4
              + value.numel() * 4 + w_pairs.numel() * 4)
    flops = B * Q * nh * (idx2.shape[1] // Q) * c * 8
    b_ms, b_by = bound(nbytes, flops)
    bucket_bytes = sum(t.numel() * 4 for t in buckets)
    return (b_ms, b_by, bound(idx2.numel() * 4 + w_pairs.numel() * 4 + bucket_bytes, 0)[0],
            bound(nbytes + bucket_bytes, flops)[0])


def most_terms_on_a_row(idx2, Lv: int) -> int:
    """The most terms a dvalue row of one (b, h) sums: the pairs starting on
    it and on the row above (after the last-row shift)."""
    s = torch.where(idx2 >= Lv - 1, Lv - 2, idx2).long()
    n = torch.zeros((idx2.shape[0], Lv + 1, idx2.shape[2]), device=idx2.device).scatter_add_(
        1, s, torch.ones_like(s, dtype=torch.float32))
    return int((n[:, 1:] + n[:, :-1]).max())


@contextlib.contextmanager
def recording_gather_bwd(calls: list):
    """Inside, every call of the gather backward (B4) appends its arguments
    to `calls` and goes on to the kernel; its launch counter counts as
    before."""
    from tamtr_torch.kernels import deform_scatter as ds

    bwd = ds.bilinear_gather_bwd

    def record(*args):
        calls.append(args)
        return bwd(*args)

    record.launches = bwd.launches  # the wrapper counts through its module's name
    ds.bilinear_gather_bwd = record
    try:
        yield
    finally:
        ds.bilinear_gather_bwd = bwd
        bwd.launches = record.launches


def check_gather_fwd_step(calls):
    """B2 on the training step's own pairs (the forward inputs of the three
    decoder layers' gathers, as `train` records them for B4): within 1e-5 of
    the plain pair form, two calls bitwise equal; per call, the CUDA-event
    ms, the device ms, the plain version's and the bound, on these inputs."""
    from tamtr_torch.kernels.deform_scatter import bilinear_gather_pairs_ref

    rows, ok = [], True
    for value, idx2, w_pairs, dout in calls:
        Q = dout.shape[1]
        row, good = time_gather_fwd(value, idx2, w_pairs, Q,
                                    lambda: bilinear_gather_pairs_ref(value, idx2, w_pairs, idx2.shape[1] // Q), iters=20)
        rows.append(row)
        ok &= good
    mean = {k: sum(r[k] for r in rows) / len(rows) for k in ("ms", "ms_device", "plain_ms", "bound_ms")}
    err = max(r["max_abs_err"] for r in rows)
    print(f"bilinear_gather_fwd on the training step's pairs ({len(rows)} calls): max_abs_err={err:.3g}, bitwise "
          f"over two calls {all(r['bitwise_repeat'] for r in rows)}; per call ms={mean['ms']:.4f} (events) ms_device="
          f"{mean['ms_device']:.5f} (profiler) plain_ms={mean['plain_ms']:.4f} bound_ms={mean['bound_ms']:.5f}", flush=True)
    if not ok:
        raise AssertionError(f"bilinear_gather kernel disagrees on the step's pairs: {rows}")
    return {f"{k}_step": v for k, v in mean.items()} | dict(max_abs_err_step=err)


def check_gather_bwd_step(calls):
    """B4 on the training step's own pairs (`train` records the three
    decoder layers' calls of one step): dvalue bitwise over two calls and
    equal to the plain row-owned version, dvalue and dw within 1e-5 of the
    scatter-add form; per call, the kernel's ms (and its buckets'), the
    plain form's and the bound, on these inputs."""
    from tamtr_torch.kernels.deform_scatter import (
        bilinear_gather_bwd, bilinear_gather_bwd_ref, bilinear_gather_bwd_rows_ref, pair_buckets,
    )

    err, ok, most = 0.0, True, 0
    bounds = [0.0, 0.0, 0.0]
    for value, idx2, w_pairs, dout in calls:
        Lv = value.shape[1]
        dv, dw = bilinear_gather_bwd(value, idx2, w_pairs, dout)
        ok &= torch.equal(dv, bilinear_gather_bwd(value, idx2, w_pairs, dout)[0])
        ok &= torch.equal(dv, bilinear_gather_bwd_rows_ref(value, idx2, w_pairs, dout)[0])
        dv_ref, dw_ref = bilinear_gather_bwd_ref(value, idx2, w_pairs, dout)
        ok &= torch.allclose(dv, dv_ref, atol=1e-5, rtol=1e-5) and torch.allclose(dw, dw_ref, atol=1e-5, rtol=1e-5)
        err = max(err, (dv - dv_ref).abs().max().item(), (dw - dw_ref).abs().max().item())
        most = max(most, most_terms_on_a_row(idx2, Lv))
        b = gather_bwd_bounds(value, idx2, w_pairs, dout, pair_buckets(idx2, w_pairs, Lv))
        bounds = [x + y / len(calls) for x, y in zip(bounds, (b[0], b[2], b[3]))]
        del dv, dw, dv_ref, dw_ref
    every = lambda fn: lambda: [fn(*args) for args in calls]  # noqa: E731
    n = len(calls)
    ms = cuda_ms(every(bilinear_gather_bwd), iters=20) / n
    ms_buckets = cuda_ms(every(lambda v, i, w, d: pair_buckets(i, w, v.shape[1])), iters=20) / n
    ms_device = device_ms(every(bilinear_gather_bwd), iters=20) / n
    ms_buckets_device = device_ms(every(lambda v, i, w, d: pair_buckets(i, w, v.shape[1])), iters=20) / n
    plain = cuda_ms(every(bilinear_gather_bwd_ref), iters=5) / n
    print(f"bilinear_gather_bwd on the training step's pairs ({n} calls, up to {most} terms on a row): "
          f"max_abs_err={err:.3g}; dvalue bitwise over two calls and equal to the plain row-owned version {ok}; "
          f"ms per call {ms:.4f} (events; buckets alone {ms_buckets:.4f}) ms_device {ms_device:.4f} (profiler; "
          f"buckets {ms_buckets_device:.4f} bound {bounds[1]:.5f}, rows {ms_device - ms_buckets_device:.4f} bound "
          f"{bounds[2]:.5f}) plain_ms={plain:.4f} bound_ms={bounds[0]:.5f}", flush=True)
    if not ok:
        raise AssertionError(f"bilinear_gather backward kernel disagrees on the step's pairs: {err}")
    return dict(ms_step=ms, ms_buckets_step=ms_buckets, ms_device_step=ms_device,
                ms_buckets_device_step=ms_buckets_device, ms_rows_device_step=ms_device - ms_buckets_device,
                plain_ms_step=plain, bound_ms_step=bounds[0], bound_buckets_ms_step=bounds[1], bound_rows_ms_step=bounds[2],
                max_abs_err_step=err, most_terms_on_a_row_step=most)


def matcher_costs(seed: int, n_images: int, M: int, n_valid, dev, nq: int = 100):
    """The matcher's cost (4 n_images, nq, M) for 4 matched decoder layers
    over a VisDrone-like batch of n_images (random predictions, M gt slots,
    n_valid[i] valid), and its gt mask."""
    from tamtr_torch.losses.matcher import match_cost

    batch = synthetic_batch(seed, n_images, 64, M, n_valid)
    g = torch.Generator().manual_seed(seed)
    n = 4 * n_images
    pred_b = torch.cat([torch.rand(n, nq, 2, generator=g), torch.rand(n, nq, 2, generator=g) * 0.1 + 0.005], -1)
    pred_s = torch.randn(n, nq, 10, generator=g) * 2 - 3
    gt = {k: torch.from_numpy(batch[k]).repeat(4, *([1] * (batch[k].ndim - 1))) for k in ("bboxes", "cls", "mask")}
    C = match_cost(pred_b.to(dev), pred_s.to(dev), gt["bboxes"].to(dev), gt["cls"].to(dev))
    return C, gt["mask"].to(dev)


def check_auction(dev):
    """Kernel B5 on the matcher's cost over a VisDrone-like batch (4 matched
    layers x 4 images: cost (16, 100, 300), one over-full and one contested
    image): `auction_assignment` in one launch identical to the CPU's
    (`auction_assignment_ref`, JAX's assignment) and to the plain version on
    the card, with no host sync (`torch.cuda.set_sync_debug_mode("error")`);
    `auction_match` (two launches, batch-wide stop) identical to
    `auction_match_ref` on the forward and the transposed solve."""
    from tamtr_torch.kernels.auction import (
        _oriented_setup, _rounds_ref, auction_assignment, auction_assignment_ref, auction_match, auction_match_ref,
    )

    n, nq = 4 * TRAIN_BATCH, 100
    C, mask = matcher_costs(13, TRAIN_BATCH, TRAIN_MAX_GT, TRAIN_VALID, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = auction_assignment(C, mask)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want_cpu = auction_assignment_ref(C.cpu(), mask.cpu())
    want = auction_assignment_ref(C, mask)
    qmask = torch.ones((n, nq), dtype=torch.bool, device=dev)
    Ct = C.transpose(1, 2).contiguous()
    solves = [(C, mask, None), (Ct, qmask, mask)]
    match_same = all(torch.equal(auction_match(c, m, row_mask=r), auction_match_ref(c, m, row_mask=r))
                     for c, m, r in solves)
    same = torch.equal(got.cpu(), want_cpu) and torch.equal(got, want) and match_same
    e = float(int((got.cpu() != want_cpu).sum()))
    ms = cuda_ms(lambda: auction_assignment(C, mask), iters=20)
    ms_match = sum(cuda_ms(lambda sv=sv: auction_match(sv[0], sv[1], row_mask=sv[2]), iters=5) for sv in solves)
    plain = cuda_ms(lambda: auction_assignment_ref(C, mask), iters=1)
    # bytes: the cost and mask read once, the assignment written once;
    # operations: per round every bidder scans its objects (subtract, two
    # compares), for the rounds each image's own solve needed in this run
    overfull = mask.sum(1) > nq
    rounds = []
    for b in range(n):
        value, pv, eps, target = _oriented_setup(C[b:b + 1], mask[b:b + 1], bool(overfull[b]))
        rounds.append(_rounds_ref(value.transpose(1, 2), eps, pv, target, 300, own_stop=True)[1])
    nbytes = C.numel() * 4 + mask.numel() + got.numel() * 4
    flops = sum(r * nq * TRAIN_MAX_GT * 3 for r in rounds)
    b_ms, b_by = bound(nbytes, flops)
    print(f"auction_assignment cost (16, 100, 300): valid {TRAIN_VALID} x 4 layers, rounds per image {rounds}, "
          f"assignments identical to the CPU's and the plain version's {same} (differing entries {e:.0f}), "
          f"no host sync (sync debug mode error), assigned per image {(got[:4] >= 0).sum(1).tolist()}, "
          f"ms={ms:.4f} (one launch) plain_ms={plain:.3f} bound_ms={b_ms:.5f} ({b_by}); "
          f"auction_match forward + transposed ms={ms_match:.4f}, identical {match_same}", flush=True)
    if not same:
        raise AssertionError("auction kernel assignments differ from the plain auction's")
    return dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=e,
                rounds=rounds, ms_auction_match_fwd_and_transposed=ms_match)


def check_auction_any_size(dev):
    """Kernel B5 at more problems than the card has SMs, 160 images of
    (100, 300) (4 matched layers x 40 images), and at 16 of (100, 600),
    whose value block exceeds a block's shared memory; over-full images in
    both. `auction_assignment` identical to the CPU's; `auction_match`
    (over-full problems run on to the batch's stop) identical to the plain
    auction on the same inputs."""
    from tamtr_torch.kernels.auction import auction_assignment, auction_assignment_ref, auction_match, auction_match_ref

    rows = {}
    for name, n_images, M, valid in (("problems160_m300", 40, 300, TRAIN_VALID * 10),
                                     ("problems16_m600", 4, 600, (560, 80, 30, 60))):
        C, mask = matcher_costs(15, n_images, M, valid, dev)
        got, want = auction_assignment(C, mask), auction_assignment_ref(C.cpu(), mask.cpu())
        got_m, want_m = auction_match(C, mask), auction_match_ref(C, mask)
        torch.cuda.synchronize()
        differ = int((got.cpu() != want).sum()) + int((got_m != want_m).sum())
        ms = cuda_ms(lambda: auction_assignment(C, mask), iters=3)
        ms_match = cuda_ms(lambda: auction_match(C, mask), iters=3)
        plain = cuda_ms(lambda: auction_assignment_ref(C, mask), iters=1, warmup=0)
        print(f"auction cost {tuple(C.shape)}: auction_assignment and auction_match identical to the plain "
              f"versions {differ == 0} (differing entries {differ}), assigned per problem min "
              f"{int((got >= 0).sum(1).min())} max {int((got >= 0).sum(1).max())}, auction_assignment ms={ms:.4f} "
              f"plain_ms={plain:.3f}, auction_match ms={ms_match:.4f}", flush=True)
        if differ:
            raise AssertionError(f"auction kernel assignments differ from the plain auction's at {tuple(C.shape)}")
        rows[name] = dict(shape=list(C.shape), ms=ms, plain_ms=plain, ms_auction_match=ms_match, differing=differ)
    return rows


def scan1d_inputs(g, L: int, Din: int, dev, G: int = 4, N: int = 16):
    """One-direction scan inputs at one level: G = one image x 4 directions,
    delta from the model's dt init (softplus of dt_b plus a small
    projection), A and D as the model initialises them; and a dy."""
    from tamtr_torch.kernels.selective_scan import softplus
    from tamtr_torch.weights import dt_bias_init

    u = torch.randn(G, L, Din, generator=g)
    delta = softplus(torch.randn(G, L, Din, generator=g) * 0.1 + dt_bias_init((G, 1, Din), g))
    A = -torch.arange(1, N + 1, dtype=torch.float32).expand(G, Din, N).contiguous()
    Bs, Cs = torch.randn(G, L, N, generator=g), torch.randn(G, L, N, generator=g)
    dy = torch.randn(G, L, Din, generator=g)
    return [t.to(dev) for t in (u, delta, A, Bs, Cs, torch.ones(G, Din))], dy.to(dev)


def check_selective_scan(dev):
    """Kernel B6 (segment summaries, the combine across segments, the output
    pass) vs the plain one-direction scan at the three 640 px levels, G = 4,
    N = 16, and at a ragged L and Din (L = 1619, Din = 1000, D None): within
    1e-4, a second call bitwise equal to the first, three launches a call.
    The call and each launch timed alone, with their bounds and resident
    blocks per SM."""
    from tamtr_torch.kernels.selective_scan import (
        SEG_STEPS, scan1d_occupancy, selective_scan, selective_scan_fwd_combine, selective_scan_fwd_output,
        selective_scan_fwd_summaries, selective_scan_ref,
    )

    phases = (selective_scan_fwd_summaries, selective_scan_fwd_combine, selective_scan_fwd_output)
    g = torch.Generator().manual_seed(16)
    rows, err = [], 0.0
    for L, Din, with_d in [(H * W, 2 * C, True) for H, W, C in LEVELS_640] + [(1619, 1000, False)]:
        args, _ = scan1d_inputs(g, L, Din, dev)
        if not with_d:
            args[5] = None
        u, delta, A, Bs, Cs, D = args
        G, N = u.shape[0], A.shape[-1]
        S = -(-L // SEG_STEPS)
        before = [f.launches for f in (selective_scan, *phases)]
        y, again = selective_scan(*args), selective_scan(*args)
        launches = [f.launches - b for f, b in zip((selective_scan, *phases), before)]
        want = selective_scan_ref(*args)
        torch.cuda.synchronize()
        e = (y - want).abs().max().item()
        ok = torch.allclose(y, want, atol=1e-4, rtol=1e-4) and bool(torch.isfinite(y).all())
        bitwise = torch.equal(y, again)
        del y, again, want
        ms = cuda_ms(lambda: selective_scan(*args), iters=5)
        plain = cuda_ms(lambda: selective_scan_ref(*args), iters=2)
        h_loc, sdt = selective_scan_fwd_summaries(u, delta, A, Bs)
        ms_sum = cuda_ms(lambda: selective_scan_fwd_summaries(u, delta, A, Bs), iters=5)
        copies = iter([h_loc.clone() for _ in range(6)])  # the combine works in place
        ms_comb = cuda_ms(lambda: selective_scan_fwd_combine(A, next(copies), sdt, L), iters=5)
        h_in = selective_scan_fwd_combine(A, h_loc, sdt, L)
        ms_out = cuda_ms(lambda: selective_scan_fwd_output(u, delta, A, Bs, Cs, D, h_in), iters=5)
        occ = scan1d_occupancy(N)
        del copies, h_loc, h_in, sdt
        # The function: u, delta, B, C, A and D read once, y written once;
        # per (g, t, d, n) dt A, the exp, a h, (dt u) B, the add, C h and the
        # sum over n; per (g, t, d) dt u and the D skip.
        x, bc, states, sums = G * L * Din, G * L * N, G * S * Din * N, G * S * Din
        w = G * Din * N + (G * Din if D is not None else 0)
        b_fn = bound(4 * (3 * x + 2 * bc + w), x * (7 * N + 3))
        # Each launch alone, with the segment design's own traffic, the
        # (G, S, Din, N) states and (G, S, Din) sums of delta: the summaries
        # read u, delta, B and A and write both (per (g, t, d, n) the exp and
        # ~3); the combine reads both and A and rewrites the states (~4 per
        # (g, segment, d, n)); the output reads the inputs and the states and
        # writes y (per (g, t, d, n) the exp and ~5, C h too).
        b_sum = bound(4 * (2 * x + bc + G * Din * N + states + sums), x * (4 * N + 2))
        b_comb = bound(4 * (2 * states + sums + G * Din * N), 4 * states)
        b_out = bound(4 * (3 * x + 2 * bc + w + states), x * (6 * N + 3))
        rows.append(dict(G=G, L=L, Din=Din, N=N, D=D is not None, S=S, ms=ms, ms_summaries=ms_sum,
                         ms_combine=ms_comb, ms_output=ms_out, plain_ms=plain, bound_ms=b_fn[0], bound_by=b_fn[1],
                         bound_summaries_ms=b_sum[0], bound_summaries_by=b_sum[1], bound_combine_ms=b_comb[0],
                         bound_combine_by=b_comb[1], bound_output_ms=b_out[0], bound_output_by=b_out[1],
                         blocks_per_sm=occ, launches_per_call=launches[0] / 2,
                         phase_launches_per_call=[n / 2 for n in launches[1:]], max_abs_err=e,
                         bitwise_repeat=bitwise))
        print(f"selective_scan_fwd G={G} L={L} Din={Din} N={N} D {D is not None} segments={S}: max_abs_err={e:.3g} "
              f"bitwise repeat {bitwise}, launches per call {launches[0] / 2} (phases "
              f"{[n / 2 for n in launches[1:]]}); ms={ms:.4f} (summaries {ms_sum:.4f} + combine {ms_comb:.4f} + "
              f"output {ms_out:.4f}) plain_ms={plain:.3f} bound_ms={b_fn[0]:.4f} ({b_fn[1]}); each launch with the "
              f"segment states' traffic: summaries {b_sum[0]:.4f} ({b_sum[1]}) combine {b_comb[0]:.4f} "
              f"({b_comb[1]}) output {b_out[0]:.4f} ({b_out[1]}); blocks/SM {occ}", flush=True)
        if not (ok and bitwise and launches == [2, 2, 2, 2]):
            raise AssertionError(f"selective_scan kernel at L={L}, Din={Din}: max error {e}, bitwise repeat "
                                 f"{bitwise}, launches over two calls {launches}")
        err = max(err, e)
        del args, u, delta, A, Bs, Cs, D
    return rows, err


def decoder_scatter_inputs(seed: int, dev, clustered: bool = False):
    """value (4, 33600, 8, 64) and the decoder's sampling at 640 px, Q = 700,
    with a dout: the generic gather's corner indices and weights (idx4, w4,
    p4 = 48) and the pair scatter's (idx2, wa, wb) (32, 16800) with dout
    (32, 700, 64), its pairs moved off the global last row as the callers of
    `_scatter_acc_pairs` do. `clustered` snaps the last level's points to
    3 x 3 cell centres (hundreds of updates on a row, as a training step's
    decoder at initialisation gives), the last-cell point kept."""
    from tamtr_torch.kernels.deform_scatter import _shift_last_row
    from tamtr_torch.nn.decoder import deform_sampling_pairs

    shapes = [(h, w) for h, w, _ in LEVELS_640]
    Lv = sum(h * w for h, w in shapes)
    g = torch.Generator().manual_seed(seed)
    value, loc, w_att = deform_inputs(g, DEFORM_B, DEFORM_Q, shapes, dev)
    if clustered:
        last = loc[0, 0, 0, 2, 0].clone()
        loc[:, :, :, 2] = (torch.floor(loc[:, :, :, 2].clamp(0, 0.999) * 3) + 0.5) / 3
        loc[0, 0, 0, 2, 0] = last
    _, _, nh, c = value.shape
    dout = torch.randn(DEFORM_B, DEFORM_Q, nh, c, generator=g).to(dev)
    idx4, w_pairs, idx2 = deform_sampling_pairs(shapes, loc, w_att)
    nU, nU2 = idx4.shape[1], idx2.shape[1]
    w4 = w_pairs.transpose(2, 3).reshape(DEFORM_B, nU, nh).contiguous()
    i2, wp, _ = _shift_last_row(idx2, w_pairs, Lv)
    G = DEFORM_B * nh
    per_g = lambda t: t.transpose(1, 2).reshape(G, nU2).contiguous()  # noqa: E731
    pairs = (per_g(i2).to(torch.int32), per_g(wp[..., 0]), per_g(wp[..., 1]),
             dout.transpose(1, 2).reshape(G, DEFORM_Q, c).contiguous())
    if int(pairs[0].max()) != Lv - 2:
        raise AssertionError("no pair starts at L2 - 2: the last-cell sample point is missing")
    return value, (idx4, w4, dout), pairs, Lv


def within_sum_bound(got, rows, upd):
    """got (fp32, (..., c)) against the fp64 sum of the updates `upd` (n, c)
    added to rows `rows` (n,) of its (rows, c) view: whether every entry is
    within its row's fp32 summation bound n_row 2^-24 sum |update| (any
    order of adds meets it), and the most updates on a row."""
    c = got.shape[-1]
    n_rows = got.numel() // c
    ref = torch.zeros(n_rows, c, dtype=torch.float64, device=got.device).index_add_(0, rows, upd.double())
    mag = torch.zeros_like(ref).index_add_(0, rows, upd.double().abs())
    count = torch.zeros(n_rows, dtype=torch.float64, device=got.device).index_add_(
        0, rows, torch.ones_like(rows, dtype=torch.float64))
    err = (got.reshape(n_rows, c).double() - ref).abs()
    return bool((err <= count[:, None] * 2.0**-24 * mag).all()), int(count.max())


def scatter_case(kernel, buckets, buckets_ref, plain, rows_ref, rows, upd, library):
    """One input of B7 or B8: the kernel (two launches) against its plain
    version (max error, 1e-5), against itself over two calls and against the
    plain row-owned transcription (bitwise), and against the fp64 sum within
    each row's fp32 summation bound; its buckets against theirs (bitwise);
    then the call, the buckets launch alone, the plain version and the
    library call timed (CUDA events), and the call's and the buckets
    launch's device time (torch.profiler: the buckets wrapper's host time
    exceeds its kernel's, so CUDA events over back-to-back launches time
    the host there)."""
    got, again = kernel(), kernel()
    want = plain()
    res = dict(bitwise_repeat=torch.equal(got, again), rows_bitwise=torch.equal(got, rows_ref()),
               buckets_equal=all(torch.equal(a, b) for a, b in zip(buckets(), buckets_ref())),
               max_abs_err=(got - want).abs().max().item(),
               within_1e5=torch.allclose(got, want, atol=1e-5, rtol=1e-5))
    res["within_sum_bound"], res["most_terms_on_a_row"] = within_sum_bound(got, rows, upd)
    lib = library()
    res["library_err"] = (lib - want).abs().max().item()
    del got, again, want, lib
    torch.cuda.synchronize()
    res.update(ms=cuda_ms(kernel, iters=20), ms_buckets=cuda_ms(buckets, iters=20), plain_ms=cuda_ms(plain, iters=5),
               library_ms=cuda_ms(library, iters=5), ms_device=device_ms(kernel, iters=20),
               ms_buckets_device=device_ms(buckets, iters=20))
    res["ms_rows_device"] = res["ms_device"] - res["ms_buckets_device"]
    return res


def scatter_bounds(nbytes: float, flops: float, in_bytes: float, out_bytes: float, buckets):
    """B7's or B8's bound (the function's bytes and operations), and each
    launch's alone: the buckets read the indices and weights (`in_bytes`)
    and write the offsets, the sorted ids and their weights; the rows pass
    reads those and dout and writes the output (`out_bytes`: dout read and
    output written)."""
    bucket_bytes = sum(t.numel() * 4 for t in buckets)
    return (*bound(nbytes, flops), bound(in_bytes + bucket_bytes, 0)[0],
            bound(out_bytes + bucket_bytes, flops)[0])


def report_scatter(name: str, shape: str, rows: dict, b_fn, b_buckets, b_rows, lib_name: str) -> dict:
    """Print B7's or B8's line; fail unless every input passed: bitwise over
    two calls, bitwise the transcription, buckets equal, the fp32 sum bound,
    and on uniform points 1e-5 from the plain version (the library call
    within 1e-4 of it)."""
    for case, r in rows.items():
        print(f"{name} {shape} {case}: max_abs_err={r['max_abs_err']:.3g} (within 1e-5 {r['within_1e5']}, "
              f"{lib_name} vs plain {r['library_err']:.3g}); bitwise over two calls {r['bitwise_repeat']}, bitwise "
              f"the plain row-owned version {r['rows_bitwise']}; buckets equal the plain version "
              f"{r['buckets_equal']}; up to {r['most_terms_on_a_row']} terms on a row, within the fp32 sum bound "
              f"{r['within_sum_bound']}; ms={r['ms']:.4f} (events; buckets alone {r['ms_buckets']:.4f}) "
              f"ms_device={r['ms_device']:.4f} (profiler; buckets {r['ms_buckets_device']:.4f} bound "
              f"{b_buckets[case]:.5f}, rows {r['ms_rows_device']:.4f} bound {b_rows[case]:.5f}) "
              f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} ({lib_name}) "
              f"bound_ms={b_fn[case][0]:.5f} ({b_fn[case][1]})", flush=True)
    u = rows["uniform"]
    ok = u["within_1e5"] and u["library_err"] < 1e-4 and all(
        r["bitwise_repeat"] and r["rows_bitwise"] and r["buckets_equal"] and r["within_sum_bound"]
        for r in rows.values())
    if not ok:
        raise AssertionError(f"{name} kernel disagrees: {rows}")
    return dict(ms=u["ms"], ms_buckets=u["ms_buckets"], ms_device=u["ms_device"],
                ms_buckets_device=u["ms_buckets_device"], ms_rows_device=u["ms_rows_device"],
                plain_ms=u["plain_ms"], library_ms=u["library_ms"], bound_ms=b_fn["uniform"][0], bound_by=b_fn["uniform"][1],
                bound_buckets_ms=b_buckets["uniform"], bound_rows_ms=b_rows["uniform"],
                max_abs_err=max(r["max_abs_err"] for r in rows.values()), bitwise_repeat=True,
                clustered={**rows["clustered"], "bound_ms": b_fn["clustered"][0],
                           "bound_buckets_ms": b_buckets["clustered"], "bound_rows_ms": b_rows["clustered"]},
                most_terms_on_a_row_uniform=u["most_terms_on_a_row"])


def check_scatter_acc(dev, value, cases: dict, Lv: int):
    """Kernel B7's two launches (`scatter_acc_buckets`, then the rows pass;
    the value gradient of `weighted_gather`) at the decoder shape, on
    uniform and on clustered sampling points (`scatter_case`), beside
    `scatter_add_` of the same updates."""
    from tamtr_torch.kernels.deform_scatter import (
        scatter_acc, scatter_acc_buckets, scatter_acc_buckets_ref, scatter_acc_ref, scatter_acc_rows_ref,
    )

    rows, b_fn, b_buckets, b_rows = {}, {}, {}, {}
    for case, (idx4, w4, dout) in cases.items():
        B, nU, nh = idx4.shape
        c = dout.shape[-1]
        upd = w4[..., None] * dout.repeat_interleave(nU // DEFORM_Q, 1)
        index = idx4.long()[..., None].expand(B, nU, nh, c)
        flat = ((torch.arange(B, device=dev)[:, None, None] * Lv + idx4.long()) * nh
                + torch.arange(nh, device=dev)).reshape(-1)
        rows[case] = scatter_case(
            lambda: scatter_acc(idx4, w4, dout, Lv), lambda: scatter_acc_buckets(idx4, w4, Lv),
            lambda: scatter_acc_buckets_ref(idx4, w4, Lv), lambda: scatter_acc_ref(idx4, w4, dout, Lv),
            lambda: scatter_acc_rows_ref(idx4, w4, dout, Lv), flat, upd.reshape(-1, c),
            lambda: torch.zeros_like(value).scatter_add_(1, index, upd))
        # bytes: dvalue written once (all of it), dout, idx and w read once;
        # operations: a multiply and an add per update and channel
        in_bytes = 4 * (idx4.numel() + w4.numel())
        out_bytes = 4 * (value.numel() + dout.numel())
        b = scatter_bounds(in_bytes + out_bytes, 2 * B * nU * nh * c, in_bytes, out_bytes,
                           scatter_acc_buckets(idx4, w4, Lv))
        b_fn[case], b_buckets[case], b_rows[case] = b[:2], b[2], b[3]
        del upd, index, flat
    idx4 = cases["uniform"][0]
    return report_scatter("scatter_acc", f"value {tuple(value.shape)} Q={DEFORM_Q} p4={idx4.shape[1] // DEFORM_Q}",
                          rows, b_fn, b_buckets, b_rows, "scatter_add_")


def check_scatter_acc_pairs(dev, cases: dict, L2: int):
    """Kernel B8's two launches (`scatter_acc_pairs_buckets`, then the rows
    pass) at G = 32, L2 = 33600, c = 64, Q = 700, on uniform and on
    clustered sampling points (`scatter_case`), beside the two
    `scatter_add_`s of the same updates."""
    from tamtr_torch.kernels.deform_scatter import (
        scatter_acc_pairs, scatter_acc_pairs_buckets, scatter_acc_pairs_buckets_ref, scatter_acc_pairs_ref,
        scatter_acc_pairs_rows_ref,
    )

    rows, b_fn, b_buckets, b_rows = {}, {}, {}, {}
    for case, (idx2, wa, wb, dout) in cases.items():
        G, nU2 = idx2.shape
        c = dout.shape[-1]
        d = dout.repeat_interleave(nU2 // DEFORM_Q, 1)
        ua, ub = wa[..., None] * d, wb[..., None] * d
        ia = idx2.long()[..., None].expand(G, nU2, c)
        gi = torch.arange(G, device=dev)[:, None] * L2
        flat = torch.cat([gi + idx2.long(), gi + idx2.long() + 1], 1).reshape(-1)
        upd = torch.cat([ua, ub], 1).reshape(-1, c)
        rows[case] = scatter_case(
            lambda: scatter_acc_pairs(idx2, wa, wb, dout, L2), lambda: scatter_acc_pairs_buckets(idx2, wa, wb, L2),
            lambda: scatter_acc_pairs_buckets_ref(idx2, wa, wb, L2),
            lambda: scatter_acc_pairs_ref(idx2, wa, wb, dout, L2),
            lambda: scatter_acc_pairs_rows_ref(idx2, wa, wb, dout, L2), flat, upd,
            lambda: torch.zeros(G, L2, c, device=dev).scatter_add_(1, ia, ua).scatter_add_(1, ia + 1, ub))
        # bytes: the output written once (all of it), dout, idx2, wa and wb
        # read once; operations: two multiplies and two adds per pair and channel
        in_bytes = 4 * 3 * G * nU2
        out_bytes = 4 * (G * L2 * c + dout.numel())
        b = scatter_bounds(in_bytes + out_bytes, 4 * G * nU2 * c, in_bytes, out_bytes,
                           scatter_acc_pairs_buckets(idx2, wa, wb, L2))
        b_fn[case], b_buckets[case], b_rows[case] = b[:2], b[2], b[3]
        del d, ua, ub, ia, flat, upd
    G, nU2 = cases["uniform"][0].shape
    return report_scatter("scatter_acc_pairs", f"G={G} L2={L2} c={cases['uniform'][3].shape[-1]} Q={DEFORM_Q} "
                          f"pairs/query={nU2 // DEFORM_Q}", rows, b_fn, b_buckets, b_rows, "2 x scatter_add_")


def drive_ops(dev):
    """The public ops off the model paths, through the entry points a user
    calls, at the 640 px shapes: the ops that reach B6-B8, and
    `auction_match` (B5 with the batch-wide stop and a row mask) on the
    transposed train cost. Inputs are made first; every launch counter is
    zeroed just before the ops run and read just after."""
    from tamtr_torch.kernels.auction import auction_match
    from tamtr_torch.kernels.deform_scatter import scatter_acc_pairs, weighted_gather
    from tamtr_torch.nn.ssm import selective_scan

    g = torch.Generator().manual_seed(21)
    scans = [scan1d_inputs(g, H * W, 2 * C, dev) for H, W, C in LEVELS_640]
    value, (idx4, w4, dout), pairs, Lv = decoder_scatter_inputs(22, dev)
    C, mask = matcher_costs(23, TRAIN_BATCH, TRAIN_MAX_GT, TRAIN_VALID, dev)
    Ct, qmask = C.transpose(1, 2).contiguous(), torch.ones(C.shape[:2], dtype=torch.bool, device=dev)
    leaves = [[t.requires_grad_() for t in args] for args, _ in scans]
    v, w = value.requires_grad_(), w4.requires_grad_()
    counters = zero_counters()
    outs = []
    for ts, (_, dy) in zip(leaves, scans):
        y = selective_scan(*ts)
        outs += [y, *torch.autograd.grad(y, ts, dy)]
    out = weighted_gather(v, idx4, w, idx4.shape[1] // DEFORM_Q)
    outs += [out, *torch.autograd.grad(out, (v, w), dout)]
    outs.append(scatter_acc_pairs(*pairs, Lv))
    per_query = auction_match(Ct, qmask, row_mask=mask)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    want = {k: OPS_LAUNCHES.get(k, 0) for k in counters}
    finite = all(bool(torch.isfinite(t).all()) for t in outs)
    shapes = ([tuple(t.shape) for t in outs[-4:-1]] == [(DEFORM_B, DEFORM_Q, 8, 64), tuple(value.shape), tuple(w4.shape)]
              and tuple(outs[-1].shape) == (pairs[0].shape[0], Lv, 64))
    # every query of an image with at least nq valid gts holds a distinct valid gt
    full = mask.sum(1) >= C.shape[1]
    matched = per_query[full]
    assigned = bool((matched >= 0).all()) and all(len(set(r.tolist())) == len(r) for r in matched.cpu())
    print(f"ops: selective_scan fwd+bwd at 3 levels, weighted_gather fwd+bwd, scatter_acc_pairs, auction_match "
          f"(transposed, row mask): outputs finite {finite}, shapes {shapes}, full images fully assigned "
          f"{assigned}, launches {launches}", flush=True)
    shapes = shapes and assigned
    if not (finite and shapes and launches == want):
        raise AssertionError(f"ops path: finite {finite}, shapes {shapes}, launches {launches}; want {want}")
    return launches


@torch.no_grad()
def spread_scores(model, seed: int):
    """Give the zero-initialised head layers small random values and the
    contrastive heads a zero bias, so that boxes and scores vary across
    queries and the comparison and postprocess see real work."""
    g = torch.Generator().manual_seed(seed)
    head = model.model[-1]
    for mlp in [head.enc_bbox_head, *head.dec_bbox_head]:
        mlp.layers[-1].weight.copy_(torch.randn(mlp.layers[-1].weight.shape, generator=g) * 0.05)
    for layer in head.decoder["layers"]:
        for lin in (layer.cross_attn.sampling_offsets, layer.cross_attn.attention_weights):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * 0.05)
    for sh in head.dec_score_head:
        sh.bias.zero_()


def same_set(got: np.ndarray, want: np.ndarray):
    """Eval outputs (B, nq, 4 + nc), card against CPU, as a tie-robust set:
    rows paired by a min-cost assignment on their largest difference, each
    pair within 1e-3; at most 2 unpaired rows an image (near-tied queries
    the top-k selection swaps), whose best scores agree at 5e-3. Returns the
    worst paired difference and the unpaired count."""
    from scipy.optimize import linear_sum_assignment

    worst, unmatched = 0.0, 0
    for b in range(got.shape[0]):
        dist = np.abs(got[b][:, None] - want[b][None]).max(-1)
        r, c = linear_sum_assignment(dist)
        matched = dist[r, c] < 1e-3
        unmatched += int((~matched).sum())
        worst = max(worst, float(dist[r, c][matched].max()))
        if (~matched).sum() > 2:
            raise AssertionError(f"GPU vs CPU: {(~matched).sum()} unmatched rows, {np.sort(dist[r, c])[-3:]}")
        if not matched.all():
            np.testing.assert_allclose(np.sort(got[b][r[~matched], 4:].max(-1)),
                                       np.sort(want[b][c[~matched], 4:].max(-1)), atol=5e-3)
    return worst, unmatched


def check_parity(dev):
    """Full-width model on the card vs on the CPU, same weights, TF32 off."""
    import copy

    from tamtr_torch.nn.graph import TAMTRModel
    from tamtr_torch.weights import init_parameters

    cpu_model = TAMTRModel.from_cfg("tamtr.yaml", nc=10)
    init_parameters(cpu_model, seed=0)
    spread_scores(cpu_model, seed=0)
    cpu_model.eval()
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.random((2, 128, 128, 3), dtype=np.float32))
    txt = torch.from_numpy(rng.standard_normal((1, 10, 512)).astype(np.float32))
    txt = txt / txt.norm(dim=-1, keepdim=True)
    with torch.inference_mode():
        got = gpu_model(img.to(dev), txt.to(dev))["pred"].cpu().numpy()
        t0 = time.perf_counter()
        want = cpu_model(img, txt)["pred"].numpy()
        cpu_s = time.perf_counter() - t0
    worst, unmatched = same_set(got, want)
    if not np.isfinite(got).all() or want[..., 4:].std() < 0.05:
        raise AssertionError("parity outputs are not finite or carry no score spread")
    print(f"parity tamtr.yaml 128px b2: worst matched row diff {worst:.3g}, unmatched {unmatched}, "
          f"cpu forward {cpu_s:.2f} s", flush=True)
    return worst


@contextlib.contextmanager
def pinned_topk(record: list, replay=None):
    """Records the indices of every `Tensor.topk` call (the decoder's
    encoder-query selection), or, given `replay`, returns those instead: two
    runs then select the same queries in the same order, which near-tied
    scores need not do across devices and precisions."""
    orig, calls = torch.Tensor.topk, iter(replay or [])

    def topk(self, *a, **kw):
        if replay is None:
            res = orig(self, *a, **kw)
            record.append(res.indices.cpu())
            return res
        idx = next(calls).to(self.device)
        return torch.return_types.topk((self.gather(1, idx), idx))

    torch.Tensor.topk = topk
    try:
        yield
    finally:
        torch.Tensor.topk = orig


def check_train_parity(dev):
    """One training step of the full-width model, card against CPU, from one
    state dict: 128 px, batch 2, max_gt 8, CDN noise and DropPath off.

    Two discrete choices sit in the step: the auction (a discontinuous
    function of the cost) and the order of the top-k encoder queries (near
    ties order differently under other rounding); either moves whole terms
    of the gradient. So the forward and backward are compared twice:
      - as each device runs them: assignments identical in >= 90% of the
        valid (layer, gt) pairs, loss components within 1e-2 relative (a
        moved assignment moves its pair's loss);
      - with the CPU's assignment and top-k order given to the card and to a
        CPU fp64 pass, against the fp32 noise floor that pass measures (two
        independent fp32 roundings lie ~1.4x one rounding apart): the
        largest relative loss-component difference card vs CPU <= 2x the
        largest CPU vs fp64, and |g_card - g_cpu| <= 2 |g_cpu - g_fp64| over
        the whole gradient and over the VSSBlocks and `cross_attn.value_proj`
        tensors together, each of which must have a non-zero gradient on the
        card. Train-mode BatchNorm over 2 images down to 4x4 maps amplifies
        rounding: that floor is ~1e-3 on the losses and a few percent on the
        gradient, where the eval-mode forward of `check_parity` agrees at
        ~1e-6;
      - after `Trainer.step` (as each device runs it), every parameter within
        1e-6 + 2% of its CPU step, except elements whose gradient sign the
        noise flips: <= 3% of the moved elements."""
    import copy

    from tamtr_torch.losses.detr_loss import DETRLossConfig, rtdetr_detection_loss
    from tamtr_torch.nn.graph import TAMTRModel
    from tamtr_torch.train.trainer import Trainer, TrainConfig
    from tamtr_torch.weights import init_parameters

    M = 8
    base = TAMTRModel.from_cfg("tamtr.yaml", nc=10, max_gt=M, vss_drop_path=0.0,
                               label_noise_ratio=0.0, box_noise_scale=0.0)
    init_parameters(base, seed=0)
    spread_scores(base, seed=0)
    batch = synthetic_batch(14, 2, 128, M, (5, 8))
    probe = lambda k: "VSSBlocks" in k or "cross_attn.value_proj" in k  # noqa: E731

    def grads_on(d, dtype=torch.float32, match=None, topk=None):
        model = copy.deepcopy(base).to(d, dtype).train()
        t = {"cls": torch.from_numpy(batch["cls"]).to(d), "mask": torch.from_numpy(batch["mask"]).to(d),
             "bboxes": torch.from_numpy(batch["bboxes"]).to(d, dtype)}
        img = torch.from_numpy(batch["img"]).to(d, dtype) / 255.0
        record = []
        with pinned_topk(record, topk):
            out = model(img, torch.from_numpy(batch["txt_feats"]).to(d, dtype), t)
        loss, items = rtdetr_detection_loss(out, t, DETRLossConfig(nc=10), match=match)
        loss.backward()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu().double()
                 for k, p in model.named_parameters()}
        return {k: float(v.detach()) for k, v in items.items() if v.ndim == 0}, items["match"].cpu(), grads, record

    rel = lambda a, b: max(abs(a[k] - v) / max(abs(v), 1e-6) for k, v in b.items())  # noqa: E731
    t0 = time.perf_counter()
    cpu_items, cpu_match, cpu_g, cpu_topk = grads_on(torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    if len(cpu_topk) != 1:
        raise AssertionError(f"expected one top-k query selection per forward, saw {len(cpu_topk)}")
    gpu_items, gpu_match, _, _ = grads_on(dev)
    fix_items, _, gpu_g, _ = grads_on(dev, match=cpu_match, topk=cpu_topk)
    exact_items, _, exact, _ = grads_on(torch.device("cpu"), torch.float64, match=cpu_match, topk=cpu_topk)
    worst_item, worst_fixed, item_noise = rel(gpu_items, cpu_items), rel(fix_items, cpu_items), rel(cpu_items, exact_items)
    valid = torch.from_numpy(batch["mask"])[None].expand_as(cpu_match)
    agree = float((gpu_match == cpu_match)[valid].float().mean())
    flat = lambda g, sel=lambda k: True: torch.cat([v.flatten() for k, v in g.items() if sel(k)])  # noqa: E731
    d_card = (flat(gpu_g) - flat(cpu_g)).norm().item()
    d_noise = (flat(cpu_g) - flat(exact)).norm().item()
    p_card = (flat(gpu_g, probe) - flat(cpu_g, probe)).norm().item()
    p_noise = (flat(cpu_g, probe) - flat(exact, probe)).norm().item()
    zero = [k for k, g in gpu_g.items() if probe(k) and g.abs().max().item() == 0 and exact[k].abs().max() > 0]

    steps = []
    for d in (dev, torch.device("cpu")):
        tr = Trainer(copy.deepcopy(base), TrainConfig(batch_size=2, accumulate=1), device=d)
        loss = tr.step(batch)["loss"]
        steps.append(({k: p.detach().cpu() for k, p in tr.model.named_parameters()}, loss))
    top = max(g.norm().item() for g in cpu_g.values())
    flips = moved = 0
    before = dict(base.named_parameters())
    for k, g in cpu_g.items():
        live = g.abs() > 1e-3 * g.abs().max() if g.norm().item() > 1e-6 * top else torch.zeros_like(g, dtype=torch.bool)
        step = (steps[1][0][k] - before[k].detach()).abs()
        flips += int((live & ((steps[0][0][k] - steps[1][0][k]).abs() > 1e-6 + 0.02 * step)).sum())
        moved += int((live & (step > 0)).sum())
    print(f"train parity tamtr.yaml 128px b2: loss card {steps[0][1]:.6f} cpu {steps[1][1]:.6f}; as run: "
          f"worst loss-component rel diff {worst_item:.3g}, assignments agree {agree:.4f}; with the cpu's "
          f"assignment and top-k: worst loss-component rel diff {worst_fixed:.3g} vs fp32 noise {item_noise:.3g}, gradient |card - cpu| / "
          f"|cpu| {d_card / flat(cpu_g).norm().item():.3g} vs fp32 noise |cpu - fp64| / |cpu| "
          f"{d_noise / flat(cpu_g).norm().item():.3g}; VSSBlocks + value_proj {p_card / flat(cpu_g, probe).norm().item():.3g}"
          f" vs {p_noise / flat(cpu_g, probe).norm().item():.3g}; step flips {flips}/{moved}; cpu forward+backward "
          f"{cpu_s:.2f} s", flush=True)
    if not (worst_item < 1e-2 and agree >= 0.9 and worst_fixed <= 2 * item_noise and d_card <= 2 * d_noise
            and p_card <= 2 * p_noise and not zero and moved > 0 and flips <= 0.03 * moved):
        raise AssertionError(f"train parity failed (zero-gradient tensors on the card: {zero[:5]})")
    return d_card / flat(cpu_g).norm().item()


def train(dev):
    """The slice's path: `TAMTR(...).trainer().step` on `tamtr.yaml` at
    640 px, batch 4, max_gt 300, accumulate 1."""
    from tamtr_torch import TAMTR
    from tamtr_torch.train.trainer import TrainConfig

    det = TAMTR("tamtr.yaml", nc=10, device=dev, seed=0, max_gt=TRAIN_MAX_GT)
    tr = det.trainer(TrainConfig(batch_size=TRAIN_BATCH, accumulate=1), seed=0)
    p0 = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    batches = [synthetic_batch(100 + i, TRAIN_BATCH, TRAIN_IMGSZ, TRAIN_MAX_GT, TRAIN_VALID)
               for i in range(WARMUP_STEPS + TIMED_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    for b in batches[:WARMUP_STEPS]:  # first steps pick cuDNN algorithms
        tr.step(b)
    counters = zero_counters()
    times, logs = [], []
    for b in batches[WARMUP_STEPS:]:
        t0 = time.perf_counter()
        m = tr.step(b)  # ends in host reads of the metrics: the device has finished
        times.append((time.perf_counter() - t0) * 1e3)
        logs.append(m)
    launches = {k: f.launches for k, f in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    want = {k: v * TIMED_STEPS for k, v in TRAIN_LAUNCHES_PER_STEP.items()}
    finite = all(math.isfinite(v) for m in logs for v in m.values())
    moved = any(not torch.equal(p0[k], v) for k, v in tr.model.state_dict().items() if v.is_floating_point())
    ema_moved = any(not torch.equal(p0[k], v) for k, v in tr.ema.state_dict().items() if v.is_floating_point())
    print(f"train tamtr.yaml {TRAIN_IMGSZ}px b{TRAIN_BATCH} max_gt {TRAIN_MAX_GT}: step ms "
          f"{[round(t, 3) for t in times]}, loss {[round(m['loss'], 4) for m in logs]}, giou/class/bbox "
          f"{[(round(m['giou'], 3), round(m['class'], 3), round(m['bbox'], 3)) for m in logs]}, grad_norm "
          f"{[round(m['grad_norm'], 2) for m in logs]}, max_memory_allocated {peak / 2**20:.1f} MiB, "
          f"launches {launches} over {TIMED_STEPS} steps", flush=True)
    if not (finite and moved and ema_moved and all(m["stepped"] == 1.0 for m in logs)):
        raise AssertionError(f"training step: finite {finite}, params moved {moved}, EMA moved {ema_moved}")
    if launches != want:
        raise AssertionError(f"launches {launches} over {TIMED_STEPS} steps; want {want}")
    # one more step, its B4 inputs kept for `check_gather_bwd_step` (after the
    # counts and the peak are read: keeping them raises the peak)
    b4_calls = []
    with recording_gather_bwd(b4_calls):
        tr.step(batches[-1])
    return launches, times, peak, [tuple(t.detach() for t in args) for args in b4_calls]


def serve(dev):
    """The main path: predict requests through the public entry point."""
    from tamtr_torch import TAMTR

    det = TAMTR("tamtr.yaml", nc=10, seed=0)
    spread_scores(det.model, seed=1)
    rng = np.random.default_rng(4)
    text = rng.standard_normal((10, 512)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    frames = [rng.integers(0, 256, (765, 1360, 3), dtype=np.uint8) for _ in range(4)]
    torch.cuda.reset_peak_memory_stats()
    counters = zero_counters()
    forwards, times = 0, {"b1": [], "b4": []}

    def request(images, key=None):
        nonlocal forwards
        t0 = time.perf_counter()
        res = det.predict(images, text)  # ends in host copies: the device has finished
        dt = (time.perf_counter() - t0) * 1e3
        forwards += 1
        if key:
            times[key].append(dt)
        for r in res:
            n = len(r["scores"])
            if r["boxes"].shape != (n, 4) or r["labels"].shape != (n,) or not np.isfinite(r["boxes"]).all():
                raise AssertionError("malformed predict result")
        return res

    request(frames[0])  # warm-up at both batch sizes: first calls pick conv algorithms
    request(frames)
    for i in range(5):
        res = request(frames[i % 4], "b1")
    res4 = request(frames, "b4")
    launches = {k: f.launches for k, f in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    want = {k: FORWARD_LAUNCHES.get(k, 0) * forwards for k in counters}
    if len(res4) != 4 or launches != want:
        raise AssertionError(f"launches {launches} after {forwards} forwards; want {want}")
    print(f"serve tamtr.yaml 640px: batch-1 ms {[round(t, 3) for t in times['b1']]}, "
          f"batch-4 ms {[round(t, 3) for t in times['b4']]}, detections/image {len(res[0]['scores'])}, "
          f"max_memory_allocated {peak / 2**20:.1f} MiB, forwards {forwards}, launches {launches}",
          flush=True)
    return launches


def fit(dev):
    """The dataset path: `Engine.train` on the generated dataset of
    `tools/smoke_train_torch.py` (640 px, 16 train and 8 val images, max_gt
    32) with the full-width `tamtr.yaml` (nc 3): 2 epochs at batch 4, 2
    loader workers, val after each epoch, `last` saved each epoch; then
    `resume=True` for a third epoch from `last`, and `Engine.val` on `best`.
    Every launch counter is zeroed before train and before val and read
    after each; the card's val forward on the first 2 val images is held
    against the CPU's with the same EMA weights (`same_set`)."""
    import copy
    import csv
    import shutil
    from pathlib import Path

    from tamtr_torch.engine.model import Engine
    from tools.smoke_train_torch import make_dataset

    root = Path("build/fit")
    shutil.rmtree(root, ignore_errors=True)
    data = str(make_dataset(root, FIT_TRAIN, FIT_VAL, TRAIN_IMGSZ))
    args = dict(data=data, batch=TRAIN_BATCH, imgsz=TRAIN_IMGSZ, max_gt=FIT_MAX_GT, workers=2, warmup_epochs=4,
                val_interval=1, save_interval=1, conf=0.05, plots=False, project=str(root / "runs"), name="fit")
    torch.cuda.reset_peak_memory_stats()
    counters = zero_counters()
    t0 = time.perf_counter()
    first = Engine("tamtr.yaml")
    first.train(epochs=2, **args)
    seen = {}
    resumed = Engine("tamtr.yaml")
    resumed.callbacks.add("on_train_start", lambda e: seen.update(
        ni=e.trainer.ni, count=e.trainer.count, generator=e.trainer.generator.get_state().clone()))
    resumed.callbacks.add("on_train_epoch_start", lambda e, epoch: seen.setdefault("epoch", epoch))
    res = resumed.train(epochs=3, resume=True, **args)
    train_s = time.perf_counter() - t0
    train_launches = {k: f.launches for k, f in counters.items()}
    steps = len(first.timing["step_ms"]) + len(resumed.timing["step_ms"])
    val_forwards = 3 * math.ceil(FIT_VAL / TRAIN_BATCH)
    want = {k: TRAIN_LAUNCHES_PER_STEP[k] * steps + FORWARD_LAUNCHES.get(k, 0) * val_forwards for k in counters}
    with open(root / "runs" / "fit" / "results.csv") as f:
        rows = list(csv.DictReader(f))
    restored = (seen.get("epoch") == 2 and seen.get("ni") == first.trainer.ni and seen.get("count") == first.trainer.count
                and torch.equal(seen.get("generator", torch.empty(0)), first.trainer.generator.get_state()))

    counters = zero_counters()
    best = Engine("tamtr.yaml").load(root / "runs" / "fit" / "weights" / "best.pt")
    val = best.val(**args)
    val_launches = {k: f.launches for k, f in counters.items()}
    val_want = {k: FORWARD_LAUNCHES.get(k, 0) * math.ceil(FIT_VAL / TRAIN_BATCH) for k in counters}
    peak = torch.cuda.max_memory_allocated()

    from tamtr_torch.data.dataset import DetectionDataset

    ds = DetectionDataset(Path(data).parent / "val" / "images", imgsz=TRAIN_IMGSZ)
    img = torch.from_numpy(np.stack([ds.get_val(i)[0] for i in range(2)]))
    txt = torch.as_tensor(best.txt_feats[None], dtype=torch.float32)
    cpu_model = copy.deepcopy(best.model).cpu()
    with torch.inference_mode():
        got = best.model(img.to(dev), txt.to(dev))["pred"].cpu().numpy()
        want_cpu = cpu_model(img, txt)["pred"].numpy()
    worst, unmatched = same_set(got, want_cpu)

    step_ms = np.asarray(first.timing["step_ms"][2:] + resumed.timing["step_ms"][1:])
    wait_ms = np.asarray(first.timing["wait_ms"][2:] + resumed.timing["wait_ms"][1:])
    losses = [float(r["loss"]) for r in rows]
    in_range = all(0.0 <= m[k] <= 1.0 for m in (res, val) for k in ("mAP50", "mAP50-95", "precision", "recall"))
    summary = dict(step_ms_median=float(np.median(step_ms)), loader_wait_ms_mean=float(wait_ms.mean()),
                   loader_wait_ms_median=float(np.median(wait_ms)),
                   loader_wait_share=float(wait_ms.sum() / (wait_ms.sum() + step_ms.sum())),
                   val_images_per_sec=val["images_per_sec"], mAP50=val["mAP50"], mAP50_95=val["mAP50-95"],
                   max_memory_allocated_mib=peak / 2**20, train_and_resume_s=train_s, steps=steps,
                   timed_steps=len(step_ms), val_parity_worst=worst, val_parity_unmatched=unmatched)
    print(f"fit tamtr.yaml {TRAIN_IMGSZ}px b{TRAIN_BATCH} on {FIT_TRAIN}+{FIT_VAL} generated images: "
          f"{json.dumps(summary)}; results.csv losses {[round(x, 4) for x in losses]}; resume restored epoch, ni, "
          f"count and generator: {restored}; launches train {train_launches}, val {val_launches}", flush=True)
    if not (len(rows) == 3 and all(math.isfinite(x) for x in losses) and in_range and restored):
        raise AssertionError(f"fit: rows {len(rows)}, losses {losses}, metrics in [0, 1] {in_range}, "
                             f"resume restored {restored} ({ {k: v for k, v in seen.items() if k != 'generator'} })")
    if train_launches != want or val_launches != val_want:
        raise AssertionError(f"fit launches: train {train_launches} (want {want}), val {val_launches} "
                             f"(want {val_want})")
    return {k: train_launches[k] + val_launches[k] for k in counters}, summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from tamtr_torch.kernels import _build

    dev = torch.device("cuda")
    # full fp32 throughout, as the reference ships: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)

    log = _build.build_all()  # a fresh checkout has no build/: this compiles every source
    print(f"build: {log['seconds']:.1f} s", flush=True)
    for line in log["ptxas"]:
        print(f"  {line}")

    scan_rows, scan_err = check_ss2d_scan(dev)
    gather = check_bilinear_gather(dev)
    bwd_rows, bwd_err = check_ss2d_scan_bwd(dev)
    gather_bwd, gather_train = check_bilinear_gather_bwd(dev)
    auction = check_auction(dev)
    auction_any = check_auction_any_size(dev)
    scan1d_rows, scan1d_err = check_selective_scan(dev)
    value, gather_args, pairs, Lv = decoder_scatter_inputs(17, dev)
    _, gather_clustered, pairs_clustered, _ = decoder_scatter_inputs(18, dev, clustered=True)
    scatter = check_scatter_acc(dev, value, dict(uniform=gather_args, clustered=gather_clustered), Lv)
    scatter_pairs = check_scatter_acc_pairs(dev, dict(uniform=pairs, clustered=pairs_clustered), Lv)
    del value, gather_args, pairs, gather_clustered, pairs_clustered
    ops_launches = drive_ops(dev)
    check_parity(dev)
    check_train_parity(dev)
    launches = serve(dev)
    train_launches, _, _, b4_calls = train(dev)
    gather_bwd.update(check_gather_bwd_step(b4_calls))
    gather_step = check_gather_fwd_step(b4_calls)
    del b4_calls
    fit_launches, fit_summary = fit(dev)

    def slice3(name, reached_through):
        return dict(launches=ops_launches[name], launches_serve=launches[name],
                    launches_train=train_launches[name], launches_fit=fit_launches[name],
                    reached_through=reached_through)

    fwd1, fwd4 = ([r for r in scan_rows if r["B"] == b] for b in (1, TRAIN_BATCH))
    levels1d = scan1d_rows[:len(LEVELS_640)]
    kernels = [
        dict(name="ss2d_scan_fwd", route="cuda", source="tamtr_torch/csrc/ss2d_scan_fwd.cu",
             replaces="tamtr_tpu/kernels/selective_scan.py:448", launches=launches["ss2d_scan_fwd"],
             **{f"launches_{p}": launches[f"ss2d_scan_fwd_{p}"] for p in ("summaries", "combine", "output")},
             launches_train=train_launches["ss2d_scan_fwd"], launches_fit=fit_launches["ss2d_scan_fwd"],
             max_abs_err=scan_err,
             **{k: sum(r[k] for r in fwd1) for k in ("ms", "ms_summaries", "ms_combine", "ms_output", "plain_ms",
                                                        "bound_ms", "bound_summaries_ms", "bound_combine_ms",
                                                        "bound_output_ms")},
             bound_by=max(fwd1, key=lambda r: r["bound_ms"])["bound_by"], library_ms=None,
             batch=1, ms_b4=sum(r["ms"] for r in fwd4), plain_ms_b4=sum(r["plain_ms"] for r in fwd4),
             bound_ms_b4=sum(r["bound_ms"] for r in fwd4),
             bound_of_launches="each launch alone, the segment states it writes or reads included",
             per_level=scan_rows),
        dict(name="bilinear_gather_fwd", route="cuda", source="tamtr_torch/csrc/bilinear_gather_fwd.cu",
             replaces="tamtr_tpu/kernels/deform_scatter.py:195", launches=launches["bilinear_gather_fwd"],
             launches_train=train_launches["bilinear_gather_fwd"], launches_fit=fit_launches["bilinear_gather_fwd"],
             **{**gather, "max_abs_err": max(gather["max_abs_err"], gather_train["max_abs_err"],
                                             gather_step["max_abs_err_step"])},
             ms_of="CUDA events over back-to-back calls, as for every kernel; ms_device: the kernel's own "
                   "time per call (torch.profiler)",
             shape="value (1, 33600, 8, 64), Q = 100", train_b4_q700={**gather_train, "shape": "value (4, 33600, "
                                                                    "8, 64), Q = 700, uniform pairs"},
             **gather_step),
        dict(name="ss2d_scan_carriers (B3a segment summaries + ss2d_scan_combine)", route="cuda",
             source="tamtr_torch/csrc/ss2d_scan_bwd.cu", replaces="tamtr_tpu/kernels/selective_scan.py:663",
             launches=train_launches["ss2d_scan_carriers"], launches_combine=train_launches["ss2d_scan_combine"],
             launches_fit=fit_launches["ss2d_scan_carriers"], launches_fit_combine=fit_launches["ss2d_scan_combine"],
             max_abs_err=bwd_err, ms=sum(r["ms_summaries"] + r["ms_combine"] for r in bwd_rows),
             ms_summaries=sum(r["ms_summaries"] for r in bwd_rows), ms_combine=sum(r["ms_combine"] for r in bwd_rows),
             plain_ms=sum(r["plain_ms"] for r in bwd_rows), plain_of="the whole plain backward",
             bound_ms=sum(r["bound_b3a_ms"] for r in bwd_rows),
             bound_by=max(bwd_rows, key=lambda r: r["bound_b3a_ms"])["bound_b3a_by"],
             bound_of="these launches alone, the segment summaries they write included", library_ms=None,
             per_level=bwd_rows),
        dict(name="ss2d_scan_bwd_walk (B3b segment walk)", route="cuda",
             source="tamtr_torch/csrc/ss2d_scan_bwd.cu", replaces="tamtr_tpu/kernels/selective_scan.py:684",
             launches=train_launches["ss2d_scan_bwd_walk"], launches_fit=fit_launches["ss2d_scan_bwd_walk"],
             max_abs_err=bwd_err,
             ms=sum(r["ms_walk"] for r in bwd_rows), plain_ms=sum(r["plain_ms"] for r in bwd_rows),
             plain_of="the whole plain backward", bound_ms=sum(r["bound_b3b_ms"] for r in bwd_rows),
             bound_by=max(bwd_rows, key=lambda r: r["bound_b3b_ms"])["bound_b3b_by"],
             bound_of="this launch alone, the segment summaries it reads included", library_ms=None,
             bound_b3a_plus_b3b_ms=sum(r["bound_ms"] for r in bwd_rows),
             bound_b3a_plus_b3b_by=max(bwd_rows, key=lambda r: r["bound_ms"])["bound_by"],
             ms_b3a_plus_b3b=sum(r["ms"] for r in bwd_rows)),
        dict(name="bilinear_gather_bwd (pair_buckets + rows pass)", route="cuda",
             source="tamtr_torch/csrc/bilinear_gather_bwd.cu", replaces="tamtr_tpu/kernels/deform_scatter.py:283",
             launches=train_launches["bilinear_gather_bwd"], launches_buckets=train_launches["pair_buckets"],
             launches_fit=fit_launches["bilinear_gather_bwd"], launches_fit_buckets=fit_launches["pair_buckets"],
             **gather_bwd),
        dict(name="auction_assignment", route="cuda", source="tamtr_torch/csrc/auction.cu",
             replaces="tamtr_tpu/kernels/auction.py:33", launches=train_launches["auction_assignment"],
             launches_fit=fit_launches["auction_assignment"], **auction,
             launches_auction_match=slice3("auction_match", "tamtr_torch.kernels.auction.auction_match"),
             any_size=auction_any),
        dict(name="selective_scan_fwd", route="cuda", source="tamtr_torch/csrc/selective_scan_fwd.cu",
             replaces="tamtr_tpu/kernels/selective_scan.py:72",
             **slice3("selective_scan_fwd", "tamtr_torch.nn.ssm.selective_scan"),
             **{f"launches_{p}": ops_launches[f"selective_scan_fwd_{p}"] for p in ("summaries", "combine", "output")},
             max_abs_err=scan1d_err,
             **{k: sum(r[k] for r in levels1d) for k in ("ms", "ms_summaries", "ms_combine", "ms_output", "plain_ms",
                                                          "bound_ms", "bound_summaries_ms", "bound_combine_ms",
                                                          "bound_output_ms")},
             bound_by=max(levels1d, key=lambda r: r["bound_ms"])["bound_by"], library_ms=None,
             sums_of="the three 640 px levels, G = 4", per_level=scan1d_rows),
        dict(name="scatter_acc (scatter_acc_buckets + rows pass)", route="cuda",
             source="tamtr_torch/csrc/deform_scatter.cu", replaces="tamtr_tpu/kernels/deform_scatter.py:86",
             **slice3("scatter_acc", "tamtr_torch.kernels.deform_scatter.weighted_gather (backward)"),
             launches_buckets=ops_launches["scatter_acc_buckets"], **scatter),
        dict(name="scatter_acc_pairs (scatter_acc_pairs_buckets + rows pass)", route="cuda",
             source="tamtr_torch/csrc/deform_scatter.cu", replaces="tamtr_tpu/kernels/deform_scatter.py:359",
             **slice3("scatter_acc_pairs", "tamtr_torch.kernels.deform_scatter.scatter_acc_pairs"),
             launches_buckets=ops_launches["scatter_acc_pairs_buckets"], **scatter_pairs),
    ]
    print(json.dumps({"fit": fit_summary}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
