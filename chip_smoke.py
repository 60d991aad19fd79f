"""Smoke run of the PyTorch port (`tamtr_torch`) on one NVIDIA H100.

Run from the root of a checkout: `python3 chip_smoke.py`. Phases:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions. Without a card the script exits non-zero and prints no result.
2. build: nvcc over `tamtr_torch/csrc/*.cu` (one process per source, all
   started together); prints the seconds and the ptxas register lines.
3. kernels: each hand-written kernel against its plain PyTorch version at the
   640 px main-path shapes (B=1): the SS2D scan at its three levels (1e-4),
   the bilinear pair gather at value (1, 33600, 8, 64), Q=100 (1e-5). Times
   from CUDA events, warm; the bound from this run's bytes and operations.
4. parity: the full-width `tamtr.yaml` model (nc=10) at 128 px, batch 2,
   on the card and on the CPU with the same state dict, compared as a
   tie-robust set at 1e-3. The whole run keeps TF32 off (full fp32).
5. serve: `TAMTR("tamtr.yaml", nc=10)` on the card answers a warm-up
   request at batch 1 and at batch 4, then 5 batch-1 requests and one
   batch-4 request of 1360x765 uint8 images (resized to 640 px on the card). The kernels' launch counters are zeroed
   just before and read just after: each must equal 3 per forward.
6. One JSON line of per-kernel numbers, then the result line
   `{"ok": true, "device": {...}}` last.
"""

from __future__ import annotations

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


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_ss2d_scan(dev):
    """The scan kernel vs its plain version at the three 640 px levels."""
    from tamtr_torch.kernels.selective_scan import ss2d_scan, ss2d_scan_ref
    from tamtr_torch.weights import dt_bias_init

    g = torch.Generator().manual_seed(1)
    rows, err = [], 0.0
    for H, W, C in LEVELS_640:
        L, D, R, N = H * W, 2 * C, math.ceil(C / 16), 16
        layouts = torch.randn(1, 2, L, D, generator=g)
        x_dbl = torch.randn(1, 2, 2, L, R + 2 * N, generator=g) * 0.6
        dts_raw, Bs, Cs = x_dbl.to(dev).split([R, N, N], -1)  # views, as SS2D passes them
        dt_w = (torch.rand(4, D, R, generator=g) * 2 - 1) * R**-0.5
        dt_b = dt_bias_init((4, D), g)
        A = -torch.arange(1, N + 1, dtype=torch.float32).expand(4, D, N).contiguous()
        Ds = torch.ones(4, D)
        args = [layouts.to(dev), dts_raw, dt_w.to(dev), dt_b.to(dev), A.to(dev), Bs, Cs, Ds.to(dev)]
        y = ss2d_scan(*args)
        want = ss2d_scan_ref(*args)
        torch.cuda.synchronize()
        e = (y - want).abs().max().item()
        ok = torch.allclose(y, want, atol=1e-4, rtol=1e-4) and bool(torch.isfinite(y).all())
        ms = cuda_ms(lambda: ss2d_scan(*args), iters=5)
        plain = cuda_ms(lambda: ss2d_scan_ref(*args), iters=2)
        nbytes = 4 * (2 * L * D + 4 * L * R + 8 * L * N + 4 * D * (R + N + 2) + 4 * L * D)
        flops = 4 * L * D * (2 * R + 8 * N + 3)
        b_ms, b_by = bound(nbytes, flops)
        rows.append(dict(L=L, D=D, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by))
        print(f"ss2d_scan_fwd L={L} D={D} R={R}: max_abs_err={e:.3g} ms={ms:.4f} "
              f"plain_ms={plain:.3f} bound_ms={b_ms:.4f} ({b_by})", flush=True)
        if not ok:
            raise AssertionError(f"ss2d_scan kernel disagrees with its plain version at L={L}: {e}")
        err = max(err, e)
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


def check_bilinear_gather(dev):
    """The pair-gather kernel vs its plain version at the 640 px decoder shape."""
    from tamtr_torch.kernels.deform_scatter import bilinear_gather, bilinear_gather_ref
    from tamtr_torch.nn.decoder import deform_sampling_pairs

    shapes = [(h, w) for h, w, _ in LEVELS_640]
    B, Q, nh, c, nl, P = 1, 100, 8, 64, 3, 4
    Lv = sum(h * w for h, w in shapes)
    g = torch.Generator().manual_seed(2)
    value = torch.randn(B, Lv, nh, c, generator=g)
    loc = torch.rand(B, Q, nh, nl, P, 2, generator=g) * 1.1 - 0.05
    H2, W2 = shapes[2]
    loc[0, 0, 0, 2, 0] = torch.tensor([1 - 0.2 / W2, 1 - 0.2 / H2])  # last pixel cell of level 2
    loc[0, 1, 1, 0, 2] = torch.tensor([0.2 / shapes[0][1], 0.5])  # x0 < 0
    loc[0, 2, 0, 0, 3] = torch.tensor([1 - 0.3 / shapes[0][1], 1 - 0.3 / shapes[0][0]])  # level boundary
    w_att = torch.rand(B, Q, nh, nl, P, generator=g)
    w_att = w_att / w_att.sum((-1, -2), keepdim=True)
    value, loc, w_att = value.to(dev), loc.to(dev), w_att.to(dev)
    idx4, w_pairs, idx2 = deform_sampling_pairs(shapes, loc, w_att)
    if int(idx2.max()) != Lv - 1:
        raise AssertionError("the last-cell sample point did not reach the global last row")
    out = bilinear_gather(value, idx4, w_pairs, idx2, nl * P)
    want = bilinear_gather_ref(value, idx4, w_pairs, idx2, nl * P)
    lib = grid_sample_deform(value, shapes, loc, w_att)
    torch.cuda.synchronize()
    e = (out - want).abs().max().item()
    e_lib = (out - lib).abs().max().item()
    ms = cuda_ms(lambda: bilinear_gather(value, idx4, w_pairs, idx2, nl * P), iters=50)
    plain = cuda_ms(lambda: bilinear_gather_ref(value, idx4, w_pairs, idx2, nl * P), iters=20)
    lib_ms = cuda_ms(lambda: grid_sample_deform(value, shapes, loc, w_att), iters=20)
    ppq = 2 * nl * P
    rows = torch.cat([idx2.clamp(max=Lv - 2), idx2.clamp(max=Lv - 2) + 1], 1).long()  # after the shift
    touched = torch.unique(rows * nh + torch.arange(nh, device=dev)).numel()
    nbytes = touched * c * 4 + idx2.numel() * 4 + w_pairs.numel() * 4 + out.numel() * 4
    flops = B * Q * nh * ppq * c * 4
    b_ms, b_by = bound(nbytes, flops)
    print(f"bilinear_gather_fwd Lv={Lv} Q={Q}: max_abs_err={e:.3g} (vs grid_sample {e_lib:.3g}) "
          f"ms={ms:.4f} plain_ms={plain:.4f} library_ms={lib_ms:.4f} bound_ms={b_ms:.5f} ({b_by})",
          flush=True)
    if not (torch.allclose(out, want, atol=1e-5, rtol=1e-5) and e_lib < 1e-4):
        raise AssertionError(f"bilinear_gather kernel disagrees: {e} (grid_sample {e_lib})")
    return dict(ms=ms, plain_ms=plain, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=e)


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


def check_parity(dev):
    """Full-width model on the card vs on the CPU, same weights, TF32 off."""
    import copy

    from scipy.optimize import linear_sum_assignment

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
    if not np.isfinite(got).all() or want[..., 4:].std() < 0.05:
        raise AssertionError("parity outputs are not finite or carry no score spread")
    print(f"parity tamtr.yaml 128px b2: worst matched row diff {worst:.3g}, unmatched {unmatched}, "
          f"cpu forward {cpu_s:.2f} s", flush=True)
    return worst


def serve(dev):
    """The main path: predict requests through the public entry point."""
    from tamtr_torch import TAMTR
    from tamtr_torch.kernels.deform_scatter import bilinear_gather
    from tamtr_torch.kernels.selective_scan import ss2d_scan

    det = TAMTR("tamtr.yaml", nc=10, seed=0)
    spread_scores(det.model, seed=1)
    rng = np.random.default_rng(4)
    text = rng.standard_normal((10, 512)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    frames = [rng.integers(0, 256, (765, 1360, 3), dtype=np.uint8) for _ in range(4)]
    torch.cuda.reset_peak_memory_stats()
    ss2d_scan.launches = 0
    bilinear_gather.launches = 0
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
    launches = {"ss2d_scan_fwd": ss2d_scan.launches, "bilinear_gather_fwd": bilinear_gather.launches}
    peak = torch.cuda.max_memory_allocated()
    if len(res4) != 4 or any(v != 3 * forwards for v in launches.values()):
        raise AssertionError(f"launches {launches} after {forwards} forwards; want 3 per forward")
    print(f"serve tamtr.yaml 640px: batch-1 ms {[round(t, 3) for t in times['b1']]}, "
          f"batch-4 ms {[round(t, 3) for t in times['b4']]}, detections/image {len(res[0]['scores'])}, "
          f"max_memory_allocated {peak / 2**20:.1f} MiB, forwards {forwards}, launches {launches}",
          flush=True)
    return launches


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

    log = _build.build_all()  # a fresh checkout has no build/: this compiles both sources
    print(f"build: {log['seconds']:.1f} s", flush=True)
    for line in log["ptxas"]:
        print(f"  {line}")

    scan_rows, scan_err = check_ss2d_scan(dev)
    gather = check_bilinear_gather(dev)
    check_parity(dev)
    launches = serve(dev)

    kernels = [
        dict(name="ss2d_scan_fwd", route="cuda", source="tamtr_torch/csrc/ss2d_scan_fwd.cu",
             replaces="tamtr_tpu/kernels/selective_scan.py:448", launches=launches["ss2d_scan_fwd"],
             max_abs_err=scan_err, ms=sum(r["ms"] for r in scan_rows),
             plain_ms=sum(r["plain_ms"] for r in scan_rows),
             bound_ms=sum(r["bound_ms"] for r in scan_rows),
             bound_by=max(scan_rows, key=lambda r: r["bound_ms"])["bound_by"], library_ms=None,
             per_level=scan_rows),
        dict(name="bilinear_gather_fwd", route="cuda", source="tamtr_torch/csrc/bilinear_gather_fwd.cu",
             replaces="tamtr_tpu/kernels/deform_scatter.py:195", launches=launches["bilinear_gather_fwd"],
             **gather),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
