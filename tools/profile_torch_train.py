"""Where the time of one `tamtr_torch` training step goes, on one GPU.

Run from the repo root on a machine with an NVIDIA card:
    python3 tools/profile_torch_train.py [--root DIR] [--batch 4] [--imgsz 640] [--max-gt 300] [--steps 3]
        [--launched-by PATTERN] [--out FILE]

`--root` names the checkout whose `tamtr_torch` and `chip_smoke.py` are
imported (default: the one that holds this script), so that two trees are
profiled by the same script.

Builds the full-width `tamtr.yaml` model (nc=10, seeded weights) and its
`Trainer` (accumulate 1), runs 2 warm-up steps on the seeded synthetic
batches of `chip_smoke.py` (one over-full image), then times `--steps` steps:
  - per stage, with CUDA events: upload, backbone and neck forward (graph
    layers 0-40), each level's VSS block forward, the rest of the head
    forward (projection, query selection, CDN, decoder), the loss (matcher
    and losses), the backward, and the optimizer (clip, AdamW, EMA, metric
    reads);
  - per CUDA kernel, with torch.profiler: device time summed by kernel name,
    and the device's busy share of the profiled wall time;
  - with `--launched-by`, one more step profiled with Python stacks and
    input shapes: for each kernel whose name holds PATTERN, the ops that
    launched it, with their input shapes and the innermost `tamtr_torch`
    line under each, and the launches and device us of each
    (`launched_by`).
Prints one JSON object, and writes it to --out when given. TF32 stays off
(full fp32, as the reference trains).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--max-gt", type=int, default=300)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--launched-by", default=None)
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent)
    a = ap.parse_args()
    sys.path.insert(0, str(a.root.resolve()))
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from chip_smoke import TRAIN_VALID, synthetic_batch
    from tamtr_torch import TAMTR
    from tamtr_torch.train import trainer as ptrain

    det = TAMTR("tamtr.yaml", nc=10, seed=0, max_gt=a.max_gt)
    tr = det.trainer(ptrain.TrainConfig(batch_size=a.batch, accumulate=1), seed=0)
    valid = [min(v, a.max_gt) for v in (TRAIN_VALID * a.batch)[: a.batch]]
    batches = [synthetic_batch(200 + i, a.batch, a.imgsz, a.max_gt, valid) for i in range(3 + 2 * a.steps)]
    model, head = tr.model, tr.model.model[-1]

    events = {}

    def mark(name):
        if name not in events:  # the first mark of a name in a step counts
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name] = ev

    hooks = [model.model[0].register_forward_pre_hook(lambda m, i: mark("forward_start")),
             head.register_forward_pre_hook(lambda m, i: mark("head_start")),
             head.register_forward_hook(lambda m, i, o: mark("head_end"))]
    for lvl, vss in enumerate(head.VSSBlocks):
        hooks.append(vss.register_forward_hook(lambda m, i, o, lvl=lvl: mark(f"vss{lvl}_end")))
    loss_fn, norm_fn = ptrain.rtdetr_detection_loss, ptrain._global_norm

    def timed_loss(*args, **kw):
        out = loss_fn(*args, **kw)
        mark("loss_end")
        return out

    def timed_norm(ts):
        mark("backward_end")
        return norm_fn(ts)

    ptrain.rtdetr_detection_loss, ptrain._global_norm = timed_loss, timed_norm
    names = ["upload", "backbone_neck_fwd", "vss0_fwd", "vss1_fwd", "vss2_fwd", "head_rest_fwd", "loss",
             "backward", "optimizer_ema", "step_wall"]
    stages = {k: [] for k in names}
    torch.cuda.reset_peak_memory_stats()
    for it, b in enumerate(batches[: 2 + a.steps]):
        events.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mark("start")
        tr.step(b)
        mark("end")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if it < 2:
            continue  # warm-up: cuDNN picks its algorithms
        span = lambda x, y: events[x].elapsed_time(events[y])  # noqa: E731
        order = ["start", "forward_start", "head_start", "vss0_end", "vss1_end", "vss2_end", "head_end",
                 "loss_end", "backward_end", "end"]
        for name, (x, y) in zip(names, zip(order, order[1:])):
            stages[name].append(span(x, y))
        stages["step_wall"].append(wall)
    for h in hooks:
        h.remove()
    ptrain.rtdetr_detection_loss, ptrain._global_norm = loss_fn, norm_fn
    peak = torch.cuda.max_memory_allocated()

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches[2 + a.steps:2 + 2 * a.steps]:
            tr.step(b)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.events():
        # ranges such as "Optimizer.step#AdamW.step" are annotations over
        # kernels that are counted themselves
        if evt.device_type == torch.autograd.DeviceType.CUDA and not getattr(evt, "is_user_annotation", False) \
                and not evt.name.startswith("Optimizer."):
            kernels[evt.name] = kernels.get(evt.name, 0.0) + evt.device_time / 1e3
    device_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:20]
    launched_by = {}
    if a.launched_by:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], with_stack=True,
                     record_shapes=True) as prof:
            tr.step(batches[-1])
            torch.cuda.synchronize()
        for evt in prof.events():
            for k in getattr(evt, "kernels", []):
                if a.launched_by in k.name:
                    frames = [f for f in (evt.stack or []) if "tamtr_torch" in f]
                    where = f"{evt.name}{evt.input_shapes} @ {frames[0] if frames else '?'}"
                    by = launched_by.setdefault(k.name[:90], {})
                    n, us = by.get(where, (0, 0.0))
                    by[where] = (n + 1, us + k.duration)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    res = {
        "card": smi, "root": str(a.root), "batch": a.batch, "imgsz": a.imgsz, "max_gt": a.max_gt, "steps": a.steps,
        "valid_gts": valid,
        "stages_ms_mean": {k: float(np.mean(v)) for k, v in stages.items()},
        "max_memory_allocated_mib": peak / 2**20,
        "profiled_wall_ms_per_step": prof_wall_ms / a.steps,
        "device_kernel_ms_per_step": device_ms / a.steps,
        "device_busy_share": device_ms / prof_wall_ms,
        "top_kernels_ms_per_step": [(n[:90], t / a.steps) for n, t in top],
        # full names: kernels whose names share a prefix (reduce_kernel<...>) stay apart
        "kernels_ms_per_step": {n: t / a.steps for n, t in kernels.items()},
        "launched_by": launched_by,
    }
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
