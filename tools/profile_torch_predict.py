"""Where the time of one `tamtr_torch` predict request goes, on one GPU.

Run from the repo root on a machine with an NVIDIA card:
    python3 tools/profile_torch_predict.py [--batch 1] [--iters 5] [--tf32] [--out FILE]

Builds the full-width `tamtr.yaml` model (nc=10, seeded weights), answers a
warm-up request, then times `--iters` requests of 1360x765 uint8 images:
  - per stage, with CUDA events: upload + resize, backbone and neck (graph
    layers 0-40), each level's VSS block, the rest of the head (projection,
    query selection, decoder), postprocess;
  - per CUDA kernel, with torch.profiler: device time summed by kernel name,
    and the device's busy share of the profiled wall time.
Prints one JSON object, and writes it to --out when given.
TF32 stays off unless --tf32 is given (full fp32, as the reference ships).
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

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--tf32", action="store_true")
    ap.add_argument("--out", type=Path)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_predict: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = a.tf32
    torch.backends.cudnn.allow_tf32 = a.tf32

    from chip_smoke import spread_scores
    from tamtr_torch import TAMTR
    from tamtr_torch.ops.nms import postprocess_predictions

    det = TAMTR("tamtr.yaml", nc=10, seed=0)
    spread_scores(det.model, seed=1)
    rng = np.random.default_rng(0)
    text = torch.from_numpy(rng.standard_normal((1, 10, 512)).astype(np.float32)).cuda()
    frames = [rng.integers(0, 256, (765, 1360, 3), dtype=np.uint8) for _ in range(a.batch)]
    head = det.model.model[-1]

    events = {}

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events[name] = ev

    hooks = [det.model.model[0].register_forward_pre_hook(lambda m, i: mark("backbone_start"))]
    hooks.append(head.register_forward_pre_hook(lambda m, i: mark("head_start")))
    for lvl, vss in enumerate(head.VSSBlocks):
        hooks.append(vss.register_forward_hook(lambda m, i, o, lvl=lvl: mark(f"vss{lvl}_end")))

    stages = {k: [] for k in ("upload_resize", "backbone_neck", "vss0", "vss1", "vss2",
                               "head_rest", "postprocess", "request_wall")}
    with torch.inference_mode():
        for it in range(a.iters + 1):
            events.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mark("start")
            img, _ = det._to_batch(frames)
            pred = det.model(img, text)["pred"]
            mark("forward_end")
            out = postprocess_predictions(pred, 0.25, 0.7, 300)
            out[0].cpu()
            mark("end")
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            if it == 0:
                continue  # warm-up
            span = lambda x, y: events[x].elapsed_time(events[y])  # noqa: E731
            stages["upload_resize"].append(span("start", "backbone_start"))
            stages["backbone_neck"].append(span("backbone_start", "head_start"))
            stages["vss0"].append(span("head_start", "vss0_end"))
            stages["vss1"].append(span("vss0_end", "vss1_end"))
            stages["vss2"].append(span("vss1_end", "vss2_end"))
            stages["head_rest"].append(span("vss2_end", "forward_end"))
            stages["postprocess"].append(span("forward_end", "end"))
            stages["request_wall"].append(wall)
    for h in hooks:
        h.remove()

    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(a.iters):
            img, _ = det._to_batch(frames)
            out = postprocess_predictions(det.model(img, text)["pred"], 0.25, 0.7, 300)
            out[0].cpu()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.name] = kernels.get(evt.name, 0.0) + evt.device_time / 1e3
    device_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    res = {
        "card": smi, "batch": a.batch, "iters": a.iters, "tf32": a.tf32,
        "stages_ms_mean": {k: float(np.mean(v)) for k, v in stages.items()},
        "profiled_wall_ms_per_request": prof_wall_ms / a.iters,
        "device_kernel_ms_per_request": device_ms / a.iters,
        "device_busy_share": device_ms / prof_wall_ms,
        "top_kernels_ms_per_request": [(n[:90], t / a.iters) for n, t in top],
    }
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
