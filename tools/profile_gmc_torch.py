"""Where the time of BoT-SORT's camera-motion compensation (`GMC`) goes,
on the card and on the CPU.

Run from the repo root on a machine with an NVIDIA card:
    python3 tools/profile_gmc_torch.py [--frames 5] [--out FILE]

Cuts --frames frames of 1360x765 from a smooth textured canvas moved by
(4, 2) px a frame (as `chip_smoke.py`'s panned sequence), then, for each
method (sparseOptFlow, orb, sift, ecc) and each device (the card, the CPU):
  - ms per frame of `GMC.apply`, the median after the first frame;
  - the same split by stage (`GMC._prep` and each cv2 stand-in of
    `trackers/gmc.py`), each stage timed between two synchronizations of
    the card, so the split adds their cost;
  - on the card, torch.profiler over one frame: host and device time by
    aten op, the number of host synchronizations (`aten::nonzero`,
    `aten::_local_scalar_dense`, device-to-host copies) and the device's
    busy share of the frame's wall time. For sparseOptFlow the LK
    iterations are the `aten::nonzero` calls of `calc_optical_flow_pyr_lk`.
Prints one JSON object, and writes it to --out when given.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tamtr_torch.data.imgproc import resize_linear  # noqa: E402
from tamtr_torch.trackers import gmc as G  # noqa: E402

METHODS = ("sparseOptFlow", "orb", "sift", "ecc")
STAGES = ("good_features_to_track", "calc_optical_flow_pyr_lk", "estimate_affine_partial_2d", "find_transform_ecc",
          "fast_keypoints", "orb_descriptors", "sift_detect", "sift_descriptors", "knn_match2")
SYNC_OPS = ("aten::nonzero", "aten::_local_scalar_dense")


def pan_frames(n: int, hw=(765, 1360), pan=(4, 2), seed: int = 37):
    h, w = hw
    rng = np.random.default_rng(seed)
    ch, cw = h + pan[1] * n + 40, w + pan[0] * n + 40
    canvas = resize_linear(rng.integers(0, 256, (ch // 16 + 1, cw // 16 + 1, 3), dtype=np.uint8), (cw, ch))
    return [np.ascontiguousarray(canvas[20 + pan[1] * f:20 + pan[1] * f + h, 20 + pan[0] * f:20 + pan[0] * f + w])
            for f in range(n)]


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


class StageClock:
    """Wraps GMC's stages so that each call is timed between two
    synchronizations of the card."""

    def __init__(self):
        self.ms = defaultdict(float)
        self.device = torch.device("cpu")
        self.saved = {}

    def wrap(self, owner, name, label):
        fn = getattr(owner, name)
        self.saved[(owner, name)] = fn

        def timed(*args, **kwargs):
            sync(self.device)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync(self.device)
            self.ms[label] += (time.perf_counter() - t0) * 1e3
            return out

        setattr(owner, name, timed)

    def __enter__(self):
        for name in STAGES:
            self.wrap(G, name, name)
        self.wrap(G.GMC, "_prep", "prep")
        return self

    def __exit__(self, *exc):
        for (owner, name), fn in self.saved.items():
            setattr(owner, name, fn)


def run(method: str, device: str, frames) -> dict:
    dev = torch.device(device)
    g = G.GMC(method, 2, device=dev)
    ms = []
    for f in frames:
        sync(dev)
        t0 = time.perf_counter()
        g.apply(f)
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    g = G.GMC(method, 2, device=dev)
    stages = []
    with StageClock() as clock:
        clock.device = dev
        for f in frames:
            clock.ms.clear()
            g.apply(f)
            stages.append(dict(clock.ms))
    split = {k: float(np.median([s.get(k, 0.0) for s in stages[1:]])) for k in stages[-1]}
    return {"ms_per_frame": float(np.median(ms[1:])), "ms_each_frame": ms, "stages_ms": split}


def profile_frame(method: str, frames) -> dict:
    from torch.profiler import ProfilerActivity, profile

    g = G.GMC(method, 2, device="cuda")
    g.apply(frames[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        g.apply(frames[1])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    kernels = [e for e in ev if dev_us(e) > 0 and not e.key.startswith("aten::")]
    busy = sum(dev_us(e) for e in kernels) / 1e3
    ops = sorted((e for e in ev if e.key.startswith("aten::")), key=lambda e: e.self_cpu_time_total, reverse=True)
    d2h = sum(e.count for e in ev if "DtoH" in e.key or "Device -> Host" in e.key)
    return {
        "wall_ms": wall,
        "device_busy_ms": busy,
        "device_busy_share": busy / wall if wall else None,
        "host_syncs": {k: sum(e.count for e in ev if e.key == k) for k in SYNC_OPS} | {"device_to_host_copies": d2h},
        "device_events": sum(e.count for e in kernels),
        "top_ops_by_host_ms": [{"op": e.key, "calls": e.count, "host_ms": e.self_cpu_time_total / 1e3,
                                "device_ms": dev_us(e) / 1e3} for e in ops[:12]],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--out", type=Path)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_gmc_torch: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    frames = pan_frames(a.frames)
    out = {"card": card, "cpu_threads": torch.get_num_threads(), "frames": a.frames, "frame_hw": [765, 1360],
           "downscale": 2, "runs": {}, "profile_card": {}}
    for method in METHODS:
        out["runs"][method] = {dev: run(method, dev, frames) for dev in ("cuda", "cpu")}
        out["profile_card"][method] = profile_frame(method, frames)
    text = json.dumps(out)
    print(text)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
