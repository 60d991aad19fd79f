"""Profiling helpers (a port of `tamtr_tpu/utils/profiler.py`).

- `Profile`: an accumulating host-side stage timer.
- `trace`: `torch.profiler` over the host and, when there is a card, the
  card; the Chrome trace goes to `log_dir/trace.json`.
- `flops_of`: the operations of one eval forward. PyTorch's
  `FlopCounterMode` counts the matrix products and convolutions (two
  operations per multiply-add) and nothing elementwise; XLA's cost analysis,
  which the JAX package's `flops_of` reads, also counts elementwise work,
  so the JAX count is the larger (about 1.24x at nano, 64 px). The counter
  does not see a CUDA kernel that the port launches itself, so the
  operations of B1 (`ss2d_scan`) and B2 (`bilinear_gather`) are counted from
  their shapes, as `chip_smoke.py` bounds them, and whatever the counter saw
  inside those calls (their plain versions, on the CPU) is taken out: the
  card and the CPU give the same count.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Any, Dict

import torch


class Profile(contextlib.ContextDecorator):
    """Accumulating timer: `with profile: ...`; `profile.t` total seconds."""

    def __init__(self) -> None:
        self.t = 0.0
        self.n = 0

    def __enter__(self) -> "Profile":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.t += time.perf_counter() - self._start
        self.n += 1

    @property
    def ms_per_call(self) -> float:
        return 1e3 * self.t / max(self.n, 1)


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """`torch.profiler.profile` over the block (CPU, and CUDA when there is
    a card), its Chrome trace written to `log_dir/trace.json`; yields the
    profiler (`key_averages()` for sums by op and kernel)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        yield prof
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def ss2d_scan_flops(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds) -> int:
    """Operations of one B1 call (four directions): per element of each
    direction, the dt projection (2R), the discretisation and state update
    and readout (8N), and the skip term (3)."""
    B, _, L, D = layouts.shape
    return 4 * B * L * D * (2 * dts_raw.shape[-1] + 8 * Bs.shape[-1] + 3)


def bilinear_gather_flops(value, idx4, w_pairs, idx2, P) -> int:
    """Operations of one B2 call: each corner pair's two rows, weighted and
    added, over the value's channels (4 a channel)."""
    return idx2.numel() * value.shape[-1] * 4


@torch.no_grad()
def flops_of(model: torch.nn.Module, img: torch.Tensor, txt: torch.Tensor) -> Dict[str, Any]:
    """Operations of one forward `model(img, txt)` (module docstring): a
    dict with "flops", "gflops" and "kernel_flops" (B1's and B2's share)."""
    from torch.utils.flop_counter import FlopCounterMode

    import tamtr_torch.nn.decoder as decoder
    import tamtr_torch.nn.ssm as ssm

    counter = FlopCounterMode(display=False)
    seen = {"inside": 0, "kernels": 0}

    def counted(fn, ops):
        def run(*args):
            before = counter.get_total_flops()
            out = fn(*args)
            seen["inside"] += counter.get_total_flops() - before
            seen["kernels"] += ops(*args)
            return out
        return run

    scan, gather = ssm.ss2d_scan, decoder.bilinear_gather
    ssm.ss2d_scan, decoder.bilinear_gather = counted(scan, ss2d_scan_flops), counted(gather, bilinear_gather_flops)
    try:
        with counter:
            model(img, txt)
    finally:
        ssm.ss2d_scan, decoder.bilinear_gather = scan, gather
    total = counter.get_total_flops() - seen["inside"] + seen["kernels"]
    return {"flops": total, "gflops": total / 1e9, "kernel_flops": seen["kernels"]}
