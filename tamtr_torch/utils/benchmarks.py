"""Benchmark harness (a port of the JAX package's `tamtr_tpu/utils/benchmarks.py`,
the reference's `utils/benchmarks.py`): an export-format sweep and
inference timing for a model.

`benchmark(engine)` times the engine's own eval forward, then exports to
each format, loads each artifact back through `AutoBackend` on the engine's
device, and asserts PREDICTION PARITY with the native forward on a fixed
batch (the reference's benchmark() vals every exported format and asserts
an mAP floor, `utils/benchmarks.py:45-152`; prediction parity is the
stronger, dataset-free equivalent). Returns a table of {format, ok,
parity_ok, parity_maxdiff, img_per_sec}, the native forward's row
first (format "native"); a format the port cannot write
gives a row with ok False and its error.

`profile_model(engine)` times one eval forward per image size (ms and
images/s, the card synchronised before the clock is read) and counts its
operations (`utils/profiler.py:flops_of`).

Both time with the host's clock around work that ends in a host read of the
result: on the card that includes the copy of `pred` to the host.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark(
    engine,
    imgsz: int = 640,
    batch: int = 1,
    formats: Optional[List[str]] = None,
    out_dir: str = "runs/benchmark",
    n_iter: int = 10,
) -> List[Dict[str, Any]]:
    from tamtr_torch.engine.exporter import FORMATS, export_model
    from tamtr_torch.nn.autobackend import AutoBackend

    if engine.model is None:
        raise RuntimeError("no weights loaded; train first or load a checkpoint")
    model = engine.model.eval()
    formats = formats or list(FORMATS)
    n_text = max(len(engine.names), 1)
    nc = len(engine.names) or model.nc
    dev = engine.device
    rows: List[Dict[str, Any]] = []

    # native timing first (the deployment path); its predictions are the
    # parity oracle for every exported format below
    img = np.random.default_rng(0).random((batch, imgsz, imgsz, 3), dtype=np.float32)
    txt = np.zeros((batch, n_text, model.text_width), np.float32)
    with torch.inference_mode():
        x, t = torch.from_numpy(img).to(dev), torch.from_numpy(txt).to(dev)
        native = model(x, t)["pred"].cpu().numpy()
        t0 = time.perf_counter()
        for _ in range(n_iter):
            model(x, t)["pred"].cpu()
        dt = (time.perf_counter() - t0) / n_iter
    rows.append({"format": "native", "ok": True, "parity_ok": True, "img_per_sec": round(batch / dt, 2)})

    meta = {"nc": model.nc, "names": engine.names, "model_cfg": str(engine.model_cfg), "imgsz": imgsz}
    for fmt in formats:
        row: Dict[str, Any] = {"format": fmt}
        try:
            path = export_model(model, imgsz, n_text, Path(out_dir) / fmt, fmt, batch, meta=meta)
            row.update(ok=True, path=str(path))
        except (RuntimeError, ValueError) as e:  # formats the port cannot write
            rows.append({"format": fmt, "ok": False, "error": str(e)[:120]})
            continue
        # export success alone is NOT a pass: load the artifact back and
        # compare predictions with the native path (boxes and scores both
        # live in [0, 1])
        try:
            backend = AutoBackend(path, model_cfg=str(engine.model_cfg), nc=nc, imgsz=imgsz, device=dev)
            pred = np.asarray(backend(img, txt))
            maxdiff = float(np.abs(pred - native).max())
            row["parity_maxdiff"] = round(maxdiff, 6)
            row["parity_ok"] = bool(pred.shape == native.shape and maxdiff < 5e-3)
            n = max(n_iter // 2, 1)
            t0 = time.perf_counter()
            for _ in range(n):
                backend(img, txt)
            row["img_per_sec"] = round(batch * n / (time.perf_counter() - t0), 2)
        except Exception as e:  # a row per format: one that loads or runs wrongly fails its own row only
            row["parity_ok"] = False
            row["parity_error"] = str(e)[:120]
        rows.append(row)
    return rows


def profile_model(
    engine,
    imgsz_list: Optional[List[int]] = None,
    batch: int = 1,
    n_iter: int = 8,
) -> List[Dict[str, Any]]:
    """Per-size timing and FLOPs sweep (reference `ProfileModels`,
    `utils/benchmarks.py:153`): one warm-up forward, then `n_iter` forwards
    timed with the card synchronised before each clock read. (The JAX
    package chains its iterations in one `lax.scan` to amortise the TPU's
    dispatch round trip, which the card does not have.)"""
    from tamtr_torch.utils.profiler import flops_of

    if engine.model is None:
        raise RuntimeError("no weights loaded; train first or load a checkpoint")
    model = engine.model.eval()
    dev = engine.device
    n_text = max(len(engine.names), 1)
    rows: List[Dict[str, Any]] = []
    for sz in imgsz_list or [320, 640]:
        img = torch.from_numpy(np.random.default_rng(0).random((batch, sz, sz, 3), dtype=np.float32)).to(dev)
        txt = torch.zeros(batch, n_text, model.text_width, device=dev)
        flops = flops_of(model, img, txt)["flops"]
        with torch.inference_mode():
            model(img, txt)
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(n_iter):
                model(img, txt)
            _sync(dev)
            dt = (time.perf_counter() - t0) / n_iter
        rows.append({
            "imgsz": sz,
            "ms_per_image": round(dt * 1e3 / batch, 2),
            "img_per_sec": round(batch / dt, 1),
            "gflops_per_image": round(flops / 1e9 / batch, 1),
        })
    return rows
