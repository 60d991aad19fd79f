"""The port's `utils/benchmarks.py` on the CPU: `benchmark` rows carry real
prediction-parity evidence for every format it can write, not just export
success (the JAX package's `test_benchmark_validates_export_accuracy`),
and a row that says why for each format it cannot; `profile_model` gives
one row per size with its operations."""

import numpy as np
import pytest
import torch

from tamtr_torch.engine.model import Engine
from tamtr_torch.nn.graph import TAMTRModel
from tamtr_torch.utils.benchmarks import benchmark, profile_model
from tamtr_torch.utils.profiler import flops_of
from tamtr_torch.weights import init_parameters

from torch_engine_data import IMG, NAMES, NC, one_thread, spread_tamtr  # noqa: F401


@pytest.fixture(scope="module")
def engine():
    eng = Engine("tamtr-nano.yaml", device="cpu")
    model = TAMTRModel.from_cfg("tamtr-nano.yaml", nc=NC)
    init_parameters(model, 0)
    eng.model = spread_tamtr(model.eval())
    eng.set_classes(NAMES)
    return eng


def test_benchmark_validates_export_accuracy(engine, tmp_path):
    formats = ["torch", "npz", "torch_export", "savedmodel", "orbax"]
    rows = benchmark(engine, imgsz=IMG, batch=1, formats=formats, out_dir=str(tmp_path), n_iter=2)
    by_fmt = {r["format"]: r for r in rows}
    assert [r["format"] for r in rows] == ["native"] + formats
    assert by_fmt["native"]["parity_ok"] and by_fmt["native"]["img_per_sec"] > 0
    for fmt in ("torch", "npz", "torch_export"):
        row = by_fmt[fmt]
        assert row["ok"] and row.get("parity_ok"), row
        assert row["parity_maxdiff"] < 5e-3, row
        assert row.get("img_per_sec", 0) > 0, row
    assert by_fmt["savedmodel"] == {"format": "savedmodel", "ok": False,
                                    "error": "savedmodel export requires tensorflow, which tamtr_torch does not use"}
    assert not by_fmt["orbax"]["ok"] and "'torch'" in by_fmt["orbax"]["error"]


def test_profile_model_rows(engine):
    rows = profile_model(engine, imgsz_list=[32, IMG], n_iter=2)
    assert [r["imgsz"] for r in rows] == [32, IMG]
    for r in rows:
        assert set(r) == {"imgsz", "ms_per_image", "img_per_sec", "gflops_per_image"}
        assert r["ms_per_image"] > 0 and r["img_per_sec"] > 0
        img = torch.zeros(1, r["imgsz"], r["imgsz"], 3)
        want = flops_of(engine.model, img, torch.zeros(1, len(NAMES), engine.model.text_width))["flops"]
        assert r["gflops_per_image"] == round(want / 1e9, 1)
    assert np.isfinite([r["ms_per_image"] for r in rows]).all()
