"""The port's `engine/tuner.py` and `Engine.tune` on the CPU: with one fake
training function, `Tuner(seed=0)` gives the JAX package's hyperparameter
sequence and a `tune_results.csv` byte-equal to JAX's; crashing trials
score 0 and the evolution goes on; `run_ray_tune` drives a fake ray[tune]
as JAX's does and says what to install without one; `Engine.tune` runs 2
iterations of 1 epoch on the generated dataset of
`tools/smoke_train_torch.py`, in this process and with isolate=True."""

import csv
import sys
from pathlib import Path

import numpy as np
import pytest

from tamtr_torch.engine.model import Engine
from tamtr_torch.engine.tuner import SPACE, Tuner, run_ray_tune

from torch_engine_data import IMG, one_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import smoke_train_torch  # noqa: E402


def _trial(log):
    """A deterministic fake training: fitness peaks at lr0 = 1e-3; every
    third trial crashes."""
    def train_fn(hyp):
        log.append(dict(hyp))
        if len(log) % 3 == 0:
            raise RuntimeError("boom")
        return {"fitness": 1.0 - abs(np.log10(hyp["lr0"]) + 3) / 4 + 0.01 * hyp["mosaic"]}
    return train_fn


@pytest.mark.parametrize("base", [None, {"lr0": 1e-4, "mosaic": 0.5}], ids=["space_mid", "given"])
def test_tuner_equals_jax(base, tmp_path):
    from tamtr_tpu.engine.tuner import Tuner as JaxTuner

    ours, theirs = [], []
    best = Tuner(save_dir=tmp_path / "port", seed=0)(_trial(ours), base_hyp=base, iterations=7)
    want = JaxTuner(save_dir=tmp_path / "jax", seed=0)(_trial(theirs), base_hyp=base, iterations=7)
    assert ours == theirs and best == want and len(ours) == 7
    assert len({tuple(sorted(h.items())) for h in ours}) > 1  # it mutated
    got = (tmp_path / "port" / "tune_results.csv").read_bytes()
    assert got == (tmp_path / "jax" / "tune_results.csv").read_bytes()
    rows = list(csv.DictReader(got.decode().splitlines()))
    assert [float(r["fitness"]) for r in rows][2::3] == [0.0, 0.0]  # crashed trials
    for h in ours:  # within the space's bounds
        for k, (_, lo, hi) in SPACE.items():
            assert k not in h or lo <= h[k] <= hi


def test_run_ray_tune_with_fake_ray(monkeypatch):
    """`run_ray_tune` on a fake ray[tune], as the JAX package's test drives
    its own: the default space from SPACE and the extras, the ASHA
    scheduler's settings, the numeric metrics reported."""
    import types

    calls = {}
    ray, ray_train, ray_tune = (types.ModuleType(n) for n in ("ray", "ray.train", "ray.tune"))
    ray_train.report = lambda metrics: calls.setdefault("reported", []).append(metrics)
    ray_tune.uniform = lambda lo, hi: ("uniform", lo, hi)

    class FakeTuneConfig:
        def __init__(self, scheduler=None, num_samples=None):
            calls["num_samples"] = num_samples

    class FakeTuner:
        def __init__(self, trainable, param_space=None, tune_config=None, **kw):
            calls["space"] = param_space
            self.trainable = trainable

        def fit(self):
            self.trainable({k: (v[1] + v[2]) / 2 for k, v in calls["space"].items()})
            return "result-grid"

    class FakeASHA:
        def __init__(self, **kw):
            calls["asha"] = kw

    ray_tune.Tuner, ray_tune.TuneConfig = FakeTuner, FakeTuneConfig
    sched = types.ModuleType("ray.tune.schedulers")
    sched.ASHAScheduler = FakeASHA
    ray.train, ray.tune = ray_train, ray_tune
    for name, mod in [("ray", ray), ("ray.train", ray_train), ("ray.tune", ray_tune), ("ray.tune.schedulers", sched)]:
        monkeypatch.setitem(sys.modules, name, mod)
    monkeypatch.setitem(sys.modules, "ray.air", None)
    out = run_ray_tune(lambda cfg: {"fitness": 0.42, "epoch": 1, "names": "ignored"}, max_samples=3, grace_period=2,
                       max_t=7)
    assert out == "result-grid" and calls["num_samples"] == 3
    assert calls["asha"] == {"time_attr": "epoch", "metric": "fitness", "mode": "max", "max_t": 7, "grace_period": 2,
                             "reduction_factor": 3}
    assert set(SPACE) <= set(calls["space"]) and {"degrees", "copy_paste"} <= set(calls["space"])
    assert calls["reported"] == [{"fitness": 0.42, "epoch": 1.0}]


def test_run_ray_tune_says_what_to_install(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_ray(name, *a, **k):
        if name.startswith("ray"):
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_ray)
    with pytest.raises(ModuleNotFoundError, match=r'pip install "ray\[tune\]"'):
        run_ray_tune(lambda cfg: {"fitness": 0.0})


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return smoke_train_torch.make_dataset(tmp_path_factory.mktemp("tune") / "data", 4, 2, IMG)


@pytest.mark.parametrize("isolate", [False, True], ids=["in_process", "isolated"])
def test_engine_tune_writes_its_rows(data, isolate, tmp_path, monkeypatch):
    # an isolated trial's process takes one thread, as this one (`one_thread`): under the test
    # processes of a whole run, a trial at a thread per core took minutes
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    best = Engine("tamtr-nano.yaml", device="cpu").tune(
        iterations=2, isolate=isolate, data=str(data), epochs=1, batch=2, imgsz=IMG, max_gt=8, workers=0,
        warmup_epochs=1, project=str(tmp_path))
    rows = list(csv.DictReader(open(tmp_path / "tune" / "tune_results.csv")))
    assert [r["iteration"] for r in rows] == ["0", "1"]
    assert all(np.isfinite(float(r["fitness"])) and 0 <= float(r["fitness"]) <= 1 for r in rows)
    assert set(best) == set(SPACE)
    # each trial trained to its end (a crashed one writes no results.csv) and saved no checkpoint
    assert len(list(tmp_path.glob("train*/results.csv"))) == 2
    assert not list(tmp_path.glob("train*/weights/*.pt"))
