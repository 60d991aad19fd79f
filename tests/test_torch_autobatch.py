"""The port's autobatch (`tamtr_torch/utils/autobatch.py`) on the CPU: the
arithmetic against the JAX package's on a grid of probe peaks and memory
sizes (JAX's probes and memory monkeypatched to the same numbers), the
default on the CPU, and `Engine.train(batch=-1)` training at it. The probe
steps themselves run only on the card (`tests/test_torch_cuda.py`)."""

import sys
from pathlib import Path

import pytest

from tamtr_torch.engine.model import Engine
from tamtr_torch.utils.autobatch import autobatch, autobatch_train, device_memory_bytes

from torch_engine_data import IMG, one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import smoke_train_torch  # noqa: E402

GIB = 2**30
CASES = [
    (2 * GIB, 5 * GIB, 80 * GIB),  # the 640 px step's scale on an 80 GB card
    (1 * GIB, 1.5 * GIB, 16 * GIB),
    (10 * GIB, 30 * GIB, 40 * GIB),  # the budget below the fixed part: batch 1
    (3 * GIB, 3 * GIB + 1000, 80 * GIB),  # a tiny per-item cost: clamped to max_batch
    (4 * GIB, 4 * GIB, 80 * GIB),  # no growth: the default
    (5 * GIB, 3 * GIB, 80 * GIB),  # shrinking: the default
    (0, 3 * GIB, 80 * GIB),  # an unknown probe: the default
    (2 * GIB, 5 * GIB, None),  # unknown memory: the default
]


@pytest.mark.parametrize("m0,m1,limit", CASES)
@pytest.mark.parametrize("fraction,max_batch,default", [(0.6, 64, 4), (0.9, 16, 2)])
def test_arithmetic_equals_jax(monkeypatch, m0, m1, limit, fraction, max_batch, default):
    import tamtr_tpu.utils.autobatch as jax_ab

    peaks = {1: int(m0), 2: int(m1)}
    monkeypatch.setattr(jax_ab, "compiled_peak_bytes", lambda step_fn, make_args, b: peaks[b])
    monkeypatch.setattr(jax_ab, "device_memory_bytes", lambda device=None: limit)
    want = jax_ab.autobatch(None, None, fraction=fraction, max_batch=max_batch, default=default)
    got = autobatch(peaks.__getitem__, limit, fraction=fraction, max_batch=max_batch, default=default)
    assert got == want


def test_cpu_gives_the_default():
    assert device_memory_bytes("cpu") is None
    assert autobatch_train("tamtr-nano.yaml", 3, IMG, 8, device="cpu") == 4
    assert autobatch_train("tamtr-nano.yaml", 3, IMG, 8, device="cpu", default=3) == 3


def test_engine_train_batch_minus_one_trains_at_the_fit(tmp_path):
    data = smoke_train_torch.make_dataset(tmp_path / "data", 8, 2, IMG)
    eng = Engine("tamtr-nano.yaml", device="cpu")
    eng.train(data=str(data), epochs=1, batch=-1, imgsz=IMG, max_gt=8, warmup_epochs=1, workers=0, val=False,
              plots=False, project=str(tmp_path), name="run")
    assert eng.cfg.batch == 4 and eng.trainer.cfg.batch_size == 4 and len(eng.timing["step_ms"]) == 2
    with pytest.raises(ValueError, match="-1"):
        eng.train(data=str(data), batch=0)
