"""The port's `engine/ensemble.py:ensemble_predict` against the JAX
package's on the CPU: two nano models with seeded, spread weights, each
carried into a JAX engine (`to_jax_variables`), predicting the same JPEG
fixtures; the merged detections of each image equal JAX's as a set
(`assert_same_row_set`, 1e-3), and each merged row is a row of one of the
models' own results."""

import shutil
from pathlib import Path

import numpy as np
import pytest

from tamtr_torch.api import TAMTR
from tamtr_torch.engine.ensemble import ensemble_predict
from tamtr_torch.weights import to_jax_variables

from torch_engine_data import IMG, NAMES, NC, assert_same_row_set, one_thread, spread_tamtr, unit_text  # noqa: F401

FIXTURES = Path(__file__).resolve().parent / "torch_data" / "jpeg"
CONF = 0.01


def _rows(r):
    oh, ow = r.orig_shape
    b = r.boxes.xyxy / np.array([ow, oh, ow, oh], np.float32)
    return np.concatenate([b, r.boxes.conf[:, None], r.boxes.cls[:, None].astype(np.float32)], 1)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    from tamtr_tpu.engine.checkpoint import InferenceState
    from tamtr_tpu.engine.model import Engine as JaxEngine

    txt = unit_text()
    ports, jaxes = [], []
    for seed in (0, 1):
        det = TAMTR("tamtr-nano.yaml", nc=NC, device="cpu", imgsz=IMG, seed=seed)
        spread_tamtr(det.model, seed=seed + 7)
        det.set_classes(NAMES, txt)
        v = to_jax_variables(det.model)
        je = JaxEngine("tamtr-nano.yaml")
        from tamtr_tpu.nn.graph import TAMTRModel as JaxModel

        je.model = JaxModel.from_yaml("tamtr-nano.yaml", nc=NC)
        je.state = InferenceState(v["params"], v["batch_stats"])
        je.set_classes(NAMES, txt)
        ports.append(det)
        jaxes.append(je)
    src = tmp_path_factory.mktemp("ensemble_src")
    for name in ("s420_q75.jpg", "gray_q85.jpg", "exif6_q90.jpg", "visdrone_1360x765_q85.jpg"):
        shutil.copy(FIXTURES / name, src / name)
    return ports, jaxes, str(src)


def test_ensemble_predict_matches_jax(models):
    ports, jaxes, src = models
    got = ensemble_predict(ports, src, iou=0.5, conf=CONF)
    want = ensemble_predict(jaxes, src, iou=0.5, conf=CONF, imgsz=IMG)
    assert [r.path for r in got] == [r.path for r in want] and len(got) == 4
    assert sum(len(r) for r in want) > 0
    for g, w in zip(got, want):
        assert g.orig_shape == w.orig_shape and len(g) == len(w), g.path
        if len(w):
            assert_same_row_set(_rows(g)[None], _rows(w)[None], atol=1e-3)
    # each merged row is one of the models' own rows, in score order
    singles = [m.predict(src, conf=CONF) for m in ports]
    for i, r in enumerate(got):
        own = np.concatenate([_rows(s[i]) for s in singles])
        assert all((np.abs(own - row).max(-1) == 0).any() for row in _rows(r))
        assert (np.diff(r.boxes.conf) <= 0).all()


def test_ensemble_predict_refuses_no_models_and_unequal_sources(models):
    ports, _, src = models

    class Fewer:
        def predict(self, source, **kw):
            return ports[0].predict(source, **kw)[:1]

    with pytest.raises(ValueError, match="at least one"):
        ensemble_predict([], src)
    with pytest.raises(ValueError, match="different sources"):
        ensemble_predict([ports[0], Fewer()], src, conf=CONF)
