"""The port's `Engine.val` against the JAX package's `Engine.val` on the
CPU: the JAX nano model's weights (initialised under `jax.jit`, ~40 s)
bridged into the port, the same 64 px PNG val split (the val resize is the
identity) and the same class text embeddings.

The zero-initialised head layers get small random values and the
contrastive bias is 0 (as in `tests/test_torch_model.py`), so that scores
spread; the val labels are the model's own top detections, jittered, so
that mAP is neither 0 nor 1. The engine's training path is held in
`tests/test_torch_engine_train.py`.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tamtr_torch.api import TAMTR
from tamtr_torch.data.text import class_text_embeddings
from tamtr_torch.engine.model import Engine
from tamtr_torch.nn.graph import TAMTRModel as PortModel
from tamtr_torch.weights import from_jax_variables

from torch_engine_data import HD, IMG, NAMES, NC, one_thread, unit_text, write_val_split  # noqa: F401


@pytest.fixture(scope="module")
def jax_nano():
    from tamtr_tpu.nn.graph import TAMTRModel

    model = TAMTRModel.from_yaml("tamtr-nano.yaml", nc=NC)
    v = jax.device_get(jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1, NC, HD)), None, False))())
    to_np = lambda t: {k: to_np(x) if hasattr(x, "items") else np.array(x) for k, x in t.items()}  # noqa: E731
    params, batch_stats = to_np(v["params"]), to_np(v["batch_stats"])
    rng = np.random.default_rng(0)
    for name, sub in params["head"].items():
        if name.startswith("dec_score_head"):
            sub["bias"] = np.zeros_like(sub["bias"])
        if name.startswith(("dec_bbox_head", "enc_bbox_head")):
            k = sub["layers2"]["kernel"]
            sub["layers2"]["kernel"] = (rng.standard_normal(k.shape) * 0.05).astype(np.float32)
        if name.startswith("layer"):
            for lin in ("sampling_offsets", "attention_weights"):
                k = sub["cross_attn"][lin]["kernel"]
                sub["cross_attn"][lin]["kernel"] = (rng.standard_normal(k.shape) * 0.05).astype(np.float32)
    return model, params, batch_stats


@pytest.fixture(scope="module")
def port_nano(jax_nano):
    _, params, batch_stats = jax_nano
    port = PortModel.from_cfg("tamtr-nano.yaml", nc=NC)
    sd, _ = from_jax_variables(params, batch_stats, port)
    port.load_state_dict(sd, strict=True)
    return port.eval()


@pytest.fixture(scope="module")
def txt():
    return unit_text()


@pytest.fixture(scope="module")
def val_data(port_nano, txt, tmp_path_factory):
    return write_val_split(tmp_path_factory.mktemp("engine_val"), port_nano, txt)


def test_val_matches_jax_engine(jax_nano, port_nano, txt, val_data):
    """`Engine.val` on bridged weights: mAP50, mAP50-95, precision and recall
    equal the JAX `Engine.val`'s within 1e-3."""
    from tamtr_tpu.engine.checkpoint import InferenceState
    from tamtr_tpu.engine.model import Engine as JaxEngine

    jmodel, params, batch_stats = jax_nano
    eng = Engine("tamtr-nano.yaml", device="cpu")
    eng.model = port_nano
    eng.set_classes(NAMES, txt)
    args = dict(data=str(val_data), imgsz=IMG, batch=2, conf=0.25, workers=1, plots=False)
    got = eng.val(**args)

    je = JaxEngine("tamtr-nano.yaml")
    je.model = jmodel
    je.state = InferenceState(params, batch_stats)
    je.set_classes(NAMES, txt)
    want = je.val(**args)
    assert 0 < want["mAP50"] < 1 and 0 < want["recall"] < 1
    for k in ("mAP50", "mAP50-95", "precision", "recall"):
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])


def test_tamtr_val_after_load_jax_variables(jax_nano, port_nano, txt, val_data):
    """`TAMTR.load_jax_variables` then `TAMTR.val` validates the bridged
    weights, the detector's one model: with no classes set, against the
    dataset's class-name embeddings; after `set_classes`, equal to
    `Engine.val` of the same weights and texts."""
    _, params, batch_stats = jax_nano
    det = TAMTR("tamtr-nano.yaml", nc=NC, device="cpu", imgsz=IMG).load_jax_variables(params, batch_stats)
    args = dict(data=str(val_data), batch=2, conf=0.25, workers=1, plots=False)
    named = det.val(**args)
    assert 0.0 <= named["mAP50"] <= 1.0
    np.testing.assert_array_equal(det._engine.txt_feats, class_text_embeddings(NAMES, dim=HD))
    det.set_classes(NAMES, txt)
    got = det.val(**args)
    eng = Engine("tamtr-nano.yaml", device="cpu")
    eng.model = port_nano
    eng.set_classes(NAMES, txt)
    want = eng.val(imgsz=IMG, **args)
    assert got["mAP50"] > 0
    for k in ("mAP50", "mAP50-95", "precision", "recall", "fitness"):
        assert got[k] == want[k], k
