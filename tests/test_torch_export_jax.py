"""The port's exporter against the JAX package's (`tamtr_tpu/engine/exporter.py`,
`tamtr_tpu/nn/autobackend.py`) on the CPU, on `tamtr-nano.yaml`'s wiring
with a head of width 512 (the text width JAX's exported programs fix): the
port's npz archive equal to JAX's `export_model(fmt="npz")` of the same
weights key for key and bitwise, fp32 and half; each package's
`AutoBackend` on the other's archive giving the other's prediction within
1e-4; and the port's `torch_export` half program against JAX's half
StableHLO program, both run on the CPU.

The half programs compute in fp32 against bf16-rounded weights, but for two
parameter-only expressions that JAX's program evaluates in bf16 (each
BatchNorm's rsqrt(var + eps) * scale, each contrastive head's
exp(logit_scale)). On this model the port's half program came within
3.6e-5 of JAX's, as its fp32 forward comes within 3.1e-5 of JAX's fp32
one; fp32 maths on the same rounded weights is ~0.1 away (the median
paired row), so the bound 1e-4 tells the two semantics apart."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tamtr_torch.engine.exporter import export_model
from tamtr_torch.nn.autobackend import AutoBackend
from tamtr_torch.nn.graph import TAMTRModel
from tamtr_torch.weights import init_parameters, to_jax_variables
from tamtr_tpu.engine.exporter import export_model as jax_export_model
from tamtr_tpu.nn.autobackend import AutoBackend as JaxAutoBackend
from tamtr_tpu.nn.graph import TAMTRModel as JaxModel

from torch_engine_data import IMG, NC, assert_same_row_set, one_thread, spread_tamtr  # noqa: F401

WIDTH = 512


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """(config path, the port's seeded and spread model, the JAX model, its
    variables: the port's weights carried by `to_jax_variables`)."""
    root = tmp_path_factory.mktemp("export_jax")
    from tamtr_torch.nn.graph import load_model_cfg

    cfg = load_model_cfg("tamtr-nano.yaml")
    cfg["head"][-1][3][1] = WIDTH
    path = root / "tamtr-nano-512.json"
    path.write_text(json.dumps(cfg))
    port = TAMTRModel.from_cfg(path, nc=NC)
    init_parameters(port, 0)
    spread_tamtr(port.eval())
    return root, path, port, JaxModel.from_yaml(path, nc=NC), to_jax_variables(port)


def _inputs():
    img = np.random.default_rng(1).random((1, IMG, IMG, 3), dtype=np.float32)
    txt = np.random.default_rng(2).standard_normal((1, NC, WIDTH)).astype(np.float32)
    return img, txt / np.linalg.norm(txt, axis=-1, keepdims=True)


@pytest.mark.parametrize("half", [False, True], ids=["fp32", "half"])
def test_npz_equals_jax_archive(carried, half):
    root, _, port, jm, variables = carried
    ours = export_model(port, IMG, NC, root / f"port_npz{int(half)}", "npz", half=half)
    theirs = jax_export_model(jm, jax.tree.map(jnp.asarray, variables), IMG, NC, root / f"jax_npz{int(half)}", "npz",
                              half=half)
    with np.load(ours) as a, np.load(theirs) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype == (np.float16 if half else np.float32), k
            assert a[k].shape == b[k].shape and a[k].tobytes() == b[k].tobytes(), k


def test_each_autobackend_reads_the_others_npz(carried):
    root, path, port, jm, variables = carried
    img, txt = _inputs()
    ours = export_model(port, IMG, NC, root / "cross_port", "npz")
    theirs = jax_export_model(jm, jax.tree.map(jnp.asarray, variables), IMG, NC, root / "cross_jax", "npz")
    with torch.no_grad():
        port_pred = port(torch.from_numpy(img), torch.from_numpy(txt))["pred"].numpy()
    jax_on_ours = np.asarray(JaxAutoBackend(ours, model_cfg=str(path), nc=NC, imgsz=IMG)(img, txt))
    jax_pred = np.asarray(jax.jit(lambda v, i, t: jm.apply(v, i, t, None, False)["pred"])(
        jax.tree.map(jnp.asarray, variables), img, txt))
    ours_on_theirs = AutoBackend(theirs, model_cfg=str(path), nc=NC, device="cpu")(img, txt)
    assert_same_row_set(jax_on_ours, port_pred, atol=1e-4)
    assert_same_row_set(ours_on_theirs, jax_pred, atol=1e-4)


def test_half_program_matches_jax_half_stablehlo(carried):
    root, _, port, jm, variables = carried
    img, txt = _inputs()
    ours = AutoBackend(export_model(port, IMG, NC, root / "pt2_half", "torch_export", half=True), device="cpu")
    theirs = JaxAutoBackend(jax_export_model(jm, jax.tree.map(jnp.asarray, variables), IMG, NC, root / "shlo_half",
                                             "stablehlo", half=True), imgsz=IMG)
    assert_same_row_set(ours(img, txt), np.asarray(theirs(img, txt)), atol=1e-4)
