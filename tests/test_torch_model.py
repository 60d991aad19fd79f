"""The port's modules and whole eval forward against the JAX package, on the
CPU, with the JAX nano model's weights bridged into the port.

The JAX nano model is initialised once for the module (under `jax.jit`).
Its zero-initialised layers (sampling offsets and attention weights, last
bbox-MLP layers) get small random values and the contrastive bias is set to
0, so that every part of the head moves the output. Modules are compared at
1e-4 on inputs captured from the port's own forward; the whole model as a
tie-robust set at 1e-3 (top-k query selection may swap near-tied queries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from tamtr_torch.api import TAMTR
from tamtr_torch.nn.graph import TAMTRModel as PortModel
from tamtr_torch.weights import from_jax_variables

NC, HD, IMG = 10, 128, 64


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _perturb(params, rng):
    """Give the zero-initialised head layers small random values."""
    head = params["head"]
    for name, sub in head.items():
        if name.startswith("dec_score_head"):
            sub["bias"] = np.zeros_like(sub["bias"])
        if name.startswith(("dec_bbox_head", "enc_bbox_head")):
            k = sub["layers2"]["kernel"]
            sub["layers2"]["kernel"] = (rng.standard_normal(k.shape) * 0.05).astype(np.float32)
        if name.startswith("layer"):
            for lin in ("sampling_offsets", "attention_weights"):
                k = sub["cross_attn"][lin]["kernel"]
                sub["cross_attn"][lin]["kernel"] = (rng.standard_normal(k.shape) * 0.05).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def jax_nano():
    from tamtr_tpu.nn.graph import TAMTRModel

    model = TAMTRModel.from_yaml("tamtr-nano.yaml", nc=NC)
    img = jnp.zeros((1, IMG, IMG, 3))
    txt = jnp.zeros((1, NC, HD))
    v = jax.device_get(jax.jit(
        lambda: model.init({"params": jax.random.PRNGKey(0)}, img, txt, None, False)
    )())
    to_np = lambda t: {k: to_np(x) if isinstance(x, dict) or hasattr(x, "items") else np.array(x)  # noqa: E731
                       for k, x in t.items()}
    params = _perturb(to_np(v["params"]), np.random.default_rng(0))
    batch_stats = to_np(v["batch_stats"])
    apply = jax.jit(lambda i, t: model.apply(
        {"params": params, "batch_stats": batch_stats}, i, t, None, False)["pred"])
    return model, params, batch_stats, apply


@pytest.fixture(scope="module")
def port_nano(jax_nano):
    _, params, batch_stats, _ = jax_nano
    model = PortModel.from_cfg("tamtr-nano.yaml", nc=NC)
    sd, report = from_jax_variables(params, batch_stats, model)
    model.load_state_dict(sd, strict=True)
    return model.eval(), report


def _inputs(seed, B=2):
    rng = np.random.default_rng(seed)
    img = rng.random((B, IMG, IMG, 3), dtype=np.float32)
    txt = rng.standard_normal((1, NC, HD)).astype(np.float32)
    return img, txt / np.linalg.norm(txt, axis=-1, keepdims=True)


def _assert_same_set(pred, want, atol=1e-3):
    for b in range(pred.shape[0]):
        dist = np.abs(pred[b][:, None] - want[b][None]).max(-1)
        rows, cols = linear_sum_assignment(dist)
        matched = dist[rows, cols] < atol
        assert matched.sum() >= len(matched) - 2, np.sort(dist[rows, cols])[-3:]
        if not matched.all():  # only boundary ties: their best scores agree
            np.testing.assert_allclose(np.sort(pred[b][rows[~matched], 4:].max(-1)),
                                       np.sort(want[b][cols[~matched], 4:].max(-1)), atol=5e-3)


def _capture_inputs(model, idx, img, txt):
    """Run the port's forward and return the positional inputs of model.model[idx]."""
    seen = {}

    def keep(mod, args, out):
        seen["args"] = args

    hook = model.model[idx].register_forward_hook(keep)
    try:
        with torch.no_grad():
            model(torch.from_numpy(img), torch.from_numpy(txt))
    finally:
        hook.remove()
    return seen["args"]


def test_bridge_is_complete(jax_nano, port_nano):
    _, params, batch_stats, _ = jax_nano
    _, report = port_nano
    assert report == {"missing": [], "shape_mismatch": [], "unused_jax": []}
    assert len(jax.tree_util.tree_leaves(params)) == 701
    assert len(jax.tree_util.tree_leaves(batch_stats)) == 340


@pytest.mark.parametrize("idx", [0, 2, 9, 16])
def test_backbone_and_neck_modules(jax_nano, port_nano, idx):
    """ConvBN (0), the ELAN stack (2), SPPELAN (9) and TIAGELAN (16), each
    alone with its bridged weights."""
    from tamtr_tpu.nn.graph import _build_module

    jmodel, params, batch_stats, _ = jax_nano
    pmodel, _ = port_nano
    img, txt = _inputs(1, B=1)
    (x, *rest) = _capture_inputs(pmodel, idx, img, txt)
    _, _, m, args = jmodel.specs[[s[0] for s in jmodel.specs].index(idx)]
    name = f"m{idx}_{m}"
    jmod = _build_module(m, args, name=None)
    vars_ = {"params": params[name], "batch_stats": batch_stats[name]}
    xj = jnp.asarray(x.permute(0, 2, 3, 1).numpy())
    if m == "TIAGELAN":
        want = jmod.apply(vars_, xj, jnp.asarray(txt), False)
        got = pmodel.model[idx](x, torch.from_numpy(txt))
    else:
        want = jmod.apply(vars_, xj, False)
        got = pmodel.model[idx](x)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_max_sigmoid_attn_block(jax_nano, port_nano):
    """TIAGELAN holds this block's weights without running it; the block
    itself matches the JAX one."""
    from tamtr_tpu.nn.layers import MaxSigmoidAttnBlock

    _, params, batch_stats, _ = jax_nano
    pmodel, _ = port_nano
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 4, 5, 64)).astype(np.float32)
    guide = rng.standard_normal((1, NC, HD)).astype(np.float32)
    want = MaxSigmoidAttnBlock(64, nh=8, ec=64).apply(
        {"params": params["m16_TIAGELAN"]["attn"], "batch_stats": batch_stats["m16_TIAGELAN"]["attn"]},
        jnp.asarray(x), jnp.asarray(guide), False,
    )
    with torch.no_grad():
        got = pmodel.model[16].attn(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(guide))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_cpam(hw):
    """Odd sizes crop the x2 upsample of the stride-2 max pool."""
    from tamtr_tpu.nn.layers import CPAM as JaxCPAM

    from tamtr_torch.nn.layers import CPAM

    x = np.random.default_rng(3).standard_normal((2, *hw, 16)).astype(np.float32)
    want = JaxCPAM().apply({}, jnp.asarray(x))
    got = CPAM()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hw", [(8, 8), (5, 7)])
def test_vss_block(jax_nano, port_nano, hw):
    from tamtr_tpu.nn.ssm import VSSBlock

    _, params, _, _ = jax_nano
    pmodel, _ = port_nano
    x = np.random.default_rng(4).standard_normal((2, *hw, 32)).astype(np.float32)
    want = VSSBlock(hidden_dim=32).apply({"params": params["head"]["vss0"]}, jnp.asarray(x), False)
    with torch.no_grad():
        got = pmodel.model[-1].VSSBlocks[0](torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_deformable_decoder_layer(jax_nano, port_nano):
    from tamtr_tpu.nn.decoder import DeformableDecoderLayer

    _, params, _, _ = jax_nano
    pmodel, _ = port_nano
    rng = np.random.default_rng(5)
    shapes = [(8, 8), (4, 4), (2, 2)]
    Q, Lv = 20, sum(h * w for h, w in shapes)
    embed = rng.standard_normal((2, Q, HD)).astype(np.float32)
    refer = rng.uniform(0.05, 0.95, (2, Q, 4)).astype(np.float32)
    feats = rng.standard_normal((2, Lv, HD)).astype(np.float32)
    pos = rng.standard_normal((2, Q, HD)).astype(np.float32)
    want = DeformableDecoderLayer(HD, 8, 1024, 3, 4).apply(
        {"params": params["head"]["layer0"]},
        *(jnp.asarray(a) for a in (embed, refer, feats)), shapes, None, jnp.asarray(pos),
    )
    with torch.no_grad():
        got = pmodel.model[-1].decoder["layers"][0](
            *(torch.from_numpy(a) for a in (embed, refer, feats)), shapes, torch.from_numpy(pos)
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_whole_model_eval_matches_jax(jax_nano, port_nano):
    _, _, _, apply = jax_nano
    pmodel, _ = port_nano
    img, txt = _inputs(6)
    want = np.asarray(apply(jnp.asarray(img), jnp.asarray(txt)))
    with torch.no_grad():
        got = pmodel(torch.from_numpy(img), torch.from_numpy(txt))["pred"].numpy()
    assert got.shape == want.shape == (2, 20, 4 + NC)
    assert want[..., 4:].std() > 0.05  # the perturbed head spreads the scores
    _assert_same_set(got, want)


def test_predict_with_bridged_weights_matches_jax(jax_nano):
    """TAMTR.load_jax_variables + predict == JAX forward + postprocess on
    the same image, boxes scaled to the image's pixels."""
    from tamtr_tpu.ops.nms import postprocess_predictions as jax_post

    _, params, batch_stats, apply = jax_nano
    det = TAMTR("tamtr-nano.yaml", nc=NC, device="cpu", imgsz=IMG).load_jax_variables(params, batch_stats)
    img, txt = _inputs(7)
    results = det.predict(img, txt[0], conf=0.6, iou=0.5)
    pred = apply(jnp.asarray(img), jnp.asarray(txt))
    boxes, scores, labels, valid, _ = (np.asarray(a) for a in jax_post(pred, 0.6, 0.5, 300))
    for b, res in enumerate(results):
        sel = valid[b] & (scores[b] > 0)
        assert sel.any()
        np.testing.assert_allclose(res["boxes"], boxes[b][sel] * IMG, atol=1e-3 * IMG)
        np.testing.assert_allclose(res["scores"], scores[b][sel], atol=1e-3)
        np.testing.assert_array_equal(res["labels"], labels[b][sel])
