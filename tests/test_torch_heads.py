"""The DETR head variants of the port (`tamtr_torch/nn/decoder.py`:
RTDETRDecoder, ManbaDecoder and the two Decoupling heads as
`ManbaWorldDecoder` switches,
`LocationManbaDecoder`, `DualRTDETRDecoder`; `DecouplingDecoderLayer`,
`ContrastiveHead2D`) against the JAX package on the CPU, one torch thread.

Each head sits on `tamtr-nano.yaml`'s wiring with its row swapped, as
`tests/test_head_variants.py` builds them (Dual on the levels [32, 36, 32,
36]). The JAX nano model is initialised once under `jax.jit`; each head is
initialised alone and put in its place, and the never-run text attention of
the TIAGELANs takes the head's text width (512 for the heads without text
scores). The zero-initialised head layers get small random values from a
numpy seed and the score biases 0, so that every part of the head moves the
output.

Bounds: the two modules at 1e-5; each model's eval as a set of rows at
1e-3 (`tests/test_torch_model.py`). Each head's training step is held in
`tests/test_torch_heads_step.py`, which shares this file's helpers.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tamtr_torch.nn import decoder as PD
from tamtr_torch.nn.graph import TAMTRModel as PortModel
from tamtr_torch.nn.graph import load_model_cfg
from tamtr_torch.weights import from_jax_variables

from test_torch_train import _to_np
from torch_engine_data import assert_same_row_set, jax_variables, one_thread, spread_head_params  # noqa: F401

NC, HD, IMG, B, M, NQ, ND = 5, 128, 64, 2, 6, 20, 12
HEADS = ["RTDETRDecoder", "ManbaDecoder", "DecouplingManbaWorldDecoder", "DecouplingDFLManbaWorldDecoder",
         "locationManbaDecoder", "DualRTDETRDecoder"]
TEXT_WIDTH = {"DecouplingManbaWorldDecoder": HD, "DecouplingDFLManbaWorldDecoder": HD}


def variant_cfg(head: str) -> dict:
    """`tamtr-nano.yaml` with its head row swapped (JSON, which YAML reads)."""
    cfg = load_model_cfg("tamtr-nano.yaml")
    froms = [32, 36, 32, 36] if head == "DualRTDETRDecoder" else [32, 36, 40]
    extra = [True] if head in TEXT_WIDTH else []
    cfg["head"][-1] = [froms, 1, head, ["nc", HD, NQ, 4, 8, 3] + extra]
    return cfg


def jax_head(head: str, ch):
    """The JAX head module `tamtr_tpu/nn/graph.py` builds for `head` (the
    Dual head's shared core), DropPath off."""
    from tamtr_tpu.nn.decoder import LocationManbaDecoder, ManbaWorldDecoder

    kw = dict(nc=NC, hd=HD, nq=NQ, ndp=4, nh=8, ndl=3, max_gt=M, num_denoising=ND, vss_drop_path=0.0)
    if head == "locationManbaDecoder":
        return LocationManbaDecoder(ch=ch, **kw)
    if head == "DualRTDETRDecoder":
        return ManbaWorldDecoder(ch=ch[:len(ch) // 2], use_text=False, use_vss=False, **kw)
    variant = {"DecouplingManbaWorldDecoder": "decouple", "DecouplingDFLManbaWorldDecoder": "dfl"}.get(head, "base")
    return ManbaWorldDecoder(ch=ch, use_text=head in TEXT_WIDTH, use_vss=head != "RTDETRDecoder", variant=variant,
                             **kw)


def apply_head(head: str, module, variables, feats, text, targets, train: bool):
    """The head's output, as `tamtr_tpu/nn/graph.py` calls it (the Dual core
    on each half of the levels); train also returns the new statistics."""
    kw = dict(rngs={"cdn": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}, mutable=["batch_stats"]) \
        if train else {}
    if head != "DualRTDETRDecoder":
        return module.apply(variables, feats, text, targets, train, **kw)
    half = len(feats) // 2
    o1, o2 = (module.apply(variables, part, text, targets, train, **kw) for part in (feats[:half], feats[half:]))
    if not train:
        return {"pred": [o1["pred"], o2["pred"]]}
    return {"dual": (o1[0], o2[0]), **o1[0]}, o1[1]


@pytest.fixture(scope="module")
def base():
    """The JAX nano model's (params, batch_stats), initialised once, and
    its features of the seeded eval images (the heads' train inputs)."""
    from tamtr_tpu.nn.graph import TAMTRModel

    jm = TAMTRModel.from_yaml("tamtr-nano.yaml", nc=NC)
    params, bs = jax_variables(jm, IMG, NC, HD)
    img, _ = inputs(0)
    feats = jax.jit(lambda p, s, i: jm.apply({"params": p, "batch_stats": s}, i, jnp.zeros((B, NC, HD)), None, False,
                                             features_only=True))(params, bs, img)
    return params, bs, [np.asarray(f) for f in feats]


def inputs(seed: int, width: int = HD):
    rng = np.random.default_rng(seed)
    img = rng.random((B, IMG, IMG, 3), dtype=np.float32)
    txt = rng.standard_normal((1, NC, width)).astype(np.float32)
    return img, txt / np.linalg.norm(txt, axis=-1, keepdims=True)


_VARIANTS = {}


def variant(head, base, tmp_path_factory):
    """(JAX model, params, batch_stats, head module, port model) of `head`
    on the nano wiring, built once per module."""
    if head in _VARIANTS:
        return _VARIANTS[head]
    from tamtr_tpu.nn.graph import TAMTRModel

    params, bs, feats = base
    path = tmp_path_factory.mktemp("heads") / f"{head}.json"
    path.write_text(json.dumps(variant_cfg(head)))
    jm = TAMTRModel.from_yaml(path, nc=NC, max_gt=M, num_denoising=ND, vss_drop_path=0.0)
    levels = [feats[[32, 36, 40].index(j)] for j in jm.head_from]
    module = jax_head(head, tuple(f.shape[-1] for f in levels))
    width = TEXT_WIDTH.get(head, 512)
    hv = _to_np(jax.device_get(jax.jit(lambda: module.init(
        {"params": jax.random.PRNGKey(3)}, [jnp.asarray(f) for f in levels[:len(module.ch)]],
        jnp.zeros((1, NC, width)), None, False))()))
    rng = np.random.default_rng(4)
    params = {**params, "head": spread_head_params(hv["params"], rng)}
    bs = {**bs, "head": hv.get("batch_stats", {})}
    for name in params:  # the TIAGELANs' text attention at this head's text width (never run)
        if name.endswith("TIAGELAN"):
            gl = params[name]["attn"]["gl"]
            params[name] = {**params[name], "attn": {**params[name]["attn"], "gl": {
                "kernel": (rng.standard_normal((width, gl["kernel"].shape[1])) * 0.05).astype(np.float32),
                "bias": gl["bias"]}}}
    port = PortModel(variant_cfg(head), nc=NC, max_gt=M, num_denoising=ND, vss_drop_path=0.0,
                     label_noise_ratio=0.0, box_noise_scale=0.0)
    sd, report = from_jax_variables(params, bs, port)
    assert not any(report.values()), report
    port.load_state_dict(sd, strict=True)
    _VARIANTS[head] = (jm, params, bs, module, port.eval())
    return _VARIANTS[head]


@pytest.mark.parametrize("head", HEADS)
def test_variant_eval_matches_jax(head, base, tmp_path_factory):
    jm, params, bs, _, port = variant(head, base, tmp_path_factory)
    assert port.head_type == head and port.uses_text == jm.uses_text
    assert port.text_width == TEXT_WIDTH.get(head, 512)
    img, txt = inputs(1, port.text_width)
    want = jax.jit(lambda i, t: jm.apply({"params": params, "batch_stats": bs}, i, t, None, False)["pred"])(img, txt)
    with torch.no_grad():
        got = port(torch.from_numpy(img), torch.from_numpy(txt))["pred"]
    pairs = zip(got, want) if head == "DualRTDETRDecoder" else [(got, want)]
    for g, w in pairs:
        assert g.shape == (B, NQ, 4 + NC)
        assert_same_row_set(g.numpy(), np.asarray(w))


def _targets(seed):
    rng = np.random.default_rng(seed)
    mask = np.arange(M)[None] < np.array([[5], [2]])
    box = np.concatenate([rng.uniform(0.2, 0.8, (B, M, 2)), rng.uniform(0.05, 0.4, (B, M, 2))], -1)
    return {"cls": rng.integers(0, NC, (B, M)).astype(np.int32), "bboxes": (box * mask[..., None]).astype(np.float32),
            "mask": mask}


def test_dual_runs_through_the_model_and_the_trainer_only(base, tmp_path_factory):
    """A Dual model trains a step through `Trainer.step` (the loss of the
    first half's outputs); the engine's entry points, which take one
    prediction per image, refuse it with a clear error, as the JAX engine
    cannot val or predict it either."""
    from tamtr_torch.api import TAMTR
    from tamtr_torch.config import get_cfg
    from tamtr_torch.engine.model import Engine
    from tamtr_torch.train.trainer import Trainer, TrainConfig

    *_, port = variant("DualRTDETRDecoder", base, tmp_path_factory)
    img, txt = inputs(4, 512)
    tr = Trainer(copy.deepcopy(port), TrainConfig(batch_size=B, accumulate=1, warmup_iters=1), device="cpu")
    m = tr.step({"img": img, "txt_feats": txt, **_targets(5)})
    assert m["stepped"] == 1.0 and np.isfinite(m["loss"]) and m["grad_norm"] > 0
    eng = Engine("tamtr-nano.yaml", device="cpu")
    with pytest.raises(NotImplementedError, match="DualRTDETRDecoder"):
        eng._eval_model(port, get_cfg())
    det = TAMTR("tamtr-nano.yaml", device="cpu")
    det._lazy_engine().model = port
    with pytest.raises(NotImplementedError, match="DualRTDETRDecoder"):
        det.predict(img, txt)


def test_fuse_folds_the_location_heads_conv_stacks(base, tmp_path_factory):
    """`fuse_model` folds each BatchNorm of Location's cv3 stacks and input
    projections into its conv; the fused twin's eval equals the model's."""
    from tamtr_torch.nn.fuse import fuse_model

    *_, port = variant("locationManbaDecoder", base, tmp_path_factory)
    fused = fuse_model(port)
    head = fused.model[-1]
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in [*head.cv3.modules(), *head.input_proj.modules()])
    img, txt = inputs(6, 512)
    with torch.no_grad():
        got, want = (m(torch.from_numpy(img), torch.from_numpy(txt))["pred"] for m in (fused, port))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# The modules alone
# ---------------------------------------------------------------------------


def _layer_inputs(seed, Q=14, nd=6, shapes=((8, 8), (4, 4)), C=32):
    rng = np.random.default_rng(seed)
    Lv = sum(h * w for h, w in shapes)
    box = np.concatenate([rng.uniform(0.2, 0.8, (B, Q, 2)), rng.uniform(0.05, 0.4, (B, Q, 2))], -1)
    mask = PD.cdn_attn_mask(nd, Q - nd, nd // 2)
    return [rng.standard_normal(s).astype(np.float32) for s in ((B, Q, C), (B, Q, C), (B, Lv, C), (B, Q, C))] + [
        box.astype(np.float32), mask]


@pytest.mark.parametrize("mode", ["decouple", "dfl"])
def test_decoupling_decoder_layer_matches_jax(mode):
    from tamtr_tpu.nn.decoder import DecouplingDecoderLayer

    shapes, nd = [(8, 8), (4, 4)], 6
    embed, embed_box, value, pos, box, mask = _layer_inputs(5)
    jl = DecouplingDecoderLayer(32, 4, 64, 2, 4, mode=mode, num_dn=nd)
    args = (embed, embed_box, box, value, shapes, mask, pos)
    v = _to_np(jax.device_get(jl.init(jax.random.PRNGKey(0), *args)))
    v = spread_head_params(v, np.random.default_rng(6))
    want = jl.apply(v, *args)
    port = PD.DecouplingDecoderLayer(32, 4, 64, 2, 4, mode=mode)
    sd = {}
    for key in port.state_dict():
        parts = key.split(".")
        node = v["params"]
        if parts[-1].startswith("in_proj"):
            kind = "kernel" if parts[-1].endswith("weight") else "bias"
            pieces = [np.asarray(node[parts[0]][n][kind]) for n in ("q_proj", "k_proj", "v_proj")]
            sd[key] = torch.from_numpy(np.concatenate([p.T if p.ndim == 2 else p for p in pieces], 0))
            continue
        for p in parts[:-1]:
            node = node[p]
        leaf = np.asarray(node["scale" if parts[0].startswith("norm") and parts[-1] == "weight" else
                               "kernel" if parts[-1] == "weight" else "bias"])
        sd[key] = torch.from_numpy(leaf.T.copy() if leaf.ndim == 2 else leaf)
    port.load_state_dict(sd, strict=True)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    with torch.no_grad():
        got = port(t(embed), t(embed_box), t(box), t(value), shapes, t(pos), t(mask), nd)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
    assert hasattr(port, "self_attn2") == (mode == "dfl")


def test_contrastive_head_2d_matches_jax():
    from tamtr_tpu.nn.decoder import ContrastiveHead2D

    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, 5, 6, 16)).astype(np.float32)
    w = rng.standard_normal((B, 4, 16)).astype(np.float32)
    jh = ContrastiveHead2D()
    v = {"params": {"bias": np.array([0.3], np.float32), "logit_scale": np.float32(1.7)}}
    want = np.asarray(jh.apply(v, x, w))  # (B, H, W, K)
    port = PD.ContrastiveHead2D()
    with torch.no_grad():
        port.bias.fill_(0.3)
        port.logit_scale.fill_(1.7)
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w))  # (B, K, H, W)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5, rtol=1e-5)
