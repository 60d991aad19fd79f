"""RT-DETR in the port (`rtdetr.yaml`: AIFI on the deepest level, the
RTDETRDecoder head, `tamtr_torch/nn/layers.py:AIFI` and the
`ManbaWorldDecoder` switches use_text=False, use_vss=False) against the JAX
package on the CPU, one torch thread.

`rtdetr.yaml` runs at full width, nc 7, 64 px, initialised once in JAX under
`jax.jit` (as `tests/test_rtdetr.py` builds it) and bridged into the port;
the zero-initialised head layers get small random values and the score
biases 0 (`torch_engine_data.py:spread_head_params`). CDN noise and
DropPath are off on both sides for the training step.

Bounds: `sincos_2d` bitwise; AIFI alone at 1e-5 on a square and a
non-square map; eval as a set of rows at 1e-3 (`tests/test_torch_model.py`);
the training step with JAX's top-k order and assignment at the main path's
bounds (`tests/test_torch_train.py`): loss 1e-4, gradient norm 1e-2, the
whole gradient within 2% of JAX's and each tensor within 7.5%, or within
twice JAX's own distance from the port's fp64 gradient where that is
larger (the test says why), the BatchNorm statistics after the step at
1e-4; the engine's val metrics within
1e-3 of the JAX engine's, and predict's detections as sets at 1e-3.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from tamtr_torch.api import TAMTR
from tamtr_torch.engine.model import Engine
from tamtr_torch.losses.detr_loss import DETRLossConfig, rtdetr_detection_loss
from tamtr_torch.nn.graph import TAMTRModel as PortModel
from tamtr_torch.nn.layers import AIFI, sincos_2d
from tamtr_torch.train import trainer as ptrain
from tamtr_torch.weights import from_jax_variables, map_torch_key

from test_torch_train import _rel_err, _to_np, jax_forward_and_topk, no_cdn_noise, pin_topk  # noqa: F401
from torch_engine_data import (assert_same_row_set, jax_variables, one_thread,  # noqa: F401
                               spread_head_params, write_val_split)

NC, IMG, B, M = 7, 64, 2, 24
N_VALID = (6, 22)
NAMES = [f"class{i}" for i in range(NC)]


@pytest.mark.parametrize("w,h,dim", [(3, 2, 8), (4, 6, 32), (20, 20, 256)])
def test_sincos_2d_is_jax_bitwise(w, h, dim):
    from tamtr_tpu.nn.layers import AIFI as JAIFI

    np.testing.assert_array_equal(sincos_2d(w, h, dim), np.asarray(JAIFI.sincos_2d(w, h, dim))[0])


def aifi_state_dict(v) -> dict:
    """The port AIFI's state dict from the JAX AIFI's flax params."""
    p = v["params"]
    lin = lambda d: {"weight": torch.from_numpy(np.asarray(d["kernel"]).T.copy()),  # noqa: E731
                     "bias": torch.from_numpy(np.asarray(d["bias"]))}
    sd = {"ma.in_proj_weight": torch.from_numpy(np.concatenate([np.asarray(p[n]["kernel"]).T for n in (
        "q_proj", "k_proj", "v_proj")], 0)),
          "ma.in_proj_bias": torch.from_numpy(np.concatenate([np.asarray(p[n]["bias"]) for n in (
              "q_proj", "k_proj", "v_proj")], 0))}
    for name in ("out_proj", "fc1", "fc2"):
        for k, t in lin(p[name]).items():
            sd[f"{'ma.' if name == 'out_proj' else ''}{name}.{k}"] = t
    for name in ("norm1", "norm2"):
        sd[f"{name}.weight"] = torch.from_numpy(np.asarray(p[name]["scale"]))
        sd[f"{name}.bias"] = torch.from_numpy(np.asarray(p[name]["bias"]))
    return sd


@pytest.mark.parametrize("hw", [(4, 4), (4, 6)])
def test_aifi_matches_jax(hw):
    """AIFI alone, with random biases and norm affines: 1e-5."""
    from tamtr_tpu.nn.layers import AIFI as JAIFI

    rng = np.random.default_rng(hw[1])
    x = rng.standard_normal((B, *hw, 32)).astype(np.float32)
    jl = JAIFI(cm=64, num_heads=4)
    v = _to_np(jax.device_get(jl.init(jax.random.PRNGKey(0), jnp.asarray(x))))
    for sub in v["params"].values():
        sub["bias"] = (rng.standard_normal(sub["bias"].shape) * 0.1).astype(np.float32)
        if "scale" in sub:
            sub["scale"] = (1 + rng.standard_normal(sub["scale"].shape) * 0.1).astype(np.float32)
    want = np.asarray(jl.apply(v, jnp.asarray(x)))
    port = AIFI(32, 64, 4)
    port.load_state_dict(aifi_state_dict(v), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def rtdetr(no_cdn_noise):
    """(JAX model, params, batch_stats, port model in eval) of rtdetr.yaml
    at nc 7, max_gt 24, DropPath and CDN noise off."""
    from tamtr_tpu.nn.graph import TAMTRModel

    jm = TAMTRModel.from_yaml("rtdetr.yaml", nc=NC, max_gt=M, vss_drop_path=0.0)
    params, bs = jax_variables(jm, IMG, NC)
    params["head"] = spread_head_params(params["head"], np.random.default_rng(0))
    port = PortModel.from_cfg("rtdetr.yaml", nc=NC, max_gt=M, vss_drop_path=0.0, label_noise_ratio=0.0,
                              box_noise_scale=0.0)
    sd, report = from_jax_variables(params, bs, port)
    assert not any(report.values()), report
    port.load_state_dict(sd, strict=True)
    return jm, params, bs, port.eval()


def test_rtdetr_eval_matches_jax(rtdetr):
    jm, params, bs, port = rtdetr
    assert port.head_type == jm.head_type == "RTDETRDecoder" and not port.uses_text and port.text_width == 512
    assert not any("VSSBlocks" in k for k in port.state_dict()) and "model.10.ma.in_proj_weight" in port.state_dict()
    rng = np.random.default_rng(1)
    img = rng.random((B, IMG, IMG, 3), dtype=np.float32)
    txt = rng.standard_normal((1, NC, 512)).astype(np.float32)
    want = jax.jit(lambda i, t: jm.apply({"params": params, "batch_stats": bs}, i, t, None, False)["pred"])(img, txt)
    with torch.no_grad():
        got = port(torch.from_numpy(img), torch.from_numpy(txt))["pred"].numpy()
    assert got.shape == (B, 300, 4 + NC) and np.asarray(want)[..., 4:].std() > 0.05
    assert_same_row_set(got, np.asarray(want))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(1)
    mask = np.arange(M)[None] < np.array(N_VALID)[:, None]
    cxcy = rng.uniform(0.15, 0.85, (B, M, 2))
    wh = rng.uniform(0.05, 0.3, (B, M, 2))
    return {"img": rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8),
            "txt_feats": np.zeros((B, NC, 512), np.float32),
            "cls": rng.integers(0, NC, (B, M)).astype(np.int32),
            "bboxes": (np.concatenate([cxcy, wh], -1) * mask[..., None]).astype(np.float32), "mask": mask}


def jax_assignment(out_j, batch):
    """The JAX matcher's (layers, B, M) assignment of the forward's matched
    layers (encoder first), as its loss stacks them."""
    from tamtr_tpu.losses.matcher import hungarian_match

    nd = int(out_j["num_dn"])
    layers = [jnp.concatenate([out_j[f"enc_{k}"][None], out_j[f"dec_{k}"][:, :, nd:]], 0) for k in ("bboxes", "scores")]
    L = layers[0].shape[0]
    tile = lambda x: jnp.tile(jnp.asarray(x), (L,) + (1,) * (x.ndim - 1))  # noqa: E731
    q = hungarian_match(*(x.reshape(L * B, *x.shape[2:]) for x in layers),
                        *(tile(batch[k]) for k in ("bboxes", "cls", "mask")))
    return torch.from_numpy(np.asarray(q).astype(np.int64)).view(L, B, M)


def jax_step(model, params, batch_stats, batch):
    """One `make_train_step`: its metrics, gradient (read back from the
    first Adam moment, m = (1 - b1) g clip) and BatchNorm statistics."""
    from tamtr_tpu.losses.detr_loss import DETRLossConfig as JCfg
    from tamtr_tpu.train import trainer as jtrain

    cfg = jtrain.TrainConfig(batch_size=B, warmup_iters=10, epochs=2)
    tx = jtrain.make_optimizer(cfg, params, steps_per_epoch=10)
    p_flat = jtrain.flatten_tree(params)
    state = jtrain.TrainState(
        step=jnp.zeros((), jnp.int32), params=p_flat, batch_stats=batch_stats, opt_state=tx.init(params),
        ema_params=jnp.copy(p_flat), ema_batch_stats=jax.tree.map(jnp.copy, batch_stats),
        unravel=jtrain.unravel_for(params),
    )
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    new, metrics = jax.jit(jtrain.make_train_step(model, tx, JCfg(nc=NC), cfg))(state, jb, jax.random.PRNGKey(0))
    coef = min(1.0, cfg.grad_clip / max(float(metrics["grad_norm"]), 1e-6))
    grads = np.asarray(new.opt_state.m) / ((1.0 - cfg.momentum) * coef)
    return cfg, metrics, _to_np(jax.jit(state.unravel)(jnp.asarray(grads))), _to_np(new.batch_stats)


def test_rtdetr_train_step_matches_jax(rtdetr, batch, monkeypatch):
    jm, params, bs, port = rtdetr
    out_j, _, jtopk = jax_forward_and_topk(jm, params, bs, batch)
    jmatch = jax_assignment(out_j, batch)
    jcfg, metrics, jgrads, jstats = jax_step(jm, params, bs, batch)

    tg = {k: torch.from_numpy(batch[k]) for k in ("cls", "bboxes", "mask")}

    def grads(dtype):
        model = copy.deepcopy(port).to(dtype).train()
        t = {**tg, "bboxes": tg["bboxes"].to(dtype)}
        with monkeypatch.context() as mp:
            pin_topk(mp, jtopk, [])
            img = torch.from_numpy(batch["img"]).to(dtype) / 255.0
            out = model(img, torch.from_numpy(batch["txt_feats"]).to(dtype), t)
        assert out["dec_scores"].shape == (6, B, out["num_dn"] + 300, NC)
        loss, _ = rtdetr_detection_loss(out, t, DETRLossConfig(nc=NC), match=jmatch)
        loss.backward()
        return loss.item(), {k: p.grad.double().numpy() if p.grad is not None else np.zeros(tuple(p.shape))
                             for k, p in model.named_parameters()}

    loss32, g32 = grads(torch.float32)
    np.testing.assert_allclose(loss32, float(metrics["loss"]), rtol=1e-4)
    _, g64 = grads(torch.float64)
    gsd, _ = from_jax_variables(jgrads, bs, port)
    gj = {k: gsd[k].double().numpy() for k in g32}
    whole = lambda g: np.concatenate([v.ravel() for v in g.values()])  # noqa: E731
    d = {name: float(_rel_err(whole(a), whole(b))) for name, a, b in (("port-jax", g32, gj), ("jax-port64", gj, g64),
                                                                       ("port-port64", g32, g64))}
    top = max(np.linalg.norm(g) for g in gj.values())
    live = [k for k in g32 if np.linalg.norm(gj[k]) > 1e-6 * top]
    per_tensor = {k: (float(_rel_err(g32[k], gj[k])), float(_rel_err(gj[k], g64[k]))) for k in live}
    print(f"rtdetr gradient distances (relative) {d}; worst tensor "
          f"{max(per_tensor.items(), key=lambda kv: kv[1][0])}")
    # The full-width step is ill-conditioned in fp32 (train-mode BatchNorm
    # over 2 images of 64 px, 8 values a channel at stride 32, and flax's
    # one-pass variance): JAX's own fp32 gradient lies ~2% from the port's
    # fp64 one overall and ~20% on the last-but-three decoder layer's
    # sampling offsets, where the port's fp32 and fp64 agree within 1%.
    # So each distance to JAX is held to the main path's bound or to twice
    # JAX's own distance from the port's fp64 pass, whichever is larger
    # (`chip_smoke.py:check_train_parity`'s rule); the port's own fp32
    # floor to the main path's 1.5%. The decoder head alone meets 2% / 7.5%
    # outright (`tests/test_torch_heads.py`, RTDETRDecoder).
    assert d["port-jax"] < max(2e-2, 2 * d["jax-port64"]) and d["port-port64"] < 1.5e-2, d
    for k, (e, floor) in per_tensor.items():
        assert e < max(7.5e-2, 2 * floor), (k, e, floor)
    assert np.abs(g32["model.10.ma.in_proj_weight"]).max() > 0

    tr = ptrain.Trainer(copy.deepcopy(port), ptrain.TrainConfig(batch_size=jcfg.batch_size,
                                                                warmup_iters=jcfg.warmup_iters, epochs=jcfg.epochs),
                        steps_per_epoch=10, device="cpu")
    monkeypatch.setattr(ptrain, "rtdetr_detection_loss", lambda o, t, c: rtdetr_detection_loss(o, t, c, match=jmatch))
    with monkeypatch.context() as mp:
        pin_topk(mp, jtopk, [])
        m = tr.step(batch)
    assert m["stepped"] == 1.0
    np.testing.assert_allclose(m["loss"], float(metrics["loss"]), rtol=1e-4)
    np.testing.assert_allclose(m["grad_norm"], float(metrics["grad_norm"]), rtol=1e-2)
    ssd, _ = from_jax_variables(params, jstats, port)
    for k, v in tr.model.state_dict().items():
        if "running_" in k:
            np.testing.assert_allclose(v.numpy(), ssd[k].numpy(), atol=1e-4, rtol=1e-4, err_msg=k)


def test_param_groups_equal_the_jax_masks(rtdetr):
    """AIFI's and the Linear score heads' leaves in the groups JAX's
    `_decay_mask` / `_bias_mask` put them in."""
    from tamtr_tpu.train.trainer import _bias_mask, _decay_mask

    _, params, _, port = rtdetr
    dm, bm = (_to_np(jax.tree.map(np.asarray, f(params))) for f in (_decay_mask, _bias_mask))
    layer_names = {idx: m.replace(".", "_") for idx, _, m, _ in port.specs}
    groups = ptrain.param_groups(port)
    for key, p in port.named_parameters():
        _, path, special = map_torch_key(key, tuple(p.shape), layer_names, len(port.specs))
        if special == "qkv":
            path = path + ["q_proj", "kernel" if key.endswith("weight") else "bias"]
        node_d, node_b = dm, bm
        for part in path:
            node_d, node_b = node_d[part], node_b[part]
        want = "bias" if bool(node_b) else ("decay" if bool(node_d) else "no_decay")
        assert groups[key] == want, (key, path)
    assert groups["model.10.ma.in_proj_bias"] == "bias" and groups["model.10.norm1.weight"] == "no_decay"
    assert groups["model.42.dec_score_head.0.weight"] == "decay"


@pytest.fixture(scope="module")
def engines(rtdetr, tmp_path_factory):
    """The JAX engine and `TAMTR("rtdetr.yaml", device="cpu")` on the same
    weights and class table, and a 6-image val split labelled by the model."""
    from tamtr_tpu.engine.checkpoint import InferenceState
    from tamtr_tpu.engine.model import Engine as JaxEngine

    jm, params, bs, port = rtdetr
    txt = np.random.default_rng(2).standard_normal((NC, 512)).astype(np.float32)
    # a fresh RT-DETR's boxes are 1-2 px at 64 px: corners jittered by 1%
    data = write_val_split(tmp_path_factory.mktemp("rtdetr_val"), port, txt, NAMES, jitter=0.01)
    je = JaxEngine("rtdetr.yaml")
    je.model = jm
    je.state = InferenceState(params, bs)
    je.set_classes(NAMES, txt)
    det = TAMTR("rtdetr.yaml", nc=NC, device="cpu", imgsz=IMG, max_gt=M).load_jax_variables(params, bs)
    det.set_classes(NAMES, txt)
    return je, det, data


def test_rtdetr_val_and_predict_match_jax_engine(engines):
    je, det, data = engines
    args = dict(data=str(data), batch=2, conf=0.25, workers=1, plots=False)
    got = det.val(**args)
    want = je.val(imgsz=IMG, **args)
    assert 0 < want["mAP50"] < 1
    for k in ("mAP50", "mAP50-95", "precision", "recall"):
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])
    source = str(data.parent / "images")
    w_res, g_res = je.predict(source, imgsz=IMG), det.predict(source)
    assert [r.path for r in g_res] == [r.path for r in w_res] and sum(len(r) for r in w_res) > 0
    for g, w in zip(g_res, w_res):
        assert len(g) == len(w), g.path
        if not len(w):
            continue
        rows = lambda r: np.concatenate([r.boxes.xyxy / IMG, r.boxes.conf[:, None],  # noqa: E731
                                         r.boxes.cls[:, None].astype(np.float32)], 1)
        dist = np.abs(rows(g)[:, None] - rows(w)[None]).max(-1)
        r, c = linear_sum_assignment(dist)
        assert dist[r, c].max() < 1e-3, (g.path, dist[r, c].max())


def test_rtdetr_facade_and_engine_build_rtdetr():
    """`RTDETR()` is `TAMTR("rtdetr.yaml")`; the engine trains it with the
    DETR loss (its head is not Detect) on the 512-wide class table."""
    from tamtr_torch.api import RTDETR
    from tamtr_torch.losses.detr_loss import DETRLossConfig as PCfg

    det = RTDETR(device="cpu")
    assert det.model_cfg == "rtdetr.yaml" and isinstance(det, TAMTR)
    model = PortModel.from_cfg("rtdetr.yaml", nc=3)
    assert isinstance(ptrain.loss_config_for(model), PCfg)
    assert Engine("rtdetr.yaml", device="cpu").model_cfg == "rtdetr.yaml"
    assert json.loads(json.dumps(model.head_args)) == [3, 256, 300, 4, 8, 6]


def test_autobackend_and_info_take_rtdetr(rtdetr):
    """`AutoBackend` over the RT-DETR model (the serving path's backend)
    answers with the model's own forward and the 512-wide text table;
    `TAMTR.info` counts the graph's 42 rows and the head."""
    from tamtr_torch.nn.autobackend import AutoBackend

    _, _, _, port = rtdetr
    ab = AutoBackend(port, imgsz=IMG, device="cpu")
    assert ab.text_width == 512 and ab.nc == NC
    rng = np.random.default_rng(9)
    img = rng.random((1, IMG, IMG, 3), dtype=np.float32)
    txt = rng.standard_normal((1, NC, 512)).astype(np.float32)
    with torch.no_grad():
        want = port(torch.from_numpy(img), torch.from_numpy(txt))["pred"].numpy()
    np.testing.assert_array_equal(ab(img, txt), want)
    assert "43 layers" in TAMTR("rtdetr.yaml", device="cpu").info(nc=NC)
