"""The YOLO Detect family of the port (`tamtr_torch/nn/yolo_head.py`,
`losses/tal.py`, `losses/v8_loss.py`, the YOLOv9 layers of `nn/layers.py`,
`yolo-gelan.yaml`) against the JAX package on the CPU, one torch thread.

Two models: `yolo-gelan.yaml` itself at nc 5 (eval parity, fuse, half,
info; this file) and its wiring at an eighth of the widths
(`torch_engine_data.py:yolo_narrow_cfg`, nc 3) for the training step, the
engine and two gloo ranks (`test_torch_yolo_engine.py`, on this file's
helpers). Each is initialised once in JAX under `jax.jit` and bridged into the
port; the Detect heads are spread (`spread_detect_params`: class biases 0,
boxes of about 3 cells) so that a fresh model assigns anchors and detects,
and their BatchNorms take the statistics of one random batch's features
(`calibrated_head`), so that the head's activations are of order 1 and
vary with the image.

Bounds: the YOLOv9 layers, the anchor and DFL helpers at 1e-5 / 1e-6; TAL's
fg_mask and target_gt equal, its targets at 1e-5; the v8 loss and its
gradient at 1e-5; eval at 1e-3 (boxes over the input size); the training
step given JAX's assignment at `tests/test_torch_train.py`'s bounds; val
metrics within 1e-3; the loader's batches at `tests/test_torch_data.py`'s.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tamtr_torch.engine.model import Engine, normalized_pred
from tamtr_torch.losses.tal import task_aligned_assigner
from tamtr_torch.losses.v8_loss import V8LossConfig, v8_detection_loss
from tamtr_torch.nn import yolo_head as PH
from tamtr_torch.nn.graph import TAMTRModel as PortModel
from tamtr_torch.weights import from_jax_variables

from torch_engine_data import NC, calibrated_head, jax_variables, one_thread, spread_detect_params  # noqa: F401

IMG = 64


def _bridge(cfg, params, batch_stats, nc):
    port = PortModel.from_cfg(cfg, nc=nc)
    sd, report = from_jax_variables(params, batch_stats, port)
    assert not any(report.values()), report
    port.load_state_dict(sd, strict=True)
    return port.eval()


@pytest.fixture(scope="module")
def full():
    """yolo-gelan.yaml at nc 5: (JAX model, params, batch_stats, port model)."""
    from tamtr_tpu.nn.graph import TAMTRModel

    jm = TAMTRModel.from_yaml("yolo-gelan.yaml", nc=5)
    params, bs = jax_variables(jm, IMG, 5)
    params = spread_detect_params(params)
    params, bs = calibrated_head(jm, params, bs, IMG, 5)
    return jm, params, bs, _bridge("yolo-gelan.yaml", params, bs, 5)


# ---------------------------------------------------------------------------
# Config, layers, helpers
# ---------------------------------------------------------------------------


def test_config_equals_jax_yaml():
    import yaml

    from tamtr_torch.nn.graph import CFG_DIR, TEXT_WIDTH

    with open("tamtr_tpu/cfg/models/yolo-gelan.yaml") as f:
        assert json.loads((CFG_DIR / "yolo-gelan.json").read_text()) == yaml.safe_load(f)
    m = PortModel.from_cfg("yolo-gelan.yaml", nc=5)
    assert (m.head_type, m.uses_text, m.text_width) == ("Detect", False, TEXT_WIDTH)
    assert PortModel.from_cfg("tamtr-nano.yaml", nc=5).uses_text


def test_unported_heads_name_their_roadmap_item():
    """Every head of the JAX package is ported now: `classify-gelan.yaml`
    builds (its Classify head on the backbone's last map), and the narrow
    config with a Classify head too; `TAMTR.info()` of the classify config
    equals the JAX package's summary, its count that of JAX's variables
    (`jax.eval_shape` of the init)."""
    from tamtr_tpu.api import TAMTR as JTAMTR
    from tamtr_tpu.nn.graph import TAMTRModel

    from tamtr_torch.api import TAMTR, variable_count
    from tamtr_torch.nn.graph import HEADS, PORTED_HEADS

    assert PORTED_HEADS == HEADS
    assert PortModel(_classify_cfg(), nc=3).head_type == "Classify"
    port = PortModel.from_cfg("classify-gelan.yaml", nc=80)
    jm = TAMTRModel.from_yaml("classify-gelan.yaml", nc=80)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)),
                                            jnp.zeros((1, 1, 512)), None, False))
    assert variable_count(port) == sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    assert TAMTR("classify-gelan.yaml", device="cpu").info(imgsz=64) == JTAMTR("classify-gelan.yaml").info(imgsz=64)


def _classify_cfg():
    from torch_engine_data import yolo_narrow_cfg

    cfg = yolo_narrow_cfg(3)
    cfg["head"][-1] = [[21], 1, "Classify", ["nc"]]
    return cfg


def _layers_cfg():
    """Silence, ADown twice, two CBLinear (one 3x3 stride 3) and a CBFuse
    that resizes a 20x20 map down to 10x10 and a 7x7 map up to 10x10 (a
    non-integer factor), into a Detect head at 80 px."""
    return {"nc": 3, "backbone": [
        [-1, 1, "Silence", []],  # 0: 80
        [-1, 1, "Conv", [16, 3, 2]],  # 1: 40
        [-1, 1, "ADown", [32]],  # 2: 20
        [-1, 1, "ADown", [32]],  # 3: 10
        [2, 1, "CBLinear", [[32, 16]]],  # 4: (32, 16) at 20
        [2, 1, "CBLinear", [[16, 32], 3, 3]],  # 5: (16, 32) at 7
        [[4, 5, 3], 1, "CBFuse", [[0, 1]]],  # 6: 32 at 10
    ], "head": [
        [-1, 1, "Conv", [32, 3, 2]],  # 7: 5
        [-1, 1, "ADown", [32]],  # 8: 2
        [[6, 7, 8], 1, "Detect", ["nc"]],
    ]}


def test_yolov9_layers_in_a_graph_match_jax(tmp_path):
    """The graph of `_layers_cfg` built in both packages from one JSON file,
    JAX's weights bridged (a CBLinear's conv is flax's `conv`): the head's
    raw outputs at 1e-5 and pred over the input size at 1e-5. CBFuse
    resizes as `jax.image.resize(..., "nearest")`, which is torch's
    "nearest-exact", not its "nearest" (both resizes of this graph differ
    between the two)."""
    from tamtr_tpu.nn.graph import TAMTRModel

    path = tmp_path / "layers.json"
    path.write_text(json.dumps(_layers_cfg()))
    jm = TAMTRModel.from_yaml(path, nc=3)
    params, bs = jax_variables(jm, 80, 3)
    rng = np.random.default_rng(0)
    bs = jax.tree.map(lambda x: (x + rng.uniform(0.1, 0.5, x.shape)).astype(np.float32), bs)
    port = _bridge(path, params, bs, 3)
    assert [type(m).__name__ for m in port.model[:7]] == ["Silence", "ConvBN", "ADown", "ADown", "CBLinear",
                                                          "CBLinear", "CBFuse"]
    img = rng.random((2, 80, 80, 3), dtype=np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, jnp.zeros((2, 3, 512)), None, False))(
        {"params": params, "batch_stats": bs}, img)
    with torch.no_grad():
        got = port(torch.from_numpy(img), torch.zeros(2, 3, 512))
    for k in ("distri", "scores", "anchors", "strides"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["pred"].numpy() / np.array([80] * 4 + [1] * 3), np.asarray(want["pred"]) /
                               np.array([80] * 4 + [1] * 3), atol=1e-5, rtol=1e-5)
    for n_in, n_out in ((20, 10), (7, 10), (8, 4), (3, 7)):
        x = torch.arange(n_in, dtype=torch.float32)[None, None, :, None].expand(1, 1, n_in, 1)
        exact = F.interpolate(x, size=(n_out, 1), mode="nearest-exact")[0, 0, :, 0]
        jx = jax.image.resize(jnp.arange(n_in, dtype=jnp.float32), (n_out,), "nearest")
        np.testing.assert_array_equal(exact.numpy(), np.asarray(jx))
        assert not torch.equal(exact, F.interpolate(x, size=(n_out, 1), mode="nearest")[0, 0, :, 0])


@pytest.mark.parametrize("c1,c2,k,s", [(16, 16, 3, 1), (8, 16, 3, 2), (16, 8, 1, 1)])
def test_dwconvbn_matches_jax(c1, c2, k, s):
    """DWConvBN (groups min(c1, c2)) in eval mode on random weights and
    statistics at 1e-5."""
    from tamtr_tpu.nn.layers import DWConvBN as JDW

    from tamtr_torch.nn.layers import DWConvBN

    rng = np.random.default_rng(c1 + c2)
    x = rng.standard_normal((2, 9, 9, c1)).astype(np.float32)
    v = jax.device_get(JDW(c2, k, s).init(jax.random.PRNGKey(0), jnp.asarray(x)))
    inner = v["params"]["ConvBN_0"]
    st = {"mean": rng.standard_normal(c2).astype(np.float32), "var": rng.uniform(0.5, 2, c2).astype(np.float32)}
    scale, bias = rng.uniform(0.5, 2, c2).astype(np.float32), rng.standard_normal(c2).astype(np.float32)
    jv = {"params": {"ConvBN_0": {"Conv_0": inner["Conv_0"], "BatchNorm_0": {"scale": scale, "bias": bias}}},
          "batch_stats": {"ConvBN_0": {"BatchNorm_0": st}}}
    want = JDW(c2, k, s).apply(jv, jnp.asarray(x))
    m = DWConvBN(c1, c2, k, s).eval()
    assert m.conv.groups == min(c1, c2)
    with torch.no_grad():
        m.conv.weight.copy_(torch.from_numpy(np.transpose(np.asarray(inner["Conv_0"]["kernel"]), (3, 2, 0, 1))))
        m.bn.weight.copy_(torch.from_numpy(scale))
        m.bn.bias.copy_(torch.from_numpy(bias))
        m.bn.running_mean.copy_(torch.from_numpy(st["mean"]))
        m.bn.running_var.copy_(torch.from_numpy(st["var"]))
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_anchor_and_dfl_helpers_match_jax():
    from tamtr_tpu.nn import yolo_head as JH

    shapes, strides = [(8, 10), (4, 5), (2, 3)], (8, 16, 32)
    for a, b in zip(PH.make_anchors(shapes, strides), JH.make_anchors(shapes, strides)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(1)
    pts = rng.uniform(2, 12, (30, 2)).astype(np.float32)
    dist = rng.uniform(0.0, 18.0, (30, 4)).astype(np.float32)  # some beyond the reg_max clip
    for xywh in (True, False):
        np.testing.assert_allclose(PH.dist2bbox(torch.from_numpy(dist), torch.from_numpy(pts), xywh).numpy(),
                                   np.asarray(JH.dist2bbox(jnp.asarray(dist), jnp.asarray(pts), xywh)), atol=1e-6,
                                   rtol=1e-6)
    boxes = JH.dist2bbox(jnp.asarray(dist), jnp.asarray(pts), xywh=False)
    np.testing.assert_allclose(PH.bbox2dist(torch.from_numpy(np.asarray(boxes)), torch.from_numpy(pts), 16).numpy(),
                               np.asarray(JH.bbox2dist(boxes, jnp.asarray(pts), 16)), atol=1e-6, rtol=1e-6)
    logits = (rng.standard_normal((2, 30, 64)) * 3).astype(np.float32)
    np.testing.assert_allclose(PH.dfl_decode(torch.from_numpy(logits)).numpy(),
                               np.asarray(JH.dfl_decode(jnp.asarray(logits))), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# TAL and the v8 loss
# ---------------------------------------------------------------------------


def _assigner_inputs(seed=2, B=2, M=12, nc=NC):
    """A crowded image (10 overlapping gts near the centre) and a padded one
    (4 valid gts, the rest junk boxes the mask must hide), anchors of 64 px
    at strides 8/16/32, predictions near every anchor, in pixels."""
    rng = np.random.default_rng(seed)
    pts, strs = PH.make_anchors([(8, 8), (4, 4), (2, 2)], (8, 16, 32))
    anchors = pts * strs
    A = len(anchors)
    c = rng.uniform(-4, 4, (B, A, 2)) + anchors[None]
    wh = rng.uniform(6, 30, (B, A, 2))
    pred = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    gc = np.concatenate([rng.uniform(22, 42, (1, M, 2)), rng.uniform(4, 60, (1, M, 2))])
    gwh = np.concatenate([rng.uniform(10, 30, (1, M, 2)), rng.uniform(8, 40, (1, M, 2))])
    gts = np.concatenate([gc - gwh / 2, gc + gwh / 2], -1).astype(np.float32)
    mask = np.arange(M)[None] < np.array([[10], [4]])
    scores = 1 / (1 + np.exp(-rng.standard_normal((B, A, nc)).astype(np.float32)))
    return (scores.astype(np.float32), pred, anchors.astype(np.float32), rng.integers(0, nc, (B, M)).astype(np.int32),
            gts, mask)


def test_tal_matches_jax_on_crowded_and_padded_gts():
    from tamtr_tpu.losses.tal import task_aligned_assigner as jax_tal

    args = _assigner_inputs()
    want = jax_tal(*(jnp.asarray(a) for a in args))
    got = task_aligned_assigner(*(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(got["fg_mask"].numpy(), np.asarray(want["fg_mask"]))
    np.testing.assert_array_equal(got["target_gt"].numpy(), np.asarray(want["target_gt"]))
    for k in ("target_bboxes", "target_scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=1e-5, err_msg=k)
    fg, tgt = got["fg_mask"].numpy(), got["target_gt"].numpy()
    assert fg[0].sum() > 10 and fg[1].sum() > 0
    assert (tgt[1][fg[1]] < 4).all()  # padding never assigned
    # anchors inside two or more gts that went to one of them: the claims were resolved
    _, _, anchors, _, gts, mask = args
    inside = ((anchors[None, None] > gts[:, :, None, :2]) & (anchors[None, None] < gts[:, :, None, 2:])).all(-1)
    assert ((inside & mask[:, :, None]).sum(1)[0][fg[0]] > 1).any()


def _head_outputs(seed, B=2, nc=NC):
    rng = np.random.default_rng(seed)
    pts, strs = PH.make_anchors([(8, 8), (4, 4), (2, 2)], (8, 16, 32))
    A = len(pts)
    bias = np.tile(-2.0 * np.abs(np.arange(16) - 1.5), 4)
    return {"distri": (rng.standard_normal((B, A, 64)) + bias).astype(np.float32),
            "scores": rng.standard_normal((B, A, nc)).astype(np.float32), "anchors": pts, "strides": strs}


def _targets(seed, B=2, M=8, nc=NC, counts=(6, 0)):
    rng = np.random.default_rng(seed)
    mask = np.arange(M)[None] < np.array(counts)[:, None]
    bb = np.concatenate([rng.uniform(0.2, 0.8, (B, M, 2)), rng.uniform(0.1, 0.4, (B, M, 2))], -1) * mask[..., None]
    return {"cls": rng.integers(0, nc, (B, M)).astype(np.int32), "bboxes": bb.astype(np.float32), "mask": mask}


def test_v8_loss_and_gradient_match_jax():
    """The total and box / cls / dfl, and the gradients to distri and
    scores, at 1e-5, with an image without gts; the assignment given back
    (`assign=`) gives the same loss."""
    from tamtr_tpu.losses.v8_loss import V8LossConfig as JCfg
    from tamtr_tpu.losses.v8_loss import v8_detection_loss as jax_loss

    out, tg = _head_outputs(3), _targets(4)

    def jl(d, s):
        return jax_loss({"distri": d, "scores": s, "anchors": jnp.asarray(out["anchors"]),
                         "strides": jnp.asarray(out["strides"])}, {k: jnp.asarray(v) for k, v in tg.items()},
                        JCfg(nc=NC, imgsz=IMG))

    (want, witems), (gd, gs) = jax.value_and_grad(jl, argnums=(0, 1), has_aux=True)(
        jnp.asarray(out["distri"]), jnp.asarray(out["scores"]))
    d, s = (torch.from_numpy(out[k]).requires_grad_() for k in ("distri", "scores"))
    po = {"distri": d, "scores": s, "anchors": torch.from_numpy(out["anchors"]),
          "strides": torch.from_numpy(out["strides"])}
    pt = {k: torch.from_numpy(v) for k, v in tg.items()}
    got, items = v8_detection_loss(po, pt, V8LossConfig(nc=NC, imgsz=IMG))
    got.backward()
    assert items["assign"]["fg_mask"].sum() > 0 and float(witems["box"]) > 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for k in ("box", "cls", "dfl"):
        np.testing.assert_allclose(items[k].item(), float(witems[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(gd), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(gs), atol=1e-5, rtol=1e-5)
    again, _ = v8_detection_loss(po, pt, V8LossConfig(nc=NC, imgsz=IMG), assign=items["assign"])
    assert torch.equal(again, got)


# ---------------------------------------------------------------------------
# The model: eval, fuse, half, info
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sz", [64, 128])
def test_yolo_gelan_eval_matches_jax(full, sz):
    """yolo-gelan (nc 5) on bridged weights: pred, its boxes over the input
    size, at 1e-3, and the raw head outputs at 1e-3."""
    jm, params, bs, port = full
    img = np.random.default_rng(sz).random((2, sz, sz, 3), dtype=np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, jnp.zeros((2, 5, 512)), None, False))(
        {"params": params, "batch_stats": bs}, img)
    with torch.no_grad():
        got = port(torch.from_numpy(img), torch.zeros(2, 5, 512))
    A = sum((sz // s) ** 2 for s in (8, 16, 32))
    assert got["pred"].shape == (2, A, 9) and got["pred"].dtype == torch.float32
    norm = lambda p: np.asarray(p) / np.array([sz] * 4 + [1] * 5)  # noqa: E731
    assert norm(want["pred"])[..., 4:].std() > 0.05  # spread scores
    np.testing.assert_allclose(norm(got["pred"].numpy()), norm(want["pred"]), atol=1e-3, rtol=1e-3)
    for k in ("distri", "scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-3, rtol=1e-3, err_msg=k)


def test_fuse_and_half_of_a_detect_model(full):
    """`Engine._eval_model` of the Detect model: fuse=True folds every
    ConvBN of the graph and the head (no BatchNorm left) and keeps the
    head's final convs as they are, equal to the unfused forward at 1e-4;
    half=True (fused or not) computes in bf16 with fp32 pred, within 2e-2
    of fp32 (boxes over the input size)."""
    from tamtr_torch.config import get_cfg
    from tamtr_torch.nn.layers import BatchNorm2d

    _, _, _, port = full
    eng = Engine("yolo-gelan.yaml", device="cpu")
    fused = eng._eval_model(port, get_cfg(overrides=dict(fuse=True)))
    assert not any(isinstance(m, BatchNorm2d) for m in fused.modules())
    head, fhead = port.model[-1], fused.model[-1]
    for a, b in zip(list(head.cv2) + list(head.cv3), list(fhead.cv2) + list(fhead.cv3)):
        assert torch.equal(a[2].weight, b[2].weight) and torch.equal(a[2].bias, b[2].bias)
    img = torch.from_numpy(np.random.default_rng(5).random((2, IMG, IMG, 3), dtype=np.float32))
    txt = torch.zeros(1, 5, 512)
    with torch.no_grad():
        want = normalized_pred(port, port(img, txt)["pred"], (IMG, IMG))
        got = normalized_pred(fused, fused(img, txt)["pred"], (IMG, IMG))
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        for fuse in (False, True):
            half = eng._eval_model(port, get_cfg(overrides=dict(fuse=fuse, half=True)))
            assert half.dtype == torch.bfloat16 and next(half.parameters()).dtype == torch.float32
            p = half(img, txt)["pred"]
            assert p.dtype == torch.float32
            torch.testing.assert_close(normalized_pred(half, p, (IMG, IMG)), want, atol=2e-2, rtol=2e-2)
    assert port.dtype == torch.float32


def test_info_equals_jax(full):
    """`TAMTR.info` of yolo-gelan equals JAX's summary (layers, params), and
    the variables held equal JAX's count."""
    from tamtr_tpu.api import TAMTR as JaxTAMTR

    from tamtr_torch.api import TAMTR, variable_count

    _, params, bs, port = full
    assert variable_count(port) == sum(x.size for x in jax.tree.leaves((params, bs)))
    assert TAMTR("yolo-gelan.yaml", device="cpu").info(nc=5) == JaxTAMTR("yolo-gelan.yaml").info(nc=5)
