"""The YOLO Segment head of the port (`tamtr_torch/nn/yolo_head.py:Proto,
Segment`, `losses/v8_seg_loss.py`, the segment task of the engine and the
CLI) against the JAX package on the CPU, one torch thread.

The model is `yolo_narrow_cfg`'s wiring with a Segment head at nc 3
(`torch_engine_data.py:yolo_task_cfg`), 64 px. Its weights are the port's
seeded ones, the Detect head spread and the whole head calibrated on four
random images (`calibrate_yolo_head`: at init SiLU shrinks the features to
~1e-4, and the head's outputs would be its biases), handed to the JAX
model as flax variables (`flax_variables_of`): no JAX init is compiled.

Bounds: the Proto alone at 1e-5 (its transposed kernel flipped); eval at
1e-3 (boxes over the input size); the loss on fixed inputs and its
gradients at 1e-5; on the model's own train forward, TAL's anchors that
differ from JAX's at most 1% of the foreground, then with JAX's assignment
the loss and its items at 1e-4, the port's fp64 parameter gradient within
1e-2 of JAX's (relative, whole) and its fp32 one within 1e-2 or twice its
own distance from the fp64 one (a step on two images in train-mode
BatchNorm is ill-conditioned in fp32); val's mAP (box and mask) at 1e-6,
its precision and recall at 1e-5 (interpolated at a confidence, they
follow the scores' last bits); the save_json records' RLE masks
byte-equal.
"""

import copy
import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tamtr_torch.engine.model import Engine, normalized_pred
from tamtr_torch.losses.v8_seg_loss import V8SegLossConfig, v8_segmentation_loss
from tamtr_torch.nn.graph import TAMTRModel as PortModel
from tamtr_torch.nn.yolo_head import Proto
from tamtr_torch.train import trainer as ptrain
from tamtr_torch.weights import from_jax_variables, init_parameters

from torch_engine_data import (NAMES, NC, calibrate_yolo_head, flax_variables_of, one_thread,  # noqa: F401
                               relabel_for_task, spread_detect_model, yolo_task_cfg)

IMG = 64
SHAPES = [(64, 64), (48, 64), (64, 48), (40, 64), (64, 40), (56, 64)]


@pytest.fixture(scope="module")
def seg(tmp_path_factory):
    """(config path, JAX model, params, batch_stats, port model): the port's
    seeded narrow Segment model, heads spread and calibrated, and the JAX
    model of the same config on its weights."""
    from tamtr_tpu.nn.graph import TAMTRModel

    path = tmp_path_factory.mktemp("seg_cfg") / "yolo-seg-narrow.json"
    path.write_text(json.dumps(yolo_task_cfg("Segment")))
    port = PortModel.from_cfg(path, nc=NC)
    init_parameters(port, 0)
    spread_detect_model(port)
    calibrate_yolo_head(port, torch.from_numpy(np.random.default_rng(0).random((4, IMG, IMG, 3), dtype=np.float32)))
    params, bs = flax_variables_of(port)
    return path, TAMTRModel.from_yaml(path, nc=NC), params, bs, port.eval()


def _jax_eval(jm, params, bs, img):
    return jax.jit(lambda v, x: jm.apply(v, x, jnp.zeros((x.shape[0], NC, 512)), None, False))(
        {"params": params, "batch_stats": bs}, img)


# ---------------------------------------------------------------------------
# The head
# ---------------------------------------------------------------------------


def test_proto_matches_jax():
    """`Proto` alone on random weights and statistics against flax's: the
    reference's ConvTranspose2d weight (in, out, 2, 2) is flax's kernel
    (2, 2, in, out) flipped in both spatial axes; unflipped it differs."""
    from tamtr_tpu.nn.yolo_head import Proto as JProto

    rng = np.random.default_rng(1)
    port = Proto(8, 16, 6).eval()
    with torch.no_grad():
        for m in port.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                m.weight.copy_(torch.from_numpy(rng.standard_normal(m.weight.shape).astype(np.float32) * 0.2))
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.from_numpy(rng.standard_normal(m.num_features).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, m.num_features).astype(np.float32)))
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 2, m.num_features).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.standard_normal(m.num_features).astype(np.float32)))
        port.upsample.bias.copy_(torch.from_numpy(rng.standard_normal(16).astype(np.float32)))

    def flax_vars(flip: bool):
        params, stats = {}, {}
        for name in ("cv1", "cv2", "cv3"):
            cb = getattr(port, name)
            params[name] = {"Conv_0": {"kernel": cb.conv.weight.detach().numpy().transpose(2, 3, 1, 0)},
                            "BatchNorm_0": {"scale": cb.bn.weight.detach().numpy(), "bias": cb.bn.bias.detach().numpy()}}
            stats[name] = {"BatchNorm_0": {"mean": cb.bn.running_mean.numpy(), "var": cb.bn.running_var.numpy()}}
        w = port.upsample.weight.detach().numpy()
        params["upsample"] = {"kernel": (w[:, :, ::-1, ::-1] if flip else w).transpose(2, 3, 0, 1),
                              "bias": port.upsample.bias.detach().numpy()}
        return {"params": params, "batch_stats": stats}

    x = rng.standard_normal((2, 5, 4, 8)).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    want = np.asarray(JProto(16, 6).apply(flax_vars(True), jnp.asarray(x)))
    assert got.shape == want.shape == (2, 10, 8, 6)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert np.abs(got - np.asarray(JProto(16, 6).apply(flax_vars(False), jnp.asarray(x)))).max() > 1e-2


def test_segment_eval_matches_jax(seg):
    """The narrow Segment model's eval against JAX's on its weights: the
    bridge leaves nothing out, pred (boxes over the input size), protos
    (NCHW here, NHWC in JAX), mask_coefs and the raw head outputs at 1e-3;
    the parameter count equals JAX's variables."""
    path, jm, params, bs, port = seg
    sd, report = from_jax_variables(params, bs, PortModel.from_cfg(path, nc=NC))
    assert not any(report.values()), report
    assert all(torch.equal(sd[k], v) for k, v in port.state_dict().items() if not k.endswith("num_batches_tracked"))
    img = np.random.default_rng(2).random((2, IMG, IMG, 3), dtype=np.float32)
    want = _jax_eval(jm, params, bs, img)
    with torch.no_grad():
        got = port(torch.from_numpy(img), torch.zeros(2, NC, 512))
    norm = lambda p: np.asarray(p) / np.array([IMG] * 4 + [1] * NC)  # noqa: E731
    np.testing.assert_allclose(norm(got["pred"].numpy()), norm(want["pred"]), atol=1e-3, rtol=1e-3)
    assert got["protos"].shape == (2, 32, IMG // 4, IMG // 4) and got["mask_coefs"].shape == (2, 84, 32)
    np.testing.assert_allclose(got["protos"].permute(0, 2, 3, 1).numpy(), np.asarray(want["protos"]), atol=1e-3,
                               rtol=1e-3)
    for k in ("mask_coefs", "distri", "scores"):
        assert np.asarray(want[k]).std() > 0.1, k  # the calibrated head's outputs vary
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-3, rtol=1e-3, err_msg=k)


def test_fuse_half_and_info_of_a_segment_model(seg):
    """fuse=True folds every ConvBN of the Segment head and its Proto (the
    transposed conv stays), equal to the unfused forward at 1e-4; half=True
    computes in bf16 with fp32 pred within 2e-2, protos and mask_coefs
    within 2% of the fp32 tensors' norms;
    `TAMTR.info` of `yolo-seg-gelan.yaml` equals JAX's."""
    from tamtr_tpu.api import TAMTR as JaxTAMTR

    from tamtr_torch.api import TAMTR
    from tamtr_torch.config import get_cfg
    from tamtr_torch.nn.layers import BatchNorm2d

    port = seg[4]
    eng = Engine(str(seg[0]), device="cpu")
    fused = eng._eval_model(port, get_cfg(overrides=dict(fuse=True)))
    assert not any(isinstance(m, BatchNorm2d) for m in fused.modules())
    assert torch.equal(fused.model[-1].proto.upsample.weight, port.model[-1].proto.upsample.weight)
    img = torch.from_numpy(np.random.default_rng(5).random((2, IMG, IMG, 3), dtype=np.float32))
    txt = torch.zeros(1, NC, 512)
    with torch.no_grad():
        want = port(img, txt)
        got = fused(img, txt)
        for k in ("protos", "mask_coefs"):
            torch.testing.assert_close(got[k], want[k], atol=1e-4, rtol=1e-4)
        ref = normalized_pred(port, want["pred"], (IMG, IMG))
        torch.testing.assert_close(normalized_pred(fused, got["pred"], (IMG, IMG)), ref, atol=1e-4, rtol=1e-4)
        for fuse in (False, True):
            half = eng._eval_model(port, get_cfg(overrides=dict(fuse=fuse, half=True)))
            out = half(img, txt)
            assert half.dtype == torch.bfloat16 and all(out[k].dtype == torch.float32 for k in ("pred", "protos"))
            torch.testing.assert_close(normalized_pred(half, out["pred"], (IMG, IMG)), ref, atol=2e-2, rtol=2e-2)
            for k in ("protos", "mask_coefs"):  # bf16 rounding: within 2% of the fp32 tensor's norm
                assert float((out[k] - want[k]).norm() / want[k].norm()) < 2e-2, k
    assert TAMTR("yolo-seg-gelan.yaml", device="cpu").info(nc=5) == JaxTAMTR("yolo-seg-gelan.yaml").info(nc=5)


# ---------------------------------------------------------------------------
# The loss
# ---------------------------------------------------------------------------


def _head_outputs(seed, B=2, nm=8):
    """Train-dict tensors of a Segment head at 64 px: boxes of about 3
    cells, scores, mask coefficients and protos (NHWC), as numpy."""
    from tamtr_torch.nn.yolo_head import make_anchors

    rng = np.random.default_rng(seed)
    pts, strs = make_anchors([(8, 8), (4, 4), (2, 2)], (8, 16, 32))
    A = len(pts)
    bias = np.tile(-2.0 * np.abs(np.arange(16) - 1.5), 4)
    return {"distri": (rng.standard_normal((B, A, 64)) + bias).astype(np.float32),
            "scores": rng.standard_normal((B, A, NC)).astype(np.float32),
            "mask_coefs": rng.standard_normal((B, A, nm)).astype(np.float32),
            "protos": rng.standard_normal((B, 16, 16, nm)).astype(np.float32), "anchors": pts, "strides": strs}


def _seg_targets(seed, B=2, M=8, counts=(6, 3), hm=16):
    """Padded targets with each gt's mask: an ellipse polygon in its box,
    filled at the protos' size as `collate` fills it."""
    from tamtr_torch.data.imgproc import fill_poly

    rng = np.random.default_rng(seed)
    mask = np.arange(M)[None] < np.array(counts)[:, None]
    bb = np.concatenate([rng.uniform(0.25, 0.75, (B, M, 2)), rng.uniform(0.15, 0.45, (B, M, 2))], -1) * mask[..., None]
    masks = np.zeros((B, M, hm, hm), np.float32)
    for b in range(B):
        for j in range(counts[b]):
            a = np.linspace(0, 2 * np.pi, 10, endpoint=False)
            cx, cy, w, h = bb[b, j] * hm
            fill_poly(masks[b, j], np.stack([cx + w / 2 * np.cos(a), cy + h / 2 * np.sin(a)], 1).astype(np.int32), 1.0)
    return {"cls": rng.integers(0, NC, (B, M)).astype(np.int32), "bboxes": bb.astype(np.float32), "mask": mask,
            "masks": masks}


def test_seg_loss_and_gradient_match_jax():
    """`v8_segmentation_loss` on fixed head outputs (one image with 6 gts,
    one with 3): the total and box / cls / dfl / seg at 1e-5, and the
    gradients to distri, scores, mask_coefs and protos at 1e-5; the
    detection loss's assignment serves the mask term (one TAL run)."""
    from tamtr_tpu.losses.v8_seg_loss import V8SegLossConfig as JCfg
    from tamtr_tpu.losses.v8_seg_loss import v8_segmentation_loss as jax_loss

    out, tg = _head_outputs(3), _seg_targets(4)
    keys = ("distri", "scores", "mask_coefs", "protos")

    def jl(*xs):
        return jax_loss({**dict(zip(keys, xs)), "anchors": jnp.asarray(out["anchors"]),
                         "strides": jnp.asarray(out["strides"])}, {k: jnp.asarray(v) for k, v in tg.items()},
                        JCfg(nc=NC, imgsz=IMG))

    (want, witems), jgrads = jax.value_and_grad(jl, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(out[k]) for k in keys))
    ts = {k: torch.from_numpy(out[k]).requires_grad_() for k in keys}
    po = {**ts, "protos": ts["protos"].permute(0, 3, 1, 2), "anchors": torch.from_numpy(out["anchors"]),
          "strides": torch.from_numpy(out["strides"])}
    got, items = v8_segmentation_loss(po, {k: torch.from_numpy(v) for k, v in tg.items()}, V8SegLossConfig(nc=NC,
                                                                                                          imgsz=IMG))
    got.backward()
    assert items["assign"]["fg_mask"].sum() > 5 and float(witems["seg"]) > 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for k in ("box", "cls", "dfl", "seg"):
        np.testing.assert_allclose(items[k].item(), float(witems[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    for k, g in zip(keys, jgrads):
        np.testing.assert_allclose(ts[k].grad.numpy(), np.asarray(g), atol=1e-5, rtol=1e-5, err_msg=k)


def _step_batch(B=2, M=8):
    rng = np.random.default_rng(11)
    return {"img": rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8),
            "txt_feats": np.zeros((B, NC, 512), np.float32), **_seg_targets(12, B, M, counts=(8, 5))}


def test_train_forward_loss_and_gradient_match_jax(seg, monkeypatch):
    """The narrow Segment model's train forward and v8 segmentation loss
    against JAX's (`jax.value_and_grad` through `TAMTRModel.apply` in train
    mode). TAL's anchors on the port's own forward differ from JAX's at
    most at 1% of the foreground; with JAX's assignment the loss and its
    items at 1e-4 and the gradients as the module docstring bounds them.
    Then
    `Trainer.step` (its loss picked by `loss_config_for`) reports the same
    loss and box / cls / dfl / seg."""
    from tamtr_tpu.losses.tal import task_aligned_assigner as jax_tal
    from tamtr_tpu.losses.v8_seg_loss import V8SegLossConfig as JCfg
    from tamtr_tpu.losses.v8_seg_loss import v8_segmentation_loss as jax_loss
    from tamtr_tpu.nn.yolo_head import dfl_decode, dist2bbox
    from tamtr_tpu.ops.boxes import xywh2xyxy

    _, jm, params, bs, port = seg
    batch = _step_batch()
    jt = {k: jnp.asarray(batch[k]) for k in ("cls", "bboxes", "mask", "masks")}
    img = batch["img"].astype(np.float32) / 255.0

    def jl(p):
        out, _ = jm.apply({"params": p, "batch_stats": bs}, img, jnp.zeros((2, NC, 512)), jt, True,
                          mutable=["batch_stats"])
        loss, items = jax_loss(out, jt, JCfg(nc=NC, imgsz=IMG))
        pred = dist2bbox(dfl_decode(out["distri"].astype(jnp.float32)), out["anchors"][None], xywh=False)
        assign = jax_tal(jax.nn.sigmoid(out["scores"].astype(jnp.float32)), pred * out["strides"][None],
                         out["anchors"] * out["strides"], jt["cls"], xywh2xyxy(jt["bboxes"]) * IMG, jt["mask"])
        return loss, (items, jax.lax.stop_gradient(assign))

    (want, (witems, jassign)), jgrads = jax.jit(jax.value_and_grad(jl, has_aux=True))(params)
    jassign = {k: torch.from_numpy(np.asarray(v)) for k, v in jassign.items()}
    tg = {k: torch.from_numpy(v) for k, v in batch.items() if k not in ("img", "txt_feats")}
    cfg = V8SegLossConfig(nc=NC, imgsz=IMG)

    def grads(dtype, assign):
        model = copy.deepcopy(port).to(dtype).train()
        out = model(torch.from_numpy(img).to(dtype), torch.zeros(2, NC, 512, dtype=dtype))
        loss, items = v8_segmentation_loss(out, {k: v.to(dtype) if v.is_floating_point() else v for k, v in tg.items()}, cfg,
                                   assign=assign)
        if assign is not None:
            loss.backward()
        return loss, items, np.concatenate([p.grad.double().numpy().ravel() if p.grad is not None else
                                            np.zeros(p.numel()) for _, p in model.named_parameters()])

    _, own, _ = grads(torch.float32, None)
    fg, jfg = own["assign"]["fg_mask"], jassign["fg_mask"]
    moved = int((fg != jfg).sum() + ((own["assign"]["target_gt"] != jassign["target_gt"]) & fg & jfg).sum())
    print(f"TAL anchors that differ from JAX's: {moved} of {int(jfg.sum())} foreground")
    assert jfg.sum() > 20 and moved <= 0.01 * int(jfg.sum())
    loss, items, g32 = grads(torch.float32, jassign)
    _, _, g64 = grads(torch.float64, jassign)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-4)
    for k in ("box", "cls", "dfl", "seg"):
        np.testing.assert_allclose(items[k].item(), float(witems[k]), rtol=1e-4, err_msg=k)
    gsd, _ = from_jax_variables(jax.device_get(jgrads), bs, port)
    g_jax = np.concatenate([gsd[k].double().numpy().ravel() for k, _ in port.named_parameters()])
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))  # noqa: E731
    readings = rel(g64, g_jax), rel(g32, g_jax), rel(g32, g64)
    print(f"parameter gradient |port fp64 - jax|, |port - jax|, |port - port fp64| (relative): {readings}")
    assert readings[0] < 1e-2 and readings[1] < max(1e-2, 2 * readings[2]), readings

    tr = ptrain.Trainer(copy.deepcopy(port), ptrain.TrainConfig(batch_size=2, warmup_iters=10, epochs=2),
                        loss_cfg=ptrain.loss_config_for(port, imgsz=IMG), steps_per_epoch=10, device="cpu")
    assert tr.loss_cfg == cfg
    monkeypatch.setattr(ptrain, "v8_segmentation_loss",
                        lambda o, t, c: v8_segmentation_loss(o, t, c, assign=jassign))
    m = tr.step(batch)
    assert set(m) == {"loss", "box", "cls", "dfl", "seg", "grad_norm", "stepped"}
    np.testing.assert_allclose(m["loss"], float(want), rtol=1e-4)
    np.testing.assert_allclose(m["seg"], float(witems["seg"]), rtol=1e-4)


# ---------------------------------------------------------------------------
# The engine and the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def val_split(seg, tmp_path_factory):
    """Six PNGs of mixed aspect ratios, each labelled with the port model's
    top-3 square detections as polygons: the outline (cv2.findContours) of
    each detection's mask resized to the image, so that gt and predicted
    masks overlap; returns (data.json, txt)."""
    from tamtr_torch.data.image_io import imwrite
    from tamtr_torch.data.imgproc import resize_linear, resize_linear_f32
    from tamtr_torch.engine.model import kept_extras
    from tamtr_torch.ops.nms import postprocess_predictions

    port = seg[4]
    root = tmp_path_factory.mktemp("seg_val")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(5)
    txt = rng.standard_normal((NC, 512)).astype(np.float32)
    for i, (h, w) in enumerate(SHAPES):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        x = resize_linear(img, (IMG, IMG))[..., ::-1].astype(np.float32) / 255.0
        with torch.inference_mode():
            out = port(torch.from_numpy(x.copy())[None], torch.from_numpy(txt[None]))
            post = postprocess_predictions(normalized_pred(port, out["pred"], (IMG, IMG)), 0.25, 0.7, 300)
            masks = kept_extras(port, out, post[4])[0].numpy()
        _, _, labels, valid, _ = (t.numpy() for t in post)
        rows = []
        for m, c in zip(masks[valid[0]], labels[0][valid[0]]):
            big = (resize_linear_f32(m, (w, h)) > 0.5).astype(np.uint8)
            contours, _ = cv2.findContours(big, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
            if not contours or len(rows) == 3:
                continue
            poly = max(contours, key=cv2.contourArea).reshape(-1, 2)
            if len(poly) >= 3:
                rows.append(" ".join([str(c)] + [f"{v:.5f}" for v in (poly / [w, h]).ravel()]))
        assert rows
        imwrite(root / "images" / f"{i}.png", img)
        (root / "labels" / f"{i}.txt").write_text("\n".join(rows))
    data = root / "data.json"
    data.write_text(json.dumps({"path": str(root), "train": "images", "val": "images", "nc": NC, "names": NAMES}))
    return str(data), txt


def test_val_and_save_json_match_jax_engine(seg, val_split, tmp_path):
    """`Engine.val` of the Segment model against the JAX `Engine.val` on its
    weights: mAP50, mAP50-95, precision, recall, mask_mAP50 and
    mask_mAP50-95 (precision and recall at 1e-5) at 1e-6 (the masks of the kept rows against each gt
    polygon filled at the image's size and resized to the protos' size);
    save_json's records equal, their RLE masks byte-equal; `mask_to_rle`
    and `rle_to_mask` equal JAX's on random masks."""
    from tamtr_tpu.engine.checkpoint import InferenceState
    from tamtr_tpu.engine.model import Engine as JaxEngine
    from tamtr_tpu.utils import coco as jcoco

    from tamtr_torch.utils import coco as pcoco

    path, jm, params, bs, port = seg
    data, txt = val_split
    args = dict(data=data, imgsz=IMG, batch=2, conf=0.25, workers=1, plots=False, save_json=True)
    eng = Engine(str(path), device="cpu")
    eng.model = port
    eng.set_classes(NAMES, txt)
    got = eng.val(**args, project=str(tmp_path / "port"))
    je = JaxEngine(str(path))
    je.model = jm
    je.state = InferenceState(params, bs)
    je.set_classes(NAMES, txt)
    want = je.val(**args, project=str(tmp_path / "jax"))
    print({k: (got[k], want[k]) for k in want if k != "images_per_sec"})
    assert 0 < want["mask_mAP50"] <= 1 and 0 < want["mAP50"] <= 1
    for k in ("mAP50", "mAP50-95", "precision", "recall", "mask_mAP50", "mask_mAP50-95"):
        assert abs(got[k] - want[k]) <= (1e-5 if k in ("precision", "recall") else 1e-6), (k, got[k], want[k])
    pj, jj = (json.loads((tmp_path / d / "predictions.json").read_text()) for d in ("port", "jax"))
    assert len(pj) == len(jj) > 0
    for a, b in zip(pj, jj):
        assert (a["image_id"], a["category_id"], a["segmentation"]) == (b["image_id"], b["category_id"],
                                                                          b["segmentation"])
        np.testing.assert_allclose(a["bbox"] + [a["score"]], b["bbox"] + [b["score"]], atol=2e-3)
    rng = np.random.default_rng(0)
    for h, w in ((1, 1), (7, 9), (30, 17)):
        for p in (0.0, 0.3, 1.0):
            m = rng.random((h, w)) < p
            rle = pcoco.mask_to_rle(m)
            assert rle == jcoco.mask_to_rle(m)
            np.testing.assert_array_equal(pcoco.rle_to_mask(rle), jcoco.rle_to_mask(rle))


def test_predict_masks_and_plot_match_jax(seg, val_split):
    """`Engine.predict` of the Segment model: each `Results` carries masks
    (n, 16, 16) equal to the JAX engine's at 1e-3 with its boxes, none
    with TTA (as JAX); `Results.plot` lays them over the image as JAX's
    does (each mask resized to the image by cv2 and thresholded at 0.5,
    blended at alpha 0.4 in the palette's colours) under the port's boxes."""
    from pathlib import Path

    from tamtr_tpu.engine.checkpoint import InferenceState
    from tamtr_tpu.engine.model import Engine as JaxEngine

    from tamtr_torch.data.image_io import imread
    from tamtr_torch.utils.plotting import _palette, annotate_image

    path, jm, params, bs, port = seg
    data, txt = val_split
    src = [str(p) for p in sorted((Path(data).parent / "images").glob("*.png"))[:3]]
    eng = Engine(str(path), device="cpu")
    eng.model = port
    eng.set_classes(NAMES, txt)
    got = eng.predict(src, imgsz=IMG)
    je = JaxEngine(str(path))
    je.model = jm
    je.state = InferenceState(params, bs)
    je.set_classes(NAMES, txt)
    want = je.predict(src, imgsz=IMG)
    for g, w in zip(got, want, strict=True):
        assert len(g) == len(w) > 0 and g.masks.shape == (len(g), IMG // 4, IMG // 4)
        np.testing.assert_allclose(g.boxes.xyxy, w.boxes.xyxy, atol=1e-3 * IMG)
        np.testing.assert_allclose(g.masks, w.masks, atol=1e-3)
        # JAX's overlay (`tamtr_tpu/engine/results.py:76-96`, cv2's resize), under the port's box drawing
        img = imread(g.path).astype(np.float32)
        colors = _palette(len(NAMES))
        for m, lab in zip(g.masks, g.boxes.cls):
            mm = cv2.resize(m.astype(np.float32), (img.shape[1], img.shape[0])) > 0.5
            img[mm] = img[mm] * 0.6 + np.array(colors[int(lab) % len(colors)], np.float32) * 0.4
        want_plot = annotate_image(img.astype(np.uint8), g.boxes.xyxy, g.boxes.conf, g.boxes.cls, g.names)
        np.testing.assert_array_equal(g.plot(), want_plot)
    assert all(r.masks is None for r in eng.predict(src, imgsz=IMG, augment=True))


def test_cli_segment_train_val_predict(tmp_path, capsys):
    """`python -m tamtr_torch segment train` of the narrow Segment config
    for one epoch on a generated polygon dataset, then `segment val` and
    `segment predict` from its `best.pt`, which reloads with its head."""
    from tamtr_torch import cli
    from tamtr_torch.api import TAMTR
    from tools.smoke_train_torch import make_dataset

    cfg = tmp_path / "seg.json"
    cfg.write_text(json.dumps(yolo_task_cfg("Segment")))
    data = relabel_for_task(make_dataset(tmp_path / "ds", 4, 2, IMG), "segment")
    cli.main(["segment", "train", f"model={cfg}", f"data={data}", "imgsz=64", "epochs=1", "batch=2", "workers=0",
              "plots=False", "device=cpu", "max_gt=8", "conf=0.01", f"project={tmp_path / 'runs'}", "name=r"])
    best = tmp_path / "runs" / "r" / "weights" / "best.pt"
    capsys.readouterr()
    cli.main(["segment", "val", f"model={best}", f"data={data}", "imgsz=64", "batch=2", "workers=0", "plots=False",
              "device=cpu", "conf=0.01"])
    assert "mask_mAP50-95" in capsys.readouterr().out
    cli.main(["segment", "predict", f"model={best}", f"source={tmp_path / 'ds' / 'val' / 'images'}", "imgsz=64",
              "device=cpu", "conf=0.0"])
    assert capsys.readouterr().out.count("detections") == 2
    loaded = TAMTR("yolo-seg-gelan.yaml", device="cpu", imgsz=IMG).load(best)
    assert loaded._engine.model.head_type == "Segment"
