"""The YOLO Pose head of the port (`tamtr_torch/nn/yolo_head.py:Pose`,
`losses/v8_pose_loss.py`, the pose task of the engine and the CLI) against
the JAX package on the CPU, one torch thread.

The model is `yolo_narrow_cfg`'s wiring with a Pose head (17 keypoints of
3 values) at nc 3, 64 px, on the port's seeded weights with its head spread
and calibrated (`torch_engine_data.py:calibrate_yolo_head`), handed to the
JAX model as flax variables (`flax_variables_of`), as
`tests/test_torch_segment.py` does.

Bounds: eval at 1e-3 (boxes and keypoints over the input size); the loss
on fixed inputs and its gradients at 1e-5; on the model's own train
forward, TAL's anchors that differ from JAX's at most 1% of the
foreground, then with JAX's assignment the loss and its items at 1e-4,
the port's fp64 parameter gradient within 1e-2 of JAX's (relative, whole)
and its fp32 one within 1e-2 or twice its own distance from the fp64 one
(a step on two images in train-mode BatchNorm is ill-conditioned in fp32:
that distance is 2.7% at one torch thread); val's mAP (box and pose) at
1e-6, its precision and recall at 1e-5 (interpolated at a confidence,
they follow the scores' last bits); predict's boxes at 1e-3.

Two faults of the JAX package, shown here: its pose predict hands the
(n, 17, 3) keypoints to `Results(masks=...)`, so `Results.plot` paints
them as masks (the port's pose `Results` carry no masks); and its
`TAMTR.info` reads the Pose row's kpt_shape as a text width and raises.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tamtr_torch.engine.model import Engine, normalized_pred
from tamtr_torch.losses.v8_pose_loss import OKS_SIGMA, V8PoseLossConfig, v8_pose_loss
from tamtr_torch.nn.graph import TAMTRModel as PortModel
from tamtr_torch.train import trainer as ptrain
from tamtr_torch.weights import from_jax_variables, init_parameters

from torch_engine_data import (NAMES, NC, calibrate_yolo_head, flax_variables_of, one_thread,  # noqa: F401
                               relabel_for_task, spread_detect_model, yolo_task_cfg)

IMG = 64
SHAPES = [(64, 64), (48, 64), (64, 48), (40, 64), (64, 40), (56, 64)]


@pytest.fixture(scope="module")
def pose(tmp_path_factory):
    """(config path, JAX model, params, batch_stats, port model), as
    `tests/test_torch_segment.py:seg` builds them for a Pose head."""
    from tamtr_tpu.nn.graph import TAMTRModel

    path = tmp_path_factory.mktemp("pose_cfg") / "yolo-pose-narrow.json"
    path.write_text(json.dumps(yolo_task_cfg("Pose")))
    port = PortModel.from_cfg(path, nc=NC)
    init_parameters(port, 0)
    spread_detect_model(port)
    calibrate_yolo_head(port, torch.from_numpy(np.random.default_rng(0).random((4, IMG, IMG, 3), dtype=np.float32)))
    params, bs = flax_variables_of(port)
    return path, TAMTRModel.from_yaml(path, nc=NC), params, bs, port.eval()


# ---------------------------------------------------------------------------
# The head
# ---------------------------------------------------------------------------


def test_pose_eval_matches_jax(pose):
    """The narrow Pose model's eval against JAX's on its weights: the bridge
    leaves nothing out, pred and keypoints over the input size (xy; the
    visibility a sigmoid), kpt_raw and the raw head outputs at 1e-3."""
    path, jm, params, bs, port = pose
    sd, report = from_jax_variables(params, bs, PortModel.from_cfg(path, nc=NC))
    assert not any(report.values()), report
    assert port.model[-1].kpt_shape == (17, 3)
    img = np.random.default_rng(2).random((2, IMG, IMG, 3), dtype=np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, jnp.zeros((2, NC, 512)), None, False))(
        {"params": params, "batch_stats": bs}, img)
    with torch.no_grad():
        got = port(torch.from_numpy(img), torch.zeros(2, NC, 512))
    norm = lambda p: np.asarray(p) / np.array([IMG] * 4 + [1] * NC)  # noqa: E731
    np.testing.assert_allclose(norm(got["pred"].numpy()), norm(want["pred"]), atol=1e-3, rtol=1e-3)
    assert got["keypoints"].shape == (2, 84, 17, 3) and got["keypoints"].dtype == torch.float32
    kn = lambda k: np.asarray(k) / np.array([IMG, IMG, 1])  # noqa: E731
    np.testing.assert_allclose(kn(got["keypoints"].numpy()), kn(want["keypoints"]), atol=1e-3, rtol=1e-3)
    for k in ("kpt_raw", "distri", "scores"):
        assert np.asarray(want[k]).std() > 0.1, k  # the calibrated head's outputs vary
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-3, rtol=1e-3, err_msg=k)


def test_fuse_half_and_info_of_a_pose_model(pose):
    """fuse=True folds every ConvBN of the Pose head (1e-4 against the
    unfused forward), half=True computes in bf16 with fp32 pred within
    2e-2 (over the input size) and keypoints within 2% of the fp32 ones'
    norm; `TAMTR.info` of
    `yolo-pose-gelan.yaml` counts the variables JAX's model holds
    (`jax.eval_shape` of its init), where JAX's own `info` raises."""
    from tamtr_tpu.api import TAMTR as JaxTAMTR
    from tamtr_tpu.nn.graph import TAMTRModel

    from tamtr_torch.api import TAMTR, variable_count
    from tamtr_torch.config import get_cfg
    from tamtr_torch.nn.layers import BatchNorm2d

    port = pose[4]
    eng = Engine(str(pose[0]), device="cpu")
    fused = eng._eval_model(port, get_cfg(overrides=dict(fuse=True)))
    assert not any(isinstance(m, BatchNorm2d) for m in fused.modules())
    img = torch.from_numpy(np.random.default_rng(5).random((2, IMG, IMG, 3), dtype=np.float32))
    txt = torch.zeros(1, NC, 512)
    with torch.no_grad():
        want = port(img, txt)
        got = fused(img, txt)
        torch.testing.assert_close(got["keypoints"] / IMG, want["keypoints"] / IMG, atol=1e-4, rtol=1e-4)
        ref = normalized_pred(port, want["pred"], (IMG, IMG))
        torch.testing.assert_close(normalized_pred(fused, got["pred"], (IMG, IMG)), ref, atol=1e-4, rtol=1e-4)
        half = eng._eval_model(port, get_cfg(overrides=dict(half=True)))
        out = half(img, txt)
        assert half.dtype == torch.bfloat16 and out["keypoints"].dtype == out["pred"].dtype == torch.float32
        torch.testing.assert_close(normalized_pred(half, out["pred"], (IMG, IMG)), ref, atol=2e-2, rtol=2e-2)
        k32, k16 = want["keypoints"], out["keypoints"]  # bf16 rounding: within 2% of the fp32 tensor's norm
        assert float((k16 - k32).norm() / k32.norm()) < 2e-2
    jm = TAMTRModel.from_yaml("yolo-pose-gelan.yaml", nc=5)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, IMG, IMG, 3)),
                                            jnp.zeros((1, 5, 512)), None, False))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert variable_count(PortModel.from_cfg("yolo-pose-gelan.yaml", nc=5)) == n_jax
    summary = TAMTR("yolo-pose-gelan.yaml", device="cpu").info(nc=5)
    assert summary == f"TAMTR(yolo-pose-gelan.yaml): 23 layers, {n_jax / 1e6:.1f}M params"
    with pytest.raises(TypeError):
        JaxTAMTR("yolo-pose-gelan.yaml").info(nc=5)


# ---------------------------------------------------------------------------
# The loss
# ---------------------------------------------------------------------------


def _head_outputs(seed, B=2):
    from tamtr_torch.nn.yolo_head import make_anchors

    rng = np.random.default_rng(seed)
    pts, strs = make_anchors([(8, 8), (4, 4), (2, 2)], (8, 16, 32))
    A = len(pts)
    bias = np.tile(-2.0 * np.abs(np.arange(16) - 1.5), 4)
    return {"distri": (rng.standard_normal((B, A, 64)) + bias).astype(np.float32),
            "scores": rng.standard_normal((B, A, NC)).astype(np.float32),
            "kpt_raw": (rng.standard_normal((B, A, 51)) * 0.5).astype(np.float32), "anchors": pts, "strides": strs}


def _pose_targets(seed, B=2, M=8, counts=(6, 3)):
    """Padded targets with 17 keypoints in each gt box, in pixels, about a
    fifth of them invisible."""
    rng = np.random.default_rng(seed)
    mask = np.arange(M)[None] < np.array(counts)[:, None]
    bb = np.concatenate([rng.uniform(0.25, 0.75, (B, M, 2)), rng.uniform(0.15, 0.45, (B, M, 2))], -1) * mask[..., None]
    xy = (bb[:, :, None, :2] + bb[:, :, None, 2:] * rng.uniform(-0.5, 0.5, (B, M, 17, 2))) * IMG
    vis = np.where(rng.random((B, M, 17, 1)) < 0.2, 0.0, 2.0)
    return {"cls": rng.integers(0, NC, (B, M)).astype(np.int32), "bboxes": bb.astype(np.float32), "mask": mask,
            "keypoints": (np.concatenate([xy, vis], -1) * mask[..., None, None]).astype(np.float32)}


def test_pose_loss_and_gradient_match_jax():
    """`v8_pose_loss` on fixed head outputs: the total and box / cls / dfl /
    pose / kobj at 1e-5, and the gradients to distri, scores and kpt_raw
    at 1e-5; OKS_SIGMA equals JAX's."""
    from tamtr_tpu.losses.v8_pose_loss import OKS_SIGMA as J_SIGMA
    from tamtr_tpu.losses.v8_pose_loss import V8PoseLossConfig as JCfg
    from tamtr_tpu.losses.v8_pose_loss import v8_pose_loss as jax_loss

    np.testing.assert_array_equal(OKS_SIGMA, np.asarray(J_SIGMA))
    out, tg = _head_outputs(3), _pose_targets(4)
    keys = ("distri", "scores", "kpt_raw")

    def jl(*xs):
        return jax_loss({**dict(zip(keys, xs)), "anchors": jnp.asarray(out["anchors"]),
                         "strides": jnp.asarray(out["strides"])}, {k: jnp.asarray(v) for k, v in tg.items()},
                        JCfg(nc=NC, imgsz=IMG))

    (want, witems), jgrads = jax.value_and_grad(jl, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(out[k]) for k in keys))
    ts = {k: torch.from_numpy(out[k]).requires_grad_() for k in keys}
    po = {**ts, "anchors": torch.from_numpy(out["anchors"]), "strides": torch.from_numpy(out["strides"])}
    got, items = v8_pose_loss(po, {k: torch.from_numpy(v) for k, v in tg.items()}, V8PoseLossConfig(nc=NC, imgsz=IMG))
    got.backward()
    assert items["assign"]["fg_mask"].sum() > 5 and float(witems["pose"]) > 0 and float(witems["kobj"]) > 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for k in ("box", "cls", "dfl", "pose", "kobj"):
        np.testing.assert_allclose(items[k].item(), float(witems[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    for k, g in zip(keys, jgrads):
        np.testing.assert_allclose(ts[k].grad.numpy(), np.asarray(g), atol=1e-5, rtol=1e-5, err_msg=k)


def test_train_forward_loss_and_gradient_match_jax(pose, monkeypatch):
    """The narrow Pose model's train forward and v8 pose loss against JAX's,
    as `tests/test_torch_segment.py` holds the Segment model's; then
    `Trainer.step` reports the same loss and pose / kobj."""
    from tamtr_tpu.losses.tal import task_aligned_assigner as jax_tal
    from tamtr_tpu.losses.v8_pose_loss import V8PoseLossConfig as JCfg
    from tamtr_tpu.losses.v8_pose_loss import v8_pose_loss as jax_loss
    from tamtr_tpu.nn.yolo_head import dfl_decode, dist2bbox
    from tamtr_tpu.ops.boxes import xywh2xyxy

    _, jm, params, bs, port = pose
    rng = np.random.default_rng(11)
    batch = {"img": rng.integers(0, 256, (2, IMG, IMG, 3), dtype=np.uint8),
             "txt_feats": np.zeros((2, NC, 512), np.float32), **_pose_targets(12, counts=(8, 5))}
    jt = {k: jnp.asarray(batch[k]) for k in ("cls", "bboxes", "mask", "keypoints")}
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
    cfg = V8PoseLossConfig(nc=NC, imgsz=IMG)

    def grads(dtype, assign):
        model = copy.deepcopy(port).to(dtype).train()
        out = model(torch.from_numpy(img).to(dtype), torch.zeros(2, NC, 512, dtype=dtype))
        loss, items = v8_pose_loss(out, {k: v.to(dtype) if v.is_floating_point() else v for k, v in tg.items()}, cfg,
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
    for k in ("box", "cls", "dfl", "pose", "kobj"):
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
    monkeypatch.setattr(ptrain, "v8_pose_loss", lambda o, t, c: v8_pose_loss(o, t, c, assign=jassign))
    m = tr.step(batch)
    assert set(m) == {"loss", "box", "cls", "dfl", "pose", "kobj", "grad_norm", "stepped"}
    np.testing.assert_allclose(m["loss"], float(want), rtol=1e-4)
    for k in ("pose", "kobj"):
        np.testing.assert_allclose(m[k], float(witems[k]), rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# The engine and the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def val_split(pose, tmp_path_factory):
    """Six PNGs of mixed aspect ratios, labelled with the port model's
    top-3 square detections as pose rows: each box jittered by up to 8%,
    each detection's keypoints (in the image's pixels) moved by up to 2 px
    and a fifth of them invisible; returns (data.json, txt)."""
    from tamtr_torch.data.image_io import imwrite
    from tamtr_torch.data.imgproc import resize_linear
    from tamtr_torch.engine.model import kept_extras
    from tamtr_torch.ops.nms import postprocess_predictions

    port = pose[4]
    root = tmp_path_factory.mktemp("pose_val")
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
            kpts = kept_extras(port, out, post[4])[0].numpy()
        boxes, _, labels, valid, _ = (t.numpy() for t in post)
        n = min(3, int(valid[0].sum()))
        assert n > 0
        xyxy = (boxes[0][valid[0]][:n] * (1 + rng.uniform(-0.08, 0.08, (n, 4)))).clip(0, 1)
        rows = []
        for c, (a, b, c2, d), k in zip(labels[0][valid[0]][:n], xyxy, kpts[valid[0]][:n]):
            xy = (k[:, :2] * np.array([w / IMG, h / IMG]) + rng.uniform(-2, 2, (17, 2))) / np.array([w, h])
            vis = np.where(rng.random(17) < 0.2, 0.0, 2.0)
            kp = np.concatenate([xy.clip(0, 1), vis[:, None]], 1)
            rows.append(" ".join([str(c), f"{(a + c2) / 2:.5f} {(b + d) / 2:.5f} {c2 - a:.5f} {d - b:.5f}"]
                                 + [f"{v:.5f}" for v in kp.ravel()]))
        imwrite(root / "images" / f"{i}.png", img)
        (root / "labels" / f"{i}.txt").write_text("\n".join(rows))
    data = root / "data.json"
    data.write_text(json.dumps({"path": str(root), "train": "images", "val": "images", "nc": NC, "names": NAMES}))
    return str(data), txt


def test_val_matches_jax_engine(pose, val_split):
    """`Engine.val` of the Pose model against the JAX `Engine.val` on its
    weights: mAP50, mAP50-95, precision, recall, pose_mAP50 and
    pose_mAP50-95 (precision and recall at 1e-5) at 1e-6 (the kept rows' keypoints stretched to each
    image and matched by OKS)."""
    from tamtr_tpu.engine.checkpoint import InferenceState
    from tamtr_tpu.engine.model import Engine as JaxEngine

    path, jm, params, bs, port = pose
    data, txt = val_split
    args = dict(data=data, imgsz=IMG, batch=2, conf=0.25, workers=1, plots=False)
    eng = Engine(str(path), device="cpu")
    eng.model = port
    eng.set_classes(NAMES, txt)
    got = eng.val(**args)
    je = JaxEngine(str(path))
    je.model = jm
    je.state = InferenceState(params, bs)
    je.set_classes(NAMES, txt)
    want = je.val(**args)
    print({k: (got[k], want[k]) for k in want if k != "images_per_sec"})
    assert 0 < want["pose_mAP50"] <= 1 and 0 < want["mAP50"] <= 1
    for k in ("mAP50", "mAP50-95", "precision", "recall", "pose_mAP50", "pose_mAP50-95"):
        assert abs(got[k] - want[k]) <= (1e-5 if k in ("precision", "recall") else 1e-6), (k, got[k], want[k])


def test_predict_gives_boxes_and_no_masks(pose, val_split):
    """`Engine.predict` of the Pose model: boxes equal to the JAX engine's
    at 1e-3 and no masks. The JAX engine hands each image's (n, 17, 3)
    keypoints to `Results(masks=...)` (`tamtr_tpu/engine/model.py:1031,
    1060`): its `masks` hold keypoints, a fault the port does not copy."""
    from pathlib import Path

    from tamtr_tpu.engine.checkpoint import InferenceState
    from tamtr_tpu.engine.model import Engine as JaxEngine

    path, jm, params, bs, port = pose
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
        assert len(g) == len(w) > 0 and g.masks is None
        np.testing.assert_allclose(g.boxes.xyxy, w.boxes.xyxy, atol=1e-3 * IMG)
        assert w.masks.shape == (len(w), 17, 3)  # JAX's fault: keypoints as masks


def test_cli_pose_train_val_predict(tmp_path, capsys):
    """`python -m tamtr_torch pose train` of the narrow Pose config for one
    epoch on a generated keypoint dataset, then `pose val` and `pose
    predict` from its `best.pt`, which reloads with its head."""
    from tamtr_torch import cli
    from tamtr_torch.api import TAMTR
    from tools.smoke_train_torch import make_dataset

    cfg = tmp_path / "pose.json"
    cfg.write_text(json.dumps(yolo_task_cfg("Pose")))
    data = relabel_for_task(make_dataset(tmp_path / "ds", 4, 2, IMG), "pose")
    cli.main(["pose", "train", f"model={cfg}", f"data={data}", "imgsz=64", "epochs=1", "batch=2", "workers=0",
              "plots=False", "device=cpu", "max_gt=8", "conf=0.01", f"project={tmp_path / 'runs'}", "name=r"])
    best = tmp_path / "runs" / "r" / "weights" / "best.pt"
    capsys.readouterr()
    cli.main(["pose", "val", f"model={best}", f"data={data}", "imgsz=64", "batch=2", "workers=0", "plots=False",
              "device=cpu", "conf=0.01"])
    assert "pose_mAP50-95" in capsys.readouterr().out
    cli.main(["pose", "predict", f"model={best}", f"source={tmp_path / 'ds' / 'val' / 'images'}", "imgsz=64",
              "device=cpu", "conf=0.0"])
    assert capsys.readouterr().out.count("detections") == 2
    loaded = TAMTR("yolo-pose-gelan.yaml", device="cpu", imgsz=IMG).load(best)
    assert loaded._engine.model.head_type == "Pose"
