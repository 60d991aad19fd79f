"""The YOLO Detect family's training step, engine, loader and two gloo
ranks (`tamtr_torch/nn/yolo_head.py`, `losses/v8_loss.py`, `engine/model.py`)
against the JAX package on the CPU, one torch thread, on `yolo-gelan.yaml`'s
wiring at an eighth of the widths (`torch_engine_data.py:yolo_narrow_cfg`,
nc 3): the bounds and the model's preparation of `test_torch_yolo.py`,
whose helpers these tests share (apart from it so that `--dist loadfile`
runs the two files on two workers).
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tamtr_torch.engine.model import Engine, normalized_pred
from tamtr_torch.losses.v8_loss import V8LossConfig, v8_detection_loss
from tamtr_torch.train import trainer as ptrain
from tamtr_torch.weights import from_jax_variables

from torch_engine_data import (NAMES, NC, calibrated_head, jax_variables, one_thread,  # noqa: F401
                               spread_detect_params, write_yolo_narrow)

from test_torch_yolo import IMG, _bridge, _targets  # noqa: E402


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    """The narrow config at nc NC: (config path, JAX model, params,
    batch_stats, port model), the heads spread; training normalises with
    each batch's statistics, so the step takes these."""
    from tamtr_tpu.nn.graph import TAMTRModel

    path = write_yolo_narrow(tmp_path_factory.mktemp("yolo_cfg"))
    jm = TAMTRModel.from_yaml(path, nc=NC)
    params, bs = jax_variables(jm, IMG, NC)
    params = spread_detect_params(params)
    return path, jm, params, bs, _bridge(path, params, bs, NC)


@pytest.fixture(scope="module")
def narrow_eval(narrow):
    """`narrow` with its head calibrated for eval (`calibrated_head`)."""
    path, jm, params, bs, _ = narrow
    params, bs = calibrated_head(jm, params, bs, IMG)
    return path, jm, params, bs, _bridge(path, params, bs, NC)


# ---------------------------------------------------------------------------
# The training step
# ---------------------------------------------------------------------------


def _step_batch(B=2, M=8):
    rng = np.random.default_rng(11)
    tg = _targets(12, B, M, counts=(8, 5))
    return {"img": rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8),
            "txt_feats": np.zeros((B, NC, 512), np.float32), **tg}


def _jax_assignment(jm, params, bs, batch):
    """JAX's train-mode forward and, on it, JAX's TAL as its v8 loss runs
    it: the assignment as numpy."""
    from tamtr_tpu.losses.tal import task_aligned_assigner as jax_tal
    from tamtr_tpu.nn.yolo_head import dfl_decode, dist2bbox
    from tamtr_tpu.ops.boxes import xywh2xyxy

    def assign(p, b, img, cls, bboxes, mask):
        out, _ = jm.apply({"params": p, "batch_stats": b}, img, jnp.zeros((img.shape[0], NC, 512)),
                          {"cls": cls, "bboxes": bboxes, "mask": mask}, True, mutable=["batch_stats"])
        pred = dist2bbox(dfl_decode(out["distri"].astype(jnp.float32)), out["anchors"][None], xywh=False)
        return jax_tal(jax.nn.sigmoid(out["scores"].astype(jnp.float32)), pred * out["strides"][None],
                       out["anchors"] * out["strides"], cls, xywh2xyxy(bboxes) * IMG, mask)

    res = jax.jit(assign)(params, bs, batch["img"].astype(np.float32) / 255.0, batch["cls"], batch["bboxes"],
                          batch["mask"])
    return {k: torch.from_numpy(np.asarray(v)) for k, v in res.items()}


def _run_jax_step(jm, params, bs, batch):
    from tamtr_tpu.config import get_cfg as jax_get_cfg
    from tamtr_tpu.engine.model import Engine as JaxEngine
    from tamtr_tpu.train import trainer as jtrain

    cfg = jtrain.TrainConfig(batch_size=len(batch["img"]), warmup_iters=10, epochs=2)
    tx = jtrain.make_optimizer(cfg, params, steps_per_epoch=10)
    p_flat = jtrain.flatten_tree(params)
    state = jtrain.TrainState(
        step=jnp.zeros((), jnp.int32), params=p_flat, batch_stats=bs, opt_state=tx.init(params),
        ema_params=jnp.copy(p_flat), ema_batch_stats=jax.tree.map(jnp.copy, bs), unravel=jtrain.unravel_for(params))
    loss = JaxEngine._loss_callable_for(jm, jax_get_cfg(overrides=dict(imgsz=IMG)), NC)
    new, metrics = jax.jit(jtrain.make_train_step(jm, tx, None, cfg, loss_callable=loss))(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    gnorm = float(metrics["grad_norm"])
    coef = min(1.0, cfg.grad_clip / max(gnorm, 1e-6))
    unravel = jax.jit(state.unravel)
    to_np = lambda t: {k: to_np(x) if hasattr(x, "items") else np.array(x) for k, x in t.items()}  # noqa: E731
    tree = lambda flat: to_np(unravel(jnp.asarray(flat)))  # noqa: E731
    grads = tree(np.asarray(new.opt_state.m) / ((1.0 - cfg.momentum) * coef))
    return cfg, {k: float(v) for k, v in metrics.items()}, grads, tree(new.params), to_np(new.batch_stats), \
        tree(new.ema_params)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_train_step_matches_jax_step(narrow, monkeypatch):
    """One `Trainer.step` of the narrow Detect model against JAX's
    `make_train_step` with `Engine._loss_callable_for`'s v8 loss.

    TAL's top-k and its claims are discrete: the port's own assignment on
    its own forward may differ from JAX's only at near-ties (counted and
    printed; at most 1% of the foreground). The gradients and the step are
    then taken with JAX's assignment (`assign=`), against
    `tests/test_torch_train.py`'s bounds: the whole gradient within 2% of
    JAX's, the port's fp64 pass too, the port's own fp32 floor within 1.5%,
    each tensor within 7.5%; after the step the loss at 1e-4, the gradient
    norm at 1e-2, at most 1% of the moved parameter entries off JAX's step
    by more than 2% of it, the BatchNorm statistics at 1e-4."""
    _, jm, params, bs, port = narrow
    batch = _step_batch()
    jcfg, metrics, jgrads, jparams, jstats, jema = _run_jax_step(jm, params, bs, batch)
    jassign = _jax_assignment(jm, params, bs, batch)
    tg = {k: torch.from_numpy(batch[k]) for k in ("cls", "bboxes", "mask")}
    loss_cfg = V8LossConfig(nc=NC, imgsz=IMG)

    def grads(dtype, assign):
        model = copy.deepcopy(port).to(dtype).train()
        out = model(torch.from_numpy(batch["img"]).to(dtype) / 255.0, torch.from_numpy(batch["txt_feats"]).to(dtype))
        loss, items = v8_detection_loss(out, {**tg, "bboxes": tg["bboxes"].to(dtype)}, loss_cfg, assign=assign)
        loss.backward()
        return loss.item(), items, {k: p.grad.double().numpy() for k, p in model.named_parameters()}

    _, own, _ = grads(torch.float32, None)
    fg, jfg = own["assign"]["fg_mask"], jassign["fg_mask"]
    moved = int((fg != jfg).sum() + ((own["assign"]["target_gt"] != jassign["target_gt"]) & fg & jfg).sum())
    print(f"TAL anchors that differ from JAX's: {moved} of {int(jfg.sum())} foreground")
    assert jfg.sum() > 20 and moved <= 0.01 * int(jfg.sum())
    loss32, items32, g32 = grads(torch.float32, jassign)
    _, _, g64 = grads(torch.float64, jassign)
    np.testing.assert_allclose(loss32, metrics["loss"], rtol=1e-4)
    for k in ("box", "cls", "dfl"):
        np.testing.assert_allclose(items32[k].item(), metrics[k], rtol=1e-4, err_msg=k)
    gsd, _ = from_jax_variables(jgrads, bs, port)
    gj = {k: gsd[k].double().numpy() for k in g32}
    whole = lambda g: np.concatenate([v.ravel() for v in g.values()])  # noqa: E731
    readings = [_rel(whole(g32), whole(gj)), _rel(whole(g64), whole(gj)), _rel(whole(g32), whole(g64))]
    top = max(np.linalg.norm(g) for g in gj.values())
    per_tensor = {k: _rel(g, gj[k]) for k, g in g32.items() if np.linalg.norm(gj[k]) > 1e-6 * top}
    print(f"gradient |port - jax|, |port fp64 - jax|, |port fp32 - fp64| (relative): {readings}; "
          f"worst tensor {max(per_tensor.items(), key=lambda kv: kv[1])}")
    assert readings[0] < 2e-2 and readings[1] < 2e-2 and readings[2] < 1.5e-2, readings
    assert all(e < 7.5e-2 for e in per_tensor.values()), per_tensor

    before = {k: p.detach().clone().numpy() for k, p in port.named_parameters()}
    model = copy.deepcopy(port)
    tr = ptrain.Trainer(model, ptrain.TrainConfig(batch_size=jcfg.batch_size, warmup_iters=jcfg.warmup_iters,
                                                  epochs=jcfg.epochs),
                        loss_cfg=ptrain.loss_config_for(model, imgsz=IMG), steps_per_epoch=10, device="cpu")
    assert tr.loss_cfg == loss_cfg
    monkeypatch.setattr(ptrain, "v8_detection_loss", lambda o, t, c: v8_detection_loss(o, t, c, assign=jassign))
    m = tr.step(batch)
    assert m["stepped"] == 1.0 and set(m) == {"loss", "box", "cls", "dfl", "grad_norm", "stepped"}
    np.testing.assert_allclose(m["loss"], metrics["loss"], rtol=1e-4)
    np.testing.assert_allclose(m["grad_norm"], metrics["grad_norm"], rtol=1e-2)
    psd, _ = from_jax_variables(jparams, jstats, model)
    esd, _ = from_jax_variables(jema, jstats, model)
    ema = tr.ema.state_dict()
    flips = moved = 0
    for k, p in model.named_parameters():
        g = gsd[k].numpy()
        live = np.abs(g) > 1e-3 * np.abs(g).max() if np.linalg.norm(g) > 1e-6 * top else np.zeros(g.shape, bool)
        for mine, theirs in ((p.detach().numpy(), psd[k].numpy()), (ema[k].numpy(), esd[k].numpy())):
            step = np.abs(theirs - before[k])
            flips += int((live & (np.abs(mine - theirs) > 1e-6 + 0.02 * step)).sum())
            moved += int((live & (step > 0)).sum())
    assert moved > 0 and flips <= 0.01 * moved, (flips, moved)
    for k, v in model.state_dict().items():
        if "running_" in k:
            np.testing.assert_allclose(v.numpy(), psd[k].numpy(), atol=1e-4, rtol=1e-4, err_msg=k)


def test_two_gloo_ranks_equal_one_process(tmp_path):
    """The narrow Detect model's step on 2 data ranks of 2 images against
    one process on the 4 (the `yolo` case of `tests/torch_parallel_worker.py`):
    the loss and box / cls / dfl at 1e-5 relative (sum(target_scores) and
    the batch size are the global batch's), the parameters after the step
    within twice the one-versus-three-thread floor, as
    `tests/test_torch_parallel.py` holds the nano step."""
    from test_torch_parallel import distance, run_ranks

    ranks = run_ranks(tmp_path, "yolo")
    one, one_model = ranks[0]["one"]
    floor = distance(ranks[0]["floor"][1], one_model)
    for r in ranks:
        got, model = r["dp"]
        for k, v in one.items():
            assert abs(got[k] - v) <= 1e-5 * abs(v), (k, got[k], v)
        d = distance(model, one_model)
        assert d[0] <= 2 * max(floor[0], 1e-4) and d[1] <= 2 * max(floor[1], 1e-4), (d, floor)
    assert all(torch.equal(ranks[0]["dp"][1][k], ranks[1]["dp"][1][k]) for k in one_model)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

SHAPES = [(64, 64), (48, 64), (64, 48), (40, 64), (64, 40), (56, 64)]


@pytest.fixture(scope="module")
def val_split(narrow_eval, tmp_path_factory):
    """Six PNGs of mixed aspect ratios, labelled with the narrow port
    model's top-3 square detections, jittered by up to 8%; the 512-wide
    class table; returns (data.json, txt)."""
    from tamtr_torch.data.image_io import imwrite
    from tamtr_torch.data.imgproc import resize_linear
    from tamtr_torch.ops.nms import postprocess_predictions

    _, _, _, _, port = narrow_eval
    root = tmp_path_factory.mktemp("yolo_val")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(5)
    txt = rng.standard_normal((NC, 512)).astype(np.float32)
    for i, (h, w) in enumerate(SHAPES):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        x = resize_linear(img, (IMG, IMG))[..., ::-1].astype(np.float32) / 255.0
        with torch.inference_mode():
            pred = normalized_pred(port, port(torch.from_numpy(x.copy())[None], torch.from_numpy(txt[None]))["pred"],
                                   (IMG, IMG))
        boxes, _, labels, valid, _ = (t.numpy() for t in postprocess_predictions(pred, 0.25, 0.7, 300))
        n = min(3, int(valid[0].sum()))
        assert n > 0
        xyxy = (boxes[0][valid[0]][:n] * (1 + rng.uniform(-0.08, 0.08, (n, 4)))).clip(0, 1)
        imwrite(root / "images" / f"{i}.png", img)
        (root / "labels" / f"{i}.txt").write_text("\n".join(
            f"{c} {(a + c2) / 2:.5f} {(b + d) / 2:.5f} {c2 - a:.5f} {d - b:.5f}"
            for c, (a, b, c2, d) in zip(labels[0][valid[0]][:n], xyxy)))
    data = root / "data.json"
    data.write_text(json.dumps({"path": str(root), "train": "images", "val": "images", "nc": NC, "names": NAMES}))
    return str(data), txt


@pytest.mark.parametrize("rect", [False, True])
def test_val_matches_jax_engine(narrow_eval, val_split, rect, monkeypatch):
    """`Engine.val` of the Detect model on bridged weights, square and rect
    (letterboxed batches by aspect ratio, the Detect head's alone): mAP50,
    mAP50-95, precision and recall equal the JAX `Engine.val`'s within
    1e-3. JAX's rect val runs on one device only: its device count is
    given as 1 for that case."""
    from tamtr_tpu.engine.checkpoint import InferenceState
    from tamtr_tpu.engine.model import Engine as JaxEngine

    path, jm, params, bs, port = narrow_eval
    data, txt = val_split
    args = dict(data=data, imgsz=IMG, batch=2, conf=0.25, workers=1, plots=False, rect=rect)
    eng = Engine(str(path), device="cpu")
    eng.model = port
    eng.set_classes(NAMES, txt)
    got = eng.val(**args)
    je = JaxEngine(str(path))
    je.model = jm
    je.state = InferenceState(params, bs)
    je.set_classes(NAMES, txt)
    if rect:
        monkeypatch.setattr(jax, "device_count", lambda: 1)
    want = je.val(**args)
    assert 0 < want["mAP50"] < 1 and 0 < want["recall"] <= 1
    for k in ("mAP50", "mAP50-95", "precision", "recall"):
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])


class _Stop(Exception):
    pass


def test_train_loader_batches_equal_jax(narrow, tmp_path, monkeypatch):
    """`Engine.train` of a Detect model in both packages builds its training
    dataset without sampled texts (`uses_text` is False; JAX's
    `random_text=probe_model.uses_text`): the datasets each engine builds
    (captured at their loaders) give equal batches, two epochs, at
    `tests/test_torch_data.py`'s bounds (cls, mask equal, no texts, boxes at
    1e-5, images within 3 levels on at most 1% of the pixels)."""
    import tamtr_tpu.engine.model as jeng
    from tamtr_tpu.data.dataset import build_loader

    import tamtr_torch.engine.model as peng
    from tamtr_torch.data.dataset import Loader
    from tools.smoke_train_torch import make_dataset

    path = narrow[0]
    data = str(make_dataset(tmp_path / "ds", 6, 2, IMG))
    seen = {}

    def capture(name):
        def f(ds, *a, **kw):
            seen[name] = (ds, a, kw)
            raise _Stop
        return f

    monkeypatch.setattr(jeng, "build_loader", capture("jax"))
    monkeypatch.setattr(peng, "Loader", capture("port"))
    args = dict(data=data, imgsz=IMG, batch=3, max_gt=8, epochs=2, workers=0, plots=False, project=str(tmp_path))
    for name, eng in (("jax", jeng.Engine(str(path))), ("port", Engine(str(path), device="cpu"))):
        with pytest.raises(_Stop):
            eng.train(**args)
    jds, pds = seen["jax"][0], seen["port"][0]
    assert jds.random_text is False and pds.random_text is False
    jl = build_loader(jds, 3, max_gt=8, seed=0, workers=0)
    pl = Loader(pds, 3, max_gt=8, seed=0, workers=0)
    worst = []
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        n = 0
        for jb, pb in zip(jl, pl):
            n += 1
            assert "texts" not in jb and "texts" not in pb
            np.testing.assert_array_equal(pb["cls"].numpy(), jb["cls"])
            np.testing.assert_array_equal(pb["mask"].numpy(), jb["mask"])
            np.testing.assert_allclose(pb["bboxes"].numpy(), jb["bboxes"], rtol=0, atol=1e-5)
            d = np.abs(pb["img"].numpy().astype(np.int64) - jb["img"])
            worst.append((int(d.max()), float((d > 1).mean())))
        assert n == 2
    assert max(w[0] for w in worst) <= 3 and max(w[1] for w in worst) <= 0.01, worst


def test_engine_and_cli_run_a_detect_model(narrow, narrow_eval, val_split, tmp_path):
    """The user's paths with a Detect model, on the CPU: `TAMTR.train` (one
    epoch: finite v8 items in the log row), `val` square and rect, `predict`
    with and without TTA and with fuse and half, `track`, `load` of the
    checkpoint; then the CLI: `python -m tamtr_torch detect train
    model=yolo-gelan.yaml` for one epoch and `predict` from its `best.pt`."""
    import csv

    from tamtr_torch import cli
    from tamtr_torch.api import TAMTR
    from tools.smoke_train_torch import make_dataset

    path = narrow[0]
    data = str(make_dataset(tmp_path / "ds", 4, 2, IMG))
    det = TAMTR(str(path), device="cpu", imgsz=IMG, max_gt=8)
    det.train(data=data, epochs=1, batch=2, workers=0, warmup_epochs=2, plots=False, conf=0.01,
              project=str(tmp_path / "runs"), name="y")
    row = next(csv.DictReader(open(tmp_path / "runs" / "y" / "results.csv")))
    assert all(np.isfinite(float(row[k])) for k in ("loss", "box", "cls", "dfl")) and "giou" not in row
    src = str(tmp_path / "ds" / "val" / "images")
    for rect in (False, True):
        m = det.val(data=data, batch=2, workers=0, plots=False, conf=0.01, rect=rect)
        assert 0.0 <= m["mAP50"] <= 1.0
    for kw in ({}, dict(augment=True), dict(fuse=True), dict(half=True)):
        res = det.predict(src, conf=0.0, **kw)
        assert len(res) == 2 and all(len(r) > 0 for r in res), kw
        for r in res:
            assert np.isfinite(r.boxes.xyxy).all()  # not clipped to the image, as JAX's
    tracker = TAMTR(str(path), nc=NC, device="cpu", imgsz=IMG)
    tracker._lazy_engine().model = narrow_eval[4]  # the calibrated head's confident boxes start tracks
    tracker.set_classes(NAMES, val_split[1])
    tracked = tracker.track(src)
    assert len(tracked) == 2 and len(tracked[0].track_ids) > 0
    loaded = TAMTR(str(path), device="cpu", imgsz=IMG).load(tmp_path / "runs" / "y" / "weights" / "last.pt")
    assert loaded._engine.model.head_type == "Detect" and len(loaded.predict(src, conf=0.0)) == 2

    cli.main(["detect", "train", "model=yolo-gelan.yaml", f"data={data}", "imgsz=64", "epochs=1", "batch=2",
              "workers=0", "plots=False", "device=cpu", "max_gt=8", f"project={tmp_path / 'cli'}", "name=r"])
    best = tmp_path / "cli" / "r" / "weights" / "best.pt"
    cli.main(["detect", "predict", f"model={best}", f"source={src}", "device=cpu", "imgsz=64", "conf=0.0"])
