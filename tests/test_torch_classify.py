"""The Classify family of the port (`tamtr_torch/nn/yolo_head.py:Classify`,
`data/dataset.py:ClassificationDataset, ClassificationLoader`, the
cross-entropy step of `train/trainer.py`, the classify task of the engine
and the CLI) against the JAX package on the CPU, one torch thread.

The model is `classify-gelan.yaml`'s wiring at an eighth of its widths
(`torch_engine_data.py:classify_narrow_cfg`, nc 3) at 64 px (32 px in the
engine). Its weights are the port's seeded ones with every BatchNorm
holding the moments of four random images (`calibrate_bn`: at init the
logits would be the Dense biases alone), handed to the JAX model as flax
variables (`flax_variables_of`): no JAX init is compiled. The datasets are
ImageFolders of PNG and JPEG files written by the port's encoders
(`write_image_folder`).

Bounds: the head alone at 1e-5, the whole model's logits at 1e-4; one
`Trainer.step` against JAX's `make_train_step(loss_callable=ce_loss)`:
the loss at rtol 1e-4, the gradient within 1e-2 of JAX's (relative, the
whole vector); the dataset's images and the loader's batches bitwise
(both resize as cv2); val's top-1 and top-5 equal; predict's probs at 1e-5.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tamtr_torch.data.dataset import ClassificationDataset, ClassificationLoader
from tamtr_torch.engine.model import Engine
from tamtr_torch.nn.graph import TAMTRModel as PortModel
from tamtr_torch.train import trainer as ptrain
from tamtr_torch.weights import from_jax_variables, init_parameters

from torch_engine_data import (NC, calibrate_bn, classify_narrow_cfg, flax_variables_of, one_thread,  # noqa: F401
                               write_image_folder)

IMG = 64
B = 4


def _images(seed, n=B, size=IMG):
    return np.random.default_rng(seed).random((n, size, size, 3), dtype=np.float32)


@pytest.fixture(scope="module")
def cls(tmp_path_factory):
    """(config path, JAX model, params, batch_stats, port model)."""
    from tamtr_tpu.nn.graph import TAMTRModel

    path = tmp_path_factory.mktemp("cls_cfg") / "classify-narrow.json"
    path.write_text(json.dumps(classify_narrow_cfg()))
    port = PortModel.from_cfg(path, nc=NC)
    init_parameters(port, 0)
    calibrate_bn(port, torch.from_numpy(_images(0)))
    params, bs = flax_variables_of(port)
    return path, TAMTRModel.from_yaml(path, nc=NC), params, bs, port


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return write_image_folder(tmp_path_factory.mktemp("imagefolder"))


def test_classify_head_matches_jax(cls):
    """`Classify` alone on a random (2, 8, 8, 64) map, at 1e-5."""
    from tamtr_tpu.nn.yolo_head import Classify as JClassify

    _, _, params, bs, port = cls
    x = np.random.default_rng(1).standard_normal((2, 8, 8, 64)).astype(np.float32)
    want = JClassify(nc=NC).apply({"params": params["head"], "batch_stats": bs["head"]}, [jnp.asarray(x)], False)
    head = port.model[-1]
    assert head.linear.in_features == 1280
    with torch.no_grad():
        got = head([torch.from_numpy(x).permute(0, 3, 1, 2)])
    for k in ("logits", "pred"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=1e-5, err_msg=k)


def test_classify_model_matches_jax(cls):
    """The whole narrow model's eval logits and softmax at 1e-4, on images
    other than the calibration's; its head type, text use and a bf16 twin
    whose Dense still runs in fp32."""
    _, jm, params, bs, port = cls
    x = _images(2)
    want = jm.apply({"params": params, "batch_stats": bs}, x, jnp.zeros((B, 1, 512)), None, False)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x), torch.zeros(B, 1, 512))
        half = port.with_dtype(torch.bfloat16)(torch.from_numpy(x), torch.zeros(B, 1, 512))
    assert (port.head_type, port.uses_text, port.text_width) == ("Classify", False, 512)
    assert np.asarray(want["logits"]).std() > 0.1  # logits that vary with the image
    for k in ("logits", "pred"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, rtol=1e-4, err_msg=k)
    assert half["logits"].dtype == torch.float32 and torch.isfinite(half["logits"]).all()
    np.testing.assert_allclose(half["pred"].sum(-1).numpy(), 1.0, atol=1e-6)


def _ce_loss(outputs, targets):
    """The JAX engine's `ce_loss` (`tamtr_tpu/engine/model.py:475-482`)."""
    import optax

    labels = targets["cls"][:, 0]
    loss = optax.softmax_cross_entropy_with_integer_labels(outputs["logits"], labels).mean()
    acc = (outputs["logits"].argmax(-1) == labels).mean()
    return loss, {"cls": loss, "top1": acc}


def _step_batch():
    rng = np.random.default_rng(3)
    return {"img": _images(3), "txt_feats": np.zeros((B, 1, 512), np.float32),
            "cls": rng.integers(0, NC, (B, 1)).astype(np.int32), "bboxes": np.zeros((B, 1, 4), np.float32),
            "mask": np.zeros((B, 1), bool)}


def test_ce_step_matches_make_train_step(cls):
    """One `Trainer.step` with the head's loss (`loss_config_for`: the
    cross-entropy) against JAX's `make_train_step(loss_callable=ce_loss)`
    on the same weights and batch (train-mode BatchNorm): loss and cls at
    rtol 1e-4; each step's gradient read back from its first Adam
    moment (m = (1 - b1) g clip), within 1e-2 of JAX's as a whole; the
    BatchNorm statistics after the step at 1e-4."""
    from tamtr_tpu.train import trainer as jtrain

    _, jm, params, bs, port = cls
    batch = _step_batch()
    cfg = jtrain.TrainConfig(batch_size=B, warmup_iters=10, epochs=2)
    tx = jtrain.make_optimizer(cfg, params, steps_per_epoch=10)
    p_flat = jtrain.flatten_tree(params)
    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=p_flat, batch_stats=bs,
                              opt_state=tx.init(params), ema_params=jnp.copy(p_flat),
                              ema_batch_stats=jax.tree.map(jnp.copy, bs), unravel=jtrain.unravel_for(params))
    step = jax.jit(jtrain.make_train_step(jm, tx, None, cfg, loss_callable=_ce_loss))
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    coef = min(1.0, cfg.grad_clip / max(float(metrics["grad_norm"]), 1e-6))
    jgrads = jax.device_get(new.unravel(np.asarray(new.opt_state.m) / ((1.0 - cfg.momentum) * coef)))
    jstats = jax.device_get(new.batch_stats)

    model = copy.deepcopy(port)
    loss_cfg = ptrain.loss_config_for(model)
    assert isinstance(loss_cfg, ptrain.CELossConfig)
    tr = ptrain.Trainer(model, ptrain.TrainConfig(batch_size=B, warmup_iters=10, epochs=2), loss_cfg=loss_cfg,
                        steps_per_epoch=10, device="cpu")
    m = tr.step(batch)
    for k in ("loss", "cls"):
        np.testing.assert_allclose(m[k], float(metrics[k]), rtol=1e-4, err_msg=k)
    assert m["top1"] * B in range(B + 1)  # JAX's step reports no top1: a share of the batch
    pcoef = min(1.0, 10.0 / max(m["grad_norm"], 1e-6))
    got = {n: tr.optimizer.state[p]["exp_avg"].double().numpy() / ((1.0 - 0.937) * pcoef)
           for n, p in tr.model.named_parameters()}
    want_sd, report = from_jax_variables(jgrads, bs, port)
    assert not any(report.values()), report
    g = np.concatenate([got[n].ravel() for n in got])
    w = np.concatenate([want_sd[n].double().numpy().ravel() for n in got])
    rel = np.linalg.norm(g - w) / np.linalg.norm(w)
    print(f"CE step: loss {m['loss']} (JAX {float(metrics['loss'])}); gradient |port - JAX| / |JAX| {rel}")
    assert rel < 1e-2 and np.linalg.norm(w) > 0
    stats_sd, _ = from_jax_variables(params, jstats, port)
    for k, v in tr.model.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), stats_sd[k].numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


def test_classification_dataset_and_loader_match_jax(folder):
    """`ClassificationDataset.get` with and without augmentation and the
    loader's batches of two epochs, on two process shards, bitwise JAX's;
    the class names and samples equal. A class folder of TIFF and WebP
    images gives JAX's samples too."""
    from tamtr_tpu.data.dataset import ClassificationDataset as JDataset
    from tamtr_tpu.data.dataset import ClassificationLoader as JLoader

    for augment in (True, False):
        jd, pd = JDataset(folder / "train", imgsz=32, augment=augment), \
            ClassificationDataset(folder / "train", imgsz=32, augment=augment)
        assert pd.names == jd.names and pd.samples == jd.samples
        for i in range(len(pd)):
            a, la = jd.get(i, np.random.default_rng(i))
            b, lb = pd.get(i, np.random.default_rng(i))
            assert la == lb and a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    jd, pd = JDataset(folder / "train", imgsz=32, augment=True, seed=3), \
        ClassificationDataset(folder / "train", imgsz=32, augment=True, seed=3)
    for pi in (0, 1):
        jl, pl = JLoader(jd, 3, seed=3, process_index=pi, process_count=2), \
            ClassificationLoader(pd, 3, seed=3, process_index=pi, process_count=2)
        assert len(jl) == len(pl) > 0
        for epoch in (0, 1):
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
            got, want = list(pl), list(jl)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                for k in ("img", "cls"):
                    np.testing.assert_array_equal(g[k], w[k])
    import cv2

    other = folder.parent / "tif_webp" / "a"
    other.mkdir(parents=True)
    rng = np.random.default_rng(5)
    for name in ("x.tif", "y.webp", "z.tiff"):
        cv2.imwrite(str(other / name), rng.integers(0, 256, (40, 52, 3), np.uint8))
    jd, pd = JDataset(other.parent, imgsz=32, augment=False), \
        ClassificationDataset(other.parent, imgsz=32, augment=False)
    assert pd.samples == jd.samples and len(pd) == 3
    for i in range(3):
        np.testing.assert_array_equal(pd.get(i, np.random.default_rng(i))[0], jd.get(i, np.random.default_rng(i))[0])


class _IndexDataset:
    """A dataset whose image is its index: enough to follow the loader."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get(self, i, rng=None):
        return np.full((1, 1, 3), i, np.float32), i % 3


@pytest.mark.parametrize("n,bs,drop_last", [(11, 2, True), (11, 2, False), (13, 3, True), (7, 4, False)])
def test_classification_loader_uneven_shards_yield_equal_batch_counts(n, bs, drop_last):
    """On two process shards of uneven length every process yields
    `len(loader)` batches, so a training step's collectives pair up
    (11 images, batch 2: JAX's first shard takes 3 batches, its second
    2). The batches are the first of JAX's on the same shard, bitwise."""
    from tamtr_tpu.data.dataset import ClassificationLoader as JLoader

    ds = _IndexDataset(n)
    counts = []
    for pi in (0, 1):
        pl = ClassificationLoader(ds, bs, seed=5, drop_last=drop_last, process_index=pi, process_count=2)
        jl = JLoader(ds, bs, seed=5, drop_last=drop_last, process_index=pi, process_count=2)
        got, want = list(pl), list(jl)
        assert len(got) == len(pl) <= len(want)
        for g, w in zip(got, want):
            for k in ("img", "cls"):
                np.testing.assert_array_equal(g[k], w[k])
        counts.append(len(got))
    assert counts[0] == counts[1] > 0


def _jax_engine(cls_fixture, names):
    from tamtr_tpu.engine.model import Engine as JEngine
    from tamtr_tpu.train import trainer as jtrain

    path, jm, params, bs, _ = cls_fixture
    eng = JEngine(str(path))
    p_flat = jtrain.flatten_tree(params)
    eng.model, eng.names = jm, list(names)
    eng.state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=p_flat, batch_stats=bs, opt_state=None,
                                  ema_params=p_flat, ema_batch_stats=bs, unravel=jtrain.unravel_for(params))
    return eng


def _port_engine(cls_fixture, names):
    path, _, _, _, port = cls_fixture
    eng = Engine(str(path), device="cpu")
    eng.model, eng.names = port.eval(), list(names)
    return eng


def test_val_top1_top5_equal_jax_engine(cls, folder):
    """`Engine.val` of a Classify model on the ImageFolder (its val/ split;
    batches of 4, the last one short) gives the JAX engine's top-1 and
    top-5 on the same weights; so does the root's test/ split when there
    is no val/."""
    names = ["blue", "green", "red"]
    want = _jax_engine(cls, names).val(data=str(folder), imgsz=32, batch=4)
    got = _port_engine(cls, names).val(data=str(folder), imgsz=32, batch=4)
    print(f"val: port {got}, JAX {want}")
    assert got == want and set(got) == {"top1", "top5"} and got["top5"] == 1.0
    assert 0.0 < got["top1"] < 1.0  # the seeded logits rank some images right, not all


def test_predict_probs_match_jax_engine(cls, folder):
    """`Engine.predict` of a Classify model on a directory and on arrays:
    one dict an image, probs at 1e-5, top5 and names equal to the JAX
    engine's."""
    names = ["blue", "green", "red"]
    arrays = [np.full((40, 50, 3), (0, 0, 220), np.uint8), np.random.default_rng(4).integers(0, 255, (33, 45, 3),
                                                                                            dtype=np.uint8)]
    for source in (str(folder / "val"), arrays):
        want = _jax_engine(cls, names).predict(source, imgsz=32)
        got = _port_engine(cls, names).predict(source, imgsz=32)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g["path"] == w["path"] and g["names"] == w["names"]
            np.testing.assert_array_equal(g["top5"], w["top5"])
            np.testing.assert_allclose(g["probs"], w["probs"], atol=1e-5)
            np.testing.assert_allclose(g["top5_conf"], w["top5_conf"], atol=1e-5)


def test_train_reload_fuse_half_info(cls, folder, tmp_path):
    """`YOLO(<config>).train` on the ImageFolder (1 epoch, batch=-1: the
    CPU's default batch): results.csv with img_per_sec, top1 and top5;
    `best.pt` and `last.pt` reload with their Classify head and give the
    trained model's predictions; fuse=True (1e-5) and half=True predict and
    val beside it; `info()` counts the held model with its GFLOPs."""
    from tamtr_torch import YOLO

    path = cls[0]
    det = YOLO(str(path), device="cpu")
    assert det.task == "classify"
    res = det.train(data=str(folder), epochs=1, batch=-1, imgsz=32, lr0=0.01, warmup_epochs=0,
                    project=str(tmp_path), name="run", plots=False)
    assert set(res) == {"top1", "top5"}
    rows = (tmp_path / "run" / "results.csv").read_text().splitlines()
    assert rows[0].split(",") == ["epoch", "loss", "img_per_sec", "top1", "top5"] and len(rows) == 2
    assert det.imgsz == 32
    src = str(folder / "val")
    want = det.predict(src)
    for name in ("best.pt", "last.pt"):
        other = YOLO("classify-gelan.yaml", device="cpu", imgsz=32).load(tmp_path / "run" / "weights" / name)
        assert other.model.head_type == "Classify" and other.model.nc == 3
        for g, w in zip(other.predict(src), want):
            np.testing.assert_allclose(g["probs"], w["probs"], atol=1e-6)
    for g, w in zip(det.predict(src, fuse=True), want):
        np.testing.assert_allclose(g["probs"], w["probs"], atol=1e-5)
    half = det.predict(src, half=True)
    assert all(np.isfinite(h["probs"]).all() and abs(h["probs"].sum() - 1) < 1e-3 for h in half)
    assert set(det.val(data=str(folder), fuse=True)) == {"top1", "top5"}
    assert "GFLOPs" in det.info(imgsz=32)


def test_cli_classify_train_val_predict(cls, folder, tmp_path, capsys):
    """`python -m tamtr_torch classify train` of the narrow config (one
    epoch), then `classify val` and `classify predict` from its `best.pt`:
    each exits normally; val prints top-1 / top-5, predict one line an
    image with its top class."""
    from tamtr_torch import cli

    cli.main(["classify", "train", f"model={cls[0]}", f"data={folder}", "imgsz=32", "epochs=1", "batch=4",
              "plots=False", "device=cpu", f"project={tmp_path}", "name=r"])
    best = tmp_path / "r" / "weights" / "best.pt"
    assert best.exists()
    capsys.readouterr()
    cli.main(["classify", "val", f"model={best}", f"data={folder}", "imgsz=32", "batch=4", "device=cpu"])
    assert "top5" in capsys.readouterr().out
    cli.main(["classify", "predict", f"model={best}", f"source={folder / 'val' / 'red'}", "imgsz=32",
              "device=cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and all(line.split(": ")[1].split()[0] in ("blue", "green", "red") for line in lines)
