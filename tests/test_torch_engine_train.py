"""The port's engine on the CPU: rect val, resume against an uninterrupted
run, the run directory (results.csv, `last`, `best`) and the preemption
stop, and the generated dataset of `tools/smoke_train_torch.py` against
`tools/smoke_train.py`'s. Models are `tamtr-nano.yaml` at 64 px on one
torch thread; `Engine.val` against the JAX engine is in
`tests/test_torch_engine.py`.
"""

import json
import os
import signal
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from tamtr_torch.api import TAMTR
from tamtr_torch.engine.model import Engine
from tamtr_torch.nn.graph import TAMTRModel as PortModel
from tamtr_torch.weights import init_parameters

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import smoke_train  # noqa: E402
import smoke_train_torch  # noqa: E402

from torch_engine_data import HD, IMG, NAMES, NC, one_thread, unit_text, write_val_split  # noqa: F401


@pytest.fixture(scope="module")
def port_nano():
    """A seeded nano model whose zero-initialised head layers get small
    random values and whose contrastive bias is 0, so that scores spread."""
    model = PortModel.from_cfg("tamtr-nano.yaml", nc=NC)
    init_parameters(model, 0)
    g = torch.Generator().manual_seed(0)
    head = model.model[-1]
    with torch.no_grad():
        for mlp in [head.enc_bbox_head, *head.dec_bbox_head]:
            mlp.layers[-1].weight.copy_(torch.randn(mlp.layers[-1].weight.shape, generator=g) * 0.05)
        for layer in head.decoder["layers"]:
            for lin in (layer.cross_attn.sampling_offsets, layer.cross_attn.attention_weights):
                lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * 0.05)
        for sh in head.dec_score_head:
            sh.bias.zero_()
    return model.eval()


@pytest.fixture(scope="module")
def txt():
    return unit_text()


@pytest.fixture(scope="module")
def val_data(port_nano, txt, tmp_path_factory):
    return write_val_split(tmp_path_factory.mktemp("engine_val"), port_nano, txt)


def test_rect_val_maps_back_to_image_pixels(port_nano, txt, val_data, tmp_path):
    """rect=True letterboxes each batch to its shape (64 px images: a 96 px
    canvas, 16 px of border 114 around) and maps the detections back to the
    image's pixels. Labelled with the non-empty detections of that canvas,
    mapped back by hand, the metrics equal those of the hand-mapped
    detections against the labels; the detections wholly in the border
    clip to empty boxes and stay false positives."""
    from tamtr_torch.data.image_io import imread
    from tamtr_torch.ops.nms import postprocess_predictions
    from tamtr_torch.utils.metrics import DetMetrics, match_predictions

    root = val_data.parent
    (tmp_path / "labels").mkdir()
    (tmp_path / "images").symlink_to(root / "images")
    want = DetMetrics()
    for p in sorted((root / "images").glob("*.png")):
        canvas = np.full((96, 96, 3), 114, np.uint8)
        canvas[16:80, 16:80] = imread(p)
        x = torch.from_numpy(canvas[None, ..., ::-1] / np.float32(255))
        with torch.inference_mode():
            pred = port_nano(x, torch.from_numpy(txt[None]))["pred"]
        boxes, scores, labels, valid, _ = (t[0].numpy() for t in postprocess_predictions(
            pred, 0.25, 0.7, 300, legacy_val_mask=True))
        pb = (boxes[valid] * 96 - 16).clip(0, IMG)
        live = ((pb[:, 2:] - pb[:, :2]) > 1).all(1)
        gt = np.round(pb[live] / IMG, 6)
        (tmp_path / "labels" / f"{p.stem}.txt").write_text("\n".join(
            f"{c} {(a + c2) / 2:.6f} {(b + d) / 2:.6f} {c2 - a:.6f} {d - b:.6f}"
            for c, (a, b, c2, d) in zip(labels[valid][live], gt)))
        gt_cls = labels[valid][live].astype(np.float32)
        pc = labels[valid].astype(np.float32)
        want.update(match_predictions(pb, pc, gt * IMG, gt_cls), scores[valid], pc, gt_cls)
    want = want.compute()
    data = tmp_path / "data.json"
    data.write_text(json.dumps({"path": str(tmp_path), "train": "images", "val": "images", "nc": NC,
                                "names": NAMES}))
    eng = Engine("tamtr-nano.yaml", device="cpu")
    eng.model = port_nano
    eng.set_classes(NAMES, txt)
    got = eng.val(rect=True, data=str(data), imgsz=IMG, batch=2, conf=0.25, workers=1, plots=False)
    assert want["mAP50"] > 0.5
    for k in ("mAP50", "mAP50-95", "precision", "recall"):
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


@pytest.fixture(scope="module")
def train_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("engine_train")
    return smoke_train_torch.make_dataset(root, 4, 2, IMG)


def _train(project, **kw):
    eng = Engine("tamtr-nano.yaml", device="cpu")
    eng.train(data=kw.pop("data"), batch=2, imgsz=IMG, max_gt=8, warmup_epochs=2, workers=0, conf=0.01,
              plots=False, project=str(project), name="run", exist_ok=True, **kw)
    return eng


def _sigint_after_first_epoch(eng):
    eng.callbacks.add("on_fit_epoch_end", lambda e, epoch, row: os.kill(os.getpid(), signal.SIGINT))


def test_resume_is_bitwise_the_uninterrupted_run(train_data, tmp_path):
    """Two epochs straight against one epoch, stopped by SIGINT, plus
    resume=True for the second: parameters, EMA, optimizer state and the
    counters come out bitwise equal."""
    straight = _train(tmp_path / "a", data=str(train_data), epochs=2, val=False)

    stopped = Engine("tamtr-nano.yaml", device="cpu")
    _sigint_after_first_epoch(stopped)
    handler = signal.getsignal(signal.SIGINT)
    stopped.train(data=str(train_data), epochs=2, val=False, batch=2, imgsz=IMG, max_gt=8, warmup_epochs=2,
                  workers=0, plots=False, project=str(tmp_path / "b"), name="run", exist_ok=True)
    assert signal.getsignal(signal.SIGINT) is handler  # the engine put the handler back
    assert stopped.trainer.ni == straight.trainer.ni // 2
    resumed = _train(tmp_path / "b", data=str(train_data), epochs=2, val=False, resume=True)

    a, b = straight.trainer, resumed.trainer
    assert (a.ni, a.count, a.last_opt) == (b.ni, b.count, b.last_opt)
    for key in ("model", "ema"):
        sa, sb = a.state_dict()[key], b.state_dict()[key]
        assert all(torch.equal(sa[k], sb[k]) for k in sa), key
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i, st in oa["state"].items():
        assert all(torch.equal(v, ob["state"][i][k]) for k, v in st.items())
    assert all(torch.equal(x, y) for x, y in zip(a.acc, b.acc))
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_run_dir_and_preemption(train_data, tmp_path):
    """results.csv gets a row per epoch run with the val metrics, `last`
    and `best` are written, and SIGINT stops the run at the epoch boundary
    with `last` saved (as `tests/test_engine.py::test_preemption_checkpoint`
    holds the JAX engine)."""
    eng = Engine("tamtr-nano.yaml", device="cpu")
    _sigint_after_first_epoch(eng)
    res = eng.train(data=str(train_data), epochs=50, batch=2, imgsz=IMG, max_gt=8, warmup_epochs=2, workers=0,
                    conf=0.01, plots=False, project=str(tmp_path / "runs"))
    run = tmp_path / "runs" / "train"
    assert (run / "weights" / "last.pt").exists() and (run / "weights" / "best.pt").exists()
    rows = (run / "results.csv").read_text().splitlines()
    assert len(rows) == 2 and "mAP50" in rows[0] and "img_per_sec" in rows[0]
    assert 0.0 <= res["mAP50"] <= 1.0 and "images_per_sec" in res
    meta = torch.load(run / "weights" / "last.pt", weights_only=True)["meta"]
    assert meta["epoch"] == 0 and meta["names"] == NAMES and meta["imgsz"] == IMG
    # a second run without exist_ok goes to train2; `load` + `val` read `best`
    loaded = Engine("tamtr-nano.yaml", device="cpu").load(run / "weights" / "best.pt")
    assert loaded.names == NAMES and loaded.txt_feats.shape == (NC, HD)
    again = loaded.val(data=str(train_data), imgsz=IMG, batch=2, conf=0.01, workers=1, plots=False)
    assert again["mAP50"] == pytest.approx(res["mAP50"], abs=1e-9)


def test_tamtr_train_then_predict_uses_the_trained_model(train_data, tmp_path):
    """`TAMTR.train` trains from the detector's seed and max_gt and leaves
    the trained EMA model as the detector's one model: `predict` sees it,
    and equals a detector that `load`s the run's `last`. A dataset whose nc
    differs from a given `nc` is refused, and `val` with no weights raises."""
    with pytest.raises(ValueError, match="nc"):
        TAMTR("tamtr-nano.yaml", nc=NC + 1, device="cpu").train(data=str(train_data))
    with pytest.raises(RuntimeError, match="no weights"):
        TAMTR("tamtr-nano.yaml", device="cpu").val(data=str(train_data))
    det = TAMTR("tamtr-nano.yaml", nc=NC, device="cpu", seed=2, imgsz=IMG, max_gt=8)
    init = {k: v.clone() for k, v in det.model.state_dict().items()}
    began = {}
    det._engine.callbacks.add("on_train_start", lambda e: began.update(
        {k: v.clone() for k, v in e.trainer.model.state_dict().items()}))
    det.train(data=str(train_data), epochs=1, batch=2, warmup_epochs=2, workers=0, val=False, plots=False,
              project=str(tmp_path), name="run")
    eng = det._engine
    assert det.model is eng.trainer.ema and det.nc == NC
    assert all(torch.equal(init[k], v) for k, v in began.items())  # train began from the detector's seed
    assert any(not torch.equal(init[k], v) for k, v in det.model.state_dict().items())
    last = tmp_path / "run" / "weights" / "last.pt"
    meta = torch.load(last, weights_only=True)["meta"]
    assert (meta["max_gt"], meta["imgsz"]) == (8, IMG)
    imgs = np.random.default_rng(3).integers(0, 256, (2, IMG, IMG, 3), dtype=np.uint8)
    got = det.predict(imgs, unit_text(), conf=0.0)
    want = TAMTR("tamtr-nano.yaml", device="cpu", imgsz=IMG).load(last).predict(imgs, unit_text(), conf=0.0)
    for g, w in zip(got, want):
        assert len(g["scores"]) > 0
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


def test_engine_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine("tamtr-nano.yaml")


def test_smoke_dataset_equals_the_jax_tools(tmp_path):
    """Labels equal `tools/smoke_train.py:make_dataset`'s files; pixels equal
    the arrays it hands to `cv2.imwrite` (captured by patching it)."""
    captured = []
    with mock.patch("cv2.imwrite", lambda path, img: captured.append(img.copy()) or True):
        smoke_train.make_dataset(tmp_path / "jax", 3, 2, 640)
    smoke_train_torch.make_dataset(tmp_path / "port", 3, 2, 640)
    from tamtr_torch.data.image_io import imread

    ours = [imread(p) for split in ("train", "val")
            for p in sorted((tmp_path / "port" / split / "images").glob("*.png"))]
    assert len(ours) == len(captured) == 5
    for a, b in zip(ours, captured):
        np.testing.assert_array_equal(a, b)
    for split in ("train", "val"):
        for lab in sorted((tmp_path / "jax" / split / "labels").glob("*.txt")):
            assert (tmp_path / "port" / split / "labels" / lab.name).read_text() == lab.read_text()
    data = json.loads((tmp_path / "port" / "data.json").read_text())
    assert data["nc"] == 3 and data["names"] == {str(k): v for k, v in smoke_train_torch.NAMES.items()}
