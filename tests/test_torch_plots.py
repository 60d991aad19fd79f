"""The port's plots and logger integrations on the CPU
(`tamtr_torch/utils/plotting.py`, `utils/callbacks.py`) against the JAX
package's, which draw with cv2 and matplotlib: the training-batch mosaic
bitwise outside bands of 2 px around each box edge and label, the feature
grids bitwise cv2's, the training curves read back through their pixels,
and one nano training of each package with plots=True and every logging
service stubbed: the same files in the run directory, and the same events
with the same payload keys and steps to every service."""

import functools
import sys
import types
from collections import Counter
from pathlib import Path

import cv2
import numpy as np
import pytest

from tamtr_torch.data.image_io import imread
from tamtr_torch.utils import plotting as P

from torch_engine_data import IMG, one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import smoke_train_torch  # noqa: E402

NAMES = ["car", "van", "bus"]


def _batch(seed=0, B=4, hw=(96, 128)):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (B, *hw, 3), dtype=np.uint8)
    n = 9
    bi = rng.integers(0, B, n)
    cls = rng.integers(0, 3, n)
    c = rng.uniform(0.1, 0.9, (n, 2))
    wh = rng.uniform(0.05, 0.6, (n, 2))
    wh[0] = (1.4, 0.3)  # a box wider than the image: clipped edges
    return imgs, bi, cls, np.concatenate([c, wh], 1).astype(np.float32)


@pytest.mark.parametrize("seed,B", [(0, 4), (1, 3), (2, 16)])
def test_plot_images_equals_jax_outside_the_bands(seed, B):
    from tamtr_tpu.utils.plotting import plot_images as jax_plot_images

    imgs, bi, cls, boxes = _batch(seed, B)
    got = P.plot_images(imgs, bi, cls, boxes, names=NAMES)
    want = jax_plot_images(imgs, bi, cls, boxes, names=NAMES)
    assert got.shape == want.shape
    h, w = imgs.shape[1:3]
    ns = int(np.ceil(min(B, 16) ** 0.5))
    mask = np.zeros(got.shape[:2], bool)

    def exclude(i, x0, y0, x1, y1, band=2):
        oy, ox = (i // ns) * h, (i % ns) * w
        ya, yb = sorted((y0, y1))
        xa, xb = sorted((x0, x1))
        ya, yb = max(ya - band, 0), min(yb + band, h - 1)
        xa, xb = max(xa - band, 0), min(xb + band, w - 1)
        if ya <= yb and xa <= xb:
            mask[oy + ya:oy + yb + 1, ox + xa:ox + xb + 1] = True

    for i, c, (cx, cy, bw, bh) in zip(bi, cls, boxes):
        x1, y1, x2, y2 = int((cx - bw / 2) * w), int((cy - bh / 2) * h), int((cx + bw / 2) * w), int((cy + bh / 2) * h)
        for e in ((x1, y1, x2, y1), (x1, y2, x2, y2), (x1, y1, x1, y2), (x2, y1, x2, y2)):
            exclude(i, *e)
        (tw, th), base = cv2.getTextSize(NAMES[c], cv2.FONT_HERSHEY_SIMPLEX, 0.3, 1)
        ty = max(y1 - 2, 8)
        exclude(i, x1, ty - th, x1 + tw, ty + base)
        exclude(i, *P.batch_label_box(NAMES[c], x1, y1))
    assert 0.02 < mask.mean() < 0.9
    np.testing.assert_array_equal(got[~mask], want[~mask])


def test_plot_images_writes_the_mosaic(tmp_path):
    imgs, bi, cls, boxes = _batch(3)
    got = P.plot_images(imgs.astype(np.float32) / 255, bi, cls, boxes, names=NAMES, save_path=tmp_path / "b.jpg")
    from tamtr_torch.data.image_io import imencode

    assert (tmp_path / "b.jpg").read_bytes() == imencode(".jpg", got)
    assert imread(tmp_path / "b.jpg").shape == got.shape


@pytest.mark.parametrize("stage,hw,c", [("", (12, 9), 5), ("neck", (7, 7), 40)])
def test_feature_visualization_is_bitwise_cv2(tmp_path, stage, hw, c):
    from tamtr_tpu.utils.plotting import feature_visualization as jax_fv

    rng = np.random.default_rng(4)
    feats = [rng.standard_normal((2, *hw, c)).astype(np.float32), rng.standard_normal((2, 4, 6, 3)).astype(np.float32)]
    got = P.feature_visualization(feats, tmp_path / "port", stage)
    want = jax_fv(feats, tmp_path / "jax", stage)
    assert [p.name for p in got] == [p.name for p in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(cv2.imread(str(g)), cv2.imread(str(w)))


def test_plot_results_curves_run_through_the_values(tmp_path):
    import csv

    rows = [{"epoch": e, "loss": 3 - 0.4 * e, "giou": 1 / e, "class": 0.5, "img_per_sec": 10 + e,
             "mAP50": "" if e % 2 else 0.1 * e} for e in range(1, 7)]
    path = tmp_path / "results.csv"
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    P.plot_results(path)
    img = imread(tmp_path / "results.png")
    series = P.results_series(path)
    epochs = series.pop("epoch")
    assert img.shape == (2 * P.PANEL_H, 4 * P.PANEL_W, 3) and len(series) == 5
    xlim = P._limits(epochs)
    for i, (k, v) in enumerate(series.items()):
        np.testing.assert_array_equal(v, [float(r[k] or 0) for r in rows])
        px, py = P.panel_xy(i, epochs, v, xlim, P._limits(v))
        for x, y in zip(px, py):
            assert tuple(img[y, x]) == P.CURVE_BGR, (k, x, y)
        ox, oy = (i % 4) * P.PANEL_W, (i // 4) * P.PANEL_H
        assert (img[oy + P.AXES[1], ox + P.AXES[0]:ox + P.AXES[2]] == 0).all()  # the axes' top edge
    assert (img[P.PANEL_H:, P.PANEL_W:] == 255).all()  # no panel after the fifth


# ------------------------------------------------------------------ training
def _stub_services(log):
    """sys.modules entries for every logging service: each call appends
    (service, call, what it carried) to `log`, values reduced to their keys,
    steps and names, which two trainings of the same run share."""
    def rec(*entry):
        log.append(entry)

    def keys(d):
        return tuple(sorted(d))

    class SummaryWriter:
        def __init__(self, log_dir):
            rec("tensorboard", "init")

        def add_scalar(self, k, v, step):
            rec("tensorboard", "add_scalar", k, step)

        def add_image(self, name, img, dataformats):
            rec("tensorboard", "add_image", name, np.asarray(img).ndim, dataformats)

        def close(self):
            rec("tensorboard", "close")

    class WandbRun:
        def __init__(self):
            self.summary = _Summary(rec)

        def log(self, data, step=None):
            rec("wandb", "log", keys(data), step)

        def save(self, path, policy=None):
            rec("wandb", "save", Path(path).stem, policy)

        def finish(self):
            rec("wandb", "finish")

    class Experiment:
        def __init__(self, project_name):
            rec("comet", "init")

        def log_metrics(self, d, epoch):
            rec("comet", "log_metrics", keys(d), epoch)

        def end(self):
            rec("comet", "end")

    class Task:
        @staticmethod
        def init(project_name, task_name):
            rec("clearml", "init")
            return Task()

        def get_logger(self):
            return types.SimpleNamespace(report_scalar=lambda t, s, v, iteration: rec("clearml", t, s, iteration))

        def close(self):
            rec("clearml", "close")

    class NeptuneRun:
        def __getitem__(self, key):
            return types.SimpleNamespace(append=lambda v, step: rec("neptune", key, step))

        def stop(self):
            rec("neptune", "stop")

    class Live:
        def __init__(self, save_dvc_exp):
            rec("dvc", "init")

        def log_metric(self, k, v):
            rec("dvc", "log_metric", k)

        def next_step(self):
            rec("dvc", "next_step")

        def end(self):
            rec("dvc", "end")

    mods = {
        "torch.utils.tensorboard": types.SimpleNamespace(SummaryWriter=SummaryWriter),
        "wandb": types.SimpleNamespace(init=lambda **kw: (rec("wandb", "init"), WandbRun())[1],
                                       Image=lambda p: Path(p).name),
        "mlflow": types.SimpleNamespace(
            set_experiment=lambda e: rec("mlflow", "set_experiment"), start_run=lambda: rec("mlflow", "start_run"),
            log_metrics=lambda d, step=None: rec("mlflow", "log_metrics", keys(d), step),
            log_artifacts=lambda p, artifact_path: rec("mlflow", "log_artifacts", Path(p).stem, artifact_path),
            log_artifact=lambda p: rec("mlflow", "log_artifact", Path(p).name), end_run=lambda: rec("mlflow", "end")),
        "comet_ml": types.SimpleNamespace(Experiment=Experiment),
        "clearml": types.SimpleNamespace(Task=Task),
        "neptune": types.SimpleNamespace(init_run=lambda project: (rec("neptune", "init"), NeptuneRun())[1]),
        "dvclive": types.SimpleNamespace(Live=Live),
        "ray": types.SimpleNamespace(train=types.SimpleNamespace(report=lambda d: rec("raytune", "report", keys(d)))),
        "ray.tune": types.SimpleNamespace(is_session_enabled=lambda: True),
    }
    mods["ray.train"] = mods["ray"].train
    return mods


class _Summary(dict):
    def __init__(self, rec):
        super().__init__()
        self._rec = rec

    def __setitem__(self, k, v):
        self._rec("wandb", "summary", k)
        super().__setitem__(k, v)


TRAIN = dict(epochs=1, batch=2, imgsz=IMG, max_gt=8, warmup_epochs=1, workers=0, conf=0.01, plots=True,
             name="run")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One nano training of each package on the same 6 + 2 generated
    images, plots=True, every service enabled and stubbed: (run directory,
    service calls) of each. JAX's text table is 512 wide; its nano head
    takes 128, so its text and train-state helpers are given the port's
    128-wide class-name embeddings."""
    import tamtr_tpu.data.text as jax_text
    import tamtr_tpu.engine.model as jax_engine
    import tamtr_tpu.utils.settings as jax_settings
    from tamtr_torch.data.text import TextEmbedder, class_text_embeddings
    from tamtr_torch.engine.model import Engine

    root = tmp_path_factory.mktemp("plots_train")
    data = smoke_train_torch.make_dataset(root / "data", 6, 2, IMG)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TAMTR_CONFIG_DIR", str(root / "config"))  # the port's defaults: every service on
        for k in ("tensorboard", "wandb", "mlflow", "comet", "clearml", "neptune", "dvc", "raytune"):
            mp.setitem(jax_settings.SETTINGS, k, True)
        mp.setattr(jax_engine, "class_text_embeddings",
                   lambda names, npz_path=None: class_text_embeddings(names, npz_path=npz_path, dim=128))
        mp.setattr(jax_text, "TextEmbedder", lambda npz_path=None: TextEmbedder(npz_path=npz_path, dim=128))
        mp.setattr(jax_engine, "create_train_state", functools.partial(jax_engine.create_train_state, text_dim=128))
        for pkg, make in (("jax", jax_engine.Engine), ("port", functools.partial(Engine, device="cpu"))):
            log = []
            with pytest.MonkeyPatch.context() as mods:
                for name, mod in _stub_services(log).items():
                    mods.setitem(sys.modules, name, mod)
                make("tamtr-nano.yaml").train(data=str(data), project=str(root / pkg), **TRAIN)
            out[pkg] = (root / pkg / "run", log)
    return out


def test_training_writes_jax_plot_files(runs):
    """The run directory holds JAX's files (the checkpoints apart: JAX
    writes orbax directories, the port `.pt` files), each image readable."""
    names = {pkg: sorted(p.name for p in d.iterdir() if p.name != "weights") for pkg, (d, _) in runs.items()}
    assert names["port"] == names["jax"] == ["confusion_matrix.png", "results.csv", "results.png",
                                             "train_batch0.jpg", "train_batch1.jpg", "train_batch2.jpg"]
    port_dir = runs["port"][0]
    for f in names["port"]:
        if f != "results.csv":
            assert imread(port_dir / f) is not None, f


def test_services_get_jax_events_and_payloads(runs):
    """Every service sees the same calls, payload keys and steps as in
    JAX's run (the checkpoint path compared by its stem)."""
    jax_log, port_log = runs["jax"][1], runs["port"][1]
    assert {e[0] for e in port_log} == {"tensorboard", "wandb", "mlflow", "comet", "clearml", "neptune", "dvc",
                                        "raytune"}
    assert Counter(port_log) == Counter(jax_log)
    for service in ("wandb", "mlflow", "comet", "clearml", "neptune", "dvc"):  # each service's last call ends it
        assert [e for e in port_log if e[0] == service][-1] == [e for e in jax_log if e[0] == service][-1]


def test_integrations_gated_by_the_settings(tmp_path):
    from tamtr_torch.utils.callbacks import Callbacks, attach_integrations
    from tamtr_torch.utils.settings import SettingsManager

    s = SettingsManager(tmp_path / "s.yaml")
    off = {**s, **{k: False for k in ("tensorboard", "wandb", "mlflow", "comet", "clearml", "neptune", "dvc",
                                      "raytune")}}
    log = []
    with pytest.MonkeyPatch.context() as mods:
        for name, mod in _stub_services(log).items():
            mods.setitem(sys.modules, name, mod)
        assert attach_integrations(Callbacks(), tmp_path, settings=off) == []
        assert attach_integrations(Callbacks(), tmp_path, settings={**off, "mlflow": True, "dvc": True}) == \
            ["mlflow", "dvc"]
    assert attach_integrations(Callbacks(), tmp_path, settings={**off, "wandb": True}) == []  # not installed
