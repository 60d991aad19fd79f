"""The port's CLI (`tamtr_torch/cli.py`, `python -m tamtr_torch`) on the CPU:
`parse_args` equal to the JAX package's on a list of argv; `main` trains a
nano model on the generated dataset of `tools/smoke_train_torch.py`, then
validates and predicts from its `best.pt` (`device=cpu`), one line and one
PNG per image; exports, benchmarks and tunes it; video sources exit with a
message naming their ROADMAP entry."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tamtr_torch import cli

from torch_engine_data import IMG, one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import smoke_train_torch  # noqa: E402

ARGVS = [
    ["train", "data=visdrone.yaml", "epochs=300", "batch=6"],
    ["detect", "val", "model=runs/detect/train/weights/best.pt", "conf=0.4", "rect=true", "classes=None"],
    ["predict", "source=images/", "save=True", "imgsz=640", "iou=0.5", "name=x=y"],
    ["segment", "predict", "model=a.json", "augment=false", "max_det=1.5e2"],
    ["serve", "model=w/best.pt", "port=8001", "host=0.0.0.0", "endpoint=tamtr"],
    ["export", "format=onnx"],
]
BAD = [["detect"], ["predikt"], ["train", "bogus"]]


@pytest.mark.parametrize("argv", ARGVS + BAD)
def test_parse_args_matches_jax(argv):
    from tamtr_tpu.cli import parse_args as jax_parse

    try:
        want = jax_parse(argv)
    except SystemExit as e:
        with pytest.raises(SystemExit) as got:
            cli.parse_args(argv)
        assert str(got.value) == str(e)
        return
    assert cli.parse_args(argv) == want


@pytest.mark.parametrize("argv,entry", [
    (["track", "source=v.mkv"], "container is not read"), (["serve"], "model=<checkpoint>"),
])
def test_unported_modes_exit_with_their_roadmap_entry(argv, entry):
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert entry in str(e.value) and ("ROADMAP" in str(e.value) or argv == ["serve"])


NANO = ["model=tamtr-nano.yaml", f"imgsz={IMG}", "device=cpu"]


@pytest.mark.parametrize("argv,error,match", [
    (["export", "format=onnx"], RuntimeError, "tf2onnx"),  # the JAX CLI's raise without tensorflow
    (["detect", "export"], RuntimeError, "savedmodel export requires tensorflow"),  # format=savedmodel by default
    (["export", "format=stablehlo"], ValueError, "'torch_export'"),
    (["export", "format=npz", "int8=True"], ValueError, "tflite-only"),
    (["segment", "tune", "use_ray=True"], ModuleNotFoundError, r'pip install "ray\[tune\]"'),
])
def test_export_and_tune_modes_raise_as_jax(argv, error, match):
    """The modes that were not ported reach the exporter and the tuner,
    which refuse what the port cannot do, as the JAX CLI's do on a machine
    without tensorflow or ray."""
    with pytest.raises(error, match=match):
        cli.main(argv + NANO)


def test_export_benchmark_and_tune_modes(trained, capsys, tmp_path):
    """`export` of a trained checkpoint prints the artifact, which loads
    back to the checkpoint's prediction; `benchmark` prints a row per format
    with parity for the three port formats; `tune` prints the best
    hyperparameters after its rows are written."""
    from tamtr_torch.nn.autobackend import AutoBackend

    root, data = trained
    best = root / "run" / "weights" / "best.pt"
    cli.main(["export", f"model={best}", "format=torch_export", f"imgsz={IMG}", f"out_dir={tmp_path / 'x'}",
              "device=cpu"])
    path = capsys.readouterr().out.strip().splitlines()[-1]
    assert path == str(tmp_path / "x" / "model.pt2")
    img = np.random.default_rng(0).random((1, IMG, IMG, 3), dtype=np.float32)
    txt = np.random.default_rng(1).standard_normal((1, 3, AutoBackend(best, device="cpu").text_width)).astype(np.float32)
    np.testing.assert_allclose(AutoBackend(path, device="cpu")(img, txt), AutoBackend(best, device="cpu")(img, txt),
                               atol=2e-5)
    cli.main(["benchmark", f"model={best}", f"imgsz={IMG}", f"out_dir={tmp_path / 'b'}", "n_iter=1", "device=cpu"])
    rows = [eval(line) for line in capsys.readouterr().out.strip().splitlines()]  # noqa: S307 (the rows' reprs)
    by_fmt = {r["format"]: r for r in rows}
    assert all(by_fmt[f]["parity_ok"] for f in ("native", "torch", "npz", "torch_export"))
    assert not by_fmt["savedmodel"]["ok"] and not by_fmt["onnx"]["ok"]
    cli.main(["tune", "model=tamtr-nano.yaml", f"data={data}", "iterations=1", "epochs=1", "batch=2", f"imgsz={IMG}",
              "max_gt=8", "workers=0", "warmup_epochs=1", f"project={tmp_path / 't'}", "device=cpu"])
    assert "lr0" in capsys.readouterr().out
    assert (tmp_path / "t" / "tune" / "tune_results.csv").read_text().count("\n") == 2


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """`main(["train", ...])`: one epoch of the nano model at 64 px on 4 + 2
    generated images; the run directory."""
    root = tmp_path_factory.mktemp("cli")
    data = smoke_train_torch.make_dataset(root / "data", 4, 2, IMG)
    cli.main(["detect", "train", "model=tamtr-nano.yaml", f"data={data}", "epochs=1", "batch=2", f"imgsz={IMG}",
              "max_gt=8", "workers=0", "warmup_epochs=1", "conf=0.01", "plots=False", f"project={root}",
              "name=run", "device=cpu"])
    return root, data


def test_cli_val_and_predict_on_a_trained_checkpoint(trained, capsys, tmp_path):
    root, data = trained
    best = root / "run" / "weights" / "best.pt"
    assert best.exists()
    cli.main(["val", f"model={best}", f"data={data}", f"imgsz={IMG}", "batch=2", "workers=1", "plots=False",
              "device=cpu"])
    assert "mAP50" in capsys.readouterr().out
    images = Path(data).parent / "val" / "images"
    cli.main(["predict", f"model={best}", f"source={images}", f"imgsz={IMG}", "save=True", f"project={tmp_path}",
              "conf=0.01", "device=cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    files = sorted(images.glob("*.png"))
    assert lines == [f"{f}: {line.rsplit(': ', 1)[1]}" for f, line in zip(files, lines)] and len(lines) == len(files)
    written = sorted((tmp_path / "predict").glob("*.png"))
    assert [p.name for p in written] == [f.name for f in files]

    from tamtr_torch import TAMTR
    from tamtr_torch.data.image_io import imread

    det = TAMTR(device="cpu", imgsz=IMG).load(best)
    res = det.predict(str(images), conf=0.01)
    assert [f"{r.path}: {len(r)} detections" for r in res] == lines
    np.testing.assert_array_equal(imread(written[0]), res[0].plot())


def test_python_m_tamtr_torch_runs_without_jax(tmp_path):
    """`python -m tamtr_torch version` and `export` (the npz archive the JAX
    package reads), in a process where JAX, cv2 and yaml cannot be
    imported."""
    pre = "import sys\nfor m in ('jax', 'flax', 'tamtr_tpu', 'cv2', 'PIL', 'yaml'):\n    sys.modules[m] = None\n"
    run = lambda args: subprocess.run(  # noqa: E731
        [sys.executable, "-c", pre + f"import runpy, sys; sys.argv = ['tamtr_torch', *{args!r}]; "
         "runpy.run_module('tamtr_torch', run_name='__main__')"], cwd=REPO, capture_output=True, text=True, timeout=120)
    res = run(["version"])
    assert res.returncode == 0 and res.stdout.strip() == "0.1.0", res.stderr
    res = run(["export", "format=npz", "model=tamtr-nano.yaml", "device=cpu", f"out_dir={tmp_path}"])
    assert res.returncode == 0 and res.stdout.strip().splitlines()[-1] == str(tmp_path / "model.npz"), res.stderr


def test_cli_track_on_a_trained_checkpoint(trained, capsys):
    """`track` over the val images as a sequence: one line per frame with
    its track count and ids, those of `TAMTR.track` with the same tracker
    (the ids themselves are held against JAX's in `test_torch_predict.py`)."""
    from tamtr_torch import TAMTR
    from tamtr_torch.trackers.byte_tracker import Track

    root, data = trained
    best = root / "run" / "weights" / "best.pt"
    images = Path(data).parent / "val" / "images"
    Track.reset_id()
    cli.main(["detect", "track", f"model={best}", f"source={images}", f"imgsz={IMG}", "conf=0.01",
              "tracker=botsort", "gmc_method=none", "device=cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    Track.reset_id()
    det = TAMTR(device="cpu", imgsz=IMG).load(best)
    res = det.track(str(images), tracker="botsort", gmc_method="none", conf=0.01)
    want = [f"{r.path}: {len(r.track_ids)} tracks {sorted(set(r.track_ids.tolist()))}" for r in res]
    assert lines == want and len(lines) == len(sorted(images.glob("*.png")))
