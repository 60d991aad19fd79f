"""Multi-rank training and val of the port over gloo on the CPU
(`tamtr_torch/parallel/`, the pattern of `tests/test_multihost.py`): a step
on n data ranks of B/n images equals the one-process step on the batch of
B, as the JAX step does under pjit; ZeRO equals plain data parallelism;
data x sp equals one process; the loader's shards are JAX's; data-parallel
val gives the one-process metrics, square and rect (the narrow Detect
model); a resumed run at world 2 with ZeRO is bitwise the uninterrupted
one.

Bounds:
- the conv + BatchNorm model of `tests/test_fsdp.py` (`TinyDet`), 3 steps:
  losses at 1e-5 relative, parameters, BatchNorm statistics and EMA at
  rtol 1e-4 / atol 1e-6 (JAX's `test_zero_matches_dp`), for 2 data ranks
  against one process and for ZeRO against plain;
- one `tamtr-nano.yaml` step: the loss at 1e-5 relative; ZeRO against
  plain at rtol 1e-4 / atol 1e-6. Its parameters after the step cannot
  meet a fixed bound: the step is ill-conditioned in fp32 (train-mode
  BatchNorm over 4 images of 64 px), and Adam moves every parameter whose
  gradient is within rounding of zero by up to +-lr whatever its size
  (JAX's `test_zero_matches_dp_real_model` says the same). One process at
  three torch threads against one thread measures that floor on the same
  step: the fractions of parameter and of BatchNorm-statistic entries that
  miss rtol 1e-4 / atol 1e-6. The ranks' fractions must be at most twice
  the floor's (the factor `chip_smoke.py:check_train_parity` allows over
  its fp32 noise floor); measured, 2 data ranks miss on 3.0e-4 and 2.2e-3
  of the entries, against 4.0e-4 and 2.1e-3 for three threads.
"""

import json
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_engine_data import IMG, NAMES, NC, one_thread, unit_text, write_val_split  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"


def run_ranks(tmp_path, case, *args, world=2, timeout=600):
    """`case` of the worker on `world` gloo ranks; each rank's result."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = tmp_path / case
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(REPO), str(WORKER.parent)]), "WORLD_SIZE": str(world),
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(WORKER), case, str(out), *map(str, args)],
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = [p.communicate(timeout=timeout)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(world)]


def close(a: dict, b: dict, rtol=1e-4, atol=1e-6):
    for k in a:
        if a[k].dtype.is_floating_point:
            torch.testing.assert_close(a[k], b[k], rtol=rtol, atol=atol, msg=k)


def test_two_ranks_equal_one_process_and_zero_equals_dp_tiny(tmp_path):
    ranks = run_ranks(tmp_path, "tiny")
    one_losses, one_model, one_ema = ranks[0]["one"]
    for r in ranks:
        for name in ("dp", "zero"):
            losses, model, ema = r[name]
            np.testing.assert_allclose(losses, one_losses, rtol=1e-5)
            close(model, one_model)  # parameters and BatchNorm statistics
            close(ema, one_ema)
        close(r["zero"][1], r["dp"][1])
        close(r["zero"][2], r["dp"][2])
    assert all(torch.equal(ranks[0]["dp"][1][k], ranks[1]["dp"][1][k]) for k in one_model)  # replicas agree


def distance(got: dict, want: dict):
    """The fractions of parameter entries and of BatchNorm running-statistic
    entries that miss rtol 1e-4 / atol 1e-6."""
    def frac(keys):
        a, b = (torch.cat([d[k].reshape(-1) for k in keys]) for d in (got, want))
        return ((a - b).abs() > 1e-4 * b.abs() + 1e-6).double().mean().item()

    floats = [k for k in want if want[k].dtype.is_floating_point]
    return frac([k for k in floats if "running" not in k]), frac([k for k in floats if "running" in k])


def test_segment_step_on_two_ranks_equals_one_process(tmp_path):
    """The narrow Segment model's step (the `segment` case of
    `tests/torch_parallel_worker.py`) on 2 data ranks of 2 images against
    one process on the 4: the loss and box / cls / dfl at 1e-5 relative
    (sum(target_scores) and the batch size are the global batch's), seg
    within twice its one-versus-three-thread distance (at least 1e-5
    relative), and both ranks' parameters equal."""
    ranks = run_ranks(tmp_path, "segment")
    one, _ = ranks[0]["one"]
    floor = abs(ranks[0]["floor"][0]["seg"] - one["seg"])
    print(f"seg: one process {one['seg']}, three threads off by {floor}, ranks {[r['dp'][0]['seg'] for r in ranks]}")
    assert one["seg"] > 0
    for r in ranks:
        got, _ = r["dp"]
        for k, v in one.items():
            bound = max(2 * floor, 1e-5 * abs(v)) if k == "seg" else 1e-5 * abs(v)
            assert abs(got[k] - v) <= bound, (k, got[k], v)
    assert all(torch.equal(ranks[0]["dp"][1][k], ranks[1]["dp"][1][k]) for k in ranks[0]["dp"][1])


def test_classify_step_on_two_ranks_equals_one_process(tmp_path):
    """The narrow Classify model's cross-entropy step (the `classify` case
    of `tests/torch_parallel_worker.py`) on 2 data ranks of 2 images
    against one process on the 4: the loss, cls and top1 at 1e-5 relative
    (the mean over the global batch, its BatchNorm moments global), the
    parameters and statistics after the step at 1e-4, both ranks' equal."""
    ranks = run_ranks(tmp_path, "classify")
    one, one_model = ranks[0]["one"]
    assert one["loss"] > 0
    for r in ranks:
        got, model = r["dp"]
        for k, v in one.items():
            assert abs(got[k] - v) <= 1e-5 * abs(v), (k, got[k], v)
        close(model, one_model)
    assert all(torch.equal(ranks[0]["dp"][1][k], ranks[1]["dp"][1][k]) for k in ranks[0]["dp"][1])


def test_nano_step_on_two_ranks_equals_one_process(tmp_path):
    """DP (2 ranks x 2 images), ZeRO and data 1 x sp 2 against the
    one-process step on the 4 images."""
    ranks = run_ranks(tmp_path, "nano")
    (one_loss,), one_model, _ = ranks[0]["one"]
    (floor_loss,), floor_model, _ = ranks[0]["floor"]
    floor = distance(floor_model, one_model)
    assert floor[0] > 0  # the floor exists: Adam's sign noise at one more thread
    for r in ranks:
        for name in ("dp", "zero", "dpsp"):
            (loss,), model, _ = r[name]
            assert abs(loss - one_loss) <= 1e-5 * abs(one_loss), (name, loss, one_loss)
            got = distance(model, one_model)
            assert got[0] <= 2 * floor[0] and got[1] <= 2 * floor[1], (name, got, floor)
        close(r["zero"][1], r["dp"][1])
    for name in ("dp", "zero", "dpsp"):
        assert all(torch.equal(ranks[0][name][1][k], ranks[1][name][1][k]) for k in one_model), name


def test_loader_shards_equal_jax(monkeypatch):
    """Per epoch, process i of 2 takes the shuffled order's [i::2] and cuts
    it into batches, as JAX's `build_loader(process_index, process_count)`."""
    import tamtr_tpu.data.dataset as jds
    from tamtr_torch.data.dataset import Loader, _EpochKeys

    class Stub:
        imgsz, task, _mosaic_on = 64, "detect", False

        def __len__(self):
            return 11

        def get(self, i, rng):
            return i

    monkeypatch.setattr(jds, "collate", lambda samples, *a, **k: list(samples))
    for pi in range(2):
        jl = jds.build_loader(Stub(), 2, seed=5, workers=1, process_index=pi, process_count=2)
        pl = Loader(Stub(), 2, seed=5, workers=0, process_index=pi, process_count=2)
        assert len(pl) == len(jl) == 2
        for epoch in range(3):
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
            want = list(jl)
            assert [list(k[2]) for k in _EpochKeys(pl)] == want
            assert [k[1] for k in _EpochKeys(pl)] == list(range(len(want)))


@pytest.fixture(scope="module")
def val_case(tmp_path_factory):
    """A seeded nano model with spread head weights, its 6-image val split,
    and the one-process `Engine.val` metrics."""
    from tamtr_torch.engine.model import Engine
    from tamtr_torch.nn.graph import TAMTRModel
    from tamtr_torch.weights import init_parameters

    root = tmp_path_factory.mktemp("dp_val")
    model = TAMTRModel.from_cfg("tamtr-nano.yaml", nc=NC)
    init_parameters(model, 0)
    g = torch.Generator().manual_seed(0)
    head = model.model[-1]
    with torch.no_grad():
        for mlp in [head.enc_bbox_head, *head.dec_bbox_head]:
            mlp.layers[-1].weight.copy_(torch.randn(mlp.layers[-1].weight.shape, generator=g) * 0.05)
        for sh in head.dec_score_head:
            sh.bias.zero_()
    model.eval()
    txt = unit_text()
    data = write_val_split(root, model, txt)
    torch.save(model.state_dict(), root / "model.pt")
    args = dict(data=str(data), imgsz=IMG, batch=2, conf=0.25, workers=1, plots=False)
    (root / "spec.json").write_text(json.dumps({"names": NAMES, "txt": txt.tolist(), "args": args}))
    eng = Engine("tamtr-nano.yaml", device="cpu")
    eng.model = model
    eng.set_classes(NAMES, txt)
    return root, eng.val(**args)


def test_data_parallel_val_equals_one_process(val_case, tmp_path):
    """3 batches over 2 ranks (rank 0 runs two): every rank returns the
    one-process metrics, exactly."""
    root, want = val_case
    assert want["mAP50"] > 0
    for got in run_ranks(tmp_path, "val", root):
        for k in ("mAP50", "mAP50-95", "precision", "recall", "fitness"):
            assert got[k] == want[k], (k, got[k], want[k])


@pytest.fixture(scope="module")
def rect_case(tmp_path_factory):
    """The narrow Detect model (`yolo_narrow_cfg`, seeded, its head spread
    and calibrated for eval), a 6-image split of mixed aspect ratios
    labelled by it, and its rect val in one process."""
    from torch_engine_data import calibrate_detect_model, spread_detect_model, write_rect_val_split, write_yolo_narrow

    from tamtr_torch.engine.model import Engine
    from tamtr_torch.nn.graph import TAMTRModel
    from tamtr_torch.weights import init_parameters

    root = tmp_path_factory.mktemp("rect")
    cfg = write_yolo_narrow(root)
    model = TAMTRModel.from_cfg(cfg, nc=NC)
    init_parameters(model, 0)
    spread_detect_model(model)
    calibrate_detect_model(model, torch.from_numpy(np.random.default_rng(0).random((4, IMG, IMG, 3), dtype=np.float32)))
    txt = np.random.default_rng(3).standard_normal((NC, 512)).astype(np.float32)
    data = write_rect_val_split(root, model.eval(), txt)
    torch.save(model.state_dict(), root / "model.pt")
    args = dict(data=str(data), imgsz=IMG, batch=2, conf=0.25, workers=1, plots=False, rect=True)
    (root / "spec.json").write_text(json.dumps({"cfg": str(cfg), "names": NAMES, "txt": txt.tolist(), "args": args}))
    eng = Engine(str(cfg), device="cpu")
    eng.model = model
    eng.set_classes(NAMES, txt)
    return root, eng.val(**args)


def test_rect_val_on_two_ranks_equals_one_process(rect_case, tmp_path):
    """Rect val (letterboxed batches binned by aspect ratio) of the narrow
    Detect model: 3 batches over 2 ranks (rank 0 runs two, the batches of
    other shapes than rank 1's); every rank returns the one-process
    metrics, exactly. The JAX engine runs rect val on one device only
    (`tamtr_tpu/engine/model.py:793`); the port keeps it at any world size."""
    from tamtr_torch.data.dataset import DetectionDataset

    root, want = rect_case
    assert 0 < want["mAP50"] < 1
    ds = DetectionDataset(str(root / "images"), imgsz=IMG, augment=False)
    ds.set_rectangle(2)
    assert len({tuple(ds.get_val(i)[0].shape[:2]) for i in range(len(ds))}) >= 2  # batches of two shapes at least
    for got in run_ranks(tmp_path, "rect", root):
        for k in ("mAP50", "mAP50-95", "precision", "recall", "fitness"):
            assert got[k] == want[k], (k, got[k], want[k])


def test_resume_at_world_two_with_zero_is_bitwise(tmp_path):
    """`Engine.train(n_devices=2, fsdp=2)` starts 2 gloo ranks itself: 2
    epochs, then resume=True for a third, against 3 epochs straight; the
    checkpoints' model, EMA, consolidated optimizer, accumulated gradient,
    counters and generator are bitwise equal."""
    sys.path.insert(0, str(REPO / "tools"))
    import smoke_train_torch

    from tamtr_torch.engine.model import Engine

    data = smoke_train_torch.make_dataset(tmp_path / "data", 4, 2, IMG)

    def train(project, epochs, **kw):
        eng = Engine("tamtr-nano.yaml", device="cpu")
        eng.train(data=str(data), batch=2, imgsz=IMG, max_gt=8, warmup_epochs=2, workers=0, plots=False,
                  val=False, project=str(project), name="run", exist_ok=True, epochs=epochs, n_devices=2,
                  fsdp=2, nbs=4, **kw)
        return eng

    with ThreadPoolExecutor(2) as pool:  # the two runs from scratch side by side
        straight = pool.submit(train, tmp_path / "a", 3)
        pool.submit(train, tmp_path / "b", 2).result()
        straight = straight.result()
    resumed = train(tmp_path / "b", 3, resume=True)
    assert straight.model is not None and resumed.names == straight.names  # the trained EMA weights, held
    a, b = (torch.load(p / "run" / "weights" / "last.pt", weights_only=True)["trainer"]
            for p in (tmp_path / "a", tmp_path / "b"))
    assert (a["ni"], a["count"], a["last_opt"]) == (b["ni"], b["count"], b["last_opt"])
    assert a["ni"] == 6 and a["count"] >= 3  # 2 steps an epoch; nbs 4 accumulates 1, then 2 minibatches
    for key in ("model", "ema"):
        assert all(torch.equal(a[key][k], b[key][k]) for k in a[key]), key
    assert len(a["optimizer"]["state"]) == len(list(straight.model.parameters()))  # every shard, on rank 0
    for i, st in a["optimizer"]["state"].items():
        assert all(torch.equal(v, b["optimizer"]["state"][i][k]) for k, v in st.items())
    assert all(torch.equal(x, y) for x, y in zip(a["acc"], b["acc"]))
    assert torch.equal(a["generator"], b["generator"])


def test_cli_device_list_trains_on_every_card(monkeypatch):
    """`device=0,1` (the reference's form) shows the process those cards
    alone and makes train start one rank a card."""
    from tamtr_torch import cli

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")  # restored (or removed) after the test
    assert cli.select_devices("0,1") == ("cuda", [0, 1])
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "0,1"
    assert cli.select_devices("cpu") == ("cpu", []) and cli.select_devices(0) == (0, [])
    seen = {}

    class Fake:
        def __init__(self, *a, device=None, **k):
            seen["device"] = device

        def train(self, **ov):
            seen.update(ov)
            return {}

    monkeypatch.setattr("tamtr_torch.TAMTR", Fake)
    cli.main(["train", "model=tamtr-nano.yaml", "data=d.json", "device=2,3"])
    assert seen["device"] == "cuda" and seen["n_devices"] == 2
