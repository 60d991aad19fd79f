"""The port's reader of the reference's own checkpoint
(`tamtr_torch/weight_files.py:read_reference_checkpoint`, `Engine.load`,
`TAMTR(...)`, the CLI's `model=`, `tools/port_torch_weights_torch.py`)
against the JAX package's converter (`tools/port_torch_weights.py:
port_state_dict`) on the CPU. The files are written as ultralytics 8.0.201
writes them by `tools/make_reference_ckpt_torch.py`: the full-width
`tamtr.yaml` once for the module (JAX's converter checks a 512-wide text
table), `tamtr-nano.yaml` for the layouts and the refusals.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tamtr_torch.engine.model import Engine
from tamtr_torch.nn.autobackend import AutoBackend
from tamtr_torch.nn.graph import TAMTRModel
from tamtr_torch.weight_files import PickledObject, is_reference_checkpoint, read_reference_checkpoint
from tamtr_torch.weights import from_jax_variables, init_parameters, to_jax_variables

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))
import port_torch_weights_torch  # noqa: E402
from make_reference_ckpt_torch import write_reference_checkpoint  # noqa: E402

from torch_engine_data import one_thread  # noqa: E402,F401

NC = 10
VISDRONE = ["pedestrian", "people", "bicycle", "car", "van", "truck", "tricycle", "awning-tricycle", "bus", "motor"]


def _seeded(cfg: str, seed: int, nc: int = NC, **kw) -> TAMTRModel:
    m = TAMTRModel.from_cfg(cfg, nc=nc, **kw)
    init_parameters(m, seed)
    return m.eval()


def _rounded(model):
    """The state dict a half checkpoint of `model` carries, back in fp32,
    without `num_batches_tracked`."""
    return {k: v.half().float() if v.is_floating_point() else v
            for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}


@pytest.fixture(scope="module")
def full(tmp_path_factory):
    """(path, seeded full-width model) of a training-layout reference file."""
    model = _seeded("tamtr.yaml", 0)
    path = write_reference_checkpoint(tmp_path_factory.mktemp("ref") / "last.pt", model, VISDRONE)
    return path, model


@pytest.fixture(scope="module")
def jax_port(full):
    """JAX's converter on the file's arrays: (params, batch_stats, report)."""
    from tamtr_tpu.nn.graph import TAMTRModel as JaxModel
    from tools.port_torch_weights import port_state_dict

    sd, _ = read_reference_checkpoint(full[0])
    return port_state_dict({k: v.numpy() for k, v in sd.items()}, JaxModel.from_yaml("tamtr.yaml", nc=NC))


@pytest.fixture(scope="module")
def loaded(full):
    return Engine("tamtr.yaml", device="cpu").load(full[0])


@pytest.fixture(scope="module")
def nano(tmp_path_factory):
    return _seeded("tamtr-nano.yaml", 0), _seeded("tamtr-nano.yaml", 1), tmp_path_factory.mktemp("nano")


def _forward(model, txt, seed: int = 3):
    img = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        return model.eval()(img, torch.as_tensor(txt)[None])["pred"]


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): np.asarray(v)})
    return out


def test_reader_state_is_the_rounded_port_state(full):
    """(a) Every key of the port model but `num_batches_tracked`, each the
    seeded fp32 value rounded to fp16 and back, bitwise."""
    path, model = full
    sd, meta = read_reference_checkpoint(path)
    want = _rounded(model)
    assert list(sd) == list(want) and len(sd) == 1029
    for k in want:
        assert sd[k].dtype == want[k].dtype and torch.equal(sd[k], want[k]), k
    assert is_reference_checkpoint(path)


def test_jax_converter_report_empty_and_bitwise(jax_port, loaded):
    """(b) JAX's port_state_dict takes the file's arrays with every list of
    its report empty, and the loaded port model's flax variables are its
    params and batch_stats bitwise."""
    params, batch_stats, report = jax_port
    assert {k: v for k, v in report.items() if v} == {}
    ours = to_jax_variables(loaded.model)
    for got, want in ((ours["params"], params), (ours["batch_stats"], batch_stats)):
        g, w = _flat(got), _flat(want)
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].shape == w[k].shape and np.array_equal(g[k], w[k]), k


def test_engine_load_forward_equals_jax_port(jax_port, loaded):
    """(c) The 64 px eval forward of `Engine.load(file)` is that of a model
    built by `from_jax_variables` from JAX's port of the same file."""
    params, batch_stats, _ = jax_port
    twin = TAMTRModel.from_cfg("tamtr.yaml", nc=NC)
    sd, report = from_jax_variables(params, batch_stats, twin)
    assert not report["missing"] and not report["shape_mismatch"] and not report["unused_jax"]
    twin.load_state_dict(sd, strict=True)
    got, want = _forward(loaded.model, loaded.txt_feats), _forward(twin, loaded.txt_feats)
    assert got.shape == (1, 100, 4 + NC) and torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_nc_and_names_from_the_file(full, loaded):
    """(e) nc and names come from the file's module; arguments win."""
    assert loaded.model.nc == NC and loaded.names == VISDRONE
    assert loaded.txt_feats.shape == (NC, 512)
    eng = Engine("tamtr.yaml", device="cpu").load(full[0], names=[f"n{i}" for i in range(NC)])
    assert eng.names == [f"n{i}" for i in range(NC)]
    with pytest.raises(ValueError, match=r"last\.pt.*shape_mismatch.*enc_score_head"):
        Engine("tamtr.yaml", device="cpu").load(full[0], nc=5)


def test_ema_over_model_and_the_stripped_layout(nano):
    """(d) A file holding both `model` and `ema` gives the EMA's weights;
    strip_optimizer's layout (`model` only) loads, and so does a file whose
    names are a list."""
    ema, other, d = nano
    both = write_reference_checkpoint(d / "both.pt", ema, cfg_path="tamtr-nano.yaml", model_slot=other)
    stripped = write_reference_checkpoint(d / "best.pt", ema, cfg_path="tamtr-nano.yaml", layout="stripped")
    want = _rounded(ema)
    for path in (both, stripped):
        sd, meta = read_reference_checkpoint(path)
        assert meta == {"nc": NC, "names": [f"class{i}" for i in range(NC)], "imgsz": 640}  # train_args
        assert all(torch.equal(sd[k], want[k]) for k in want)
    ckpt = torch.load(stripped, map_location="cpu", weights_only=False,
                      pickle_module=sys.modules["tamtr_torch.weight_files"]._PICKLE_MODULE)
    assert ckpt["ema"] is None and ckpt["epoch"] == -1 and ckpt["version"] == "8.0.201"
    got = Engine("tamtr-nano.yaml", device="cpu").load(stripped).model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)


class _Hostile:
    """Unpickles as `fn(*args)`."""

    def __init__(self, fn, *args):
        self.fn, self.args = fn, args

    def __reduce__(self):
        return self.fn, self.args


def test_hostile_pickle_runs_nothing(nano, tmp_path):
    """(f) `os.system`, `builtins.exec` and `eval` named by the pickle,
    in the entries beside the model and as the root itself, reach stubs:
    the file they would write never appears."""
    ema, _, _ = nano
    marker = tmp_path / "ran"
    cmd = f"touch {marker}"
    code = f"open({str(marker)!r}, 'w').write('x')"
    extra = {"train_args": {"a": _Hostile(os.system, cmd), "b": _Hostile(exec, code), "c": _Hostile(eval, code)}}
    path = write_reference_checkpoint(tmp_path / "hostile.pt", ema, cfg_path="tamtr-nano.yaml", extra=extra)
    sd, _ = read_reference_checkpoint(path)
    assert len(sd) == len(_rounded(ema)) and not marker.exists()
    ckpt = torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=sys.modules["tamtr_torch.weight_files"]._PICKLE_MODULE)
    stub = ckpt["train_args"]["a"]
    assert isinstance(stub, PickledObject) and stub.qualname == "posix.system" and stub.pickled_args == (cmd,)
    assert ckpt["train_args"]["b"].qualname == "__builtin__.exec"  # protocol 2 names the builtins so
    root = tmp_path / "root.pt"
    torch.save({"ema": _Hostile(os.system, cmd), "model": None}, root)
    with pytest.raises(ValueError, match=r"root\.pt: its ema / model entry is posix\.system"):
        Engine("tamtr-nano.yaml", device="cpu").load(root)
    assert not marker.exists()


def test_refusals_name_the_file_and_keys(nano, tmp_path):
    """(g) Not a zip archive (junk, the legacy format), no module tree, a
    tree that holds itself, a checkpoint fused by switch_to_deploy (JAX's unmapped_torch and
    missing_params, the first five keys each), a shape mismatch."""
    ema, _, _ = nano
    junk = tmp_path / "junk.pt"
    junk.write_bytes(b"\x02" * 64)
    legacy = tmp_path / "legacy.pt"
    torch.save({"model": ema}, legacy, _use_new_zipfile_serialization=False)
    for p in (junk, legacy):
        with pytest.raises(ValueError, match=rf"{p.name}: not a torch zip archive"):
            read_reference_checkpoint(p)
        with pytest.raises(ValueError, match=rf"{p.name}: not a torch zip archive"):
            Engine("tamtr-nano.yaml", device="cpu").load(p)
    tree = tmp_path / "tree.pt"
    torch.save({"model": Path("x"), "ema": None}, tree)
    with pytest.raises(ValueError, match=r"tree\.pt: its ema / model entry is pathlib\.\w*Path"):
        read_reference_checkpoint(tree)
    loop = torch.nn.Sequential(torch.nn.Linear(2, 2))
    loop._modules["again"] = loop
    torch.save({"model": loop, "ema": None}, tmp_path / "loop.pt")
    with pytest.raises(ValueError, match=r"loop\.pt: module again\. holds itself"):
        read_reference_checkpoint(tmp_path / "loop.pt")
    fused = write_reference_checkpoint(tmp_path / "fused.pt", _seeded("tamtr-nano.yaml", 0, deploy=True),
                                       cfg_path="tamtr-nano.yaml")
    with pytest.raises(ValueError) as e:
        Engine("tamtr-nano.yaml", device="cpu").load(fused)
    msg = str(e.value)
    assert msg.startswith(f"{fused}: not a checkpoint of tamtr-nano.yaml at nc={NC}")
    assert "unmapped_torch: 36 keys" in msg and "missing_params: 180 keys" in msg
    assert "first ['model.2.cv2.0.m.0.cv1.fused.weight', 'model.2.cv2.0.m.0.cv1.fused.bias'," in msg
    assert "first ['model.2.cv2.0.m.0.cv1.conv1.conv.weight', 'model.2.cv2.0.m.0.cv1.conv1.bn.weight'," in msg
    assert msg.count("', '") == 8  # five keys of each list
    small = write_reference_checkpoint(tmp_path / "nc3.pt", _seeded("tamtr-nano.yaml", 0, nc=3),
                                       cfg_path="tamtr-nano.yaml")
    with pytest.raises(ValueError, match=r"nc3\.pt: .*shape_mismatch: 3 keys.*denoising_class_embed"):
        Engine("tamtr-nano.yaml", device="cpu").load(small, nc=NC)


def test_port_checkpoints_stay_weights_only(nano, tmp_path):
    """The port's own `.pt` is no reference checkpoint: it loads through
    `torch.load(weights_only=True)` as before, with its model config, in
    the engine and in the facade."""
    ema, _, _ = nano
    path = tmp_path / "port.pt"
    meta = {"nc": NC, "names": VISDRONE, "model_cfg": "tamtr-nano.yaml", "imgsz": 64, "max_gt": 128}
    torch.save({"trainer": {"ema": ema.state_dict()}, "meta": meta}, path)
    assert not is_reference_checkpoint(path)
    eng = Engine("tamtr.yaml", device="cpu").load(path)
    assert eng.model_cfg == "tamtr-nano.yaml" and eng.names == VISDRONE
    from tamtr_torch import TAMTR

    assert TAMTR(str(path), device="cpu").model_cfg == "tamtr-nano.yaml"  # the facade takes the file's config
    with pytest.raises(ValueError, match=r"port\.pt: its ema / model entry is NoneType"):
        read_reference_checkpoint(path)


def test_tool_output_through_autobackend(full, loaded, tmp_path):
    """`tools/port_torch_weights_torch.py` writes the port's "torch" layout:
    AutoBackend reads it and gives `Engine.load`'s forward; AutoBackend
    refuses the reference file naming Engine.load; --export raises naming
    the reference's classes."""
    out = tmp_path / "port.pt"
    assert port_torch_weights_torch.main([str(full[0]), str(out)]) == 0
    assert not is_reference_checkpoint(out)
    ab = AutoBackend(str(out), device="cpu")
    assert ab.names == VISDRONE and ab.nc == NC and ab.imgsz == 640
    img = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(3))
    got = ab(img.numpy(), loaded.txt_feats[None])
    np.testing.assert_array_equal(got, _forward(loaded.model, loaded.txt_feats).numpy())
    with pytest.raises(RuntimeError, match=r"last\.pt: a reference .*Engine\.load.*port_torch_weights_torch"):
        AutoBackend(str(full[0]), device="cpu")
    with pytest.raises(NotImplementedError, match="RTDETRDetectionWorldModel"):
        port_torch_weights_torch.main(["--export"])
    with pytest.raises(ValueError, match="not a reference checkpoint"):
        port_torch_weights_torch.port(out, tmp_path / "again.pt")


def test_facade_and_cli_load_the_file(full, loaded, tmp_path, capsys):
    """`TAMTR(<file>.pt)` (the reference's `RTDETRWorld("TAM_TR.pt")`) and
    `python -m tamtr_torch predict model=<file>.pt` load the reference file
    through `Engine.load`; nothing of ultralytics or timm is imported or
    left in `sys.modules` (h)."""
    from tamtr_torch import RTDETRWorld
    from tamtr_torch.cli import main

    det = RTDETRWorld(str(full[0]), device="cpu")
    assert det.nc == NC and det._engine.names == VISDRONE
    got = det.model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in loaded.model.state_dict().items())
    main(["predict", f"model={full[0]}", f"source={REPO / 'tests/torch_data/jpeg/exif6_q90.jpg'}", "imgsz=64",
          "device=cpu", "conf=0.0"])
    assert capsys.readouterr().out.strip().endswith("exif6_q90.jpg: 100 detections")
    assert not [m for m in sys.modules if m.split(".")[0] in ("ultralytics", "timm")]
