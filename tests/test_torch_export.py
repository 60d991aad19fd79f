"""The port's exporter (`tamtr_torch/engine/exporter.py`) and the load side
of its `AutoBackend` on the CPU, at nano size: each port format, fp32 and
half, back through `AutoBackend(device="cpu")` within 2e-5 of the live
forward (the JAX package's bound, `tests/test_autobackend.py:51,57`); the
exported program holding kernels B1 and B2 as `tamtr::` op nodes;
`torch.library.opcheck` on both ops; the raise cases; and
`to_jax_variables` inverting `from_jax_variables` bitwise on every head
family's JAX variables. The comparisons with the JAX package's exporter are
in `tests/test_torch_export_jax.py`."""

import json

import numpy as np
import pytest
import torch

from tamtr_torch.engine.exporter import FORMATS, export_model, program_of
from tamtr_torch.nn.autobackend import AutoBackend
from tamtr_torch.nn.graph import TAMTRModel
from tamtr_torch.weights import from_jax_variables, init_parameters, to_jax_variables

from torch_engine_data import (HEADS, HEAD_NC, IMG, NC, classify_narrow_cfg, one_thread, spread_tamtr,  # noqa: F401
                               variant_cfg, yolo_narrow_cfg, yolo_task_cfg)

PORT_FORMATS = ("torch", "npz", "torch_export")


def _inputs(width: int):
    img = np.random.default_rng(1).random((1, IMG, IMG, 3), dtype=np.float32)
    txt = np.random.default_rng(2).standard_normal((1, NC, width)).astype(np.float32)
    return img, txt / np.linalg.norm(txt, axis=-1, keepdims=True)


def _forward(module, img, txt):
    with torch.no_grad():
        return module(torch.from_numpy(img), torch.from_numpy(txt)).numpy()


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The seeded, spread nano model at nc 3 and its six artifacts: each
    port format, fp32 and half, exported on the CPU."""
    root = tmp_path_factory.mktemp("export")
    model = TAMTRModel.from_cfg("tamtr-nano.yaml", nc=NC)
    init_parameters(model, 0)
    model = spread_tamtr(model.eval())
    meta = {"nc": NC, "names": ["a", "b", "c"], "model_cfg": "tamtr-nano.yaml", "imgsz": IMG, "max_gt": 128}
    paths = {(fmt, half): export_model(model, IMG, NC, root / f"{fmt}{int(half)}", fmt, half=half, meta=meta)
             for fmt in PORT_FORMATS for half in (False, True)}
    return model, paths, {}


def _backend(artifacts, fmt, half):
    """`AutoBackend` of one artifact on the CPU, loaded once a module."""
    _, paths, loaded = artifacts
    if (fmt, half) not in loaded:
        loaded[fmt, half] = AutoBackend(paths[fmt, half], model_cfg="tamtr-nano.yaml", nc=NC, device="cpu")
    return loaded[fmt, half]


def _rounded(model, dtype):
    """A copy of `model` with every float tensor of its state rounded to
    `dtype` and back."""
    import copy

    twin = copy.deepcopy(model)
    with torch.no_grad():
        for t in twin.state_dict().values():
            if t.is_floating_point():
                t.copy_(t.to(dtype).float())
    return twin


@pytest.mark.parametrize("fmt", PORT_FORMATS)
def test_format_round_trips_through_autobackend(artifacts, fmt):
    model = artifacts[0]
    img, txt = _inputs(model.text_width)
    want = _forward(program_of(model), img, txt)
    ab = _backend(artifacts, fmt, False)
    assert ab.backend == ("torch_export" if fmt == "torch_export" else "torch")
    got = ab(img, txt)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-5)
    if fmt != "npz":  # the npz archive carries no meta, as JAX's
        assert ab.nc == NC and ab.names == ["a", "b", "c"] and ab.imgsz == IMG


@pytest.mark.parametrize("fmt", PORT_FORMATS)
def test_half_format_round_trips_through_autobackend(artifacts, fmt):
    """half=True: the weights stored in bf16 ("torch", "torch_export") or
    float16 ("npz"); loaded back they compute as the live forward of the
    same weights rounded (`torch_export`: as JAX's half program, the eager
    `program_of(model, half=True)`), within 2e-5. The npz archive is under
    0.75 of the fp32 one's size, as JAX's `test_quantized_exports` has it."""
    model, paths, _ = artifacts
    img, txt = _inputs(model.text_width)
    path = paths[fmt, True]
    ab = _backend(artifacts, fmt, True)
    if fmt == "torch_export":
        want = _forward(program_of(model, half=True), img, txt)
        assert {t.dtype for t in ab.model.state_dict().values()} == {torch.bfloat16}
    else:
        want = _forward(program_of(_rounded(model, torch.bfloat16 if fmt == "torch" else torch.float16)), img, txt)
        if fmt == "torch":
            ema = torch.load(path, weights_only=True)["trainer"]["ema"]
            assert {t.dtype for t in ema.values() if t.is_floating_point()} == {torch.bfloat16}
        else:
            with np.load(path) as data:
                assert {data[k].dtype for k in data.files} == {np.dtype(np.float16)}
            assert path.stat().st_size < 0.75 * paths[fmt, False].stat().st_size
    np.testing.assert_allclose(ab(img, txt), want, atol=2e-5)


def test_exported_program_holds_the_kernel_ops(artifacts):
    """B1 and B2 are single nodes of the loaded program, 3 each a forward
    (three VSS levels, three decoder layers), so on the card they launch
    the hand-written kernels; their counters count inside the op."""
    for half in (False, True):
        program = _backend(artifacts, "torch_export", half).model
        targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
        assert targets.count("tamtr.ss2d_scan_fwd.default") == 3
        assert targets.count("tamtr.bilinear_gather_fwd.default") == 3


def _scan_args(dtype):
    from tamtr_torch.kernels.selective_scan import SS2D_STATES

    g = torch.Generator().manual_seed(0)
    B, L, D, R, N = 1, 24, 32, 4, SS2D_STATES
    seq = lambda *s: (torch.randn(*s, generator=g) * 0.5).to(dtype)  # noqa: E731
    return (seq(B, 2, L, D), seq(B, 2, 2, L, R), torch.randn(4, D, R, generator=g) * 0.3, torch.randn(4, D, generator=g),
            -torch.rand(4, D, N, generator=g) - 0.1, seq(B, 2, 2, L, N), seq(B, 2, 2, L, N), torch.randn(4, D, generator=g))


def _gather_args(dtype):
    g = torch.Generator().manual_seed(1)
    B, Lv, nh, c, Q, P = 1, 40, 2, 8, 3, 4
    idx2 = torch.randint(0, Lv, (B, Q * P * 2, nh), generator=g, dtype=torch.int32)
    idx4 = torch.stack([idx2, (idx2 + 1).clamp(max=Lv - 1)], 2).reshape(B, Q * P * 4, nh)
    return torch.randn(B, Lv, nh, c, generator=g).to(dtype), idx4, torch.rand(B, Q * P * 2, nh, 2, generator=g), idx2, P


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("op", ["ss2d_scan_fwd", "bilinear_gather_fwd"])
def test_opcheck(op, dtype):
    """The registered ops' schema, fake implementations (bf16 in, bf16 out;
    B1's `y_dtype`) and dispatch pass `torch.library.opcheck` on the CPU."""
    from tamtr_torch.kernels.deform_scatter import bilinear_gather_fwd_op
    from tamtr_torch.kernels.selective_scan import ss2d_scan_fwd_op

    if op == "ss2d_scan_fwd":
        args = _scan_args(dtype)
        torch.library.opcheck(ss2d_scan_fwd_op, args)
        torch.library.opcheck(ss2d_scan_fwd_op, args + (torch.float32,))
        assert ss2d_scan_fwd_op(*args, torch.float32).dtype == torch.float32
        assert ss2d_scan_fwd_op(*args).dtype == dtype
    else:
        torch.library.opcheck(bilinear_gather_fwd_op, _gather_args(dtype))
        assert bilinear_gather_fwd_op(*_gather_args(dtype)).dtype == dtype


@pytest.mark.parametrize("fmt", FORMATS + ("orbax", "stablehlo"))
def test_int8_raises_for_every_format(fmt, tmp_path):
    """int8 is a tflite-only flag in JAX, and tflite needs tensorflow."""
    model = TAMTRModel.from_cfg("tamtr-nano.yaml", nc=NC)
    with pytest.raises((ValueError, RuntimeError)):
        export_model(model, IMG, NC, tmp_path, fmt, int8=True)


@pytest.mark.parametrize("fmt,error,match", [
    ("savedmodel", RuntimeError, "tensorflow"), ("tflite", RuntimeError, "tensorflow"),
    ("pb", RuntimeError, "tensorflow"), ("onnx", RuntimeError, "tf2onnx"),
    ("orbax", ValueError, "'torch'"), ("stablehlo", ValueError, "'torch_export'"), ("bogus", ValueError, "valid"),
])
def test_formats_the_port_does_not_write_raise(fmt, error, match, tmp_path):
    model = TAMTRModel.from_cfg("tamtr-nano.yaml", nc=NC)
    with pytest.raises(error, match=match):
        export_model(model, IMG, NC, tmp_path, fmt)
    assert not any(tmp_path.iterdir())  # nothing written


def test_autobackend_refuses_what_it_cannot_load(artifacts, tmp_path):
    paths = artifacts[1]
    for name, match in (("model.stablehlo", "jax"), ("model.tflite", "tensorflow"), ("model.pb", "tensorflow"),
                        ("model.onnx", "onnxruntime")):
        with pytest.raises(RuntimeError, match=match):
            AutoBackend(str(tmp_path / name), device="cpu")
    (tmp_path / "saved_model").mkdir()
    (tmp_path / "saved_model" / "saved_model.pb").write_bytes(b"")
    (tmp_path / "model_orbax").mkdir()
    with pytest.raises(RuntimeError, match="tensorflow"):
        AutoBackend(str(tmp_path / "saved_model"), device="cpu")
    with pytest.raises(RuntimeError, match="orbax"):
        AutoBackend(str(tmp_path / "model_orbax"), device="cpu")
    with pytest.raises(ValueError, match="nc"):  # an npz carries no meta: nc must be given, as in JAX
        AutoBackend(str(paths["npz", False]), model_cfg="tamtr-nano.yaml", device="cpu")
    with pytest.raises(ValueError, match="does not hold"):  # an archive of another config
        AutoBackend(str(paths["npz", False]), model_cfg="yolo-gelan.yaml", nc=NC, device="cpu")
    # a program captured on the CPU is refused on the card, never moved there
    with pytest.raises(RuntimeError, match="exported on cpu"):
        AutoBackend(str(paths["torch_export", False]), device="cuda")


def _configs(root):
    """Every head family `Engine` builds, at its test size: (config path,
    text width)."""
    cfgs = {"yolo": yolo_narrow_cfg(), "segment": yolo_task_cfg("Segment"), "pose": yolo_task_cfg("Pose"),
            "classify": classify_narrow_cfg(), **{h: variant_cfg(h) for h in HEADS if h != "RTDETRDecoder"}}
    out = {"tamtr-nano": "tamtr-nano.yaml", "rtdetr": "rtdetr.yaml"}
    for name, cfg in cfgs.items():
        path = root / f"{name}.json"
        path.write_text(json.dumps(cfg))
        out[name] = str(path)
    return out


FAMILIES = ["tamtr-nano", "yolo", "rtdetr", "segment", "pose", "classify"] + [h for h in HEADS if h != "RTDETRDecoder"]


@pytest.mark.parametrize("family", FAMILIES)
def test_to_jax_variables_inverts_from_jax_variables(family, tmp_path):
    """The JAX model's variables (shapes from `jax.eval_shape` of its init,
    values from a numpy seed) -> `from_jax_variables` -> the port model ->
    `to_jax_variables`: the same leaves, bitwise."""
    import jax
    import jax.numpy as jnp

    from tamtr_tpu.nn.graph import TAMTRModel as JaxModel

    path = _configs(tmp_path)[family]
    nc = HEAD_NC if family in HEADS else NC
    port = TAMTRModel.from_cfg(path, nc=nc)
    jm = JaxModel.from_yaml(path, nc=nc)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, IMG, IMG, 3)),
                                            jnp.zeros((1, nc, port.text_width)), None, False))
    rng = np.random.default_rng(0)
    leaves, tree = jax.tree_util.tree_flatten(shapes)
    variables = jax.tree_util.tree_unflatten(tree, [rng.standard_normal(s.shape).astype(np.float32) for s in leaves])
    sd, report = from_jax_variables(variables["params"], variables["batch_stats"], port)
    assert report == {"missing": [], "shape_mismatch": [], "unused_jax": []}
    port.load_state_dict(sd)
    back = to_jax_variables(port)
    want = jax.tree_util.tree_flatten_with_path(variables)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, g), (_, w) in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape and np.array_equal(g, w), p
