"""The deploy fuse (`tamtr_torch/nn/fuse.py`) and `fuse=` in the engine, on
the CPU, against the JAX package's `tamtr_tpu/nn/fuse.py`: blocks with
randomised BatchNorm statistics (2e-5, `tests/test_fuse.py`'s bound), the
fused kernels against JAX's `fuse_repconv_variables` (1e-6), the whole nano
model against JAX's deploy model (1e-3 as a tie-robust set), predict with
and without fuse (1e-4), a twin that follows the weights through training,
and half=True with and without fuse."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from tamtr_tpu.nn import layers as JL
from tamtr_tpu.nn.fuse import fuse_repconv_variables
from tamtr_torch.config import get_cfg
from tamtr_torch.engine.model import Engine
from tamtr_torch.nn import layers as PL
from tamtr_torch.nn.fuse import fuse_conv_bn, fuse_model
from tamtr_torch.nn.graph import TAMTRModel as PortModel
from tamtr_torch.weights import _flatten_tree, from_jax_variables, map_torch_key

from torch_engine_data import IMG, NAMES, NC, jax_nano_session, one_thread, unit_text  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import smoke_train_torch  # noqa: E402


def _randomize_bn(tree, rng):
    """The BatchNorm statistics and affine of a flax variables tree given
    spread values, so that folding is tested (`tests/test_fuse.py:
    _randomize_bn`); every other leaf as it is."""
    def walk(node, path=()):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if not any(p == "BatchNorm_0" or p.endswith("_bn") for p in path):
            return np.asarray(node)
        leaf = path[-1]
        if leaf in ("mean", "bias"):
            return rng.normal(0, 0.3, node.shape).astype(np.float32)
        if leaf == "var":
            return rng.uniform(0.5, 2.0, node.shape).astype(np.float32)
        if leaf == "scale":
            return rng.uniform(0.5, 1.5, node.shape).astype(np.float32)
        return np.asarray(node)

    return walk(tree)


def _load_block(block, variables):
    """The flax variables of a block into the port's block, through the
    weight bridge's key map (the block standing as graph layer 0)."""
    trees = {col: _flatten_tree({"m0_X": variables.get(col, {})}) for col in ("params", "batch_stats")}
    sd = {}
    for k, t in block.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = t
            continue
        col, path, _ = map_torch_key(f"model.0.{k}", tuple(t.shape), {0: "X"}, head_index=99)
        v = np.asarray(trees[col][tuple(path)])
        sd[k] = torch.from_numpy(np.ascontiguousarray(v.transpose(3, 2, 0, 1) if v.ndim == 4 else v))
    block.load_state_dict(sd)
    return block.eval()


@pytest.mark.parametrize("kind", ["RepConvN", "RepNCSPELAN4"])
def test_block_fusion_matches_unfused_and_jax(kind):
    rng = np.random.default_rng(0 if kind == "RepConvN" else 1)
    if kind == "RepConvN":
        jm, jd, pm, cin, hw = JL.RepConvN(8), JL.RepConvN(8, deploy=True), PL.RepConvN(8, 8), 8, 16
    else:
        jm, jd = JL.RepNCSPELAN4(16, 16, 8, n=1), JL.RepNCSPELAN4(16, 16, 8, n=1, deploy=True)
        pm, cin, hw = PL.RepNCSPELAN4(12, 16, 16, 8, n=1), 12, 8
    x = rng.normal(size=(2, hw, hw, cin)).astype(np.float32)
    v = _randomize_bn(jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))), rng)
    want_jax = np.asarray(jd.apply(fuse_repconv_variables(v), jnp.asarray(x), False))
    pm = _load_block(pm, v)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        plain = pm(xt).permute(0, 2, 3, 1).numpy()
        fused = fuse_model(pm)(xt).permute(0, 2, 3, 1).numpy()
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in fuse_model(pm).modules())
    np.testing.assert_allclose(fused, plain, atol=2e-5)
    np.testing.assert_allclose(fused, want_jax, atol=2e-5)
    assert not pm.deploy if kind == "RepConvN" else not pm.cv2[0].m[0].cv1.deploy  # the source is unchanged


def test_folded_convbn_matches_unfolded():
    torch.manual_seed(0)
    m = PL.ConvBN(6, 10, 3, 2).eval()
    with torch.no_grad():
        m.bn.running_mean.normal_(0, 0.3)
        m.bn.running_var.uniform_(0.5, 2.0)
        m.bn.weight.uniform_(0.5, 1.5)
        m.bn.bias.normal_(0, 0.3)
        x = torch.randn(2, 6, 17, 13)
        want = m.bn(m.conv(x))
        got = fuse_conv_bn(m.conv, m.bn)(x)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


@pytest.fixture(scope="module")
def jax_nano(tmp_path_factory):
    model, params, batch_stats = jax_nano_session(tmp_path_factory)
    rng = np.random.default_rng(7)
    batch_stats = _randomize_bn(batch_stats, rng)
    spread = _randomize_bn({"p": params}, rng)["p"]  # BN scales and biases spread too
    return model, spread, batch_stats


@pytest.fixture(scope="module")
def port_nano(jax_nano):
    _, params, batch_stats = jax_nano
    model = PortModel.from_cfg("tamtr-nano.yaml", nc=NC)
    sd, report = from_jax_variables(params, batch_stats, model)
    assert not any(report.values()), report
    model.load_state_dict(sd)
    return model.eval()


def test_fused_kernels_equal_jax_fuse_repconv_variables(jax_nano, port_nano):
    """Every RepConvN's fused 3x3 kernel and bias equal those of JAX's
    `fuse_repconv_variables` (HWIO -> OIHW) within 1e-6, and JAX's deploy
    variables load through the bridge into a deploy-built port model with
    nothing missing or unused."""
    _, params, batch_stats = jax_nano
    fused_vars = jax.device_get(fuse_repconv_variables({"params": params, "batch_stats": batch_stats}))
    deploy = PortModel.from_cfg("tamtr-nano.yaml", nc=NC, deploy=True)
    sd, report = from_jax_variables(fused_vars["params"], fused_vars["batch_stats"], deploy)
    assert not any(report.values()), report
    twin = fuse_model(port_nano).state_dict()
    keys = [k for k in sd if ".fused." in k]
    assert len(keys) == 2 * 18  # 18 RepConvN blocks, weight and bias
    for k in keys:
        np.testing.assert_allclose(twin[k].numpy(), sd[k].numpy(), atol=1e-6, rtol=0)


def _same_set(pred, want, atol):
    for b in range(pred.shape[0]):
        dist = np.abs(pred[b][:, None] - want[b][None]).max(-1)
        rows, cols = linear_sum_assignment(dist)
        matched = dist[rows, cols] < atol
        assert matched.sum() >= len(matched) - 2, np.sort(dist[rows, cols])[-3:]
        if not matched.all():  # only boundary ties: their best scores agree
            np.testing.assert_allclose(np.sort(pred[b][rows[~matched], 4:].max(-1)),
                                       np.sort(want[b][cols[~matched], 4:].max(-1)), atol=5e-3)


def test_whole_fused_model_matches_jax_deploy_model(jax_nano, port_nano):
    from tamtr_tpu.nn.graph import TAMTRModel as JaxModel

    _, params, batch_stats = jax_nano
    fused_vars = fuse_repconv_variables({"params": params, "batch_stats": batch_stats})
    deploy = JaxModel.from_yaml("tamtr-nano.yaml", nc=NC, deploy=True)
    rng = np.random.default_rng(6)
    img = rng.random((2, IMG, IMG, 3), dtype=np.float32)
    txt = unit_text()[None]
    want = np.asarray(jax.jit(lambda v, i, t: deploy.apply(v, i, t, None, False)["pred"])(
        fused_vars, jnp.asarray(img), jnp.asarray(txt)))
    with torch.no_grad():
        got = fuse_model(port_nano)(torch.from_numpy(img), torch.from_numpy(txt))["pred"].numpy()
    assert got.shape == want.shape and want[..., 4:].std() > 0.05
    _same_set(got, want, 1e-3)


def _rows(r):
    oh, ow = r.orig_shape
    b = r.boxes.xyxy / np.array([ow, oh, ow, oh], np.float32)
    return np.concatenate([b, r.boxes.conf[:, None], r.boxes.cls[:, None].astype(np.float32)], 1)


def _assert_same_detections(got, want, atol=1e-4):
    for g, w in zip(got, want, strict=True):
        assert len(g) == len(w), g.path
        if len(w):
            gr, wr = _rows(g), _rows(w)
            dist = np.abs(gr[:, None] - wr[None]).max(-1)
            r, c = linear_sum_assignment(dist)
            assert dist[r, c].max() < atol, (g.path, dist[r, c].max())
            np.testing.assert_array_equal(gr[r, 5], wr[c, 5])


@pytest.fixture(scope="module")
def train_data(tmp_path_factory):
    return smoke_train_torch.make_dataset(tmp_path_factory.mktemp("fuse_train"), 4, 2, IMG)


def test_predict_fused_equals_unfused_and_follows_training(train_data, tmp_path):
    """`Engine.predict(fuse=True)` equals fuse=False within 1e-4 after each
    of two epochs of one training run, whose second epoch updates the same
    EMA model in place: the twin is built again, not reused stale. The
    engine's models stay unfused, and the epoch after a fused predict
    trains."""
    images = str(Path(train_data).parent / "val" / "images")
    eng = Engine("tamtr-nano.yaml", device="cpu")
    seen = []

    def predict_both(e, epoch, row):
        fused = e.predict(images, imgsz=IMG, conf=0.0, fuse=True)
        _assert_same_detections(fused, e.predict(images, imgsz=IMG, conf=0.0))
        assert all(not m.deploy for m in e.trainer.ema.modules() if isinstance(m, PL.RepConvN))
        assert all(not m.deploy for m in e.trainer.model.modules() if isinstance(m, PL.RepConvN))
        seen.append((e._fused[1], _rows(fused[0])))

    eng.callbacks.add("on_fit_epoch_end", predict_both)
    # warmup over 50 minibatches: the optimizer steps at minibatches 0 and 2
    eng.train(data=str(train_data), epochs=2, batch=2, imgsz=IMG, max_gt=8, warmup_epochs=50, workers=0,
              val=False, plots=False, project=str(tmp_path), name="run")
    assert len(seen) == 2 and seen[0][0] is not seen[1][0]
    assert seen[0][1].shape != seen[1][1].shape or not np.array_equal(seen[0][1], seen[1][1])
    assert eng.trainer.last_opt == 2  # an optimizer step in the second epoch, after the first's fused predict


def test_fused_val_and_track_equal_unfused(port_nano, train_data):
    """val and track run the fused twin under fuse=True, with the unfused
    model's results: equal mAP within 1e-4, the same track ids."""
    from tamtr_torch.trackers.byte_tracker import Track

    eng = Engine("tamtr-nano.yaml", device="cpu")
    eng.model = port_nano
    eng.set_classes(NAMES, unit_text())
    args = dict(data=str(train_data), imgsz=IMG, batch=2, conf=0.01, workers=1, plots=False)
    plain, fused = eng.val(**args), eng.val(fuse=True, **args)
    for k in ("mAP50", "mAP50-95", "precision", "recall"):
        assert abs(plain[k] - fused[k]) <= 1e-4, k
    frames = str(Path(train_data).parent / "val" / "images")
    Track.reset_id()
    a = eng.track(frames, imgsz=IMG, conf=0.01)
    Track.reset_id()
    b = eng.track(frames, imgsz=IMG, conf=0.01, fuse=True)
    assert [r.track_ids.tolist() for r in a] == [r.track_ids.tolist() for r in b]
    _assert_same_detections(b, a)


def test_half_raises_naming_its_roadmap_entry(port_nano, train_data, tmp_path):
    """half=True used to raise naming ROADMAP queue A item 5, the bf16 path;
    that item is ported now, so predict, track and val run with half=True,
    with and without fuse=True, on a twin computing in bf16 that shares or
    folds the fp32 weights and leaves the model's own dtype alone (parity
    with JAX's bf16 model: `tests/test_torch_bf16.py`)."""
    eng = Engine("tamtr-nano.yaml", device="cpu")
    eng.model = port_nano
    eng.set_classes(NAMES, unit_text())
    images = str(Path(train_data).parent / "val" / "images")
    for fuse in (False, True):
        plain = eng.predict(images, imgsz=IMG, conf=0.01)
        half = eng.predict(images, imgsz=IMG, conf=0.01, half=True, fuse=fuse)
        twin = eng._eval_model(port_nano, get_cfg(overrides={"half": True, "fuse": fuse}))
        assert twin.dtype == torch.bfloat16 and port_nano.dtype == torch.float32
        assert (twin.model is port_nano.model) != fuse  # the unfused twin shares the modules
        assert len(half) == len(plain) and sum(len(r) for r in half) > 0
        assert len(eng.track(images, imgsz=IMG, half=True, fuse=fuse)) == len(plain)
        metrics = eng.val(data=str(train_data), imgsz=IMG, half=True, fuse=fuse, plots=False)
        assert metrics and all(np.isfinite(v) for v in metrics.values())
