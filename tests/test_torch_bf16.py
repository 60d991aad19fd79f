"""The port's bf16 compute path on the CPU against the JAX package's at
bf16 (`tamtr_tpu/nn/graph.py:TAMTRModel.dtype`): the plain SS2D scan and
bilinear gather at bf16 I/O, the dtype of every island of the nano model,
the eval forward with `half=True` (and fused), the engine's `half=True`
and `bf16=True`, and a data-parallel bf16 step. The training step at bf16
is `tests/test_torch_bf16_step.py`. The same inputs, from numpy seeds, go
to both packages; each bound and the readings it was set on stand beside
the test.
"""

import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from tamtr_torch.kernels.deform_scatter import bilinear_gather
from tamtr_torch.kernels.selective_scan import ss2d_scan
from tamtr_torch.nn.decoder import deform_sampling_pairs
from tamtr_torch.nn.graph import TAMTRModel as PortModel
from tamtr_torch.parallel.seq_scan import LocalBlocks, ss2d_scan_sp
from tamtr_torch.weights import from_jax_variables
from torch_engine_data import IMG, NAMES, NC, jax_nano_session, one_thread, unit_text  # noqa: F401

BF = torch.bfloat16
SEQ = (0, 1, 5, 6)  # the scan's sequence tensors: layouts, dts_raw, Bs, Cs


def ss2d_inputs(seed, B=2, L=24, D=16, N=4, R=4):
    """`tests/test_torch_seq_parallel.py`'s inputs (fp32 numpy) and a dy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    args = [f(B, 2, L, D), f(B, 2, 2, L, R), f(4, D, R) * 0.1, f(4, D) * 0.1,
            -np.exp(f(4, D, N) * 0.3), f(B, 2, 2, L, N), f(B, 2, 2, L, N), f(4, D)]
    return args, f(B, 4, L, D)


def bf16_steps(got: np.ndarray, want: np.ndarray, floor: float) -> float:
    """The largest |got - want| in units of one bf16 step (2^-7 of the
    larger magnitude's power of two) beyond an absolute `floor`."""
    mag = np.maximum(np.abs(got), np.abs(want))
    step = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    return float((np.maximum(np.abs(got - want) - floor, 0) / step).max())


def rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _scan_case(port_scan, seed):
    """The port's `port_scan` and JAX's `ss2d_scan_xla`, both at bf16
    sequence I/O on the same bf16 inputs: (y, grads) of each."""
    from tamtr_tpu.kernels.selective_scan import ss2d_scan_xla

    args, w = ss2d_inputs(seed)
    bf = jnp.bfloat16
    jargs = [jnp.asarray(a).astype(bf) if i in SEQ else jnp.asarray(a) for i, a in enumerate(args)]
    dy = jnp.asarray(w).astype(bf)
    y_j, vjp = jax.vjp(lambda *a: ss2d_scan_xla(*a, chunk=8), *jargs)
    g_j = vjp(dy)
    ts = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(BF if i in SEQ else torch.float32).requires_grad_()
          for i, a in enumerate(jargs)]
    y_t = port_scan(*ts)
    g_t = torch.autograd.grad(y_t, ts, torch.from_numpy(np.array(dy.astype(jnp.float32))).to(BF))
    assert y_t.dtype == BF and y_j.dtype == bf
    for i, (t, gt, gj) in enumerate(zip(ts, g_t, g_j)):
        assert gt.dtype == t.dtype and gj.dtype == jargs[i].dtype, i  # every cotangent in its primal's dtype
    f32 = lambda x: np.asarray(x.float().detach().numpy() if torch.is_tensor(x) else x.astype(jnp.float32))  # noqa: E731
    return f32(y_t), f32(y_j), [f32(g) for g in g_t], [f32(g) for g in g_j]


@pytest.mark.parametrize("scan", ["ss2d_scan", "ss2d_scan_sp n=2"])
def test_plain_ss2d_scan_bf16_matches_jax(scan):
    """y within one bf16 step beyond 2^-12 absolute (both compute in fp32
    and round once; the floor covers the fp32 sums' cancellation near 0);
    the gradients within 1% of JAX's bf16 gradients over the tensor's norm
    for the layouts, 1e-4 for the other seven (JAX's own bf16-vs-fp32
    bounds are atol 0.3 / rtol 0.15, `tests/test_pallas_scan.py:196-202`).
    Readings, both cases: y bitwise (0 steps); the layouts' gradient 0.35%
    (JAX's XLA backward rounds du once with the D-skip in it, the port adds
    the D-skip to the bf16 du as JAX's Pallas backward does,
    `selective_scan.py:887`), dts_raw, Bs and Cs bitwise, the fp32
    parameter gradients 2.5e-7 and below."""
    fn = ss2d_scan if scan == "ss2d_scan" else (lambda *a: ss2d_scan_sp(*a, LocalBlocks(2)))
    y_t, y_j, g_t, g_j = _scan_case(fn, 3)
    steps = bf16_steps(y_t, y_j, 2.0**-12)
    errs = [rel(a, b) for a, b in zip(g_t, g_j)]
    print(f"{scan}: y {steps} bf16 steps; gradients (relative): {errs}")
    assert steps <= 1.0, steps
    assert errs[0] < 1e-2 and max(errs[1:]) < 1e-4, errs


@pytest.mark.parametrize("N,D", [(24, 40), (48, 64)])
def test_ss2d_pieces_bf16_round_once_as_jax(N, D):
    """bf16 sequences at a state size the kernels take in groups of 16
    lanes (`ss2d_pieces`, the plain scan injected where the card runs B1):
    each group writes y in fp32 and the sum is rounded to bf16 once, so y
    is within one bf16 step beyond 2^-12 of JAX's `ss2d_scan_xla` at bf16,
    which rounds once, and of the port's unsplit plain scan. Readings: 0
    steps from both, at N = 24 and 48; with each group's y rounded to bf16
    before the sum, 207 and 243 steps (near-cancelling sums)."""
    from tamtr_tpu.kernels.selective_scan import ss2d_scan_xla
    from tamtr_torch.kernels.selective_scan import _SS2DScan, ss2d_pieces, ss2d_scan_ref

    args, _ = ss2d_inputs(11, N=N, D=D, R=2)
    bf = jnp.bfloat16
    jargs = [jnp.asarray(a).astype(bf) if i in SEQ else jnp.asarray(a) for i, a in enumerate(args)]
    want = np.asarray(ss2d_scan_xla(*jargs, chunk=8).astype(jnp.float32))
    ts = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(BF if i in SEQ else torch.float32)
          for i, a in enumerate(jargs)]
    y = ss2d_pieces(_SS2DScan.apply, *ts)
    assert y.dtype == BF
    got = y.float().numpy()
    steps = (bf16_steps(got, want, 2.0**-12), bf16_steps(got, ss2d_scan_ref(*ts).float().numpy(), 2.0**-12))
    print(f"ss2d_pieces bf16 N={N} D={D}: {steps} bf16 steps from JAX's scan and the unsplit plain scan")
    assert max(steps) <= 1.0, steps


def _gather_case(seed, B=2, Q=6, nh=2, c=8, P=2, shapes=((6, 5), (3, 3))):
    """Inputs of the pair gather with one sample point in the last pixel
    cell of the last level (its pair starts on the global last row)."""
    rng = np.random.default_rng(seed)
    Lv, nl = sum(h * w for h, w in shapes), len(shapes)
    value = rng.standard_normal((B, Lv, nh, c)).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (B, Q, nh, nl, P, 2)).astype(np.float32)
    H, W = shapes[-1]
    loc[0, 0, 0, -1, -1] = (1 - 0.25 / W, 1 - 0.25 / H)
    logits = rng.standard_normal((B, Q, nh, nl * P)).astype(np.float32)
    w_att = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx4, w_pairs, idx2 = deform_sampling_pairs(list(shapes), torch.from_numpy(loc),
                                                torch.from_numpy(w_att.reshape(B, Q, nh, nl, P)))
    assert int(idx2.max()) == Lv - 1
    return value, idx4, w_pairs, idx2, nl * P


def test_plain_bilinear_gather_bf16_matches_jax(monkeypatch):
    """bf16 value through the port's plain gather and its backward against
    JAX's `bilinear_gather` at bf16, at `tests/test_deform_scatter.py:
    169-187`'s bounds: out within 2e-2 and dvalue within 3e-2, both bf16;
    dw fp32 within 5e-2 on the slots with a live corner (a dead slot's dw is
    unspecified, `tests/test_torch_kernels_bwd.py`). JAX runs its XLA path:
    its Pallas backward reads past the block for the pair on the global
    last row that this case holds (ROADMAP queue B, the last-row contract).
    Readings: out 7.8e-3 (one bf16 step: JAX's XLA einsum rounds the
    weights to bf16, the port sums in fp32 and rounds once), dvalue 3.9e-3,
    dw 2.6e-2 (each side's dout = cos(out) rounded to bf16 carries the
    forward's step)."""
    import tamtr_tpu.kernels.deform_scatter as ds

    monkeypatch.setattr(ds, "FORCE_PALLAS", False)
    value, idx4, w_pairs, idx2, P = _gather_case(4)
    v16 = jnp.asarray(value).astype(jnp.bfloat16)
    j_idx4, j_w, j_idx2 = (jnp.asarray(t.numpy()) for t in (idx4, w_pairs, idx2))

    def jloss(v, w):
        return jnp.sum(jnp.sin(ds.bilinear_gather(v, j_idx4, w, j_idx2, P).astype(jnp.float32)))

    out_j = ds.bilinear_gather(v16, j_idx4, j_w, j_idx2, P)
    dv_j, dw_j = jax.grad(jloss, argnums=(0, 1))(v16, j_w)
    vt = torch.from_numpy(value).to(BF).requires_grad_()
    wt = w_pairs.clone().requires_grad_()
    out_t = bilinear_gather(vt, idx4, wt, idx2, P)
    dv_t, dw_t = torch.autograd.grad(torch.sin(out_t.float()).sum(), (vt, wt))
    assert out_t.dtype == BF and out_j.dtype == jnp.bfloat16
    assert dv_t.dtype == BF and dv_j.dtype == jnp.bfloat16 and dw_t.dtype == torch.float32
    live = w_pairs.numpy() != 0
    f = lambda x: np.asarray(x.astype(jnp.float32))  # noqa: E731
    t = lambda x: x.detach().float().numpy()  # noqa: E731
    errs = [float(np.abs(t(out_t) - f(out_j)).max()), float(np.abs(t(dv_t) - f(dv_j)).max()),
            float(np.abs(t(dw_t)[live] - f(dw_j)[live]).max())]
    print(f"bilinear gather at bf16, max |port - jax|: out, dvalue, dw = {errs}")
    assert errs[0] < 2e-2 and errs[1] < 3e-2 and errs[2] < 5e-2, errs


# ---------------------------------------------------------------------------
# the nano model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nano(tmp_path_factory):
    """(JAX model, params, batch_stats, the port model with them)."""
    model, params, batch_stats = jax_nano_session(tmp_path_factory)
    port = PortModel.from_cfg("tamtr-nano.yaml", nc=NC)
    sd, report = from_jax_variables(params, batch_stats, port)
    assert not any(report.values()), report
    port.load_state_dict(sd)
    return model, params, batch_stats, port.eval()


def test_dtype_map_at_bf16(monkeypatch):
    """One train-mode forward, loss and backward of a bf16 nano model: the
    scan's and the gather's inputs and outputs are bf16, and so is a conv's
    and a VSS block's output; every BatchNorm of train mode normalises in
    fp32; `out_norm`, the score logits (contrastive and encoder), the boxes
    and the loss are fp32; every parameter and every gradient is fp32."""
    import tamtr_torch.nn.decoder as pdec
    import tamtr_torch.nn.ssm as pssm
    from tamtr_torch.losses.detr_loss import DETRLossConfig, rtdetr_detection_loss
    from tamtr_torch.nn.decoder import ContrastiveHead
    from tamtr_torch.weights import init_parameters

    seen = {"scan": [], "gather": [], "bn": [], "hooks": {}}
    scan, gather, bn = pssm.ss2d_scan, pdec.bilinear_gather, torch.nn.functional.batch_norm

    def rec_scan(*a):
        y = scan(*a)
        seen["scan"].append(tuple(a[i].dtype for i in SEQ) + (y.dtype,))
        return y

    def rec_gather(value, *a):
        out = gather(value, *a)
        seen["gather"].append((value.dtype, out.dtype))
        return out

    def rec_bn(x, *a, **k):
        seen["bn"].append(x.dtype)
        return bn(x, *a, **k)

    monkeypatch.setattr(pssm, "ss2d_scan", rec_scan)
    monkeypatch.setattr(pdec, "bilinear_gather", rec_gather)
    monkeypatch.setattr(torch.nn.functional, "batch_norm", rec_bn)
    model = PortModel.from_cfg("tamtr-nano.yaml", nc=NC, max_gt=8, dtype=BF)
    init_parameters(model, 0)
    model.train()

    def hook(name):
        def keep(mod, args, out):
            seen["hooks"].setdefault(name, []).append((args[0].dtype, out.dtype))
        return keep

    head = model.model[-1]
    named = {"conv": model.model[0].conv, "vss": head.VSSBlocks[0], "out_norm": head.VSSBlocks[0].op.out_norm,
             "enc_score_head": head.enc_score_head, "input_proj_conv": head.input_proj[0][0]}
    named.update({f"contrastive{i}": m for i, m in enumerate(m for m in head.modules() if isinstance(m, ContrastiveHead))})
    for name, m in named.items():
        m.register_forward_hook(hook(name))
    rng = np.random.default_rng(0)
    tg = {"cls": torch.from_numpy(rng.integers(0, NC, (2, 8))), "mask": torch.arange(8)[None].expand(2, 8) < 5,
          "bboxes": torch.from_numpy(rng.uniform(0.2, 0.6, (2, 8, 4)).astype(np.float32))}
    out = model(torch.rand(2, IMG, IMG, 3, generator=torch.Generator().manual_seed(0)), torch.from_numpy(unit_text()[None]),
                tg, torch.Generator().manual_seed(1))
    loss, _ = rtdetr_detection_loss(out, tg, DETRLossConfig(nc=NC, match_method="scipy"))
    loss.backward()

    assert seen["scan"] and all(d == (BF,) * 5 for d in seen["scan"]), seen["scan"]
    assert seen["gather"] and all(d == (BF, BF) for d in seen["gather"]), seen["gather"]
    assert seen["bn"] and all(d == torch.float32 for d in seen["bn"]), set(seen["bn"])
    h = seen["hooks"]
    assert h["conv"] == [(BF, BF)] and h["vss"] == [(BF, BF)] and h["input_proj_conv"] == [(BF, BF)]
    assert h["out_norm"] == [(torch.float32, torch.float32)]
    assert h["enc_score_head"] == [(torch.float32, torch.float32)]
    assert all(o == torch.float32 for k, v in h.items() if k.startswith("contrastive") for _, o in v)
    for k in ("dec_bboxes", "dec_scores", "enc_bboxes", "enc_scores"):
        assert out[k].dtype == torch.float32, k
    assert loss.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers() if b.is_floating_point())
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert len(grads) > 100 and all(g.dtype == torch.float32 for g in grads)


def set_distance(got: np.ndarray, want: np.ndarray, spare: int = 2) -> float:
    """Two (B, nq, 4 + nc) predictions as sets of rows: per image the rows
    matched one to one by the least max-abs distance (top-k may order or
    pick near-tied queries differently), the `spare` worst matches of each
    image left out as boundary ties; the root mean square of the remaining
    rows' differences over all images."""
    errs = []
    for b in range(got.shape[0]):
        dist = np.abs(got[b][:, None] - want[b][None]).max(-1)
        r, c = linear_sum_assignment(dist)
        keep = np.argsort(dist[r, c])[:len(r) - spare]
        errs.append((got[b][r[keep]] - want[b][c[keep]]).ravel())
    e = np.concatenate(errs)
    return float(np.sqrt(np.mean(e * e)))


@pytest.mark.parametrize("fuse", [False, True], ids=["half", "fuse+half"])
def test_eval_at_bf16_matches_jax(nano, fuse):
    """The port with half=True (the twin `Engine._eval_model` builds) against
    JAX's `model.clone(dtype=jnp.bfloat16)` on the same 8 images, as sets of
    rows (`set_distance`): within twice JAX's own bf16-vs-fp32 distance
    there. With fuse=True both sides are fused (the port folds every
    BatchNorm in fp32, JAX fuses RepConvN, `fuse_repconv_variables`) and
    computed at bf16. Two bf16 computations with their own roundings lie
    about sqrt(2) times one rounding apart; the largest row distance is too
    unsteady for a bound (one image's readings: 0.0175 port-JAX against
    0.0078 JAX-JAX). Readings (RMS, port vs JAX bf16 / JAX bf16 vs fp32):
    0.00479 / 0.00370 unfused, 0.00454 / 0.00420 fused."""
    from tamtr_tpu.nn.fuse import fuse_repconv_variables

    from tamtr_torch.config import get_cfg
    from tamtr_torch.engine.model import Engine

    jmodel, params, batch_stats, port = nano
    variables = {"params": params, "batch_stats": batch_stats}
    if fuse:
        jmodel, variables = jmodel.clone(deploy=True), jax.device_get(fuse_repconv_variables(variables))
    img = np.random.default_rng(6).random((8, IMG, IMG, 3), dtype=np.float32)
    txt = unit_text()[None]
    run = lambda m: np.asarray(jax.jit(lambda v, i, t: m.apply(v, i, t, None, False)["pred"])(  # noqa: E731
        variables, jnp.asarray(img), jnp.asarray(txt)), np.float32)
    want32, want16 = run(jmodel), run(jmodel.clone(dtype=jnp.bfloat16))
    eng = Engine("tamtr-nano.yaml", device="cpu")
    twin = eng._eval_model(port, get_cfg(overrides={"half": True, "fuse": fuse}))
    assert twin.dtype == BF and port.dtype == torch.float32
    with torch.no_grad():
        got = twin(torch.from_numpy(img), torch.from_numpy(txt))["pred"]
    assert got.dtype == torch.float32 and got.shape == want16.shape
    d_port, d_jax = set_distance(got.numpy(), want16), set_distance(want16, want32)
    print(f"{'fused ' if fuse else ''}eval at bf16 (RMS): |port - jax bf16| {d_port}, |jax bf16 - jax fp32| {d_jax}")
    assert 0 < d_jax and d_port <= 2 * d_jax, (d_port, d_jax)
    assert all(p.dtype == torch.float32 for p in twin.parameters())


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bf16_runs(tmp_path_factory):
    """`Engine.train(bf16=True)` on the tiny dataset: two epochs straight,
    and one epoch stopped by SIGINT then resumed for the second."""
    import sys
    from pathlib import Path

    from tamtr_torch.engine.model import Engine

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    import smoke_train_torch

    root = tmp_path_factory.mktemp("bf16_train")
    data = smoke_train_torch.make_dataset(root / "data", 4, 2, IMG)
    kw = dict(data=str(data), epochs=2, batch=2, imgsz=IMG, max_gt=8, warmup_epochs=2, workers=0, conf=0.01,
              plots=False, bf16=True, name="run", exist_ok=True)
    straight = Engine("tamtr-nano.yaml", device="cpu")
    straight.train(project=str(root / "a"), **kw)
    stopped = Engine("tamtr-nano.yaml", device="cpu")
    stopped.callbacks.add("on_fit_epoch_end", lambda e, epoch, row: signal.raise_signal(signal.SIGINT))
    stopped.train(project=str(root / "b"), **kw)
    resumed = Engine("tamtr-nano.yaml", device="cpu")
    resumed.train(project=str(root / "b"), resume=True, **kw)
    return data, root, straight, resumed


def test_train_bf16_keeps_fp32_weights_and_resumes_bitwise(bf16_runs):
    """The trained model and its EMA compute in bf16 and hold fp32 weights,
    the checkpoint holds fp32 weights, and the resumed run is bitwise the
    straight one (parameters, EMA, optimizer state, counters)."""
    _, root, straight, resumed = bf16_runs
    a, b = straight.trainer, resumed.trainer
    assert a.model.dtype == BF and straight.model.dtype == BF
    assert (a.ni, a.count, a.last_opt) == (b.ni, b.count, b.last_opt) and a.ni == 4
    for key in ("model", "ema"):
        sa, sb = a.state_dict()[key], b.state_dict()[key]
        assert all(v.dtype == torch.float32 for v in sa.values() if v.is_floating_point()), key
        assert all(torch.equal(sa[k], sb[k]) for k in sa), key
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i, st in oa["state"].items():
        assert all(torch.equal(v, ob["state"][i][k]) for k, v in st.items())
    ckpt = torch.load(root / "a" / "run" / "weights" / "last.pt", weights_only=False)
    floats = [v for part in ("model", "ema") for v in ckpt["trainer"][part].values() if v.is_floating_point()]
    assert floats and all(v.dtype == torch.float32 for v in floats)


def test_engine_half_val_predict_and_cli(bf16_runs, tmp_path):
    """val and predict with half=True on the trained checkpoint, and the
    CLI's predict with half=True, run: the detections and metrics of the
    bf16 twin lie near the fp32 model's."""
    from tamtr_torch import cli
    from tamtr_torch.engine.model import Engine

    data, root, _, _ = bf16_runs
    best = root / "a" / "run" / "weights" / "best.pt"
    eng = Engine("tamtr-nano.yaml", device="cpu").load(best)
    assert eng.model.dtype == torch.float32
    m32 = eng.val(data=str(data), plots=False, conf=0.01)
    m16 = eng.val(data=str(data), plots=False, conf=0.01, half=True)
    assert set(m16) == set(m32) and all(np.isfinite(v) for v in m16.values())
    images = str(data.parent / "val" / "images")
    r32, r16 = eng.predict(images, imgsz=IMG, conf=0.01), eng.predict(images, imgsz=IMG, conf=0.01, half=True)
    assert len(r16) == len(r32) and eng.model.dtype == torch.float32
    for a, b in zip(r16, r32):
        n = min(len(a), len(b), 5)
        if n:
            np.testing.assert_allclose(np.sort(a.boxes.conf)[-n:], np.sort(b.boxes.conf)[-n:], atol=0.1)
    rc = cli.main(["predict", f"model={best}", f"source={images}", "half=True", "conf=0.01", "device=cpu",
                   f"imgsz={IMG}", f"project={tmp_path}", "save=True"])
    assert rc in (0, None)
    assert len(list((tmp_path / "predict").iterdir())) == len(r16)


def test_data_parallel_bf16_step_equals_one_process(tmp_path):
    """One nano step at bf16 on 2 gloo data ranks of 2 images against one
    process on the 4, at `tests/test_torch_parallel.py`'s noise-floor
    bounds: the fractions of parameter and BatchNorm-statistic entries that
    miss rtol 1e-4 / atol 1e-6, and the loss's distance, each at most twice
    that of one process at three torch threads against one (the noise
    floor); the weights fp32 and the ranks bitwise equal. The fp32 step
    holds the loss at 1e-5; at bf16 a different rounding (threads, or 2
    images a rank) moves a near-tied top-k query or match, and with it
    whole loss terms. Readings: loss 60.22 against 60.03 (the floor 58.66);
    misses 3.9e-3 and 0.770 against the floor's 3.9e-3 and 0.777. These
    bounds see the bf16 step run over the ranks, not its gradient: at this
    size bf16 rounding alone moves the step's gradient by more than its
    norm (three threads against one: 1.5x), and one process on 2 of the 4
    images, a missing all-reduce, reads 4.1e-3 and 0.946, inside them.
    `test_data_parallel_bf16_stem_gradient_equals_one_process` holds the
    data-parallel gradient at bf16."""
    from test_torch_parallel import distance, run_ranks

    ranks = run_ranks(tmp_path, "nano_bf16")
    (one_loss,), one_model, _ = ranks[0]["one"]
    (floor_loss,), floor_model, _ = ranks[0]["floor"]
    floor = distance(floor_model, one_model)
    for r in ranks:
        (loss,), model, ema = r["dp"]
        got = distance(model, one_model)
        print(f"bf16 data parallel: loss {loss} vs {one_loss} (floor {floor_loss}); misses {got} against the "
              f"floor {floor}")
        assert abs(loss - one_loss) <= 2 * abs(floor_loss - one_loss) + 1e-5 * abs(one_loss), (loss, one_loss)
        assert got[0] <= 2 * floor[0] and got[1] <= 2 * floor[1], (got, floor)
        assert all(v.dtype == torch.float32 for v in (*model.values(), *ema.values()) if v.is_floating_point())
    assert all(torch.equal(ranks[0]["dp"][1][k], ranks[1]["dp"][1][k]) for k in one_model)


def test_data_parallel_bf16_stem_gradient_equals_one_process(tmp_path):
    """The data-parallel gradient at bf16 where it is well conditioned: the
    nano model's first three layers (train-mode BatchNorm over the global
    batch, in fp32 on bf16 activations) on 2 gloo ranks of 2 images against
    one process on the 4 (`torch_parallel_worker.py:stem_bf16`), as
    relative L2 distances: the gradient summed over the ranks within 5e-2,
    the running statistics within 1e-4, each rank's output rows within
    2e-2. Three torch threads leave this case bitwise (the floor of the
    whole-step test above is 0 here), so the bounds stand on the readings:
    the ranks' BatchNorm merges centred moments where one process sums
    once, and the fp32 difference flips some bf16 roundings of the
    normalised activations, which the next convolutions spread. Readings:
    gradient 1.1e-2, statistics 9.1e-6, output rows 5.0e-3. One process on
    the first 2 images alone, a rank whose gradient misses the all-reduce,
    reads 0.81, 1.2e-3 and 0.20: the test asserts that it breaks the
    gradient and statistics bounds."""
    from test_torch_parallel import run_ranks

    ranks = run_ranks(tmp_path, "stem_bf16")
    one, floor, half = (ranks[0][k] for k in ("one", "floor", "half"))
    d = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    bounds = (5e-2, 1e-4, 2e-2)
    half_d = [d(half[0], one[0]), d(half[1], one[1]), d(half[2], one[2][:2])]
    print(f"bf16 stem: three threads {[d(floor[i], one[i]) for i in range(3)]}, half batch {half_d}")
    assert half_d[0] > bounds[0] and half_d[1] > bounds[1], half_d
    for r, rank in enumerate(ranks):
        got = [d(rank["dp"][0], one[0]), d(rank["dp"][1], one[1]), d(rank["dp"][2], one[2][2 * r:2 * r + 2])]
        print(f"bf16 stem, rank {r}: {got}")
        assert all(g <= b for g, b in zip(got, bounds)), (got, bounds)
    assert torch.equal(ranks[0]["dp"][0], ranks[1]["dp"][0])
