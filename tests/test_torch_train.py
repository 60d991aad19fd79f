"""The port's training slice on the CPU against the JAX package: RIOU, the
DETR loss, the train-mode forward, the parameter groups, and the
accumulation / EMA cadence (one whole nano train step: in
`test_torch_train_whole.py`, on this file's fixtures and helpers).

The JAX nano model is initialised once for the module (under `jax.jit`),
with its zero-initialised head layers given small random values, and bridged
into the port. CDN noise and DropPath are off on both sides (the JAX
`get_cdn_group` is wrapped with zero noise for this module, the port model
is built with zero noise and `vss_drop_path=0`): the two frameworks' random
streams differ. Image 1 of the batch holds more valid gts than the nano
model's 20 queries, so the matcher's transposed solve runs too.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from tamtr_torch.losses.detr_loss import DETRLossConfig, rtdetr_detection_loss
from tamtr_torch.nn.graph import TAMTRModel as PortModel
from tamtr_torch.ops import boxes as pboxes
from tamtr_torch.train import trainer as ptrain
from tamtr_torch.weights import from_jax_variables

NC, HD, IMG, M, B = 4, 128, 64, 24, 2
N_VALID = (6, 22)  # image 1 is over-full: 22 > nq = 20


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _perturb(params, rng):
    """Give the zero-initialised head layers small random values."""
    head = params["head"]
    for name, sub in head.items():
        if name.startswith("dec_score_head"):
            sub["bias"] = np.zeros_like(sub["bias"])
        if name.startswith(("dec_bbox_head", "enc_bbox_head")):
            k = sub["layers2"]["kernel"]
            sub["layers2"]["kernel"] = (rng.standard_normal(k.shape) * 0.05).astype(np.float32)
        if name.startswith("layer"):
            for lin in ("sampling_offsets", "attention_weights"):
                k = sub["cross_attn"][lin]["kernel"]
                sub["cross_attn"][lin]["kernel"] = (rng.standard_normal(k.shape) * 0.05).astype(np.float32)
    return params


def _to_np(tree):
    return {k: _to_np(x) if isinstance(x, dict) or hasattr(x, "items") else np.array(x) for k, x in tree.items()}


_JAX_CDN = []  # the JAX package's get_cdn_group while `no_cdn_noise` wraps it


@pytest.fixture(scope="module")
def no_cdn_noise():
    import tamtr_tpu.nn.decoder as jdec

    mp = pytest.MonkeyPatch()
    _JAX_CDN.append(jdec.get_cdn_group)
    mp.setattr(jdec, "get_cdn_group", lambda *a, **k: _JAX_CDN[0](*a[:7], 0.0, 0.0))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def jax_nano(no_cdn_noise, tmp_path_factory):
    """The JAX nano model and its perturbed variables; the init is compiled
    once per test session (`session_cached`) for this file and the bf16
    step files."""
    from tamtr_tpu.nn.graph import TAMTRModel

    from torch_engine_data import session_cached

    model = TAMTRModel.from_yaml("tamtr-nano.yaml", nc=NC, max_gt=M, vss_drop_path=0.0)

    def make():
        v = jax.device_get(jax.jit(lambda: model.init(
            {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1, NC, HD)), None, False
        ))())
        return _perturb(_to_np(v["params"]), np.random.default_rng(0)), _to_np(v["batch_stats"])

    params, batch_stats = session_cached(tmp_path_factory, "train-nano", make)
    return model, params, batch_stats


def _port_model(params, batch_stats):
    model = PortModel.from_cfg("tamtr-nano.yaml", nc=NC, max_gt=M, vss_drop_path=0.0,
                               label_noise_ratio=0.0, box_noise_scale=0.0)
    sd, report = from_jax_variables(params, batch_stats, model)
    assert not any(report.values()), report
    model.load_state_dict(sd, strict=True)
    return model


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(1)
    mask = np.arange(M)[None] < np.array(N_VALID)[:, None]
    txt = rng.standard_normal((B, NC, HD)).astype(np.float32)
    cxcy = rng.uniform(0.15, 0.85, (B, M, 2))
    wh = rng.uniform(0.05, 0.3, (B, M, 2))
    return {
        "img": rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8),
        "txt_feats": txt / np.linalg.norm(txt, axis=-1, keepdims=True),
        "cls": rng.integers(0, NC, (B, M)).astype(np.int32),
        "bboxes": np.concatenate([cxcy, wh], -1).astype(np.float32) * mask[..., None],
        "mask": mask,
    }


def _targets(batch, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return {k: conv(batch[k]) for k in ("cls", "bboxes", "mask")}


def _rel_err(got, want):
    scale = np.linalg.norm(want)
    return np.linalg.norm(got - want) / scale if scale > 0 else np.abs(got).max()


# ---------------------------------------------------------------------------
# RIOU and the loss on fixed inputs
# ---------------------------------------------------------------------------


def _boxes(rng, n):
    return np.concatenate([rng.uniform(0.2, 0.8, (n, 2)), rng.uniform(0.02, 0.4, (n, 2))], -1).astype(np.float32)


@pytest.mark.parametrize("kind", ["IoU", "GIoU", "DIoU", "CIoU", "RIOU"])
@pytest.mark.parametrize("xywh", [True, False])
def test_bbox_iou_matches_jax(kind, xywh):
    """Random pairs plus degenerate ones: zero width, zero height, zero size,
    identical boxes; NaN in the same places (zero-size under RIOU)."""
    from tamtr_tpu.ops.boxes import bbox_iou as jax_iou

    rng = np.random.default_rng(2)
    b1, b2 = _boxes(rng, 40), _boxes(rng, 40)
    b1[0, 2] = 0.0
    b1[1, 3] = 0.0
    b1[2, 2:] = 0.0
    b2[3] = b1[3]
    b2[4, 2:] = 0.0
    if not xywh:
        b1, b2 = (pboxes.xywh2xyxy(torch.from_numpy(b)).numpy() for b in (b1, b2))
    flags = {kind: True} if kind != "IoU" else {}
    want = np.asarray(jax_iou(jnp.asarray(b1), jnp.asarray(b2), xywh=xywh, **flags))
    got = pboxes.bbox_iou(torch.from_numpy(b1), torch.from_numpy(b2), xywh=xywh, **flags).numpy()
    assert got.shape == want.shape == (40, 1)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
    if kind == "RIOU" and xywh:
        assert np.isnan(got[2]).all()
        gj = jax.grad(lambda a: jax_iou(a, jnp.asarray(b2[5:]), RIOU=True).sum())(jnp.asarray(b1[5:]))
        t = torch.from_numpy(b1[5:]).requires_grad_()
        pboxes.bbox_iou(t, torch.from_numpy(b2[5:]), RIOU=True).sum().backward()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj), atol=1e-5, rtol=1e-4)


def _fixed_outputs(seed, ndl=3, nq=6, num_dn=16, G=1, nc=NC):
    rng = np.random.default_rng(seed)
    Q = num_dn + nq
    box = lambda *s: np.concatenate([rng.uniform(0.2, 0.8, s + (2,)), rng.uniform(0.05, 0.3, s + (2,))],  # noqa: E731
                                    -1).astype(np.float32)
    return {
        "dec_bboxes": box(ndl, B, Q), "dec_scores": rng.standard_normal((ndl, B, Q, nc)).astype(np.float32),
        "enc_bboxes": box(B, nq), "enc_scores": rng.standard_normal((B, nq, nc)).astype(np.float32),
        "num_dn": num_dn, "dn_groups": G,
    }


def test_detr_loss_on_fixed_outputs_matches_jax():
    """Values, gradients to the outputs and assignments, with an over-full
    image (8 valid gts, 6 queries) and an image without gts."""
    from tamtr_tpu.losses.detr_loss import DETRLossConfig as JCfg
    from tamtr_tpu.losses.detr_loss import rtdetr_detection_loss as jax_loss

    Mg = 8
    out = _fixed_outputs(4, num_dn=2 * Mg)
    rng = np.random.default_rng(5)
    mask = np.arange(Mg)[None] < np.array([[8], [0]])
    tg = {"cls": rng.integers(0, NC, (B, Mg)).astype(np.int32),
          "bboxes": _boxes(rng, B * Mg).reshape(B, Mg, 4), "mask": mask}
    keys = ["dec_bboxes", "dec_scores", "enc_bboxes", "enc_scores"]

    def jloss(*arrs):
        o = {**dict(zip(keys, arrs)), "num_dn": out["num_dn"], "dn_groups": out["dn_groups"]}
        return jax_loss(o, {k: jnp.asarray(v) for k, v in tg.items()}, JCfg(nc=NC))

    (want, witems), wgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(out[k]) for k in keys))
    ts = {k: torch.from_numpy(out[k]).requires_grad_() for k in keys}
    got, items = rtdetr_detection_loss({**out, **ts}, {k: torch.from_numpy(v) for k, v in tg.items()},
                                       DETRLossConfig(nc=NC))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for k, v in witems.items():
        np.testing.assert_allclose(items[k].item(), float(v), atol=1e-5, rtol=1e-5, err_msg=k)
    for k, g in zip(keys, wgrads):
        np.testing.assert_allclose(ts[k].grad.numpy(), np.asarray(g), atol=1e-5, rtol=1e-5, err_msg=k)
    assert (items["match"][:, 0] >= 0).sum(-1).tolist() == [6] * 4  # over-full: every query used


def test_cdn_group_with_injected_noise_matches_jax():
    """The CDN queries with label and box noise on, the port fed the JAX
    package's own draws (same key splits as `get_cdn_group`)."""
    import tamtr_tpu.nn.decoder as jdec

    from tamtr_torch.nn.decoder import cdn_attn_mask, get_cdn_group

    jax_cdn = _JAX_CDN[0] if _JAX_CDN else jdec.get_cdn_group
    rng = np.random.default_rng(6)
    Bn, Mn, G, nc, hd = 2, 5, 2, 4, 8
    cls = rng.integers(0, nc, (Bn, Mn)).astype(np.int32)
    box = _boxes(rng, Bn * Mn).reshape(Bn, Mn, 4)
    mask = np.arange(Mn)[None] < np.array([[5], [3]])
    table = rng.standard_normal((nc + 1, hd)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jax_cdn(jnp.asarray(cls), jnp.asarray(box), jnp.asarray(mask), nc, jnp.asarray(table), G, key, 0.5, 1.0)
    k_cls, k_sign, k_part, k_newcls = jax.random.split(key, 4)
    shape = (Bn, 2 * G, Mn)
    noise = {"flip": jax.random.uniform(k_cls, shape), "new_cls": jax.random.randint(k_newcls, shape, 0, nc),
             "sign": jax.random.randint(k_sign, shape + (4,), 0, 2) * 2.0 - 1.0,
             "part": jax.random.uniform(k_part, shape + (4,))}
    got = get_cdn_group(torch.from_numpy(cls), torch.from_numpy(box), torch.from_numpy(mask), nc,
                        torch.from_numpy(table), G, noise={k: torch.from_numpy(np.array(v)) for k, v in noise.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
    assert (np.asarray(noise["flip"]) < 0.25).any()  # some classes flipped
    np.testing.assert_array_equal(cdn_attn_mask(2 * G * Mn, 7, 2 * Mn), jdec.cdn_attn_mask(2 * G * Mn, 7, 2 * Mn))


# ---------------------------------------------------------------------------
# Train-mode forward and one whole train step
# ---------------------------------------------------------------------------


def _assert_same_rows(got, want, atol):
    """Row sets equal up to order (top-k may swap near-tied queries)."""
    dist = np.abs(got[:, None] - want[None]).max(-1)
    r, c = linear_sum_assignment(dist)
    assert (dist[r, c] < atol).sum() >= len(r) - 1, np.sort(dist[r, c])[-3:]


def jax_forward_and_topk(model, params, batch_stats, batch):
    """The JAX model's train-mode forward on the batch, the BatchNorm
    statistics after it, and the (B, nq) query indices its top-k selected,
    in order (read by wrapping `jax.lax.top_k` while the forward traces)."""
    img = batch["img"].astype(np.float32) / 255.0
    picked, top_k = [], jax.lax.top_k

    def recording(x, k):
        res = top_k(x, k)
        picked.append(res[1])
        return res

    def fwd(p, bs, i, t, tg):
        out = model.apply({"params": p, "batch_stats": bs}, i, t, tg, True,
                          rngs={"cdn": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
                          mutable=["batch_stats"])
        return out, picked[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "top_k", recording)
        (out, mut), topk = jax.jit(fwd)(params, batch_stats, jnp.asarray(img), jnp.asarray(batch["txt_feats"]),
                                        _targets(batch, "jax"))
    return out, mut, [torch.from_numpy(np.asarray(topk).astype(np.int64))]


@pytest.fixture(scope="module")
def jax_train_forward(jax_nano, batch, tmp_path_factory):
    """`jax_forward_and_topk` of the nano model on the batch, as numpy, once
    per test session (this file and `test_torch_train_whole.py` read it)."""
    from torch_engine_data import session_cached

    def make():
        out, mut, topk = jax_forward_and_topk(*jax_nano, batch)
        return jax.device_get(out), jax.device_get(mut), topk

    return session_cached(tmp_path_factory, "train-nano-forward", make)


def test_train_mode_forward_matches_jax(jax_nano, jax_train_forward, batch):
    """dn queries (fixed order) directly, matching queries as a set of rows
    over all layers, and the BatchNorm statistics after the forward.

    Each backbone and neck module matches JAX at 1e-4 in train mode (the test
    below), but train-mode BatchNorm over this batch of 2 amplifies rounding
    through the stack to ~1e-3 at the head's input; the scores, logit-scaled by
    exp(logit_scale) = 14.3, carry that times 14: hence 2e-3 on boxes and
    2e-2 on scores (weighted 0.1 in the row sets)."""
    _, params, batch_stats = jax_nano
    out_j, mut, _ = jax_train_forward
    img = batch["img"].astype(np.float32) / 255.0
    port = _port_model(params, batch_stats).train()
    with torch.no_grad():
        out_p = port(torch.from_numpy(img), torch.from_numpy(batch["txt_feats"]), _targets(batch, "torch"))
    num_dn = out_p["num_dn"]
    assert num_dn == int(out_j["num_dn"]) == 2 * (100 // M) * M and out_p["dn_groups"] == 100 // M
    for k, tol in (("dec_bboxes", 2e-3), ("dec_scores", 2e-2)):
        assert out_p[k].shape == out_j[k].shape
        np.testing.assert_allclose(out_p[k][:, :, :num_dn].numpy(), np.asarray(out_j[k])[:, :, :num_dn],
                                   atol=tol, rtol=tol, err_msg=k)
    rows = lambda o: np.concatenate([np.asarray(o[k])[:, :, num_dn:].transpose(1, 2, 0, 3).reshape(  # noqa: E731
        B, -1, 3 * np.asarray(o[k]).shape[-1]) * w for k, w in (("dec_bboxes", 1.0), ("dec_scores", 0.1))], -1)
    for b in range(B):
        _assert_same_rows(rows(out_p)[b], rows(out_j)[b], atol=2e-3)
    sd, _ = from_jax_variables(params, _to_np(mut["batch_stats"]), port)
    for k, v in port.state_dict().items():
        if "running_" in k:
            np.testing.assert_allclose(v.numpy(), sd[k].numpy(), atol=1e-4, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("idx", [0, 2, 9, 16])
def test_modules_in_train_mode_match_jax(jax_nano, idx):
    """ConvBN (0), the ELAN stack (2), SPPELAN (9) and TIAGELAN (16) in train
    mode, each alone on the same input: outputs and the BatchNorm statistics
    after the call (momentum 0.97 of flax, biased batch variance)."""
    from tamtr_tpu.nn.graph import _build_module

    jmodel, params, batch_stats = jax_nano
    port = _port_model(params, batch_stats).train()
    rng = np.random.default_rng(idx)
    mod = port.model[idx]
    c_in = next(p for n, p in mod.named_parameters() if n.endswith("conv.weight")).shape[1]
    hw = 16 if idx < 9 else 4
    x = rng.standard_normal((B, hw, hw, c_in)).astype(np.float32)
    _, _, m, args = jmodel.specs[[s[0] for s in jmodel.specs].index(idx)]
    name = f"m{idx}_{m}"
    jmod = _build_module(m, args, name=None)
    vs = {"params": params[name], "batch_stats": batch_stats[name]}
    txt = rng.standard_normal((B, NC, HD)).astype(np.float32)
    if m == "TIAGELAN":
        want, mut = jmod.apply(vs, jnp.asarray(x), jnp.asarray(txt), True, mutable=["batch_stats"])
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(txt))
    else:
        want, mut = jmod.apply(vs, jnp.asarray(x), True, mutable=["batch_stats"])
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    new_bs = {**batch_stats, name: _to_np(mut["batch_stats"])}
    sd, _ = from_jax_variables(params, new_bs, port)
    for k, v in port.state_dict().items():
        if k.startswith(f"model.{idx}.") and "running_" in k:
            np.testing.assert_allclose(v.numpy(), sd[k].numpy(), atol=1e-5, rtol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def jax_step(jax_nano, batch, tmp_path_factory):
    """`run_jax_step` of the nano model, once per test session (this file
    and `test_torch_bf16_step_whole.py` read it)."""
    from torch_engine_data import session_cached

    return session_cached(tmp_path_factory, "train-nano-step", lambda: jax.device_get(run_jax_step(*jax_nano, batch)))


def run_jax_step(model, params, batch_stats, batch):
    """One `make_train_step` of `model`; its gradient is read back from the
    first Adam moment: m = (1 - b1) * g * clip_coef."""
    from tamtr_tpu.losses.detr_loss import DETRLossConfig as JCfg
    from tamtr_tpu.train import trainer as jtrain

    cfg = jtrain.TrainConfig(batch_size=B, warmup_iters=10, epochs=2)
    tx = jtrain.make_optimizer(cfg, params, steps_per_epoch=10)
    p_flat = jtrain.flatten_tree(params)
    state = jtrain.TrainState(
        step=jnp.zeros((), jnp.int32), params=p_flat, batch_stats=batch_stats, opt_state=tx.init(params),
        ema_params=jnp.copy(p_flat), ema_batch_stats=jax.tree.map(jnp.copy, batch_stats),
        unravel=jtrain.unravel_for(params),
    )
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    new, metrics = jax.jit(jtrain.make_train_step(model, tx, JCfg(nc=NC), cfg))(state, jb, jax.random.PRNGKey(0))
    gnorm = float(metrics["grad_norm"])
    coef = min(1.0, cfg.grad_clip / max(gnorm, 1e-6))
    grads = np.asarray(new.opt_state.m) / ((1.0 - cfg.momentum) * coef)
    unravel = jax.jit(state.unravel)
    tree = lambda flat: _to_np(unravel(jnp.asarray(flat)))  # noqa: E731
    return cfg, metrics, tree(grads), tree(new.params), _to_np(new.batch_stats), tree(new.ema_params)


def _port_cfg(jcfg):
    return ptrain.TrainConfig(batch_size=jcfg.batch_size, warmup_iters=jcfg.warmup_iters, epochs=jcfg.epochs)


def _jax_assignment(out_j, batch):
    """The JAX matcher's (layers, B, M) assignment over the forward's
    matched layers (encoder first), as its loss stacks them."""
    from tamtr_tpu.losses.matcher import hungarian_match

    nd = int(out_j["num_dn"])
    layers = [jnp.concatenate([out_j[f"enc_{k}"][None], out_j[f"dec_{k}"][:, :, nd:]], 0) for k in ("bboxes", "scores")]
    L = layers[0].shape[0]
    tile = lambda x: jnp.tile(jnp.asarray(x), (L,) + (1,) * (x.ndim - 1))  # noqa: E731
    q = hungarian_match(*(x.reshape(L * B, *x.shape[2:]) for x in layers),
                        *(tile(batch[k]) for k in ("bboxes", "cls", "mask")))
    return torch.from_numpy(np.asarray(q).astype(np.int64)).view(L, B, M)


def pin_topk(mp, topk, record):
    """Patch `torch.Tensor.topk` on `mp`: each call's indices are appended
    to `record`, or, given `topk` (one (B, k) index tensor a call), those
    are returned in order, so that a forward selects the same queries in the
    same order as another."""
    orig = torch.Tensor.topk

    def pinned(self, *a, **kw):
        if topk is None:
            res = orig(self, *a, **kw)
            record.append(res.indices)
            return res
        idx = topk[len(record) % len(topk)]
        record.append(idx)
        return torch.return_types.topk((self.gather(1, idx), idx))

    mp.setattr(torch.Tensor, "topk", pinned)


def _port_grads(port, batch, dtype, match, monkeypatch, topk=None):
    """Parameter gradients of one train-mode forward + loss with `match` as
    the assignment (or the port's own, None); records the decoder's top-k
    query indices, or replays `topk` so that another precision or package
    selects the same queries in the same order."""
    model = copy.deepcopy(port).to(dtype).train()
    tg = {**_targets(batch, "torch"), "bboxes": torch.from_numpy(batch["bboxes"]).to(dtype)}
    record = []
    with monkeypatch.context() as mp:
        pin_topk(mp, topk, record)
        out = model(torch.from_numpy(batch["img"]).to(dtype) / 255.0, torch.from_numpy(batch["txt_feats"]).to(dtype), tg)
    loss, items = rtdetr_detection_loss(out, tg, DETRLossConfig(nc=NC), match=match)
    loss.backward()
    grads = {k: p.grad.double().numpy() if p.grad is not None else np.zeros(tuple(p.shape)) for k, p in model.named_parameters()}
    return loss.item(), items["match"], grads, record, {k: v.detach() if torch.is_tensor(v) else v for k, v in out.items()}


def _matched_layers(out, batch):
    """(L, B, nq, 4) boxes and (L, B, nq, nc) logits of a train forward's
    matched layers (encoder first), as numpy, and its dn count."""
    nd = int(out["num_dn"])
    return [np.concatenate([np.asarray(out[f"enc_{k}"])[None], np.asarray(out[f"dec_{k}"])[:, :, nd:]], 0)
            for k in ("bboxes", "scores")]


def assert_swaps_within_noise(match, jmatch, out_p, out_j, batch):
    """The port's own assignment against JAX's: equal, or different only by
    swaps of near-tied pairs. For a layer and image whose k gts differ, the
    swap's margin is its cost under JAX's cost matrix above JAX's own
    assignment, C_j(port) - C_j(jax) (the cost of `losses/matcher.py:
    match_cost` on JAX's forward), and the two forwards' measured distance
    is d = max |C_port - C_j| over the image's valid entries: an optimal
    assignment of C_port lies within 2 k d of JAX's under C_j, so a margin
    above that is a fault, not rounding. Returns the (layer, image, k,
    margin, 2 k d) of each swap."""
    from tamtr_torch.losses.matcher import match_cost

    (bp, sp), (bj, sj) = _matched_layers(out_p, batch), _matched_layers(out_j, batch)
    gt_b, gt_c = torch.from_numpy(batch["bboxes"]), torch.from_numpy(batch["cls"])
    swaps = []
    for layer in range(jmatch.shape[0]):
        cp, cj = (match_cost(torch.from_numpy(b).float(), torch.from_numpy(s).float(), gt_b, gt_c).numpy()
                  for b, s in ((bp[layer], sp[layer]), (bj[layer], sj[layer])))
        for i in range(B):
            n = int(batch["mask"][i].sum())
            mine, theirs = match[layer, i, :n].numpy(), jmatch[layer, i, :n].numpy()
            k = int((mine != theirs).sum())
            if k == 0:
                continue
            cols = np.arange(n)
            margin = float(cj[i][mine, cols].sum() - cj[i][theirs, cols].sum())
            d = float(np.abs(cp[i][:, :n] - cj[i][:, :n]).max())
            swaps.append((layer, i, k, margin, 2 * k * d))
    print("assignment swaps (layer, image, gts moved, margin under JAX's costs, 2 k d):", swaps)
    for layer, i, k, margin, allowed in swaps:
        assert margin <= allowed, (layer, i, k, margin, allowed)
    return swaps


def test_param_groups_equal_the_jax_masks(jax_nano):
    from tamtr_tpu.train.trainer import _bias_mask, _decay_mask
    from tamtr_torch.weights import map_torch_key

    _, params, batch_stats = jax_nano
    port = _port_model(params, batch_stats)
    dm, bm = (_to_np(jax.tree.map(np.asarray, f(params))) for f in (_decay_mask, _bias_mask))
    layer_names = {idx: m.replace(".", "_") for idx, _, m, _ in port.specs}
    head = port.specs[-1][0] + 1
    groups = ptrain.param_groups(port)
    assert len(groups) == len(dict(port.named_parameters()))
    for key, p in port.named_parameters():
        _, path, special = map_torch_key("model." + key.split("model.", 1)[1], tuple(p.shape), layer_names, head)
        if special == "qkv":
            path = path + ["q_proj", "kernel" if key.endswith("weight") else "bias"]
        node_d, node_b = dm, bm
        for part in path:
            node_d, node_b = node_d[part], node_b[part]
        want = "bias" if bool(node_b) else ("decay" if bool(node_d) else "no_decay")
        assert groups[key] == want, (key, path)
    assert groups["model.41.VSSBlocks.0.op.Ds"] == "decay"
    assert groups["model.41.dec_score_head.0.logit_scale"] == "no_decay"


# ---------------------------------------------------------------------------
# Schedule, accumulation cadence, EMA, NaN guard
# ---------------------------------------------------------------------------


def test_lr_schedule_matches_jax():
    from tamtr_tpu.train.trainer import TrainConfig as JCfg
    from tamtr_tpu.train.trainer import make_lr_schedules

    kw = dict(lr0=1e-4, lrf=0.5, warmup_iters=100, warmup_bias_lr=0.1, epochs=10)
    lr_main, lr_bias = make_lr_schedules(JCfg(**kw), steps_per_epoch=50)
    cfg = ptrain.TrainConfig(**kw)
    for ni in (0, 1, 37, 99, 100, 250, 499):
        np.testing.assert_allclose(ptrain.lr_at(cfg, ni, 50, 0.0), float(lr_main(ni)), rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(ptrain.lr_at(cfg, ni, 50, 0.1), float(lr_bias(ni)), rtol=1e-5, atol=1e-12)


class _Tiny(torch.nn.Module):
    nc = 2

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(4, 3)

    def forward(self, img, txt, targets, generator=None):
        return {"x": self.lin(img.reshape(img.shape[0], -1)[:, :4])}


def _tiny_batch(nan=False):
    img = torch.full((2, 2, 2, 3), float("nan") if nan else 0.5)
    return {"img": img, "txt_feats": torch.zeros(2, 1, 4), "cls": torch.zeros(2, 1, dtype=torch.int32),
            "bboxes": torch.zeros(2, 1, 4), "mask": torch.zeros(2, 1, dtype=torch.bool)}


@pytest.fixture
def tiny_loss(monkeypatch):
    def loss(out, targets, cfg):
        v = (out["x"] ** 2).sum()
        return v, {"giou": v, "class": v, "bbox": v, "match": torch.zeros(1)}

    monkeypatch.setattr(ptrain, "rtdetr_detection_loss", loss)


@pytest.mark.parametrize("bs,nbs,nw,n", [(6, 64, 40, 120), (2, 8, 6, 30)])
def test_accumulation_cadence_and_ema(tiny_loss, bs, nbs, nw, n):
    """Steps where the reference steps (`tests/test_accumulate.py`), the EMA
    ticking on optimizer steps only with decay 0.9999 (1 - exp(-t/2000))."""
    last, want = -1, []
    for ni in range(n):
        if ni - last >= max(1, round(float(np.interp(ni, [0, nw], [1, nbs / bs])))):
            want.append(ni)
            last = ni
    torch.manual_seed(0)
    tr = ptrain.Trainer(_Tiny(), ptrain.TrainConfig(batch_size=bs, nbs=nbs, warmup_iters=nw, epochs=10),
                        device="cpu")
    got = []
    for ni in range(n):
        ema_before = tr.ema.lin.weight.clone()
        m = tr.step(_tiny_batch())
        if m["stepped"]:
            got.append(ni)
            d = 0.9999 * (1 - np.exp(-len(got) / 2000.0))
            torch.testing.assert_close(tr.ema.lin.weight, ema_before * d + (1 - d) * tr.model.lin.weight)
        else:
            assert torch.equal(tr.ema.lin.weight, ema_before)
    assert got == want and tr.count == len(want)


def test_nan_guard_keeps_the_parameters(tiny_loss):
    tr = ptrain.Trainer(_Tiny(), ptrain.TrainConfig(batch_size=2, accumulate=1, warmup_iters=1), device="cpu")
    before = copy.deepcopy(tr.model.state_dict())
    m = tr.step(_tiny_batch(nan=True))
    assert m["stepped"] == 1.0 and not np.isfinite(m["loss"])
    assert all(torch.equal(v, before[k]) for k, v in tr.model.state_dict().items())
    assert tr.count == 1 and all(float(a.abs().sum()) == 0 for a in tr.acc)
    tr.step(_tiny_batch())
    assert not torch.equal(tr.model.lin.bias, before["lin.bias"])


def test_trainer_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptrain.Trainer(_Tiny())
