"""The port's loss variants (`tamtr_torch/losses/variants.py`) and the
`DETRLossConfig` switches that reach them, against the JAX package's on the
CPU: the same numpy-seeded inputs through both, one torch thread.

Bounds: each function at 1e-6 (values) and 1e-5 (gradients), relative and
absolute; `rtdetr_detection_loss` with each switch at 1e-5, its components
and the gradients to the head's outputs. Degenerate boxes (zero width or
height, zero size, identical, touching edges) go through NWD and Wise-IoU;
the slide weight is taken on each side of its band edges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tamtr_tpu.losses.variants as J
from tamtr_torch.losses import variants as P
from tamtr_torch.losses.detr_loss import DETRLossConfig, rtdetr_detection_loss

from torch_engine_data import one_thread  # noqa: F401

NC, B = 4, 2


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _boxes(rng, n):
    """(n, 4) cxcywh boxes, the first rows degenerate: zero width, zero
    height, zero size."""
    b = np.concatenate([rng.uniform(0.2, 0.8, (n, 2)), rng.uniform(0.02, 0.4, (n, 2))], -1).astype(np.float32)
    b[0, 2] = 0.0
    b[1, 3] = 0.0
    b[2, 2:] = 0.0
    return b


def _pair(rng, n=24):
    """Predicted and target boxes: random pairs and the degenerate rows of
    `_boxes`, an identical pair, and a pair whose edges touch."""
    pred, tgt = _boxes(rng, n), _boxes(rng, n)
    tgt[3] = pred[3]
    tgt[4] = pred[4]
    tgt[4, 0] = pred[4, 0] + (pred[4, 2] + tgt[4, 2]) / 2  # the boxes touch along x
    return pred, tgt


@pytest.mark.parametrize("auto_iou", [0.5, 0.1, 0.73])
def test_slide_weight_and_loss_match_jax(auto_iou):
    """The three bands, with targets exactly on and on each side of the band
    edges (auto_iou - 0.1 and auto_iou, after the 0.2 floor), and the
    gradient of slide_loss to the logits and the targets."""
    rng = np.random.default_rng(0)
    a = max(auto_iou, 0.2)
    true = np.concatenate([rng.uniform(0, 1, 40), [a - 0.1, a, a - 0.1 - 1e-4, a + 1e-4, a - 0.05, 0.0, 1.0]])
    true = true.astype(np.float32)
    pred = rng.standard_normal(true.shape).astype(np.float32)
    _close(P.slide_weight(torch.from_numpy(true), auto_iou), J.slide_weight(jnp.asarray(true), auto_iou), 1e-6)
    want, (gp, gt) = jax.value_and_grad(lambda p, t: J.slide_loss(p, t, auto_iou).sum(), argnums=(0, 1))(
        jnp.asarray(pred), jnp.asarray(true))
    tp, tt = torch.from_numpy(pred).requires_grad_(), torch.from_numpy(true).requires_grad_()
    got = P.slide_loss(tp, tt, auto_iou).sum()
    got.backward()
    _close(got.item(), float(want), 1e-6)
    _close(tp.grad, gp, 1e-5)
    _close(tt.grad, gt, 1e-5)


def test_ema_slide_and_slide_varifocal_match_jax():
    """The EMA update (also its -1 sentinel, which skips), EMASlideLoss, and
    SlideVarifocalLoss with its gradient to the logits."""
    rng = np.random.default_rng(1)
    pred = rng.standard_normal((3, 7, NC)).astype(np.float32)
    label = np.eye(NC, dtype=np.float32)[rng.integers(0, NC, (3, 7))] * (rng.random((3, 7, 1)) < 0.5)
    gt = (label * rng.uniform(0.05, 0.95, (3, 7, 1))).astype(np.float32)
    for mean, updates, auto in ((0.5, 0.0, 0.62), (0.4, 7.0, 0.33), (0.7, 3.0, -1.0)):
        pm, pu = P.ema_slide_update(torch.tensor(mean), torch.tensor(updates), auto)
        jm, ju = J.ema_slide_update(jnp.float32(mean), jnp.float32(updates), auto)
        _close(pm, jm, 1e-6)
        _close(pu, ju, 1e-6)
        pl, pm2, _ = P.ema_slide_loss(torch.from_numpy(pred), torch.from_numpy(gt), torch.tensor(mean),
                                      torch.tensor(updates), auto)
        jl, jm2, _ = J.ema_slide_loss(jnp.asarray(pred), jnp.asarray(gt), jnp.float32(mean), jnp.float32(updates), auto)
        _close(pl, jl, 1e-6)
        _close(pm2, jm2, 1e-6)
    for auto in (0.5, 0.05):
        want, g = jax.value_and_grad(lambda p: J.slide_varifocal_loss(p, jnp.asarray(gt), jnp.asarray(label),
                                                                      auto).mean(1).sum())(jnp.asarray(pred))
        tp = torch.from_numpy(pred).requires_grad_()
        got = P.slide_varifocal_loss(tp, torch.from_numpy(gt), torch.from_numpy(label), auto).mean(1).sum()
        got.backward()
        _close(got.item(), float(want), 1e-6)
        _close(tp.grad, g, 1e-5)


@pytest.mark.parametrize("xywh", [True, False])
def test_wasserstein_similarity_matches_jax(xywh):
    """NWD on random and degenerate pairs, and its gradient to both boxes."""
    from tamtr_torch.ops.boxes import xywh2xyxy

    pred, tgt = _pair(np.random.default_rng(2))
    if not xywh:
        pred, tgt = (xywh2xyxy(torch.from_numpy(b)).numpy() for b in (pred, tgt))
    want, (g1, g2) = jax.value_and_grad(lambda a, b: J.wasserstein_similarity(a, b, xywh=xywh).sum(),
                                        argnums=(0, 1))(jnp.asarray(pred), jnp.asarray(tgt))
    t1, t2 = torch.from_numpy(pred).requires_grad_(), torch.from_numpy(tgt).requires_grad_()
    got = P.wasserstein_similarity(t1, t2, xywh=xywh)
    assert got.shape == (len(pred), 1)
    got.sum().backward()
    _close(got.sum().item(), float(want), 1e-6)
    _close(got.detach(), J.wasserstein_similarity(jnp.asarray(pred), jnp.asarray(tgt), xywh=xywh), 1e-6)
    _close(t1.grad, g1, 1e-5)
    _close(t2.grad, g2, 1e-5)


@pytest.mark.parametrize("monotonous", [None, True, False])
@pytest.mark.parametrize("training", [True, False])
def test_wise_iou_matches_jax(monotonous, training):
    """Wise-IoU v1 / v2 / v3 on random and degenerate pairs (touching edges
    meet the tie rule of the maxima, zero sizes the 1e-9 floors): the loss,
    the new running mean, and the gradient to the predicted boxes."""
    pred, tgt = _pair(np.random.default_rng(3))
    mean = 0.8

    def jl(p):
        loss, new = J.wise_iou(p, jnp.asarray(tgt), jnp.float32(mean), monotonous=monotonous, training=training)
        return loss.sum(), (loss, new)

    (_, (want, want_mean)), g = jax.value_and_grad(jl, has_aux=True)(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    got, got_mean = P.wise_iou(tp, torch.from_numpy(tgt), mean, monotonous=monotonous, training=training)
    got.sum().backward()
    assert np.isfinite(np.asarray(want)).all()
    _close(got.detach(), want, 1e-6)
    _close(got_mean, want_mean, 1e-6)
    _close(tp.grad, g, 1e-5)


def _head_outputs(seed, ndl=3, nq=6, num_dn=16, G=1):
    """A train dict of the DETR head: boxes (cxcywh) and logits of every
    layer, the encoder's, and a CDN block of G groups."""
    rng = np.random.default_rng(seed)
    Q = num_dn + nq
    box = lambda *s: np.concatenate([rng.uniform(0.2, 0.8, s + (2,)), rng.uniform(0.05, 0.3, s + (2,))],  # noqa: E731
                                    -1).astype(np.float32)
    return {"dec_bboxes": box(ndl, B, Q), "dec_scores": rng.standard_normal((ndl, B, Q, NC)).astype(np.float32),
            "enc_bboxes": box(B, nq), "enc_scores": rng.standard_normal((B, nq, NC)).astype(np.float32),
            "num_dn": num_dn, "dn_groups": G}


SWITCHES = {
    "sl": dict(use_sl=True),
    "svfl": dict(use_svfl=True),
    "nwd": dict(nwd_loss=True, iou_ratio=0.3),
    "wiseiou": dict(use_wiseiou=True),
    "wiseiou_nwd_svfl": dict(use_wiseiou=True, nwd_loss=True, use_svfl=True),
    "svfl_no_gts": dict(use_svfl=True),
    "sl_no_gts": dict(use_sl=True),
}


@pytest.mark.parametrize("name", list(SWITCHES))
def test_detr_loss_switches_match_jax(name):
    """`rtdetr_detection_loss` with each switch on the same head outputs as
    JAX's: the total, every component and the gradients to the outputs at
    1e-5, with an over-full image (8 valid gts, 6 queries) and an image
    without gts; the `_no_gts` cases have no gt in the batch (SVFL falls
    back to the focal loss, auto_iou to its -1 sentinel, floored at 0.2)."""
    from tamtr_tpu.losses.detr_loss import DETRLossConfig as JCfg
    from tamtr_tpu.losses.detr_loss import rtdetr_detection_loss as jax_loss

    Mg = 8
    out = _head_outputs(4, num_dn=2 * Mg)
    rng = np.random.default_rng(5)
    counts = [[0], [0]] if name.endswith("no_gts") else [[8], [0]]
    mask = np.arange(Mg)[None] < np.array(counts)
    tg = {"cls": rng.integers(0, NC, (B, Mg)).astype(np.int32), "mask": mask,
          "bboxes": np.concatenate([rng.uniform(0.2, 0.8, (B, Mg, 2)), rng.uniform(0.02, 0.4, (B, Mg, 2))],
                                   -1).astype(np.float32)}
    keys = ["dec_bboxes", "dec_scores", "enc_bboxes", "enc_scores"]
    sw = SWITCHES[name]

    def jloss(*arrs):
        o = {**dict(zip(keys, arrs)), "num_dn": out["num_dn"], "dn_groups": out["dn_groups"]}
        return jax_loss(o, {k: jnp.asarray(v) for k, v in tg.items()}, JCfg(nc=NC, **sw))

    (want, witems), wgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(out[k]) for k in keys))
    ts = {k: torch.from_numpy(out[k]).requires_grad_() for k in keys}
    got, items = rtdetr_detection_loss({**out, **ts}, {k: torch.from_numpy(v) for k, v in tg.items()},
                                       DETRLossConfig(nc=NC, **sw))
    got.backward()
    assert np.isfinite(float(want))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for k, v in witems.items():
        np.testing.assert_allclose(items[k].item(), float(v), atol=1e-5, rtol=1e-5, err_msg=k)
    for k, g in zip(keys, wgrads):
        np.testing.assert_allclose(ts[k].grad.numpy(), np.asarray(g), atol=1e-5, rtol=1e-5, err_msg=k)


def test_default_loss_takes_the_default_path():
    """With every switch off the loss is the default one: equal, bit for
    bit, to the config written out with each switch off, and different
    from each switch's."""
    out = _head_outputs(6, num_dn=16)
    rng = np.random.default_rng(7)
    tg = {"cls": torch.from_numpy(rng.integers(0, NC, (B, 8)).astype(np.int32)),
          "mask": torch.from_numpy(np.arange(8)[None] < np.array([[5], [3]])),
          "bboxes": torch.from_numpy(np.concatenate([rng.uniform(0.2, 0.8, (B, 8, 2)),
                                                     rng.uniform(0.02, 0.4, (B, 8, 2))], -1).astype(np.float32))}
    t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in out.items()}
    base, _ = rtdetr_detection_loss(t, tg, DETRLossConfig(nc=NC))
    off, _ = rtdetr_detection_loss(t, tg, DETRLossConfig(nc=NC, use_sl=False, use_svfl=False, nwd_loss=False,
                                                         use_wiseiou=False, iou_ratio=0.9))
    assert torch.equal(base, off)
    for sw in ("sl", "svfl", "nwd", "wiseiou"):
        other, _ = rtdetr_detection_loss(t, tg, DETRLossConfig(nc=NC, **SWITCHES[sw]))
        assert not torch.equal(base, other), sw
