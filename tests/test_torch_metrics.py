"""The port's val metrics and the val options of postprocess against the
JAX package's, on the CPU: AP, `DetMetrics`, the TP table and the confusion
matrix at 1e-9 on the same stats; `postprocess_predictions` with
`legacy_val_mask`, `classes` and `single_cls` and their combinations at
1e-7, the kept query indices included."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tamtr_tpu.ops.nms import postprocess_predictions as jax_post
from tamtr_tpu.utils import metrics as jm

from tamtr_torch.ops.nms import postprocess_predictions
from tamtr_torch.utils import metrics as pm


def _boxes(rng, n, scale=100.0):
    xy = rng.uniform(0, scale * 0.8, (n, 2))
    wh = rng.uniform(scale * 0.02, scale * 0.2, (n, 2))
    return np.concatenate([xy, xy + wh], 1)


def _image(rng, n_gt, n_pred, nc):
    """gts, and predictions near some of them (others random)."""
    gt = _boxes(rng, n_gt)
    gt_cls = rng.integers(0, nc, n_gt).astype(np.float32)
    near = gt[rng.integers(0, max(n_gt, 1), n_pred)] if n_gt else _boxes(rng, n_pred)
    pred = near + rng.normal(0, 3, (n_pred, 4))
    stray = rng.random(n_pred) < 0.3
    pred[stray] = _boxes(rng, int(stray.sum()))
    pred_cls = np.where(rng.random(n_pred) < 0.8, gt_cls[rng.integers(0, max(n_gt, 1), n_pred)] if n_gt else 0,
                        rng.integers(0, nc, n_pred)).astype(np.float32)
    conf = rng.random(n_pred)
    return pred, conf, pred_cls, gt, gt_cls


def _stats(seed, n_images=12, nc=4):
    rng = np.random.default_rng(seed)
    return [_image(rng, int(rng.integers(0, 8)), int(rng.integers(0, 15)), nc) for _ in range(n_images)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tp_table_ap_and_detmetrics_match_jax(seed):
    images = _stats(seed)
    dp, dj = pm.DetMetrics(), jm.DetMetrics()
    tps = []
    for pred, conf, pc, gt, gc in images:
        a = pm.match_predictions(pred, pc, gt, gc)
        b = jm.match_predictions(pred, pc, gt, gc)
        np.testing.assert_array_equal(a, b)
        tps.append(a)
        dp.update(a, conf, pc, gc)
        dj.update(b, conf, pc, gc)
    got, want = dp.compute(), dj.compute()
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9, k
    assert 0 < want["mAP50"] < 1
    tp = np.concatenate(tps)
    conf = np.concatenate([i[1] for i in images])
    pc = np.concatenate([i[2] for i in images])
    tc = np.concatenate([i[4] for i in images])
    a, b = pm.ap_per_class(tp, conf, pc, tc), jm.ap_per_class(tp, conf, pc, tc)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-9)
    r = np.sort(np.random.default_rng(seed).random(20))
    p = np.random.default_rng(seed + 1).random(20)
    assert abs(pm.compute_ap(r, p)[0] - jm.compute_ap(r, p)[0]) <= 1e-9
    np.testing.assert_allclose(pm.smooth(p, 0.1), jm.smooth(p, 0.1), atol=1e-12)


def test_empty_stats_match_jax():
    assert pm.DetMetrics().compute() == jm.DetMetrics().compute()
    d = pm.DetMetrics()
    d.update(np.zeros((0, 10), bool), np.zeros(0), np.zeros(0), np.zeros(3))
    assert d.compute()["mAP50"] == 0.0


@pytest.mark.parametrize("conf", [0.25, None])
def test_confusion_matrix_matches_jax(conf):
    cp, cj = pm.ConfusionMatrix(4, conf=conf), jm.ConfusionMatrix(4, conf=conf)
    for pred, score, pc, gt, gc in _stats(3) + [(_boxes(np.random.default_rng(9), 3), np.ones(3), np.zeros(3),
                                                   np.zeros((0, 4)), np.zeros(0))]:
        cp.process_batch(pred, score, pc.astype(np.int64), gt, gc)
        cj.process_batch(pred, score, pc.astype(np.int64), gt, gc)
    np.testing.assert_array_equal(cp.matrix, cj.matrix)
    assert cp.matrix.sum() > 0
    for a, b in zip(cp.tp_fp(), cj.tp_fp()):
        np.testing.assert_array_equal(a, b)
    cp2, cj2 = pm.ConfusionMatrix(3, task="classify"), jm.ConfusionMatrix(3, task="classify")
    cp2.process_cls_preds([0, 1, 2, 2], [0, 2, 2, 1])
    cj2.process_cls_preds([0, 1, 2, 2], [0, 2, 2, 1])
    np.testing.assert_array_equal(cp2.matrix, cj2.matrix)


def _pred(seed, B=3, nq=60, nc=5):
    """Clustered boxes (NMS suppresses), spread scores, an exact tie."""
    rng = np.random.default_rng(seed)
    centres = np.concatenate([rng.uniform(0.2, 0.8, (8, 2)), rng.uniform(0.05, 0.3, (8, 2))], 1)
    box = centres[rng.integers(0, 8, (B, nq))] + rng.normal(0, 0.01, (B, nq, 4))
    scores = rng.random((B, nq, nc))
    scores[0, 5] = scores[0, 6]
    return np.concatenate([box, scores], -1).astype(np.float32)


@pytest.mark.parametrize("legacy,classes,single_cls", [
    (legacy, classes, single) for legacy, classes, single in itertools.product(
        (False, True), (None, (1,), (0, 2, 4)), (False, True))
])
def test_postprocess_options_match_jax(legacy, classes, single_cls):
    pred = _pred(4)
    for conf, max_det in ((0.4, 300), (0.7, 300), (0.4, 7)):
        want = [np.asarray(a) for a in jax_post(jnp.asarray(pred), conf, 0.5, max_det, legacy_val_mask=legacy,
                                                classes=classes, single_cls=single_cls)]
        got = [t.numpy() for t in postprocess_predictions(torch.from_numpy(pred), conf, 0.5, max_det,
                                                          legacy_val_mask=legacy, classes=classes,
                                                          single_cls=single_cls)]
        assert len(got) == len(want) == 5
        assert 0 < want[3].sum() < pred.shape[0] * pred.shape[1]
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-7)
