"""Detection metrics: AP, mAP50 and mAP50-95 with COCO-style 101-point
interpolation (numpy; a copy of the JAX package's `utils/metrics.py`, which
ports the reference's `utils/metrics.py:999-1387` and
`engine/validator.py:208-247`).

The per-image TP table is built as the reference builds it: greedy IoU
matching at 10 thresholds 0.5:0.05:0.95, each gt used at most once per
threshold, highest-IoU pairs first. Fitness = 0.1 * mAP50 + 0.9 * mAP50-95.
The mask and keypoint IoUs and `ConfusionMatrix.plot` (matplotlib) are not
ported: no ported head needs them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

IOUV = np.linspace(0.5, 0.95, 10)


def box_iou_np(a: np.ndarray, b: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """(N,4) x (M,4) xyxy -> (N,M) IoU."""
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(br - tl, 0, None).prod(-1)
    area_a = np.clip(a[:, 2:] - a[:, :2], 0, None).prod(-1)
    area_b = np.clip(b[:, 2:] - b[:, :2], 0, None).prod(-1)
    return inter / (area_a[:, None] + area_b[None, :] - inter + eps)


def match_predictions(
    pred_boxes: np.ndarray,
    pred_cls: np.ndarray,
    gt_boxes: np.ndarray,
    gt_cls: np.ndarray,
    iouv: np.ndarray = IOUV,
) -> np.ndarray:
    """Per-image TP table (Npred, len(iouv)) bool (reference `validator.py:208-247`).

    Replicates the reference FORK's dedup order exactly: sort candidate
    (gt, pred) pairs by IoU desc, dedup by prediction, then dedup by gt
    WITHOUT re-sorting by IoU first — the fork comments out the second sort
    (`validator.py:244`), so the gt-dedup runs in ascending-prediction-index
    order. Mainline ultralytics re-sorts; the fork's 39.7 mAP protocol does
    not, and this table feeds that protocol.
    """
    correct = np.zeros((len(pred_cls), len(iouv)), dtype=bool)
    if len(gt_cls) == 0 or len(pred_cls) == 0:
        return correct
    iou = box_iou_np(gt_boxes, pred_boxes)
    correct_class = gt_cls[:, None] == pred_cls[None, :]
    iou = iou * correct_class
    for i, thr in enumerate(iouv):
        m = np.array(np.nonzero(iou >= thr)).T  # (n, 2) [gt, pred]
        if m.shape[0]:
            if m.shape[0] > 1:
                m = m[iou[m[:, 0], m[:, 1]].argsort()[::-1]]
                m = m[np.unique(m[:, 1], return_index=True)[1]]
                # no IoU re-sort here (fork behavior, see docstring)
                m = m[np.unique(m[:, 0], return_index=True)[1]]
            correct[m[:, 1].astype(int), i] = True
    return correct


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> Tuple[float, np.ndarray, np.ndarray]:
    """101-point interpolated AP (reference `compute_ap`, `utils/metrics.py:999`)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = np.trapezoid(np.interp(x, mrec, mpre), x)
    return float(ap), mpre, mrec


def smooth(y: np.ndarray, f: float = 0.05) -> np.ndarray:
    """Box filter of fraction f (reference `smooth`, `utils/metrics.py:941`)."""
    nf = round(len(y) * f * 2) // 2 + 1  # filter length (odd)
    p = np.ones(nf // 2)
    yp = np.concatenate((p * y[0], y, p * y[-1]), 0)
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


def ap_per_class(
    tp: np.ndarray,
    conf: np.ndarray,
    pred_cls: np.ndarray,
    target_cls: np.ndarray,
    eps: float = 1e-16,
) -> Dict[str, np.ndarray]:
    """AP per class over all images (reference `ap_per_class`, `utils/metrics.py:1032`).

    P/R follow the reference semantics exactly: per-class curves are
    interpolated onto a 1000-point confidence grid, and the reported P/R
    are taken at the argmax of the smoothed MEAN F1 curve (one global
    confidence threshold for all classes, `utils/metrics.py:1122-1124`) —
    verified equal to the reference implementation by
    `tests/test_metrics_reference_equivalence.py`.
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = len(unique_classes)
    x = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, tp.shape[1]))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        sel = pred_cls == c
        n_l = nt[ci]
        n_p = sel.sum()
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[sel]).cumsum(0)
        tpc = tp[sel].cumsum(0)
        recall = tpc / (n_l + eps)
        precision = tpc / (tpc + fpc)
        # negated x/xp because np.interp needs increasing xp (conf descends)
        r_curve[ci] = np.interp(-x, -conf[sel], recall[:, 0], left=0)
        p_curve[ci] = np.interp(-x, -conf[sel], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], _, _ = compute_ap(recall[:, j], precision[:, j])
    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    k = int(smooth(f1_curve.mean(0), 0.1).argmax()) if nc else 0
    return {
        "classes": unique_classes,
        "ap": ap,  # (nc, 10)
        "ap50": ap[:, 0],
        "precision": p_curve[:, k] if nc else np.zeros(0),
        "recall": r_curve[:, k] if nc else np.zeros(0),
    }


@dataclass
class DetMetrics:
    """Accumulates per-image stats and produces mAP (reference `DetMetrics`)."""

    stats: List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = field(
        default_factory=list
    )

    def update(
        self,
        tp: np.ndarray,
        conf: np.ndarray,
        pred_cls: np.ndarray,
        target_cls: np.ndarray,
    ) -> None:
        self.stats.append((tp, conf, pred_cls, target_cls))

    def compute(self) -> Dict[str, float]:
        if not self.stats:
            return {"mAP50": 0.0, "mAP50-95": 0.0, "precision": 0.0, "recall": 0.0, "fitness": 0.0}
        tp = np.concatenate([s[0] for s in self.stats])
        conf = np.concatenate([s[1] for s in self.stats])
        pc = np.concatenate([s[2] for s in self.stats])
        tc = np.concatenate([s[3] for s in self.stats])
        if len(tc) == 0 or len(conf) == 0:
            return {"mAP50": 0.0, "mAP50-95": 0.0, "precision": 0.0, "recall": 0.0, "fitness": 0.0}
        res = ap_per_class(tp, conf, pc, tc)
        map50 = float(res["ap50"].mean()) if len(res["ap50"]) else 0.0
        map5095 = float(res["ap"].mean()) if res["ap"].size else 0.0
        return {
            "mAP50": map50,
            "mAP50-95": map5095,
            "precision": float(res["precision"].mean()),
            "recall": float(res["recall"].mean()),
            "fitness": 0.1 * map50 + 0.9 * map5095,
        }


class ConfusionMatrix:
    """Detection / classification confusion matrix (reference
    `utils/metrics.py:801-940`).

    Detect: an (nc+1, nc+1) matrix indexed [predicted, actual]; the extra
    row/column is background (FP row nc->gt, FN column pred->nc). Matching
    uses a single IoU threshold (0.45) with greedy unique assignment;
    detections below `conf` 0.25 are ignored.
    """

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45,
                 task: str = "detect") -> None:
        self.nc = nc
        self.conf = 0.25 if conf in (None, 0.001) else conf
        self.iou_thres = iou_thres
        self.task = task
        n = nc + 1 if task == "detect" else nc
        self.matrix = np.zeros((n, n), dtype=np.int64)

    def process_cls_preds(self, preds, targets) -> None:
        """Classification: preds/targets are int class arrays."""
        for p, t in zip(np.asarray(preds).ravel(), np.asarray(targets).ravel()):
            self.matrix[int(p), int(t)] += 1

    def process_batch(
        self,
        pred_boxes: np.ndarray,
        pred_conf: np.ndarray,
        pred_cls: np.ndarray,
        gt_boxes: np.ndarray,
        gt_cls: np.ndarray,
    ) -> None:
        """One image. Boxes xyxy; gt_cls int."""
        gt_cls = np.asarray(gt_cls, np.int64).ravel()
        if len(gt_cls) == 0:
            if pred_boxes is not None and len(pred_boxes):
                keep = pred_conf >= self.conf
                for c in np.asarray(pred_cls)[keep].astype(np.int64):
                    self.matrix[c, self.nc] += 1  # false positive
            return
        if pred_boxes is None or len(pred_boxes) == 0:
            for c in gt_cls:
                self.matrix[self.nc, c] += 1  # false negative (background pred)
            return
        keep = np.asarray(pred_conf) >= self.conf
        pred_boxes = np.asarray(pred_boxes)[keep]
        pred_cls = np.asarray(pred_cls, np.int64)[keep]
        iou = box_iou_np(np.asarray(gt_boxes), pred_boxes)
        gi, pi = np.nonzero(iou >= self.iou_thres)
        if len(gi):
            m = np.stack([gi, pi, iou[gi, pi]], 1)
            m = m[m[:, 2].argsort()[::-1]]
            m = m[np.unique(m[:, 1], return_index=True)[1]]
            m = m[m[:, 2].argsort()[::-1]]
            m = m[np.unique(m[:, 0], return_index=True)[1]]
        else:
            m = np.zeros((0, 3))
        matched_gt = m[:, 0].astype(int)
        matched_pred = m[:, 1].astype(int)
        for g, p in zip(matched_gt, matched_pred):
            self.matrix[pred_cls[p], gt_cls[g]] += 1
        for g in range(len(gt_cls)):
            if g not in matched_gt:
                self.matrix[self.nc, gt_cls[g]] += 1
        for p in range(len(pred_cls)):
            if p not in matched_pred:
                self.matrix[pred_cls[p], self.nc] += 1

    def tp_fp(self):
        """Per-class (tp, fp) from the matrix (reference `:900-906`)."""
        tp = self.matrix.diagonal()
        fp = self.matrix.sum(1) - tp
        if self.task == "detect":
            return tp[:-1], fp[:-1]
        return tp, fp
