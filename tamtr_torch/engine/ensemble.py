"""Model ensembling (a port of the JAX package's `tamtr_tpu/engine/ensemble.py`;
the reference's `nn/tasks.py:Ensemble` + `attempt_load_weights`).

The reference concatenates the detection outputs of several checkpoints and
lets NMS merge them. Here `ensemble_predict` runs each model's predictor
and merges the per-image detections with one final class-aware NMS.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np

from tamtr_torch.engine.results import Results
from tamtr_torch.models.sam.predict import _nms_numpy


def _nms_classwise(boxes: np.ndarray, scores: np.ndarray, labels: np.ndarray, iou_thresh: float) -> np.ndarray:
    """Greedy class-aware NMS on the host (small N after each model's NMS):
    the kept indices, by score."""
    keep_all = []
    for c in np.unique(labels):
        idx = np.nonzero(labels == c)[0]
        keep = _nms_numpy(boxes[idx], scores[idx], iou_thresh)
        keep_all.extend(idx[keep].tolist())
    return np.asarray(sorted(keep_all, key=lambda i: -scores[i]), np.int64)


def ensemble_predict(models: Sequence[Any], source: Any, iou: float = 0.7, max_det: int = 300,
                     **predict_kwargs: Any) -> List[Results]:
    """Predict with every model and merge the detections per image.

    `models`: facades (TAMTR, YOLO, ...) or Engines with loaded weights;
    all must share the class vocabulary and see the same images.
    """
    if not models:
        raise ValueError("need at least one model")
    per_model = [m.predict(source, **predict_kwargs) for m in models]
    n_images = len(per_model[0])
    if any(len(r) != n_images for r in per_model):
        raise ValueError("models saw different sources")
    merged: List[Results] = []
    for i in range(n_images):
        rs = [pm[i] for pm in per_model]
        boxes = np.concatenate([r.boxes.xyxy for r in rs])
        scores = np.concatenate([r.boxes.conf for r in rs])
        labels = np.concatenate([r.boxes.cls for r in rs]).astype(np.int64)
        if len(boxes):
            keep = _nms_classwise(boxes, scores, labels, iou)[:max_det]
            boxes, scores, labels = boxes[keep], scores[keep], labels[keep]
        r0 = rs[0]
        merged.append(Results(r0.path, boxes, scores, labels, r0.names, orig_shape=r0.orig_shape))
    return merged
