"""Fixed-slot greedy NMS and eval-output postprocessing (torch port of
`tamtr_tpu/ops/nms.py`), with no torchvision.

The IoU matrix is computed on the tensors' device; the greedy keep sweep runs
on the host over a (N, N) boolean matrix, N = the number of queries (100 at
full width), so it costs one small copy instead of N tiny device launches.
Results keep the JAX package's static layout: `max_det` slots, -1 padded,
with a validity mask.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from tamtr_torch.ops.boxes import box_iou_pairwise, xywh2xyxy

MAX_WH = 7680.0  # class offset: boxes of different classes never overlap


def nms(
    boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.45, max_det: int = 300
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS on xyxy boxes.

    Args:
      boxes: (N, 4) xyxy.
      scores: (N,) confidence; entries <= 0 are ignored.
    Returns:
      keep: (max_det,) int32 indices into the input (score-sorted), -1 padded.
      keep_mask: (max_det,) bool.
    """
    order = torch.argsort(-scores, stable=True)
    b = boxes[order]
    s = scores[order]
    over = (box_iou_pairwise(b, b) > iou_threshold).cpu().numpy()
    alive = (s > 0).cpu().numpy()
    for i in range(len(alive)):
        if alive[i]:  # a kept box suppresses the lower-scored boxes it overlaps
            alive[i + 1 :] &= ~over[i, i + 1 :]
    kept = order[torch.from_numpy(alive).to(order.device)][:max_det]
    out = torch.full((max_det,), -1, dtype=torch.int32, device=boxes.device)
    out[: kept.numel()] = kept.to(torch.int32)
    return out, out >= 0


def multiclass_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    labels: torch.Tensor,
    iou_threshold: float = 0.45,
    max_det: int = 300,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class NMS via the class-offset trick."""
    off = labels.to(boxes.dtype)[:, None] * MAX_WH
    return nms(boxes + off, scores, iou_threshold, max_det)


def postprocess_predictions(
    pred: torch.Tensor, conf_thres: float = 0.4, iou_thres: float = 0.6, max_det: int = 300,
    legacy_val_mask: bool = False, classes: Optional[Sequence[int]] = None, single_cls: bool = False,
):
    """Decode the head's eval output for a batch: best class per query,
    strict `> conf_thres` filter, then class-offset NMS per image.

    - `classes`: a query whose best class is not in `classes` is dropped,
      not given its best allowed class (the filter follows the argmax).
    - `single_cls`: every detection gets class 0, so all suppress each other.
    - `legacy_val_mask`: the reference val protocol's quirk: the conf mask
      is computed in the original query order but applied to the
      score-sorted array, so query i survives iff the original query at i's
      sort rank passed the threshold. The validator sets it, predict keeps
      the plain filter (`tamtr_tpu/ops/nms.py:postprocess_predictions`).

    Args:
      pred: (B, nq, 4 + nc) normalized cxcywh + sigmoid scores.
    Returns:
      boxes_xyxy (B, max_det, 4) normalized, scores (B, max_det),
      labels (B, max_det) int32, valid (B, max_det) bool, and the kept
      source query indices (B, max_det) int32 (0 where not valid).
    """
    bboxes = xywh2xyxy(pred[..., :4])
    scores, labels = pred[..., 4:].max(-1)
    if classes is not None:
        allowed = torch.zeros(pred.shape[-1] - 4, dtype=torch.bool, device=pred.device)
        allowed[torch.as_tensor(list(classes), dtype=torch.long, device=pred.device)] = True
        scores = torch.where(allowed[labels], scores, torch.zeros_like(scores))
    if single_cls:
        labels = torch.zeros_like(labels)
    if legacy_val_mask:
        ranks = torch.argsort(torch.argsort(-scores, dim=-1, stable=True), dim=-1, stable=True)
        gate = torch.gather(scores, -1, ranks) > conf_thres
    else:
        gate = scores > conf_thres
    scores = torch.where(gate, scores, torch.zeros_like(scores))
    outs = []
    for b, s, lab in zip(bboxes, scores, labels):
        keep, valid = multiclass_nms(b, s, lab, iou_thres, max_det)
        safe = torch.where(valid, keep, torch.zeros_like(keep)).long()
        outs.append((
            b[safe],
            torch.where(valid, s[safe], torch.zeros_like(s[safe])),
            lab[safe].to(torch.int32),
            valid,
            safe.to(torch.int32),
        ))
    return tuple(torch.stack(parts) for parts in zip(*outs))
