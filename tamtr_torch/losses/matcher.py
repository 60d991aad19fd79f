"""Hungarian matching for the DETR loss (torch port of
`tamtr_tpu/losses/matcher.py`).

The cost matrix (focal class cost + L1 + RIOU) is computed with ground truth
padded to `max_gt` and a validity mask. Solvers:

- `method="auto"`/"auction": `kernels.auction.auction_assignment`: kernel
  B5 in one launch on the card, its plain version on the CPU; images with
  more valid gts than queries are solved transposed.
- `method="scipy"`: the host oracle, `linear_sum_assignment` per image.
"""

from __future__ import annotations

import numpy as np
import torch

from tamtr_torch.kernels.auction import auction_assignment
from tamtr_torch.ops.boxes import bbox_iou

COST_CLASS = 2.0
COST_BBOX = 5.0
COST_GIOU = 2.0
FL_ALPHA = 0.25
FL_GAMMA = 2.0


def _solve_host(cost: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
    """Per-image LSA on the valid gt columns. cost (B, nq, M) -> (B, M) query
    index matched to each gt (or -1)."""
    from scipy.optimize import linear_sum_assignment

    B, nq, M = cost.shape
    out = np.full((B, M), -1, dtype=np.int32)
    for b in range(B):
        n = int(n_valid[b])
        if n == 0:
            continue
        c = np.nan_to_num(cost[b, :, :n], nan=0.0, posinf=0.0, neginf=0.0)
        rows, cols = linear_sum_assignment(c)
        out[b, cols] = rows.astype(np.int32)
    return out


def match_cost(pred_bboxes, pred_scores, gt_bboxes, gt_cls) -> torch.Tensor:
    """(B, nq, M) matching cost of predictions (cxcywh, logits) against
    padded gts, without gradient; NaN and inf become 0."""
    pred_bboxes, pred_scores = pred_bboxes.detach(), pred_scores.detach()
    B, nq, _ = pred_scores.shape
    M = gt_bboxes.shape[1]
    p = torch.sigmoid(pred_scores)
    ps = p.gather(2, gt_cls.long()[:, None, :].expand(B, nq, M))
    neg = (1 - FL_ALPHA) * (ps**FL_GAMMA) * (-torch.log(1 - ps + 1e-8))
    pos = FL_ALPHA * ((1 - ps) ** FL_GAMMA) * (-torch.log(ps + 1e-8))
    cost_bbox = (pred_bboxes[:, :, None, :] - gt_bboxes[:, None, :, :]).abs().sum(-1)
    riou = bbox_iou(pred_bboxes[:, :, None, :], gt_bboxes[:, None, :, :], xywh=True, RIOU=True)
    C = COST_CLASS * (pos - neg) + COST_BBOX * cost_bbox + COST_GIOU * (1.0 - riou.squeeze(-1))
    return torch.nan_to_num(C, nan=0.0, posinf=0.0, neginf=0.0)


def hungarian_match(pred_bboxes, pred_scores, gt_bboxes, gt_cls, gt_mask, method: str = "auto"):
    """Optimal assignment between predictions and padded ground truth.

    pred_bboxes (B, nq, 4) cxcywh; pred_scores (B, nq, nc) logits; gt_bboxes
    (B, M, 4); gt_cls (B, M); gt_mask (B, M) bool (valid entries contiguous
    from 0). Returns (B, M) int32: matched query per gt, -1 for padding.
    """
    C = match_cost(pred_bboxes, pred_scores, gt_bboxes, gt_cls)
    if method in ("auto", "auction"):
        return auction_assignment(C, gt_mask)
    if method != "scipy":
        raise ValueError(f"unknown match method {method!r}")
    out = _solve_host(C.float().cpu().numpy(), gt_mask.sum(1).cpu().numpy())
    return torch.where(gt_mask, torch.from_numpy(out).to(C.device), -1)
