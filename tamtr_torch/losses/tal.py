"""Task-aligned assigner (TAL) for the YOLO Detect loss (torch port of
`tamtr_tpu/losses/tal.py`; the reference's `TaskAlignedAssigner`,
`utils/tal.py:60-248`).

The alignment metric is score^alpha * CIoU^beta over the anchors whose
centre lies inside a gt box; each gt takes its top-k anchors; an anchor
claimed by several gts goes to the one it overlaps most; the target score
of an anchor is its alignment scaled by its gt's best IoU over its gt's
best alignment. Ground truth is padded (B, M) with a validity mask.

It makes labels, not gradients: it runs without autograd. `torch.topk` and
`jax.lax.top_k` may order near-tied candidates differently; only the set of
the k largest enters, so they differ only where the k-th and the (k+1)-th
alignments tie. The bool reductions are cast to integers first (a CUDA
argmax takes no bool).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from tamtr_torch.ops.boxes import bbox_iou


@torch.no_grad()
def task_aligned_assigner(pred_scores: torch.Tensor, pred_bboxes: torch.Tensor, anchor_points: torch.Tensor,
                          gt_cls: torch.Tensor, gt_bboxes: torch.Tensor, gt_mask: torch.Tensor, topk: int = 10,
                          alpha: float = 0.5, beta: float = 6.0, eps: float = 1e-9) -> Dict[str, torch.Tensor]:
    """pred_scores (B, A, nc) after the sigmoid; pred_bboxes (B, A, 4) xyxy;
    anchor_points (A, 2); gt_cls (B, M); gt_bboxes (B, M, 4) xyxy, in the
    units of the anchors; gt_mask (B, M). Returns target_bboxes (B, A, 4),
    target_scores (B, A, nc), fg_mask (B, A) bool and target_gt (B, A)."""
    B, A, nc = pred_scores.shape
    M = gt_cls.shape[1]
    gt_mask = gt_mask.bool()
    gt_cls = gt_cls.long()

    # candidates: anchor centres inside the gt boxes
    lt = anchor_points[None, None] - gt_bboxes[:, :, None, :2]  # (B, M, A, 2)
    rb = gt_bboxes[:, :, None, 2:] - anchor_points[None, None]
    in_gts = torch.cat([lt, rb], -1).amin(-1) > eps  # (B, M, A)

    # the alignment metric
    ps = pred_scores.transpose(1, 2).gather(1, gt_cls[:, :, None].expand(B, M, A))  # (B, M, A)
    iou = bbox_iou(gt_bboxes[:, :, None, :], pred_bboxes[:, None, :, :], xywh=False, CIoU=True).squeeze(-1)
    iou = iou.clamp(min=0.0)
    align = torch.where(in_gts & gt_mask[:, :, None], ps**alpha * iou**beta, 0.0)

    # the top k anchors of each gt
    topk_val, topk_idx = align.topk(topk, -1)  # (B, M, k)
    cand = torch.zeros((B, M, A + 1), dtype=torch.uint8, device=align.device)
    cand.scatter_(2, torch.where(topk_val > eps, topk_idx, A), 1)
    cand = cand[..., :A].bool() & gt_mask[:, :, None]

    # an anchor claimed by several gts keeps the one of highest IoU
    n_claims = cand.sum(1)  # (B, A)
    best_gt = torch.where(cand, iou, -1.0).argmax(1)  # (B, A)
    own = torch.arange(M, device=align.device)[None, :, None] == best_gt[:, None, :]
    mask_pos = torch.where(n_claims[:, None, :] > 1, own, cand) & cand  # (B, M, A)

    fg_mask = mask_pos.any(1)  # (B, A)
    target_gt = torch.where(fg_mask, mask_pos.to(torch.uint8).argmax(1), 0)  # (B, A)
    t_cls = gt_cls.gather(1, target_gt)
    t_boxes = gt_bboxes.gather(1, target_gt[..., None].expand(B, A, 4))

    # the normalised target scores (`tal.py:126-131`)
    align_pos = torch.where(mask_pos, align, 0.0)
    max_align = align_pos.amax(-1, keepdim=True)  # (B, M, 1)
    max_iou = torch.where(mask_pos, iou, 0.0).amax(-1, keepdim=True)
    norm_align = (align_pos * max_iou / (max_align + eps)).amax(1)  # (B, A)
    t_scores = F.one_hot(t_cls, nc).to(norm_align.dtype) * norm_align[..., None]
    t_scores = torch.where(fg_mask[..., None], t_scores, 0.0)
    return {"target_bboxes": t_boxes, "target_scores": t_scores, "fg_mask": fg_mask, "target_gt": target_gt}
