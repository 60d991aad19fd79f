"""YOLOv8 detection loss: BCE classes, CIoU boxes and the DFL (torch port
of `tamtr_tpu/losses/v8_loss.py`; the reference's `utils/loss.py:235-330`).

Targets arrive padded (B, M) with a mask. The assigner (`losses/tal.py`)
runs in pixels on the decoded predictions, without gradient. The class BCE
over every anchor and the box and DFL terms over the foreground anchors are
each divided by sum(target_scores); the total is box * 7.5 + cls * 0.5 +
dfl * 1.5 (the config's gains) times the batch size. Under
`parallel.dist.data_parallel` sum(target_scores) and the batch size are
the global batch's: a rank's loss is then its share of the global loss.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from tamtr_torch.kernels import at_least_fp32
from tamtr_torch.losses.tal import task_aligned_assigner
from tamtr_torch.losses.variants import bce_logits
from tamtr_torch.nn.yolo_head import bbox2dist, dfl_decode, dist2bbox
from tamtr_torch.ops.boxes import bbox_iou, xywh2xyxy
from tamtr_torch.parallel.dist import data_groups, global_sum


@dataclass(frozen=True)
class V8LossConfig:
    nc: int = 80
    reg_max: int = 16
    box: float = 7.5
    cls: float = 0.5
    dfl: float = 1.5
    imgsz: int = 640


def v8_detection_loss(head_out: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor], cfg: V8LossConfig,
                      assign: Optional[Dict[str, torch.Tensor]] = None) -> Tuple[torch.Tensor, Dict]:
    """head_out: the Detect head's train dict; targets: cls (B, M), bboxes
    (B, M, 4) normalized cxcywh, mask (B, M). `assign`, if given, is an
    assigner's output (target_bboxes, target_scores, fg_mask) used in place
    of this call's, so that two runs can be compared with the assignment
    held fixed. Returns (total, {"box", "cls", "dfl", "assign"})."""
    distri = at_least_fp32(head_out["distri"])  # (B, A, 4 * reg_max)
    scores = at_least_fp32(head_out["scores"])  # (B, A, nc)
    anchors, strides = head_out["anchors"].to(distri.dtype), head_out["strides"].to(distri.dtype)
    B, A, _ = scores.shape

    # predictions decoded in anchor (stride) units, assigned in pixels
    pred_xyxy = dist2bbox(dfl_decode(distri, cfg.reg_max), anchors[None], xywh=False)
    pred_xyxy_px = pred_xyxy * strides[None]
    if assign is None:
        gt_xyxy_px = xywh2xyxy(targets["bboxes"].to(distri.dtype)) * cfg.imgsz
        assign = task_aligned_assigner(torch.sigmoid(scores.detach()), pred_xyxy_px.detach(), anchors * strides,
                                       targets["cls"], gt_xyxy_px, targets["mask"])
    fg = assign["fg_mask"].to(distri.dtype)
    t_scores = assign["target_scores"].to(distri.dtype)
    t_boxes_px = assign["target_bboxes"].to(distri.dtype)
    tss = global_sum(t_scores.sum()).clamp(min=1.0)

    loss_cls = bce_logits(scores, t_scores).sum() / tss
    w = t_scores.sum(-1)  # (B, A)
    ciou = bbox_iou(pred_xyxy_px, t_boxes_px, xywh=False, CIoU=True).squeeze(-1)
    loss_box = (((1.0 - ciou) * w) * fg).sum() / tss

    # DFL: cross-entropy against the two integer bins around the target distance
    t_dist = bbox2dist(t_boxes_px / strides[None], anchors[None], cfg.reg_max)  # (B, A, 4)
    tl = t_dist.floor().long()
    tr = tl + 1
    wl = tr.to(t_dist.dtype) - t_dist
    logp = distri.unflatten(-1, (4, cfg.reg_max)).log_softmax(-1)
    ce_l = -logp.gather(-1, tl[..., None]).squeeze(-1)
    ce_r = -logp.gather(-1, tr.clamp(0, cfg.reg_max - 1)[..., None]).squeeze(-1)
    dfl = (ce_l * wl + ce_r * (1.0 - wl)).mean(-1)
    loss_dfl = ((dfl * w) * fg).sum() / tss

    g = data_groups()
    n = B * (g.data_size if g is not None else 1)
    total = (cfg.box * loss_box + cfg.cls * loss_cls + cfg.dfl * loss_dfl) * n
    return total, {"box": loss_box, "cls": loss_cls, "dfl": loss_dfl, "assign": assign}
