"""YOLOv8 segmentation loss: the detection loss plus a per-instance mask
BCE (torch port of `tamtr_tpu/losses/v8_seg_loss.py`; the reference's
`v8SegmentationLoss`, `utils/loss.py:331+`).

The mask term takes the top-`mask_topk` anchors of each image by their
assigned target-score weight (a fixed-size set that holds every foreground
anchor unless an image has more than `mask_topk`; anchors of weight 0 add
nothing), the gt each is assigned, the BCE of its predicted mask
(coefficients x protos) against that gt's mask, cropped to the gt box in
mask space (half-open: x1 <= x < x2) and divided by the box's area there
(at least 1), weighted like the box loss and divided by sum(target_scores).

One assignment: the JAX loss runs TAL again on the same inputs; here the
detection loss's assignment (`v8_detection_loss`'s items["assign"], or the
one given as `assign=`) serves both. `torch.topk` and `lax.top_k` may order
tied weights differently; the sum runs over the chosen set, so only a tie
at the `mask_topk`-th place could move it. Under
`parallel.dist.data_parallel`, sum(target_scores) and the batch size are
the global batch's, as in `v8_detection_loss`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from tamtr_torch.kernels import at_least_fp32
from tamtr_torch.losses.v8_loss import V8LossConfig, v8_detection_loss
from tamtr_torch.losses.variants import bce_logits
from tamtr_torch.ops.boxes import xywh2xyxy
from tamtr_torch.parallel.dist import data_groups, global_sum


@dataclass(frozen=True)
class V8SegLossConfig(V8LossConfig):
    mask_topk: int = 128  # anchors per image that enter the mask term
    overlap_mask: bool = True


def top_foreground(assign: Dict[str, torch.Tensor], k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(weights (B, K), anchor indices (B, K), gt indices (B, K)) of the K
    = min(k, A) anchors of largest assigned weight sum(target_scores) * fg
    in each image."""
    w = assign["target_scores"].sum(-1) * assign["fg_mask"].to(assign["target_scores"].dtype)
    topw, topi = w.topk(min(k, w.shape[1]), dim=1)
    return topw, topi, assign["target_gt"].gather(1, topi)


def v8_segmentation_loss(head_out: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor], cfg: V8SegLossConfig,
                         assign: Optional[Dict[str, torch.Tensor]] = None) -> Tuple[torch.Tensor, Dict]:
    """head_out: the Segment head's train dict (mask_coefs (B, A, nm),
    protos (B, nm, Hm, Wm)); targets adds "masks" (B, M, Hm, Wm) {0, 1} per
    gt at the protos' size. Returns (total, {box, cls, dfl, seg, assign})."""
    total_det, items = v8_detection_loss(head_out, targets, cfg, assign=assign)
    protos = at_least_fp32(head_out["protos"])
    mc = at_least_fp32(head_out["mask_coefs"])
    B, nm, Hm, Wm = protos.shape
    gt_masks = targets["masks"].to(protos.dtype)
    gt_px = xywh2xyxy(targets["bboxes"].to(protos.dtype)) * cfg.imgsz
    tss = global_sum(items["assign"]["target_scores"].to(protos.dtype).sum()).clamp(min=1.0)

    topw, topi, gt_idx = top_foreground(items["assign"], cfg.mask_topk)
    topw = topw.to(protos.dtype)
    rows = torch.arange(B, device=protos.device)[:, None]
    mc_k = mc.gather(1, topi[..., None].expand(-1, -1, nm))  # (B, K, nm)
    gmask_k, box_k = gt_masks[rows, gt_idx], gt_px[rows, gt_idx]  # (B, K, Hm, Wm), (B, K, 4)
    bce = bce_logits(torch.einsum("bkn,bnhw->bkhw", mc_k, protos), gmask_k)

    # crop to the gt box in mask space (pixels * Wm / imgsz)
    x1, y1, x2, y2 = (box_k[..., j:j + 1] * s for j, s in enumerate((Wm / cfg.imgsz, Hm / cfg.imgsz) * 2))
    gx = torch.arange(Wm, device=protos.device, dtype=protos.dtype)
    gy = torch.arange(Hm, device=protos.device, dtype=protos.dtype)
    crop = ((gy >= y1) & (gy < y2))[..., :, None] & ((gx >= x1) & (gx < x2))[..., None, :]
    area = ((x2 - x1) * (y2 - y1)).clamp(min=1.0).squeeze(-1)
    per_inst = (bce * crop).sum((-2, -1)) / area
    loss_mask = (per_inst * topw * (topw > 0)).sum() / tss

    g = data_groups()
    n = B * (g.data_size if g is not None else 1)
    return total_det + cfg.box * loss_mask * n, {**items, "seg": loss_mask}
