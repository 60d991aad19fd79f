"""YOLOv8 pose loss: the detection loss plus an OKS-style keypoint term and
a visibility BCE (torch port of `tamtr_tpu/losses/v8_pose_loss.py`; the
reference's `v8PoseLoss`).

Over the top-`mask_topk` anchors by assigned weight (`v8_seg_loss.py:
top_foreground`), each predicted keypoint's squared distance d^2 to its
gt's gives 1 - exp(-d^2 / (2 (area + 1e-9) 4 sigma^2)), area that of the
assigned gt box (at least 1), averaged over the visible keypoints; with
kdim 3 a BCE of the visibility logits against visibility > 0 (`kobj`).
Each is weighted like the box loss and divided by sum(target_scores); the
total adds (pose * 12.0 + kobj * 1.0 by default) times the batch size.

One assignment, the detection loss's (or `assign=`), as in
`v8_seg_loss.py`; under `parallel.dist.data_parallel` sum(target_scores)
and the batch size are the global batch's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tamtr_torch.kernels import at_least_fp32
from tamtr_torch.losses.v8_loss import V8LossConfig, v8_detection_loss
from tamtr_torch.losses.v8_seg_loss import top_foreground
from tamtr_torch.losses.variants import bce_logits
from tamtr_torch.parallel.dist import data_groups, global_sum

# COCO-17 OKS sigmas (the reference's `utils/metrics.py:OKS_SIGMA`), float32
OKS_SIGMA = np.array([0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62, 1.07, 1.07, 0.87, 0.87,
                      0.89, 0.89], np.float32) / 10.0


@dataclass(frozen=True)
class V8PoseLossConfig(V8LossConfig):
    kpt_shape: Tuple[int, int] = (17, 3)
    pose: float = 12.0
    kobj: float = 1.0
    mask_topk: int = 128


def keypoint_sigmas(nk: int) -> np.ndarray:
    """OKS_SIGMA for 17 keypoints, else 1 / nk each."""
    return OKS_SIGMA if nk == 17 else np.full((nk,), 1.0 / nk, np.float32)


def v8_pose_loss(head_out: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor], cfg: V8PoseLossConfig,
                 assign: Optional[Dict[str, torch.Tensor]] = None) -> Tuple[torch.Tensor, Dict]:
    """head_out: the Pose head's train dict (kpt_raw (B, A, nk * kdim));
    targets adds "keypoints" (B, M, nk, 3) in input pixels (x, y,
    visibility). Returns (total, {box, cls, dfl, pose, kobj, assign})."""
    total_det, items = v8_detection_loss(head_out, targets, cfg, assign=assign)
    k3 = at_least_fp32(head_out["kpt_raw"])
    dt = k3.dtype
    B, A, _ = k3.shape
    nk, kdim = cfg.kpt_shape
    k3 = k3.view(B, A, nk, kdim)
    anchors, strides = head_out["anchors"].to(dt)[None, :, None, :], head_out["strides"].to(dt)[None, :, None, :]
    xy_pred = (k3[..., :2] * 2.0 + (anchors - 0.5)) * strides
    a = items["assign"]
    tss = global_sum(a["target_scores"].to(dt).sum()).clamp(min=1.0)

    topw, topi, gt_idx = top_foreground(a, cfg.mask_topk)
    topw = topw.to(dt)
    valid = (topw > 0).to(dt)
    rows = torch.arange(B, device=k3.device)[:, None]
    gt_kpts = targets["keypoints"].to(dt)[rows, gt_idx]  # (B, K, nk, 3)
    xy_k = xy_pred[rows, topi]  # (B, K, nk, 2)
    box_k = a["target_bboxes"].to(dt)[rows, topi]
    area = ((box_k[..., 2] - box_k[..., 0]) * (box_k[..., 3] - box_k[..., 1])).clamp(min=1.0)

    kpt_mask = (gt_kpts[..., 2] > 0).to(dt)  # (B, K, nk)
    d2 = (xy_k - gt_kpts[..., :2]).square().sum(-1)
    sig = torch.as_tensor(keypoint_sigmas(nk), device=k3.device).to(dt)
    e = d2 / (2.0 * (area[..., None] + 1e-9) * (4 * sig.square()))
    kpt_loss = ((1.0 - torch.exp(-e)) * kpt_mask).sum(-1) / kpt_mask.sum(-1).clamp(min=1.0)
    loss_pose = (kpt_loss * topw * valid).sum() / tss

    loss_kobj = k3.new_zeros(())
    if kdim == 3:
        bce = bce_logits(k3[..., 2][rows, topi], kpt_mask)  # (B, K, nk)
        loss_kobj = (bce.mean(-1) * topw * valid).sum() / tss

    g = data_groups()
    n = B * (g.data_size if g is not None else 1)
    total = total_det + (cfg.pose * loss_pose + cfg.kobj * loss_kobj) * n
    return total, {**items, "pose": loss_pose, "kobj": loss_kobj}
