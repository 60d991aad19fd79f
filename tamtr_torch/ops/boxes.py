"""Box format conversions and pairwise IoU (torch port of `tamtr_tpu/ops/boxes.py`).

The IoU family with RIOU (`bbox_iou`) belongs to the training slice and is
not here yet.
"""

from __future__ import annotations

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2). Last axis is 4."""
    cx, cy, w, h = x.unbind(-1)
    hw, hh = w * 0.5, h * 0.5
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], dim=-1)


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h). Last axis is 4."""
    x1, y1, x2, y2 = x.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], dim=-1)


def box_iou_pairwise(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Pairwise IoU between two sets of xyxy boxes: (N, 4) x (M, 4) -> (N, M)."""
    a1, a2 = box1[:, None, :2], box1[:, None, 2:]
    b1, b2 = box2[None, :, :2], box2[None, :, 2:]
    inter = (torch.minimum(a2, b2) - torch.maximum(a1, b1)).clamp(min=0).prod(-1)
    area1 = (a2 - a1).prod(-1)
    area2 = (b2 - b1).prod(-1)
    return inter / (area1 + area2 - inter + eps)
