"""Box format conversions, the IoU family with TAM-TR's RIOU, and pairwise
IoU (torch port of `tamtr_tpu/ops/boxes.py`).

RIOU is a CIoU variant whose centre-distance normaliser is
``c^2 = (max(w1,h1) + max(w2,h2) + sqrt(rho2))^2`` instead of the squared
convex diagonal; the matcher cost and the box loss use it. A zero-size box
gives NaN under RIOU (0/0 in the aspect term), as in the JAX package.
"""

from __future__ import annotations

import math

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


def xywh2ltwh(x: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (left, top, w, h)."""
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - w * 0.5, cy - h * 0.5, w, h], dim=-1)


def ltwh2xywh(x: torch.Tensor) -> torch.Tensor:
    """(left, top, w, h) -> (cx, cy, w, h)."""
    l, t, w, h = x.unbind(-1)
    return torch.stack([l + w * 0.5, t + h * 0.5, w, h], dim=-1)


def ltwh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(left, top, w, h) -> (x1, y1, x2, y2)."""
    l, t, w, h = x.unbind(-1)
    return torch.stack([l, t, l + w, t + h], dim=-1)


def xyxy2ltwh(x: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (left, top, w, h)."""
    x1, y1, x2, y2 = x.unbind(-1)
    return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1)


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True, GIoU: bool = False,
             DIoU: bool = False, CIoU: bool = False, RIOU: bool = False, eps: float = 1e-7) -> torch.Tensor:
    """Elementwise (broadcasting) IoU between box1 and box2 (trailing axis 4);
    the result keeps a trailing axis of 1. `alpha` of CIoU/RIOU carries no
    gradient, as in the JAX package (`ops/boxes.py:99`)."""
    if xywh:
        x1, y1, w1, h1 = box1.split(1, -1)
        x2, y2, w2, h2 = box2.split(1, -1)
        b1_x1, b1_x2, b1_y1, b1_y2 = x1 - w1 * 0.5, x1 + w1 * 0.5, y1 - h1 * 0.5, y1 + h1 * 0.5
        b2_x1, b2_x2, b2_y1, b2_y2 = x2 - w2 * 0.5, x2 + w2 * 0.5, y2 - h2 * 0.5, y2 + h2 * 0.5
    else:
        b1_x1, b1_y1, b1_x2, b1_y2 = box1.split(1, -1)
        b2_x1, b2_y1, b2_x2, b2_y2 = box2.split(1, -1)
        w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
        w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps

    inter = (torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1)).clamp(min=0) * (
        torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1)
    ).clamp(min=0)
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if not (GIoU or DIoU or CIoU or RIOU):
        return iou

    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
    if CIoU or DIoU or RIOU:
        rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2 + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4.0
        if CIoU or RIOU:
            v = (4.0 / math.pi**2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
            with torch.no_grad():
                alpha = v / (v - iou + (1.0 + eps))
            if RIOU:  # rotation-invariant enclosing measure instead of the convex diagonal
                c2 = (torch.maximum(w1, h1) + torch.maximum(w2, h2) + torch.sqrt(rho2) + eps) ** 2
            else:
                c2 = cw**2 + ch**2 + eps
            return iou - (rho2 / c2 + v * alpha)
        c2 = cw**2 + ch**2 + eps
        return iou - rho2 / c2
    c_area = cw * ch + eps
    return iou - (c_area - union) / c_area


def box_iou_pairwise(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Pairwise IoU between two sets of xyxy boxes: (N, 4) x (M, 4) -> (N, M)."""
    a1, a2 = box1[:, None, :2], box1[:, None, 2:]
    b1, b2 = box2[None, :, :2], box2[None, :, 2:]
    inter = (torch.minimum(a2, b2) - torch.maximum(a1, b1)).clamp(min=0).prod(-1)
    area1 = (a2 - a1).prod(-1)
    area2 = (b2 - b1).prod(-1)
    return inter / (area1 + area2 - inter + eps)
