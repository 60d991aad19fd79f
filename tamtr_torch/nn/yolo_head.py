"""The anchor-free YOLO Detect head with its DFL box distribution (torch
port of `tamtr_tpu/nn/yolo_head.py:25-118`: `make_anchors`, `dist2bbox`,
`bbox2dist`, `dfl_decode`, `Detect`).

Attribute names are the reference's (`cv2.{i}.{j}`, `cv3.{i}.{j}`), so
state-dict keys are its `model.22.cv2.0.0.conv.weight`, .... The
reference's `dfl` conv holds fixed weights (0..reg_max-1) and no flax
twin: `dfl_decode` computes the same integral without it.

Segment, Pose, Classify and Proto are not ported yet (ROADMAP queue A,
item 7).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from tamtr_torch.kernels import at_least_fp32
from tamtr_torch.nn.layers import Conv2d, ConvBN


def make_anchors(shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
                 offset: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """Anchor points (cell centres, in cells) (A, 2) and each anchor's
    stride (A, 1), levels in order, each row-major over (h, w)."""
    pts, strs = [], []
    for (h, w), s in zip(shapes, strides):
        gy, gx = np.meshgrid(np.arange(h, dtype=np.float32) + offset, np.arange(w, dtype=np.float32) + offset,
                             indexing="ij")
        pts.append(np.stack([gx, gy], -1).reshape(-1, 2))
        strs.append(np.full((h * w, 1), s, np.float32))
    return np.concatenate(pts), np.concatenate(strs)


def dist2bbox(dist: torch.Tensor, anchor_points: torch.Tensor, xywh: bool = True) -> torch.Tensor:
    """(l, t, r, b) distances -> boxes around the anchor points."""
    lt, rb = dist.chunk(2, -1)
    x1y1, x2y2 = anchor_points - lt, anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], -1)
    return torch.cat([x1y1, x2y2], -1)


def bbox2dist(bboxes_xyxy: torch.Tensor, anchor_points: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Boxes -> (l, t, r, b), clipped to [0, reg_max - 1.01]."""
    x1y1, x2y2 = bboxes_xyxy.chunk(2, -1)
    return torch.cat([anchor_points - x1y1, x2y2 - anchor_points], -1).clamp(0, reg_max - 1 - 0.01)


def dfl_decode(distri: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """The expectation of each side's softmax bin distribution (the
    reference's DFL conv), in fp32 at least: (..., 4 * reg_max) -> (..., 4)."""
    p = at_least_fp32(distri).unflatten(-1, (4, reg_max)).softmax(-1)
    return (p * torch.arange(reg_max, dtype=p.dtype, device=p.device)).sum(-1)


class Detect(nn.Module):
    """YOLOv8 Detect head over the feature levels `ch`.

    forward(feats, a list of NCHW maps) -> {"distri" (B, A, 4 * reg_max),
    "scores" (B, A, nc) logits, "anchors" (A, 2) in cells, "strides" (A, 1)};
    in eval mode also "pred" (B, A, 4 + nc): xywh boxes in input pixels and
    sigmoid scores, fp32. The box and class branches' final 1x1 convs run in
    fp32 at least, as flax promotes a bf16 input against their fp32 weights;
    the DFL softmax and the sigmoid too (JAX's islands).
    """

    def __init__(self, nc: int = 80, ch: Sequence[int] = (), reg_max: int = 16,
                 strides: Sequence[int] = (8, 16, 32)):
        super().__init__()
        self.nc, self.reg_max, self.strides = nc, reg_max, tuple(strides)
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(nn.Sequential(ConvBN(c, c2, 3), ConvBN(c2, c2, 3), Conv2d(c2, 4 * reg_max, 1))
                                 for c in ch)
        self.cv3 = nn.ModuleList(nn.Sequential(ConvBN(c, c3, 3), ConvBN(c3, c3, 3), Conv2d(c3, nc, 1)) for c in ch)

    def bias_prior(self, i: int) -> float:
        """The class bias of level i at init (the reference's `bias_init`):
        log(5 / nc / (640 / stride)^2)."""
        return math.log(5 / self.nc / (640 / self.strides[i]) ** 2)

    def forward(self, feats: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        box, cls = [], []
        for f, b, c in zip(feats, self.cv2, self.cv3):
            box.append(b[2](at_least_fp32(b[1](b[0](f)))).flatten(2).transpose(1, 2))
            cls.append(c[2](at_least_fp32(c[1](c[0](f)))).flatten(2).transpose(1, 2))
        anchors, strides = (torch.from_numpy(a).to(feats[0].device) for a in
                            make_anchors([f.shape[-2:] for f in feats], self.strides))
        out = {"distri": torch.cat(box, 1), "scores": torch.cat(cls, 1), "anchors": anchors, "strides": strides}
        if not self.training:
            boxes = dist2bbox(dfl_decode(out["distri"], self.reg_max), anchors[None]) * strides[None]
            out["pred"] = torch.cat([boxes, torch.sigmoid(at_least_fp32(out["scores"]))], -1)
        return out
