"""The anchor-free YOLO heads with their DFL box distribution, and the
classification head (torch port of `tamtr_tpu/nn/yolo_head.py:25-211`:
`make_anchors`, `dist2bbox`, `bbox2dist`, `dfl_decode`, `Detect`,
`Classify`, `Proto`, `Segment`, `Pose`).

Attribute names are the reference's (`cv2.{i}.{j}`, `cv3.{i}.{j}`, and
Segment's and Pose's `cv4.{i}.{j}` and `proto.{cv1,upsample,cv2,cv3}`),
so state-dict keys are its `model.22.cv2.0.0.conv.weight`, ...: the
reference's Segment and Pose inherit Detect, as they do here. The
reference's `dfl` conv holds fixed weights (0..reg_max-1) and no flax
twin: `dfl_decode` computes the same integral without it. `Classify` keeps
the reference's `conv` and `linear` (`model.9.conv.conv.weight`,
`model.9.linear.weight`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tamtr_torch.kernels import at_least_fp32
from tamtr_torch.nn.layers import Conv2d, ConvBN, at_input_dtype


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


def _branch_outputs(branches: nn.ModuleList, feats: List[torch.Tensor]) -> torch.Tensor:
    """Each level's ConvBN, ConvBN, 1x1 conv (the last in fp32 at least),
    flattened row-major and concatenated: (B, A, c)."""
    return torch.cat([b[2](at_least_fp32(b[1](b[0](f)))).flatten(2).transpose(1, 2)
                      for f, b in zip(feats, branches)], 1)


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
        anchors, strides = (torch.from_numpy(a).to(feats[0].device) for a in
                            make_anchors([f.shape[-2:] for f in feats], self.strides))
        out = {"distri": _branch_outputs(self.cv2, feats), "scores": _branch_outputs(self.cv3, feats),
               "anchors": anchors, "strides": strides}
        if not self.training:
            boxes = dist2bbox(dfl_decode(out["distri"], self.reg_max), anchors[None]) * strides[None]
            out["pred"] = torch.cat([boxes, torch.sigmoid(at_least_fp32(out["scores"]))], -1)
        return out


class Classify(nn.Module):
    """Image classification head (the reference's `Classify`,
    `tamtr_tpu/nn/yolo_head.py:121-134`): the last feature map through a
    1x1 ConvBN to `c_hidden` channels, the global mean, then `linear` to nc
    logits in fp32 at least, as flax promotes the fp32-cast mean against
    its fp32 Dense (the reference's dropout is 0 at inference and absent in
    JAX).

    forward(feats, a list of NCHW maps or one map) -> {"logits" (B, nc),
    "pred" (B, nc) softmax}, in train and eval alike."""

    def __init__(self, nc: int = 1000, ch: Sequence[int] = (), c_hidden: int = 1280):
        super().__init__()
        self.nc = nc
        self.conv = ConvBN(ch[-1], c_hidden, 1, 1)
        self.linear = nn.Linear(c_hidden, nc)

    def forward(self, feats) -> Dict[str, torch.Tensor]:
        x = feats[-1] if isinstance(feats, (list, tuple)) else feats
        logits = self.linear(at_least_fp32(self.conv(x).mean((2, 3))))
        return {"logits": logits, "pred": logits.softmax(-1)}


class Proto(nn.Module):
    """Mask prototypes (the reference's `Proto`): ConvBN 3x3, a 2x
    transposed-conv upsample, ConvBN 3x3, ConvBN 1x1 to nm maps.

    `upsample` is the reference's `nn.ConvTranspose2d(c_, c_, 2, 2, 0,
    bias=True)`; its weight (in, out, 2, 2) is flax's `ConvTranspose`
    kernel (2, 2, in, out) flipped in both spatial axes
    (`weights.py:from_jax_variables`). It runs in fp32 at least, as flax
    promotes a bf16 input against its fp32 kernel, so the layers after it
    and the protos are fp32."""

    def __init__(self, c1: int, c_: int = 256, c2: int = 32):
        super().__init__()
        self.cv1 = ConvBN(c1, c_, 3)
        self.upsample = nn.ConvTranspose2d(c_, c_, 2, 2, 0, bias=True)
        self.cv2 = ConvBN(c_, c_, 3)
        self.cv3 = ConvBN(c_, c2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = at_least_fp32(self.cv1(x))
        x = F.conv_transpose2d(x, *at_input_dtype(x, self.upsample.weight, self.upsample.bias, owner=self.upsample),
                               stride=2)
        return self.cv3(self.cv2(x))


class Segment(Detect):
    """Instance segmentation head (the reference's `Segment`): a Detect, a
    `Proto` on the first level and per-level mask coefficients `cv4`
    (ConvBN, ConvBN, 1x1 conv to nm, c4 = max(ch[0] // 4, nm)).

    Adds to Detect's dict, in train and eval: "mask_coefs" (B, A, nm) and
    "protos" (B, nm, 2 H0, 2 W0), NCHW (the JAX head's are NHWC); both fp32
    at least."""

    def __init__(self, nc: int = 80, ch: Sequence[int] = (), nm: int = 32, npr: int = 256, reg_max: int = 16,
                 strides: Sequence[int] = (8, 16, 32)):
        super().__init__(nc, ch, reg_max, strides)
        self.nm, self.npr = nm, npr
        self.proto = Proto(ch[0], npr, nm)
        c4 = max(ch[0] // 4, nm)
        self.cv4 = nn.ModuleList(nn.Sequential(ConvBN(c, c4, 3), ConvBN(c4, c4, 3), Conv2d(c4, nm, 1)) for c in ch)

    def forward(self, feats: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = super().forward(feats)
        out["mask_coefs"] = _branch_outputs(self.cv4, feats)
        out["protos"] = self.proto(feats[0])
        return out


def decode_keypoints(kpt_raw: torch.Tensor, anchors: torch.Tensor, strides: torch.Tensor,
                     kpt_shape: Tuple[int, int]) -> torch.Tensor:
    """Raw keypoint outputs (B, A, nk * kdim) -> (B, A, nk, kdim) in input
    pixels, fp32 at least: xy = (raw * 2 + anchor - 0.5) * stride, and the
    sigmoid visibility when kdim is 3."""
    k = at_least_fp32(kpt_raw).unflatten(-1, tuple(kpt_shape))
    a, s = anchors.to(k.dtype)[None, :, None, :], strides.to(k.dtype)[None, :, None, :]
    xy = (k[..., :2] * 2.0 + (a - 0.5)) * s
    return torch.cat([xy, torch.sigmoid(k[..., 2:3])], -1) if kpt_shape[1] == 3 else xy


class Pose(Detect):
    """Keypoint head (the reference's `Pose`): a Detect and per-level
    keypoint branches `cv4` (ConvBN, ConvBN, 1x1 conv to nk = kpt_shape[0]
    * kpt_shape[1], c4 = max(ch[0] // 4, nk)).

    Adds "kpt_raw" (B, A, nk) to Detect's dict, and in eval "keypoints"
    (B, A, kpt_shape[0], kpt_shape[1]) by `decode_keypoints`."""

    def __init__(self, nc: int = 1, ch: Sequence[int] = (), kpt_shape: Tuple[int, int] = (17, 3), reg_max: int = 16,
                 strides: Sequence[int] = (8, 16, 32)):
        super().__init__(nc, ch, reg_max, strides)
        self.kpt_shape = tuple(kpt_shape)
        nk = self.kpt_shape[0] * self.kpt_shape[1]
        c4 = max(ch[0] // 4, nk)
        self.cv4 = nn.ModuleList(nn.Sequential(ConvBN(c, c4, 3), ConvBN(c4, c4, 3), Conv2d(c4, nk, 1)) for c in ch)

    def forward(self, feats: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = super().forward(feats)
        out["kpt_raw"] = _branch_outputs(self.cv4, feats)
        if not self.training:
            out["keypoints"] = decode_keypoints(out["kpt_raw"], out["anchors"], out["strides"], self.kpt_shape)
        return out
