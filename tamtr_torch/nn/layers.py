"""Backbone and neck blocks (torch port of `tamtr_tpu/nn/layers.py`).

Convolutions run NCHW. Attribute names follow the reference checkpoint
(`conv`/`bn`, `cv1..cv5`, `m.{j}`, `cv2.0`/`cv2.1`), so state-dict keys are
the reference's. BatchNorm eps is 1e-3, the reference's value after
`initialize_weights`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3


def autopad(k: int, p: Optional[int] = None) -> int:
    """'same'-shape padding."""
    return k // 2 if p is None else p


class ConvBN(nn.Module):
    """Conv2d (no bias) + BatchNorm + SiLU, the reference's `Conv`."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: Optional[int] = None,
                 g: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p), groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=BN_EPS)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class RepConvN(nn.Module):
    """RepVGG block: 3x3 and 1x1 branches summed (no identity branch)."""

    def __init__(self, c1: int, c2: int, act: bool = True):
        super().__init__()
        self.conv1 = ConvBN(c1, c2, 3, 1, p=1, act=False)
        self.conv2 = ConvBN(c1, c2, 1, 1, p=0, act=False)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(x) + self.conv2(x)
        return F.silu(y) if self.act else y


class RepNBottleneck(nn.Module):
    """RepConvN -> Conv 3x3, with a residual when shapes allow."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = RepConvN(c1, c_)
        self.cv2 = ConvBN(c_, c2, 3, 1)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class RepNCSP(nn.Module):
    """CSP bottleneck with RepN blocks."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = ConvBN(c1, c_, 1, 1)
        self.cv3 = ConvBN(2 * c_, c2, 1, 1)
        self.m = nn.Sequential(*(RepNBottleneck(c_, c_, shortcut, e=1.0) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class RepNCSPELAN4(nn.Module):
    """YOLOv9 CSP-ELAN block."""

    def __init__(self, c1: int, c2: int, c3: int, c4: int, n: int = 1):
        super().__init__()
        self.cv1 = ConvBN(c1, c3, 1, 1)
        self.cv2 = nn.Sequential(RepNCSP(c3 // 2, c4, n), ConvBN(c4, c4, 3, 1))
        self.cv3 = nn.Sequential(RepNCSP(c4, c4, n), ConvBN(c4, c4, 3, 1))
        self.cv4 = ConvBN(c3 + 2 * c4, c2, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y1, y2 = self.cv1(x).chunk(2, 1)
        y3 = self.cv2(y2)
        y4 = self.cv3(y3)
        return self.cv4(torch.cat([y1, y2, y3, y4], 1))


class MaxSigmoidAttnBlock(nn.Module):
    """Max-sigmoid region-text attention: a per-head sigmoid gate from the
    max text similarity, applied to 3x3-projected features.

    x (B, c1, H, W); guide (B, K, gc) -> (B, c2, H, W).
    """

    def __init__(self, c1: int, c2: int, nh: int = 1, ec: int = 128, gc: int = 512):
        super().__init__()
        self.nh, self.hc, self.ec_dim = nh, c2 // nh, ec
        self.ec = ConvBN(c1, ec, 1, act=False) if c1 != ec else None
        self.gl = nn.Linear(gc, ec)
        self.bias = nn.Parameter(torch.zeros(nh))
        self.proj_conv = ConvBN(c1, c2, 3, 1, act=False)

    def forward(self, x: torch.Tensor, guide: torch.Tensor) -> torch.Tensor:
        B, _, H, W = x.shape
        g = self.gl(guide).view(B, -1, self.nh, self.ec_dim // self.nh)
        embed = x if self.ec is None else self.ec(x)
        embed = embed.view(B, self.nh, self.ec_dim // self.nh, H, W)
        aw = torch.einsum("bmchw,bkmc->bmhwk", embed, g).max(-1).values / self.hc**0.5
        aw = torch.sigmoid(aw + self.bias[None, :, None, None])
        y = self.proj_conv(x).view(B, self.nh, self.hc, H, W) * aw[:, :, None]
        return y.reshape(B, -1, H, W)


class TIAGELAN(RepNCSPELAN4):
    """Text-image attention GELAN. The reference computes its text attention
    and discards the result, so the data path is RepNCSPELAN4's; `attn` holds
    the parameters (checkpoint keys) and is not run."""

    def __init__(self, c1: int, c2: int, c3: int, c4: int, n: int = 1, nh: int = 8, gc: int = 512):
        super().__init__(c1, c2, c3, c4, n)
        self.attn = MaxSigmoidAttnBlock(c3 // 2, c4, nh=nh, ec=c4, gc=gc)

    def forward(self, x: torch.Tensor, guide: torch.Tensor) -> torch.Tensor:
        return super().forward(x)


def max_pool_same(x: torch.Tensor, k: int, s: int = 1) -> torch.Tensor:
    """MaxPool2d(k, s, padding=k//2)."""
    return F.max_pool2d(x, k, s, k // 2)


class SPPELAN(nn.Module):
    """Spatial pyramid pooling ELAN: three cascaded k5 max pools."""

    def __init__(self, c1: int, c2: int, c3: int):
        super().__init__()
        self.cv1 = ConvBN(c1, c3, 1, 1)
        self.cv5 = ConvBN(4 * c3, c2, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(max_pool_same(y[-1], 5, 1))
        return self.cv5(torch.cat(y, 1))


class CPAM(nn.Module):
    """Channel/spatial pyramid attention: maxpool(k3, s2) -> bilinear x2 ->
    crop to the input size -> sigmoid gate, then a per-eighth-of-channels
    max-over-channel sigmoid gate."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        m = max_pool_same(x, 3, 2)
        m = F.interpolate(m, scale_factor=2, mode="bilinear", align_corners=False)
        cx = torch.sigmoid(m[..., :h, :w]) * x
        return torch.cat(
            [torch.sigmoid(si.amax(1, keepdim=True)) * si for si in cx.chunk(8, 1)], 1
        )


class Upsample(nn.Module):
    """Nearest resize by 2 (repeat) or 0.5 (`x[:, :, ::2, ::2]`)."""

    def __init__(self, scale: float = 2.0):
        super().__init__()
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.scale >= 1:
            s = int(self.scale)
            return x.repeat_interleave(s, 2).repeat_interleave(s, 3)
        s = int(round(1.0 / self.scale))
        return x[:, :, ::s, ::s]


class Concat(nn.Module):
    """Channel concat of a list of NCHW maps."""

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat(list(xs), 1)


class MLP(nn.Module):
    """ReLU MLP with reference keys `layers.{j}`."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x
