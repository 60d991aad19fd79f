"""Backbone and neck blocks (torch port of `tamtr_tpu/nn/layers.py`).

Convolutions run NCHW. Attribute names follow the reference checkpoint
(`conv`/`bn`, `cv1..cv5`, `m.{j}`, `cv2.0`/`cv2.1`), so state-dict keys are
the reference's. BatchNorm eps is 1e-3, the reference's value after
`initialize_weights`. In train mode BatchNorm follows the JAX package (flax
momentum 0.97, running variance from the biased batch variance), and
DropPath draws its masks from a generator the caller passes in; under
`parallel.dist.data_parallel` both act over the global batch.

Compute dtype (flax's `dtype` with fp32 `param_dtype`): the parameters stay
fp32, and each `Linear` and `Conv2d` computes in its input's dtype with its
weight cast at use (`at_input_dtype`), so autograd carries every gradient
back to the fp32 master; without autograd the casts are kept until the
weights change. `TAMTRModel` casts its inputs to the model's
dtype; the fp32 islands cast their inputs up. BatchNorm is one: fp32 in
train mode, the activation's dtype in eval (its statistics stay fp32).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tamtr_torch.kernels import at_least_fp32
from tamtr_torch.parallel.dist import all_reduce_sum, batch_rows, data_groups

BN_EPS = 1e-3
BN_MOMENTUM = 0.03  # torch convention: running = (1 - 0.03) running + 0.03 batch (flax 0.97)


def at_input_dtype(x: torch.Tensor, *params: Optional[torch.Tensor], owner: Optional[nn.Module] = None):
    """`params` cast to x's dtype for one use (None stays None): a layer
    computes in its input's dtype, as flax's `dtype=x.dtype` does, and the
    gradient of the cast returns to the fp32 parameter. At x's dtype the
    parameters themselves, uncopied.

    Given the module `owner` that holds `params`, and no gradient to carry
    (grad mode off, or parameters that take none), the casts are kept on
    `owner` and made again only when a parameter changes (its storage or
    version counter, as `engine/model.py:weights_key` reads them): an eval
    forward at bf16 then casts each weight once, not on every call."""
    if all(p is None or p.dtype == x.dtype for p in params):
        return list(params)
    if owner is None or (torch.is_grad_enabled() and any(p is not None and p.requires_grad for p in params)):
        return [None if p is None else p.to(x.dtype) for p in params]
    stamp = (x.dtype,) + tuple(None if p is None else (p.data_ptr(), -1 if p.is_inference() else p._version)
                               for p in params)
    kept = owner.__dict__.get("_cast_at_use")
    if kept is None or kept[0] != stamp or any(a is not b for a, b in zip(kept[1], params)):
        with torch.inference_mode(False), torch.no_grad():  # ordinary tensors, also under inference mode
            casts = [None if p is None else p.detach().to(x.dtype) for p in params]
        kept = owner.__dict__["_cast_at_use"] = (stamp, params, casts)
    return list(kept[2])


class Linear(nn.Linear):
    """nn.Linear computing in its input's dtype (`at_input_dtype`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, *at_input_dtype(x, self.weight, self.bias, owner=self))


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in its input's dtype (`at_input_dtype`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, *at_input_dtype(x, self.weight, self.bias, owner=self))


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm returning its input's dtype: a bf16 input is normalised
    in fp32 against the fp32 affine and rounded once, as flax's LayerNorm
    with `dtype=x.dtype` computes (the card's layer_norm takes no bf16 input
    with fp32 weights)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(at_least_fp32(x)).to(x.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d whose train mode updates the running statistics as
    flax's BatchNorm does: running_var moves towards the biased batch
    variance, where `nn.BatchNorm2d` uses the unbiased one. Normalisation
    uses the biased batch variance in both. Eval mode is `nn.BatchNorm2d`'s.

    Under `parallel.dist.data_parallel` with more than one data rank the
    moments are the global batch's: every rank's (count, mean, biased
    variance) per channel, exchanged in one differentiable all-reduce, are
    merged as Chan et al. merge partial moments (the global mean, and the
    mean of each rank's variance plus its mean's squared offset from the
    global one), so the backward sees the global moments too. (flax's
    one-pass E[x^2] - E[x]^2 moved a nano step's loss 7.6e-4 from the
    one-process step's; the merged centred moments keep it within 1e-5.)

    In train mode the moments and the normalisation run in fp32 and the
    result returns in x's dtype (`tamtr_tpu/nn/layers.py:64-76`); in eval
    the normalisation takes x's dtype, as F.batch_norm computes a bf16 x
    against the fp32 statistics in fp32 and rounds once."""

    def __init__(self, num_features: int, eps: float = BN_EPS):
        super().__init__(num_features, eps=eps, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        return self._train_forward(at_least_fp32(x)).to(x.dtype)

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        groups = data_groups()
        if groups is not None and groups.data_size > 1:
            return self._global_batch_norm(x, groups)
        with torch.no_grad():
            var, mean = torch.var_mean(x, (0, 2, 3), unbiased=False)
            self.running_mean.mul_(1.0 - BN_MOMENTUM).add_(mean, alpha=BN_MOMENTUM)
            self.running_var.mul_(1.0 - BN_MOMENTUM).add_(var, alpha=BN_MOMENTUM)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _global_batch_norm(self, x: torch.Tensor, groups) -> torch.Tensor:
        C = x.shape[1]
        var, mean = torch.var_mean(x, (0, 2, 3), unbiased=False)
        mine = torch.cat([x.new_full((1,), x.numel() // C), mean, var])
        # row r holds rank r's moments: the sum of the rows is the all-gather
        own = (torch.arange(groups.data_size, device=x.device) == groups.data_rank).to(x.dtype)
        rows = all_reduce_sum(own[:, None] * mine, groups.data)
        counts, means, vars_ = rows[:, :1], rows[:, 1:C + 1], rows[:, C + 1:]
        total = counts.sum()
        mean = (counts * means).sum(0) / total
        var = (counts * (vars_ + (means - mean).square())).sum(0) / total
        with torch.no_grad():
            self.running_mean.mul_(1.0 - BN_MOMENTUM).add_(mean, alpha=BN_MOMENTUM)
            self.running_var.mul_(1.0 - BN_MOMENTUM).add_(var, alpha=BN_MOMENTUM)
            self.num_batches_tracked += 1
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]


class DropPath(nn.Module):
    """Stochastic depth over the batch dim (`tamtr_tpu/nn/layers.py:476`):
    in train mode each sample's branch is kept with probability 1 - rate and
    scaled by 1 / (1 - rate). The masks come from the caller's generator."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        if generator is None:
            raise ValueError("DropPath in train mode needs an explicit torch.Generator")
        keep = 1.0 - self.rate
        # drawn for the global batch under `data_parallel` (`batch_rows`)
        u = batch_rows(lambda b: torch.rand((b,) + (1,) * (x.ndim - 1), generator=generator, device=x.device),
                       x.shape[0])
        return x * (u < keep) / keep


def autopad(k: int, p: Optional[int] = None) -> int:
    """'same'-shape padding."""
    return k // 2 if p is None else p


class ConvBN(nn.Module):
    """Conv2d (no bias) + BatchNorm + SiLU, the reference's `Conv`."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: Optional[int] = None,
                 g: int = 1, act: bool = True):
        super().__init__()
        self.conv = Conv2d(c1, c2, k, s, autopad(k, p), groups=g, bias=False)
        self.bn = BatchNorm2d(c2)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class DWConvBN(ConvBN):
    """Depthwise ConvBN (`tamtr_tpu/nn/layers.py:82`): groups min(c1, c2)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, act: bool = True):
        super().__init__(c1, c2, k, s, g=min(c1, c2), act=act)


class RepConvN(nn.Module):
    """RepVGG block: 3x3 and 1x1 branches summed (no identity branch). With
    deploy=True it is the fused form (`tamtr_tpu/nn/layers.py:113-122`): one
    biased 3x3 conv `fused`, whose weights `nn.fuse.fuse_repconv` makes."""

    def __init__(self, c1: int, c2: int, act: bool = True, deploy: bool = False):
        super().__init__()
        if deploy:
            self.fused = Conv2d(c1, c2, 3, 1, 1, bias=True)
        else:
            self.conv1 = ConvBN(c1, c2, 3, 1, p=1, act=False)
            self.conv2 = ConvBN(c1, c2, 1, 1, p=0, act=False)
        self.act, self.deploy = act, deploy

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.fused(x) if self.deploy else self.conv1(x) + self.conv2(x)
        return F.silu(y) if self.act else y


class RepNBottleneck(nn.Module):
    """RepConvN -> Conv 3x3, with a residual when shapes allow."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5, deploy: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = RepConvN(c1, c_, deploy=deploy)
        self.cv2 = ConvBN(c_, c2, 3, 1)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class RepNCSP(nn.Module):
    """CSP bottleneck with RepN blocks."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, e: float = 0.5,
                 deploy: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = ConvBN(c1, c_, 1, 1)
        self.cv3 = ConvBN(2 * c_, c2, 1, 1)
        self.m = nn.Sequential(*(RepNBottleneck(c_, c_, shortcut, e=1.0, deploy=deploy) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class RepNCSPELAN4(nn.Module):
    """YOLOv9 CSP-ELAN block."""

    def __init__(self, c1: int, c2: int, c3: int, c4: int, n: int = 1, deploy: bool = False):
        super().__init__()
        self.cv1 = ConvBN(c1, c3, 1, 1)
        self.cv2 = nn.Sequential(RepNCSP(c3 // 2, c4, n, deploy=deploy), ConvBN(c4, c4, 3, 1))
        self.cv3 = nn.Sequential(RepNCSP(c4, c4, n, deploy=deploy), ConvBN(c4, c4, 3, 1))
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
        self.gl = Linear(gc, ec)
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

    def __init__(self, c1: int, c2: int, c3: int, c4: int, n: int = 1, nh: int = 8, gc: int = 512,
                 deploy: bool = False):
        super().__init__(c1, c2, c3, c4, n, deploy=deploy)
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


class ADown(nn.Module):
    """YOLOv9 downsample (`tamtr_tpu/nn/layers.py:282`): a 2x2 average pool
    at stride 1 (no padding), then half the channels through a 3x3 stride-2
    ConvBN and the other half through a padded 3x3 stride-2 max pool and a
    1x1 ConvBN; c2 / 2 channels each."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.c = c2 // 2
        self.cv1 = ConvBN(c1 // 2, self.c, 3, 2, p=1)
        self.cv2 = ConvBN(c1 // 2, self.c, 1, 1, p=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = F.avg_pool2d(x, 2, 1, 0).chunk(2, 1)
        return torch.cat([self.cv1(x1), self.cv2(F.max_pool2d(x2, 3, 2, 1))], 1)


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


class Silence(nn.Module):
    """The identity (YOLOv9's placeholder layer)."""

    def forward(self, x):
        return x


class CBLinear(nn.Module):
    """YOLOv9 auxiliary-branch projection (`tamtr_tpu/nn/layers.py:403`):
    one biased conv to sum(c2s) channels, split into a tuple of maps."""

    def __init__(self, c1: int, c2s: Sequence[int], k: int = 1, s: int = 1):
        super().__init__()
        self.c2s = tuple(int(c) for c in c2s)
        self.conv = Conv2d(c1, sum(self.c2s), k, s, autopad(k), bias=True)

    def forward(self, x: torch.Tensor):
        return self.conv(x).split(self.c2s, 1)


class CBFuse(nn.Module):
    """YOLOv9 cross-branch fuse (`tamtr_tpu/nn/layers.py:431`): entry idx[i]
    of each earlier input (a CBLinear tuple), resized to the last input's
    size and summed with it. The resize is JAX's `jax.image.resize(...,
    "nearest")`, which samples at half-pixel centres: torch's
    "nearest-exact" (the reference's `F.interpolate` "nearest" samples at
    floor(i * in / out) and picks other rows)."""

    def __init__(self, idx: Sequence[int]):
        super().__init__()
        self.idx = tuple(int(i) for i in idx)

    def forward(self, xs) -> torch.Tensor:
        last = xs[-1]
        out = last
        for i, x in enumerate(xs[:-1]):
            xi = F.interpolate(x[self.idx[i]], size=last.shape[-2:], mode="nearest-exact")
            out = out + xi.to(last.dtype)
        return out


class MLP(nn.Module):
    """ReLU MLP with reference keys `layers.{j}`."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MultiHeadSelfAttention(nn.Module):
    """MHA with nn.MultiheadAttention's parameter names (`in_proj_weight`,
    `in_proj_bias`, `out_proj`); q, k and v take separate inputs, and an
    optional bool mask (Q, K) blocks the pairs where it is True."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.h = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Linear(d_model, d_model)

    def forward(self, q, k, v, mask: Optional[torch.Tensor] = None):
        B, Q, C = q.shape
        h, d = self.h, C // self.h
        w, b = at_input_dtype(q, self.in_proj_weight, self.in_proj_bias, owner=self)
        (wq, wk, wv), (bq, bk, bv) = w.chunk(3), b.chunk(3)
        qp = F.linear(q, wq, bq).view(B, Q, h, d).transpose(1, 2)
        kp = F.linear(k, wk, bk).view(B, -1, h, d).transpose(1, 2)
        vp = F.linear(v, wv, bv).view(B, -1, h, d).transpose(1, 2)
        logits = qp @ kp.transpose(-1, -2) / math.sqrt(d)
        if mask is not None:
            logits = logits.masked_fill(mask, float("-inf"))
        att = logits.softmax(-1)
        return self.out_proj((att @ vp).transpose(1, 2).reshape(B, Q, C))


def sincos_2d(w: int, h: int, dim: int, temperature: float = 10000.0) -> np.ndarray:
    """AIFI's 2-D sin-cos embedding, (w * h, dim) fp32 (`tamtr_tpu/nn/
    layers.py:AIFI.sincos_2d`). The meshgrid is (w, h) 'ij', so row
    wi * h + hi holds the position (wi, hi), as the reference builds it
    (`transformer.py:89-104`)."""
    if dim % 4:
        raise ValueError("AIFI's embed dim must be divisible by 4")
    gw, gh = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32), indexing="ij")
    pos_dim = dim // 4
    omega = 1.0 / (temperature ** (np.arange(pos_dim, dtype=np.float32) / pos_dim))
    out_w = gw.reshape(-1)[:, None] * omega[None]
    out_h = gh.reshape(-1)[:, None] * omega[None]
    return np.concatenate([np.sin(out_w), np.cos(out_w), np.sin(out_h), np.cos(out_h)], 1).astype(np.float32)


class AIFI(nn.Module):
    """Intra-scale feature interaction (RT-DETR's encoder on the deepest
    map, `tamtr_tpu/nn/layers.py:319-369`): one post-norm transformer
    encoder layer over the map's tokens with a 2-D sin-cos embedding; q =
    k = tokens + pos, v = tokens; FFN fc1 -> GELU -> fc2.

    The tokens flatten h-major (row hi * W + wi) while `sincos_2d` orders
    its rows w-major, so the embedding is transposed against the tokens,
    also on square maps: the reference adds it so, and so do JAX and this
    port. The GELU is flax's `nn.gelu`, the tanh approximation, as JAX
    computes it (the reference's `nn.GELU` is exact). The attention is
    plain matrix products and a softmax, in fp32 at any compute dtype: the
    JAX layer's Dense layers promote a bf16 input against their fp32
    kernels, so its output, and what follows it, is fp32.

    x (B, C, H, W) -> (B, C, H, W)."""

    def __init__(self, c1: int, cm: int = 2048, num_heads: int = 8):
        super().__init__()
        self.ma = MultiHeadSelfAttention(c1, num_heads)
        self.fc1 = Linear(c1, cm)
        self.fc2 = Linear(cm, c1)
        self.norm1 = LayerNorm(c1, eps=1e-5)
        self.norm2 = LayerNorm(c1, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        tokens = x.flatten(2).transpose(1, 2)
        pos = torch.from_numpy(sincos_2d(W, H, C)).to(x.device, x.dtype)
        q, tokens = at_least_fp32(tokens + pos), at_least_fp32(tokens)
        tokens = self.norm1(tokens + self.ma(q, q, tokens))
        tokens = self.norm2(tokens + self.fc2(F.gelu(self.fc1(tokens), approximate="tanh")))
        return tokens.transpose(1, 2).reshape(B, C, H, W)
