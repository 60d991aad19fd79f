"""Segment Anything modules in torch (a port of the JAX package's
`tamtr_tpu/models/sam/modules.py`, the reference's
`ultralytics/models/sam/modules/{encoders,decoders,transformer,tiny_encoder}.py`):

- `ImageEncoderViT`: patch embedding, windowed and global ViT blocks with
  the decomposed relative position bias, the conv neck (SAM ViT-B/L/H).
- `TinyViTEncoder`: MobileSAM's TinyViT (MBConv stage, windowed attention
  stages with per-offset biases, patch merging, the neck).
- `PromptEncoder`: points, boxes and masks -> sparse and dense embeddings.
- `MaskDecoder`: the two-way transformer and the hypernetwork mask heads.

The attention is ordinary torch ops (matmul, softmax) in fp32, as the JAX
package computes it in plain XLA; no kernel of the port runs here. GELU is
the exact erf form throughout, as the JAX modules ask for it. Image maps
and embeddings are NHWC (B, H, W, C) at every module's interface, as in
JAX; the convolutions run NCHW inside. Attribute names are the
reference's, so state-dict keys are its (`blocks.0.attn.qkv.weight`,
`mask_downscaling.0.weight`, `output_upscaling.0.weight`, ...);
`weights.py:from_jax_sam_variables` maps the flax trees onto them.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class MLPBlock(nn.Module):
    """Linear -> GELU (exact) or ReLU -> Linear."""

    def __init__(self, dim: int, mlp_dim: int, out_dim: Optional[int] = None, act: str = "gelu"):
        super().__init__()
        self.lin1 = nn.Linear(dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, out_dim or dim)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.lin1(x)
        return self.lin2(F.gelu(x) if self.act == "gelu" else F.relu(x))


class MLP(nn.Module):
    """num_layers Linear layers with ReLU between (the reference's
    `decoders.py:MLP`)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int,
                 sigmoid_output: bool = False):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims, dims[1:] + [output_dim]))
        self.sigmoid_output = sigmoid_output

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x) if i == len(self.layers) - 1 else F.relu(layer(x))
        return torch.sigmoid(x) if self.sigmoid_output else x


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW map (eps 1e-6)."""

    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__(c, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nchw(super().forward(_nhwc(x)))


def window_partition(x: torch.Tensor, ws: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) -> (B * nW, ws, ws, C), zero-padded to multiples of ws;
    and the padded (Hp, Wp)."""
    B, H, W, C = x.shape
    pad_h, pad_w = (ws - H % ws) % ws, (ws - W % ws) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, C), (Hp, Wp)


def window_unpartition(w: torch.Tensor, ws: int, pad_hw: Tuple[int, int], hw: Tuple[int, int]) -> torch.Tensor:
    """The inverse of `window_partition`: (B * nW, ws, ws, C) -> (B, H, W, C)."""
    Hp, Wp = pad_hw
    H, W = hw
    B = w.shape[0] // (Hp * Wp // ws // ws)
    x = w.reshape(B, Hp // ws, Wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


def _rel_pos_table(q_size: int, k_size: int) -> np.ndarray:
    """(q, k) indices into a (2 max(q, k) - 1, C) relative position table
    (the reference's `get_rel_pos`)."""
    q = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    return ((q - k) + (k_size - 1) * max(q_size / k_size, 1.0)).astype(np.int64)


class ViTAttention(nn.Module):
    """Multi-head self-attention over a (B, H, W, C) map or window, with the
    decomposed relative position bias when `use_rel_pos` (`rel_pos_h`,
    `rel_pos_w`: (2 input_size - 1, head_dim))."""

    def __init__(self, dim: int, num_heads: int, use_rel_pos: bool = False,
                 input_size: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.use_rel_pos = use_rel_pos
        if use_rel_pos:
            hd = dim // num_heads
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        nh, hd = self.num_heads, C // self.num_heads
        qkv = self.qkv(x.reshape(B, H * W, C)).reshape(B, H * W, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B, nh, N, hd)
        attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
        if self.use_rel_pos:
            Rh = self.rel_pos_h[torch.from_numpy(_rel_pos_table(H, H)).to(x.device)]  # (H, H, hd)
            Rw = self.rel_pos_w[torch.from_numpy(_rel_pos_table(W, W)).to(x.device)]  # (W, W, hd)
            r_q = q.reshape(B, nh, H, W, hd)
            rel_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, Rh)
            rel_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, Rw)
            attn = (attn.reshape(B, nh, H, W, H, W) + rel_h[..., :, None] + rel_w[..., None, :]).reshape(
                B, nh, H * W, H * W)
        out = attn.softmax(-1) @ v
        return self.proj(out.transpose(1, 2).reshape(B, H, W, C))


class ViTBlock(nn.Module):
    """Pre-norm transformer block (LayerNorm eps 1e-6), windowed when
    window_size > 0 (padded windows), then an exact-GELU MLP."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, use_rel_pos: bool = False,
                 window_size: int = 0, input_size: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = ViTAttention(dim, num_heads, use_rel_pos,
                                 (window_size, window_size) if window_size > 0 else input_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))
        self.window_size = window_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.norm1(x)
        if self.window_size > 0:
            H, W = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, self.window_size)
            x = window_unpartition(self.attn(x), self.window_size, pad_hw, (H, W))
        else:
            x = self.attn(x)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    """The patchify conv (kernel and stride `patch_size`)."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nhwc(self.proj(_nchw(x)))


def _neck(c_in: int, c_out: int) -> nn.Sequential:
    """1x1 conv, LayerNorm2d, 3x3 conv, LayerNorm2d (no biases)."""
    return nn.Sequential(nn.Conv2d(c_in, c_out, 1, bias=False), LayerNorm2d(c_out),
                         nn.Conv2d(c_out, c_out, 3, padding=1, bias=False), LayerNorm2d(c_out))


class ImageEncoderViT(nn.Module):
    """ViTDet image encoder: (B, S, S, 3) -> (B, S/16, S/16, out_chans)."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0, out_chans: int = 256, use_abs_pos: bool = True,
                 use_rel_pos: bool = True, window_size: int = 14, global_attn_indexes: Sequence[int] = ()):
        super().__init__()
        self.img_size, self.embed_dim = img_size, embed_dim
        gs = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, 3, embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, gs, gs, embed_dim)) if use_abs_pos else None
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio, use_rel_pos,
                     0 if i in global_attn_indexes else window_size, (gs, gs)) for i in range(depth))
        self.neck = _neck(embed_dim, out_chans)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        if self.pos_embed is not None:
            x = x + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return _nhwc(self.neck(_nchw(x)))


# ---------------------------------------------------------------------------
# TinyViT (MobileSAM)
# ---------------------------------------------------------------------------


class ConvBN2d(nn.Module):
    """Conv (no bias) + BatchNorm (eps 1e-5), the reference's `Conv2d_BN`,
    on NCHW maps; eval mode uses the running statistics."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: int = 0, groups: int = 1,
                 bn_weight_init: float = 1.0):
        super().__init__()
        self.c = nn.Conv2d(c1, c2, k, s, p, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=1e-5)
        self.bn_weight_init = bn_weight_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.c(x))


class PatchEmbedTiny(nn.Module):
    """Two stride-2 3x3 ConvBNs with a GELU between (`seq.0`, `seq.2`)."""

    def __init__(self, c: int):
        super().__init__()
        self.seq = nn.Sequential(ConvBN2d(3, c // 2, 3, 2, 1), nn.GELU(), ConvBN2d(c // 2, c, 3, 2, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.seq(x)


class MBConv(nn.Module):
    """Mobile inverted bottleneck: 1x1 expand, 3x3 depthwise, 1x1 project
    (its BatchNorm scale initialised to 0), GELU after the residual."""

    def __init__(self, c: int, out_chans: int, expand_ratio: float = 4.0):
        super().__init__()
        hidden = int(c * expand_ratio)
        self.conv1 = ConvBN2d(c, hidden)
        self.conv2 = ConvBN2d(hidden, hidden, 3, 1, 1, groups=hidden)
        self.conv3 = ConvBN2d(hidden, out_chans, bn_weight_init=0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.gelu(self.conv2(F.gelu(self.conv1(x))))
        return F.gelu(self.conv3(y) + x)


class PatchMerging(nn.Module):
    """1x1 ConvBN, 3x3 depthwise ConvBN at `stride`, 1x1 ConvBN; the merge
    into the last stage keeps stride 1 (`tamtr_tpu/models/sam/modules.py:286`)."""

    def __init__(self, c: int, out_dim: int, stride: int = 2):
        super().__init__()
        self.conv1 = ConvBN2d(c, out_dim)
        self.conv2 = ConvBN2d(out_dim, out_dim, 3, stride, 1, groups=out_dim)
        self.conv3 = ConvBN2d(out_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv3(F.gelu(self.conv2(F.gelu(self.conv1(x)))))


def _attention_bias_idxs(resolution: Tuple[int, int]) -> Tuple[int, np.ndarray]:
    """The number of distinct (|dy|, |dx|) offsets of a window and the
    (N, N) map of each token pair to its offset's index, offsets numbered
    in order of first appearance."""
    points = list(itertools.product(range(resolution[0]), range(resolution[1])))
    offsets: dict = {}
    idxs = []
    for p1 in points:
        for p2 in points:
            off = (abs(p1[0] - p2[0]), abs(p1[1] - p2[1]))
            if off not in offsets:
                offsets[off] = len(offsets)
            idxs.append(offsets[off])
    n = len(points)
    return len(offsets), np.asarray(idxs, np.int64).reshape(n, n)


class TinyViTAttention(nn.Module):
    """Window attention over (B, N, C) tokens: LayerNorm (eps 1e-5), q/k/v
    of key_dim, key_dim and attn_ratio x key_dim a head, plus the trained
    per-offset bias `attention_biases` (nh, offsets)."""

    def __init__(self, dim: int, key_dim: int, num_heads: int, attn_ratio: float, resolution: Tuple[int, int]):
        super().__init__()
        self.num_heads, self.key_dim = num_heads, key_dim
        self.d = int(attn_ratio * key_dim)
        n_off, idxs = _attention_bias_idxs(resolution)
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.qkv = nn.Linear(dim, num_heads * (2 * key_dim + self.d))
        self.proj = nn.Linear(num_heads * self.d, dim)
        self.attention_biases = nn.Parameter(torch.zeros(num_heads, n_off))
        self.register_buffer("attention_bias_idxs", torch.from_numpy(idxs), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, _ = x.shape
        qkv = self.qkv(self.norm(x)).reshape(B, N, self.num_heads, -1)
        q, k, v = (t.transpose(1, 2) for t in qkv.split([self.key_dim, self.key_dim, self.d], -1))
        attn = (q @ k.transpose(-2, -1)) * self.key_dim ** -0.5 + self.attention_biases[:, self.attention_bias_idxs]
        out = (attn.softmax(-1) @ v).transpose(1, 2).reshape(B, N, self.num_heads * self.d)
        return self.proj(out)


class TinyViTMlp(nn.Module):
    """LayerNorm (eps 1e-5), fc1, exact GELU, fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(self.norm(x))))


class TinyViTBlock(nn.Module):
    """Window attention (padded windows unless the map is one window), a
    residual, a depthwise `local_conv`, then the MLP with its residual;
    (B, H, W, C) in and out."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7, mlp_ratio: float = 4.0,
                 local_conv_size: int = 3):
        super().__init__()
        self.window_size = window_size
        self.attn = TinyViTAttention(dim, dim // num_heads, num_heads, 1.0, (window_size, window_size))
        self.local_conv = ConvBN2d(dim, dim, local_conv_size, 1, local_conv_size // 2, groups=dim)
        self.mlp = TinyViTMlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        ws = self.window_size
        if H == ws and W == ws:
            a = self.attn(x.reshape(B, H * W, C)).reshape(B, H, W, C)
        else:
            w, pad_hw = window_partition(x, ws)
            a = self.attn(w.reshape(-1, ws * ws, C))
            a = window_unpartition(a.reshape(-1, ws, ws, C), ws, pad_hw, (H, W))
        x = _nhwc(self.local_conv(_nchw(x + a)))
        y = x.reshape(B, H * W, C)
        return (y + self.mlp(y)).reshape(B, H, W, C)


class TinyViTLayer(nn.Module):
    """One stage: its blocks (MBConvs in stage 0) and its downsample."""

    def __init__(self, blocks: Sequence[nn.Module], downsample: Optional[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class TinyViTEncoder(nn.Module):
    """MobileSAM's TinyViT-5M: (B, 1024, 1024, 3) -> (B, 64, 64, 256).
    The patch embedding (/4), the MBConv stage, then the attention stages
    with patch merging between them (the last merge at stride 1), the
    neck."""

    def __init__(self, embed_dims: Sequence[int] = (64, 128, 160, 320), depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (2, 4, 5, 10), window_sizes: Sequence[int] = (7, 7, 14, 7),
                 mlp_ratio: float = 4.0, mbconv_expand_ratio: float = 4.0, local_conv_size: int = 3,
                 out_chans: int = 256):
        super().__init__()
        n = len(depths)
        self.patch_embed = PatchEmbedTiny(embed_dims[0])
        layers = []
        for s in range(n):
            c = embed_dims[s]
            if s == 0:
                blocks = [MBConv(c, c, mbconv_expand_ratio) for _ in range(depths[0])]
            else:
                blocks = [TinyViTBlock(c, num_heads[s], window_sizes[s], mlp_ratio, local_conv_size)
                          for _ in range(depths[s])]
            down = PatchMerging(c, embed_dims[s + 1], stride=1 if s == n - 2 else 2) if s < n - 1 else None
            layers.append(TinyViTLayer(blocks, down))
        self.layers = nn.ModuleList(layers)
        self.neck = _neck(embed_dims[-1], out_chans)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(_nchw(x))  # NCHW through the MBConv stage
        for s, layer in enumerate(self.layers):
            if s > 0:
                x = _nhwc(x)
                for blk in layer.blocks:
                    x = blk(x)
                x = _nchw(x)
            else:
                for blk in layer.blocks:
                    x = blk(x)
            if layer.downsample is not None:
                x = layer.downsample(x)
        return _nhwc(self.neck(x))


# ---------------------------------------------------------------------------
# Prompt encoder
# ---------------------------------------------------------------------------


class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier position encoding; the (2, C/2) gaussian matrix is a
    checkpointed tensor (a buffer, as in the reference)."""

    def __init__(self, num_pos_feats: int = 64):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.zeros(2, num_pos_feats))

    def _encode(self, coords: torch.Tensor) -> torch.Tensor:
        coords = (2.0 * np.pi) * ((2.0 * coords - 1.0) @ self.positional_encoding_gaussian_matrix)
        return torch.cat([torch.sin(coords), torch.cos(coords)], -1)

    def grid(self, h: int, w: int) -> torch.Tensor:
        """(h, w, C) encoding of the pixel centres ((i + 0.5) / n, as (x, y))."""
        dev = self.positional_encoding_gaussian_matrix.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        return self._encode(torch.stack([gx, gy], -1))

    def with_coords(self, coords: torch.Tensor, image_size: Tuple[int, int]) -> torch.Tensor:
        """(..., C) encoding of pixel coordinates (..., 2) as (x, y)."""
        scale = torch.tensor([image_size[1], image_size[0]], dtype=coords.dtype, device=coords.device)
        return self._encode(coords / scale)


class PromptEncoder(nn.Module):
    """Point, box and mask prompts -> (sparse (B, N, C), dense (B, h, w, C)).

    Point labels: 1 foreground, 0 background, -1 not a point; points
    without boxes get a padding point (label -1). Boxes give two corner
    tokens; masks (B, 4h, 4w, 1) go through the downscaling stack, else the
    dense embedding is `no_mask_embed` everywhere."""

    def __init__(self, embed_dim: int = 256, image_embedding_size: Tuple[int, int] = (64, 64),
                 input_image_size: Tuple[int, int] = (1024, 1024), mask_in_chans: int = 16):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = tuple(image_embedding_size)
        self.input_image_size = tuple(input_image_size)
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, embed_dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        c = mask_in_chans
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, c // 4, 2, 2), LayerNorm2d(c // 4), nn.GELU(),
            nn.Conv2d(c // 4, c, 2, 2), LayerNorm2d(c), nn.GELU(), nn.Conv2d(c, embed_dim, 1))
        self.no_mask_embed = nn.Embedding(1, embed_dim)

    def get_dense_pe(self) -> torch.Tensor:
        """(1, h, w, C) encoding of the image-embedding grid."""
        return self.pe_layer.grid(*self.image_embedding_size)[None]

    def _embed_points(self, points: torch.Tensor, labels: torch.Tensor, pad: bool) -> torch.Tensor:
        points = points + 0.5  # pixel centres
        if pad:
            points = torch.cat([points, torch.zeros_like(points[:, :1])], 1)
            labels = torch.cat([labels, -torch.ones_like(labels[:, :1])], 1)
        pe = self.pe_layer.with_coords(points, self.input_image_size)
        lab = labels[..., None]
        pos, neg = self.point_embeddings[1].weight[0], self.point_embeddings[0].weight[0]
        return torch.where(lab == -1, self.not_a_point_embed.weight[0], pe + torch.where(lab == 0, neg, pos))

    def _embed_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        corners = self.pe_layer.with_coords((boxes + 0.5).reshape(-1, 2, 2), self.input_image_size)
        return corners + torch.cat([self.point_embeddings[2].weight, self.point_embeddings[3].weight])[None]

    def forward(self, points: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                boxes: Optional[torch.Tensor] = None,
                masks: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """points: ((B, P, 2) xy pixels, (B, P) labels); boxes: (B, 4) xyxy;
        masks: (B, 4h, 4w, 1) low-res mask logits."""
        bs = points[0].shape[0] if points is not None else boxes.shape[0] if boxes is not None else \
            masks.shape[0] if masks is not None else 1
        dev = self.no_mask_embed.weight.device
        sparse = torch.zeros(bs, 0, self.embed_dim, device=dev)
        if points is not None:
            sparse = torch.cat([sparse, self._embed_points(points[0], points[1], pad=boxes is None)], 1)
        if boxes is not None:
            sparse = torch.cat([sparse, self._embed_boxes(boxes)], 1)
        if masks is not None:
            dense = _nhwc(self.mask_downscaling(_nchw(masks)))
        else:
            h, w = self.image_embedding_size
            dense = self.no_mask_embed.weight.reshape(1, 1, 1, -1).expand(bs, h, w, self.embed_dim)
        return sparse, dense


# ---------------------------------------------------------------------------
# Two-way transformer and mask decoder
# ---------------------------------------------------------------------------


class SAMAttention(nn.Module):
    """Attention with the projections downsampled by `downsample_rate`."""

    def __init__(self, embedding_dim: int, num_heads: int, downsample_rate: int = 1):
        super().__init__()
        internal = embedding_dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embedding_dim, internal)
        self.k_proj = nn.Linear(embedding_dim, internal)
        self.v_proj = nn.Linear(embedding_dim, internal)
        self.out_proj = nn.Linear(internal, embedding_dim)

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        b, n, c = t.shape
        return t.reshape(b, n, self.num_heads, c // self.num_heads).transpose(1, 2)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        q, k, v = self._heads(self.q_proj(q)), self._heads(self.k_proj(k)), self._heads(self.v_proj(v))
        attn = (q @ k.transpose(-2, -1)) / math.sqrt(q.shape[-1])
        out = attn.softmax(-1) @ v
        b, h, n, c = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, h * c))


class TwoWayAttentionBlock(nn.Module):
    """Token self-attention, token-to-image and image-to-token cross
    attention, a ReLU MLP on the tokens; LayerNorms eps 1e-5."""

    def __init__(self, embedding_dim: int, num_heads: int, mlp_dim: int = 2048, attention_downsample_rate: int = 2,
                 skip_first_layer_pe: bool = False):
        super().__init__()
        self.self_attn = SAMAttention(embedding_dim, num_heads)
        self.norm1 = nn.LayerNorm(embedding_dim, eps=1e-5)
        self.cross_attn_token_to_image = SAMAttention(embedding_dim, num_heads, attention_downsample_rate)
        self.norm2 = nn.LayerNorm(embedding_dim, eps=1e-5)
        self.mlp = MLPBlock(embedding_dim, mlp_dim, act="relu")
        self.norm3 = nn.LayerNorm(embedding_dim, eps=1e-5)
        self.norm4 = nn.LayerNorm(embedding_dim, eps=1e-5)
        self.cross_attn_image_to_token = SAMAttention(embedding_dim, num_heads, attention_downsample_rate)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    """`depth` two-way blocks and a final token-to-image attention."""

    def __init__(self, depth: int = 2, embedding_dim: int = 256, num_heads: int = 8, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim, attention_downsample_rate, i == 0)
            for i in range(depth))
        self.final_attn_token_to_image = SAMAttention(embedding_dim, num_heads, attention_downsample_rate)
        self.norm_final_attn = nn.LayerNorm(embedding_dim, eps=1e-5)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding (B, h, w, C), image_pe (1 or B, h, w, C),
        point_embedding (B, N, C) -> (queries (B, N, C), keys (B, hw, C))."""
        b, h, w, c = image_embedding.shape
        keys = image_embedding.reshape(b, h * w, c)
        key_pe = image_pe.reshape(image_pe.shape[0], h * w, c).expand(b, h * w, c)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q, k = queries + point_embedding, keys + key_pe
        queries = queries + self.final_attn_token_to_image(q, k, keys)
        return self.norm_final_attn(queries), keys


class MaskDecoder(nn.Module):
    """The two-way transformer over the prompt tokens and the image
    embedding, a 4x upscale by two stride-2 transposed convs, and the
    hypernetwork MLPs: (masks (B, 4, 4h, 4w), iou_pred (B, 4)); the
    caller takes outputs 1: (multimask) or 0 (single)."""

    def __init__(self, transformer_dim: int = 256, num_multimask_outputs: int = 3, iou_head_depth: int = 3,
                 iou_head_hidden_dim: int = 256, transformer_depth: int = 2, transformer_num_heads: int = 8,
                 transformer_mlp_dim: int = 2048):
        super().__init__()
        d = transformer_dim
        self.num_mask_tokens = num_multimask_outputs + 1
        self.transformer = TwoWayTransformer(transformer_depth, d, transformer_num_heads, transformer_mlp_dim)
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, d)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, 2, 2), LayerNorm2d(d // 4), nn.GELU(),
            nn.ConvTranspose2d(d // 4, d // 8, 2, 2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(MLP(d, d, d // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(d, iou_head_hidden_dim, self.num_mask_tokens, iou_head_depth)

    def forward(self, image_embeddings, image_pe, sparse_prompt_embeddings, dense_prompt_embeddings):
        """image_embeddings (1 or B, h, w, C) broadcast over the B prompts."""
        bs = sparse_prompt_embeddings.shape[0]
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight])[None].expand(bs, -1, -1)
        tokens = torch.cat([out_tokens, sparse_prompt_embeddings], 1)
        src = image_embeddings.expand(bs, *image_embeddings.shape[1:]) + dense_prompt_embeddings
        b, h, w, c = src.shape
        hs, src = self.transformer(src, image_pe, tokens)
        iou_token_out, mask_tokens_out = hs[:, 0], hs[:, 1:1 + self.num_mask_tokens]
        upscaled = _nhwc(self.output_upscaling(_nchw(src.reshape(b, h, w, c))))  # (B, 4h, 4w, C/8)
        hyper_in = torch.stack([mlp(mask_tokens_out[:, i]) for i, mlp in enumerate(self.output_hypernetworks_mlps)],
                               1)
        masks = torch.einsum("bmc,bhwc->bmhw", hyper_in, upscaled)
        return masks, self.iou_prediction_head(iou_token_out)
