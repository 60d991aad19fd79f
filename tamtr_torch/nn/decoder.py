"""MEH head: VMamba mixers, a deformable decoder, text-contrastive scoring
and, in train mode, the static-shape CDN denoising branch (torch port of
`tamtr_tpu/nn/decoder.py`).

The other DETR heads of the JAX package (`tamtr_tpu/nn/graph.py:281-329`)
are `ManbaWorldDecoder` with its switches (no VSS mixers, Linear score
heads, `DecouplingDecoderLayer`s), `DualRTDETRDecoder` (one core over the
two halves of the levels) and `LocationManbaDecoder` (conv class maps with
`ContrastiveHead2D` text scores, a box-only decoder).

Attribute names follow the reference checkpoint (`VSSBlocks.{i}`,
`input_proj.{i}.{0,1}`, `decoder.layers.{i}` with `in_proj_weight`,
`enc_output.{0,1}`, `dec_score_head.{i}`, `dec_bbox_head.{i}.layers.{j}`,
`denoising_class_embed`).

Compute dtype: the layers compute in their input's dtype (`nn/layers.py`),
and the head keeps the JAX package's fp32 islands (`tamtr_tpu/nn/decoder.py`):
the sampling offsets, attention weights and locations (`:80-81`, `:182-197`),
the encoder score head (`:590`), the contrastive score logits (`:239-240`),
the box regression and decode (`:607`, `:634`, `:652`, `:678`), and the
input projection's BatchNorm in train mode (`:541`). The CDN queries are
fp32, so in train mode the decoder layers run in fp32 around the
compute-dtype value projection and gather, as JAX's concat promotes them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tamtr_torch.kernels import at_least_fp32
from tamtr_torch.kernels.deform_scatter import bilinear_gather
from tamtr_torch.nn.layers import (
    MLP, BatchNorm2d, Conv2d, ConvBN, LayerNorm, Linear, MultiHeadSelfAttention,
)
from tamtr_torch.nn.ssm import VSSBlock
from tamtr_torch.ops.boxes import xywh2xyxy, xyxy2xywh
from tamtr_torch.parallel.dist import batch_rows


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def deform_sampling_pairs(shapes: Sequence[Tuple[int, int]], loc: torch.Tensor, w_att: torch.Tensor):
    """Bilinear corner indices and weights of every sample point, with the
    levels' rows globalized into one multi-level value.

    loc (B, Q, nh, nl, P, 2) normalized xy; w_att (B, Q, nh, nl, P).
    Returns idx4 (B, Q*nl*P*4, nh) int32 corner rows, w_pairs
    (B, Q*nl*P*2, nh, 2) corner x attention weights, swapped for pairs with
    x0 < 0, and idx2 (B, Q*nl*P*2, nh) int32 pair starts. Corner order per
    point is (y0,x0), (y0,x1), (y1,x0), (y1,x1); grid_sample zeros padding
    (align_corners=False) gives out-of-range corners weight 0.
    """
    B, Q, nh, nl, P, _ = loc.shape
    starts = np.cumsum([0] + [h * w for h, w in shapes])[:-1]
    idx4_l, wp_l, idx2_l, swap_l = [], [], [], []
    for lvl, (H, W) in enumerate(shapes):
        start = int(starts[lvl])
        x = loc[:, :, :, lvl, :, 0] * W - 0.5  # (B, Q, nh, P)
        y = loc[:, :, :, lvl, :, 1] * H - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        wx1, wy1 = x - x0, y - y0
        idx_c, w_c = [], []
        for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
            for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
                xi, yi = x0 + dx, y0 + dy
                valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
                idx_c.append(
                    yi.clamp(0, H - 1).to(torch.int32) * W + xi.clamp(0, W - 1).to(torch.int32) + start
                )
                w_c.append((wx * wy) * valid)
        idx4_l.append(torch.stack(idx_c, -1).permute(0, 1, 3, 4, 2))  # (B, Q, P, 4, nh)
        w4 = (torch.stack(w_c, -1) * w_att[:, :, :, lvl, :, None]).permute(0, 1, 3, 4, 2)
        wp_l.append(w4.reshape(B, Q, P * 2, 2, nh).transpose(3, 4))  # (B, Q, 2P, nh, 2)
        xs = x0.clamp(0, W - 1).to(torch.int32)
        r0 = y0.clamp(0, H - 1).to(torch.int32) * W + xs + start
        r1 = (y0 + 1).clamp(0, H - 1).to(torch.int32) * W + xs + start
        idx2_l.append(torch.stack([r0, r1], -1).permute(0, 1, 3, 4, 2))  # (B, Q, P, 2, nh)
        swap_l.append((x0 < 0)[..., None].expand(*x0.shape, 2).permute(0, 1, 3, 4, 2))
    # per query, pairs run in (level, point, row) order
    idx4 = torch.cat(idx4_l, 2).reshape(B, Q * nl * P * 4, nh)
    w_pairs = torch.cat(wp_l, 2).reshape(B, Q * nl * P * 2, nh, 2)
    idx2 = torch.cat(idx2_l, 2).reshape(B, Q * nl * P * 2, nh)
    swap = torch.cat(swap_l, 2).reshape(B, Q * nl * P * 2, nh)
    w_pairs = torch.where(swap[..., None], w_pairs.flip(-1), w_pairs)
    return idx4, w_pairs, idx2


def ms_deform_attn_core(value, shapes, sampling_locations, attention_weights) -> torch.Tensor:
    """Deformable attention gather: value (B, Lv, nh, c) -> (B, Q, nh * c)."""
    B, _, nh, c = value.shape
    _, Q, _, nl, P, _ = sampling_locations.shape
    idx4, w_pairs, idx2 = deform_sampling_pairs(shapes, sampling_locations, attention_weights)
    return bilinear_gather(value, idx4, w_pairs, idx2, nl * P).reshape(B, Q, nh * c)


def sampling_offset_bias(nh: int, nl: int, npts: int) -> torch.Tensor:
    """Rotated-grid bias of `sampling_offsets`: head h points along angle
    2*pi*h/nh, point p at distance p + 1."""
    thetas = np.arange(nh, dtype=np.float32) * (2.0 * math.pi / nh)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, nl, npts, 1))
    for p in range(npts):
        grid[:, :, p, :] *= p + 1
    return torch.from_numpy(grid.reshape(-1).astype(np.float32))


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention."""

    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8, n_points: int = 4):
        super().__init__()
        self.nh, self.nl, self.P = n_heads, n_levels, n_points
        self.value_proj = Linear(d_model, d_model)
        self.sampling_offsets = Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = Linear(d_model, n_heads * n_levels * n_points)
        self.output_proj = Linear(d_model, d_model)

    def forward(self, query, refer_bbox, value, shapes):
        """query (B, Q, C); refer_bbox (B, Q, 4) cxcywh in [0, 1]; value (B, Lv, C).
        The sampling offsets and attention weights are fp32 whatever the
        query's dtype (bf16 would move the sampling points)."""
        B, Q, C = query.shape
        nh, nl, P = self.nh, self.nl, self.P
        v = self.value_proj(value).view(B, -1, nh, C // nh)
        off = self.sampling_offsets(at_least_fp32(query)).view(B, Q, nh, nl, P, 2)
        w = self.attention_weights(at_least_fp32(query)).view(B, Q, nh, nl * P).softmax(-1).view(B, Q, nh, nl, P)
        xy = refer_bbox[:, :, None, None, None, :2]
        wh = refer_bbox[:, :, None, None, None, 2:]
        loc = xy + off / P * wh * 0.5
        return self.output_proj(ms_deform_attn_core(v, shapes, loc, w))


class ContrastiveHead(nn.Module):
    """Region-text similarity logits: cosine similarity scaled by
    exp(logit_scale), plus a bias."""

    def __init__(self):
        super().__init__()
        self.bias = nn.Parameter(torch.full((1,), -10.0))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (B, Q, C) region embeds; w (B, K, C) text embeds -> (B, Q, K)
        logits, in fp32 whatever the inputs' dtype."""
        x, w = at_least_fp32(x), at_least_fp32(w)
        xn = x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        wn = w / w.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        return torch.einsum("bqc,bkc->bqk", xn, wn) * self.logit_scale.exp() + self.bias


class ContrastiveHead2D(nn.Module):
    """Region-text scores on a feature map (`tamtr_tpu/nn/decoder.py:402-
    422`): each pixel's channels and each text row unit-normalised, their
    dot scaled by exp(logit_scale), plus a bias.

    x (B, C, H, W); w (B, K, C) -> (B, K, H, W) logits, in fp32 whatever
    the inputs' dtype."""

    def __init__(self):
        super().__init__()
        self.bias = nn.Parameter(torch.full((1,), -10.0))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x, w = at_least_fp32(x), at_least_fp32(w)
        xn = x / x.norm(dim=1, keepdim=True).clamp(min=1e-12)
        wn = w / w.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        return torch.einsum("bchw,bkc->bkhw", xn, wn) * self.logit_scale.exp() + self.bias


class DeformableDecoderLayer(nn.Module):
    """Self-attention + deformable cross-attention + FFN, post-norm."""

    def __init__(self, d_model: int, n_heads: int, d_ffn: int, n_levels: int, n_points: int):
        super().__init__()
        self.self_attn = MultiHeadSelfAttention(d_model, n_heads)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.linear1 = Linear(d_model, d_ffn)
        self.linear2 = Linear(d_ffn, d_model)
        self.norm3 = LayerNorm(d_model, eps=1e-5)

    def forward(self, embed, refer_bbox, feats, shapes, query_pos, attn_mask=None):
        query_pos = query_pos.to(embed.dtype)
        q = embed + query_pos
        embed = self.norm1(embed + self.self_attn(q, q, embed, attn_mask))
        embed = self.norm2(embed + self.cross_attn(embed + query_pos, refer_bbox, feats, shapes))
        return self.norm3(embed + self.linear2(F.relu(self.linear1(embed))))


class DecouplingDecoderLayer(nn.Module):
    """A decoder layer with separate class and box streams
    (`tamtr_tpu/nn/decoder.py:271-331`), in two modes:

    - "decouple": both streams are carried from layer to layer. The class
      stream gets self-attention (`self_attn1`), its own deformable
      cross-attention (`cross_attn_cls`) and FFN; the box stream only its
      cross-attention (`cross_attn_box`) and FFN.
    - "dfl": the box stream is rebuilt in each layer from the dn part of the
      query position and the matching part of the class stream after its
      self-attention, then gets its own self-attention (`self_attn2`, with
      the class stream's q and k), cross-attention and FFN. (The reference
      keeps plain 4-coordinate box heads here: no distributional decode.)

    Each layer runs the deformable gather twice. The norms and FFNs compute
    in fp32 whatever the input's dtype: the JAX layer's LayerNorm and Dense
    carry no dtype, so flax promotes a bf16 stream against their fp32
    parameters.

    forward(embed, embed_box, refer_bbox, feats, shapes, query_pos,
    attn_mask, num_dn) -> (embed, embed_box)."""

    def __init__(self, d_model: int, n_heads: int, d_ffn: int, n_levels: int, n_points: int,
                 mode: str = "decouple"):
        super().__init__()
        if mode not in ("decouple", "dfl"):
            raise ValueError(f"unknown decoupled layer mode {mode!r}")
        self.mode = mode
        self.self_attn1 = MultiHeadSelfAttention(d_model, n_heads)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        if mode == "dfl":
            self.self_attn2 = MultiHeadSelfAttention(d_model, n_heads)
            self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.cross_attn_cls = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm3 = LayerNorm(d_model, eps=1e-5)
        self.cross_attn_box = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm4 = LayerNorm(d_model, eps=1e-5)
        self.linear1 = Linear(d_model, d_ffn)
        self.linear2 = Linear(d_ffn, d_model)
        self.norm5 = LayerNorm(d_model, eps=1e-5)
        self.linear3 = Linear(d_model, d_ffn)
        self.linear4 = Linear(d_ffn, d_model)
        self.norm6 = LayerNorm(d_model, eps=1e-5)

    def forward(self, embed, embed_box, refer_bbox, feats, shapes, query_pos, attn_mask=None, num_dn: int = 0):
        query_pos = query_pos.to(embed.dtype)
        q = embed + query_pos
        embed = self.norm1(at_least_fp32(embed + self.self_attn1(q, q, embed, attn_mask)))
        if self.mode == "dfl":
            embed_box = torch.cat([at_least_fp32(query_pos[:, :num_dn]), embed[:, num_dn:]], 1)
            embed_box = self.norm2(at_least_fp32(embed_box + self.self_attn2(q, q, embed_box.to(q.dtype), attn_mask)))
        embed = self.norm3(at_least_fp32(embed + self.cross_attn_cls(embed + query_pos, refer_bbox, feats, shapes)))
        embed_box = self.norm4(at_least_fp32(
            embed_box + self.cross_attn_box(embed_box + query_pos, refer_bbox, feats, shapes)))
        embed = self.norm5(embed + self.linear2(F.relu(self.linear1(embed))))
        embed_box = self.norm6(embed_box + self.linear4(F.relu(self.linear3(embed_box))))
        return embed, embed_box


def cdn_attn_mask(num_dn: int, num_queries: int, group_block: int) -> np.ndarray:
    """Static CDN attention mask (True = blocked): dn queries see only their
    own block of `group_block`; matching queries see no dn query."""
    tgt = num_dn + num_queries
    mask = np.zeros((tgt, tgt), dtype=bool)
    mask[num_dn:, :num_dn] = True
    if num_dn:
        idx = np.arange(num_dn) // group_block
        mask[:num_dn, :num_dn] = idx[:, None] != idx[None, :]
    return mask


def cdn_noise(shape: Tuple[int, int, int], num_classes: int, generator: torch.Generator,
              device) -> Dict[str, torch.Tensor]:
    """The draws of `get_cdn_group` for (B, 2G, M) queries: class-flip
    uniforms, replacement classes, box-noise signs (+-1) and magnitudes.
    Under `parallel.dist.data_parallel` each is drawn for the global batch
    and this rank keeps its rows (`batch_rows`)."""
    B, G2, M = shape
    kw = dict(generator=generator, device=device)
    return {
        "flip": batch_rows(lambda b: torch.rand((b, G2, M), **kw), B),
        "new_cls": batch_rows(lambda b: torch.randint(0, num_classes, (b, G2, M), **kw), B),
        "sign": batch_rows(lambda b: torch.randint(0, 2, (b, G2, M, 4), **kw), B).float() * 2.0 - 1.0,
        "part": batch_rows(lambda b: torch.rand((b, G2, M, 4), **kw), B),
    }


def get_cdn_group(gt_cls, gt_bbox, gt_mask, num_classes: int, class_embed: torch.Tensor,
                  num_groups: int, generator: Optional[torch.Generator] = None,
                  cls_noise_ratio: float = 0.5, box_noise_scale: float = 1.0,
                  noise: Optional[Dict[str, torch.Tensor]] = None):
    """Denoising queries, static-shape layout of `tamtr_tpu/nn/decoder.py:350-399`.

    gt_cls (B, M) int; gt_bbox (B, M, 4) cxcywh; gt_mask (B, M) bool;
    class_embed (nc + 1, hd). The dn layout is 2G blocks of M, the first G
    positive. The noise is drawn from `generator` (see `cdn_noise`), or taken
    from `noise` so that a test can inject the same draws as another
    framework. Returns dn_embed (B, 2G*M, hd) and dn_bbox_logit (B, 2G*M, 4).
    """
    B, M = gt_cls.shape
    G2 = 2 * num_groups
    cls_t = gt_cls[:, None].expand(B, G2, M)
    box_t = gt_bbox[:, None].expand(B, G2, M, 4)
    mask_t = gt_mask[:, None].expand(B, G2, M)
    if noise is None and (cls_noise_ratio > 0 or box_noise_scale > 0):
        if generator is None:
            raise ValueError("get_cdn_group needs an explicit torch.Generator for its noise")
        noise = cdn_noise((B, G2, M), num_classes, generator, gt_bbox.device)
    if cls_noise_ratio > 0:
        cls_t = torch.where(noise["flip"] < cls_noise_ratio * 0.5, noise["new_cls"].to(cls_t.dtype), cls_t)
    if box_noise_scale > 0:
        known = xywh2xyxy(box_t)
        diff = (box_t[..., 2:] * 0.5).repeat(1, 1, 1, 2) * box_noise_scale
        is_neg = (torch.arange(G2, device=gt_bbox.device) >= num_groups)[None, :, None, None]
        part = noise["part"] + is_neg.to(noise["part"].dtype)
        box_t = xyxy2xywh((known + noise["sign"] * part * diff).clamp(0.0, 1.0))
    box_logit = torch.log(box_t.clamp(min=1e-6) / (1 - box_t).clamp(min=1e-6))
    embed = torch.where(mask_t[..., None], class_embed[cls_t.long()], 0.0)
    box_logit = torch.where(mask_t[..., None], box_logit, 0.0)
    return embed.reshape(B, G2 * M, -1), box_logit.reshape(B, G2 * M, 4)


def generate_anchors(shapes: Sequence[Tuple[int, int]], grid_size: float = 0.05, eps: float = 1e-2):
    """Anchor boxes in logit space, (L, 4), and their validity (L, 1).

    As in the reference, x is divided by the map height and y by its width
    (the same thing for square maps); invalid anchors are inf.
    """
    anchors = []
    for i, (h, w) in enumerate(shapes):
        gy, gx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij")
        grid_xy = (np.stack([gx, gy], -1) + 0.5) / np.array([h, w], dtype=np.float32)
        wh = np.ones_like(grid_xy) * grid_size * (2.0**i)
        anchors.append(np.concatenate([grid_xy, wh], -1).reshape(h * w, 4))
    anchors = np.concatenate(anchors, 0)
    valid = ((anchors > eps) & (anchors < 1 - eps)).all(-1, keepdims=True)
    anchors = np.log(anchors / (1 - anchors))
    return np.where(valid, anchors, np.inf).astype(np.float32), valid


def select_queries(scores: torch.Tensor, nq: int) -> torch.Tensor:
    """(B, nq) indices of the tokens with the highest class score, scores
    (B, L, K); an input with fewer than nq tokens (a small TTA scale) has
    its selection tiled up to nq."""
    k_eff = min(nq, scores.shape[1])
    ind = scores.max(-1).values.topk(k_eff, dim=1).indices
    return ind if k_eff == nq else ind.repeat(1, -(-nq // k_eff))[:, :nq]


def take_rows(x: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """x (B, L, C) at the rows ind (B, Q) -> (B, Q, C)."""
    return torch.gather(x, 1, ind[..., None].expand(-1, -1, x.shape[-1]))


def refined_boxes(bbox_delta, refer, last_refined, train: bool, i: int):
    """(refined, box of layer i's train output): the refined boxes of a
    decoder layer; in train mode, layer i > 0's output boxes take their
    gradient through the previous layer's refined boxes, not the detached
    reference."""
    refined = torch.sigmoid(bbox_delta + inverse_sigmoid(refer))
    if not train or i == 0:
        return refined, refined
    return refined, torch.sigmoid(bbox_delta + inverse_sigmoid(last_refined))


class ManbaWorldDecoder(nn.Module):
    """The MEH head: per-level VSS mixers, input projection, top-k query
    selection over encoder scores, `ndl` deformable decoder layers with
    text-contrastive scores; with its switches, the other DETR heads of the
    JAX package (`tamtr_tpu/nn/graph.py:296-329`, `nn/decoder.py:447-688`):

    - use_vss=False: no VSS mixers (RTDETRDecoder, the Dual core);
    - use_text=False: per-layer `Linear(hd, nc)` score heads on fp32 input
      (RTDETRDecoder, ManbaDecoder); the text table is taken and ignored;
    - variant "decouple" / "dfl": `DecouplingDecoderLayer`s
      (DecouplingManbaWorldDecoder, DecouplingDFLManbaWorldDecoder), whose
      box stream feeds the box heads and class stream the score heads.

    feats: per-level NCHW maps; text (B, K, hd). Eval (`.eval()` or no
    targets): a dict with "pred" (B, nq, 4 + nc) normalized cxcywh + sigmoid
    scores of the last layer. Train (`.train()` and targets {"cls",
    "bboxes", "mask"}): the JAX package's train dict, with the CDN queries
    in front (num_dn of them): dec_bboxes/dec_scores (ndl, B, num_dn + nq,
    .), enc_bboxes/enc_scores, num_dn and dn_groups. Random draws (DropPath,
    CDN noise) come from `generator`.
    """

    def __init__(self, nc: int = 80, ch: Sequence[int] = (128, 256, 512), hd: int = 512,
                 nq: int = 100, ndp: int = 4, nh: int = 8, ndl: int = 3, d_ffn: int = 1024,
                 num_denoising: int = 100, max_gt: int = 128, label_noise_ratio: float = 0.5,
                 box_noise_scale: float = 1.0, vss_drop_path: float = 0.1, use_text: bool = True,
                 use_vss: bool = True, variant: str = "base"):
        super().__init__()
        self.nc, self.hd, self.nq, self.ndl = nc, hd, nq, ndl
        self.num_denoising, self.max_gt = num_denoising, max_gt
        self.label_noise_ratio, self.box_noise_scale = label_noise_ratio, box_noise_scale
        self.use_text, self.use_vss, self.variant = use_text, use_vss, variant
        nl = len(ch)
        if use_vss:
            self.VSSBlocks = nn.ModuleList(VSSBlock(c, drop_path=vss_drop_path) for c in ch)
        self.input_proj = nn.ModuleList(
            nn.Sequential(Conv2d(c, hd, 1, bias=False), BatchNorm2d(hd)) for c in ch
        )
        if variant == "base":
            layers = (DeformableDecoderLayer(hd, nh, d_ffn, nl, ndp) for _ in range(ndl))
        else:
            layers = (DecouplingDecoderLayer(hd, nh, d_ffn, nl, ndp, mode=variant) for _ in range(ndl))
        self.decoder = nn.ModuleDict({"layers": nn.ModuleList(layers)})
        self.denoising_class_embed = nn.Embedding(nc + 1, hd)
        self.query_pos_head = MLP(4, 2 * hd, hd, 2)
        self.enc_output = nn.Sequential(Linear(hd, hd), LayerNorm(hd, eps=1e-5))
        self.enc_score_head = Linear(hd, nc)
        self.enc_bbox_head = MLP(hd, hd, 4, 3)
        self.dec_score_head = nn.ModuleList(ContrastiveHead() if use_text else Linear(hd, nc) for _ in range(ndl))
        self.dec_bbox_head = nn.ModuleList(MLP(hd, hd, 4, 3) for _ in range(ndl))

    @property
    def dn_groups(self) -> int:
        return max(1, self.num_denoising // self.max_gt)

    @property
    def num_dn(self) -> int:
        return 2 * self.dn_groups * self.max_gt

    def score(self, i: int, output: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
        """Layer i's class logits, fp32."""
        if self.use_text:
            return self.dec_score_head[i](output, text)
        return self.dec_score_head[i](at_least_fp32(output))

    def forward(self, feats: List[torch.Tensor], text: torch.Tensor,
                targets: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        train = self.training and targets is not None
        if self.use_vss:  # the VSS mixers run channels-last
            feats = [vss(f.permute(0, 2, 3, 1), generator).permute(0, 3, 1, 2)
                     for vss, f in zip(self.VSSBlocks, feats)]
        shapes = [(f.shape[2], f.shape[3]) for f in feats]
        flat = torch.cat([proj(f).flatten(2).transpose(1, 2) for proj, f in zip(self.input_proj, feats)], 1)
        # (B, L, hd), row-major per level

        num_dn, attn_mask = 0, None
        if train and self.num_denoising > 0:
            dn_embed, dn_bbox = get_cdn_group(
                targets["cls"], targets["bboxes"], targets["mask"], self.nc,
                self.denoising_class_embed.weight, self.dn_groups, generator,
                self.label_noise_ratio, self.box_noise_scale,
            )
            num_dn = self.num_dn
            attn_mask = torch.from_numpy(cdn_attn_mask(num_dn, self.nq, 2 * self.max_gt)).to(flat.device)

        anchors_np, valid_np = generate_anchors(shapes)
        anchors = torch.from_numpy(anchors_np).to(flat.device)
        valid = torch.from_numpy(valid_np.astype(np.float32)).to(flat.device)
        features = self.enc_output(valid.to(flat.dtype) * flat)
        enc_scores_all = self.enc_score_head(at_least_fp32(features))  # (B, L, nc), fp32
        topk_ind = select_queries(enc_scores_all, self.nq)
        top_feats = take_rows(features, topk_ind)
        refer_logit = self.enc_bbox_head(at_least_fp32(top_feats)) + anchors[topk_ind]  # box regression in fp32
        enc_scores = take_rows(enc_scores_all, topk_ind)
        enc_bboxes = torch.sigmoid(refer_logit)

        embeddings = top_feats
        if train:  # the decoder starts from the selection without its gradient
            refer_logit, embeddings = refer_logit.detach(), embeddings.detach()
        if num_dn:
            refer_logit = torch.cat([dn_bbox, refer_logit], 1)
            embeddings = torch.cat([dn_embed, embeddings], 1)

        output = output_box = embeddings  # output_box: the box stream of the decoupled layers
        refer = torch.sigmoid(refer_logit)
        dec_bboxes, dec_scores, last_refined = [], [], None
        for i, layer in enumerate(self.decoder["layers"]):
            pos = self.query_pos_head(refer)
            if self.variant == "base":
                output = output_box = layer(output, refer, flat, shapes, pos, attn_mask)
            else:
                output, output_box = layer(output, output_box, refer, flat, shapes, pos, attn_mask, num_dn)
            bbox_delta = self.dec_bbox_head[i](at_least_fp32(output_box))
            last_refined, box = refined_boxes(bbox_delta, refer, last_refined, train, i)
            if train:
                dec_scores.append(self.score(i, output, text))
                dec_bboxes.append(box)
            refer = last_refined.detach() if train else last_refined
        if not train:
            scores = self.score(self.ndl - 1, output, text)  # eval scores the last layer
            pred = torch.cat([refer, torch.sigmoid(scores)], -1)
            return {"pred": pred, "enc_scores": enc_scores, "enc_bboxes": enc_bboxes}
        return {
            "dec_bboxes": torch.stack(dec_bboxes), "dec_scores": torch.stack(dec_scores),
            "enc_bboxes": enc_bboxes, "enc_scores": enc_scores,
            "num_dn": num_dn, "dn_groups": self.dn_groups if num_dn else 0,
        }


class DualRTDETRDecoder(ManbaWorldDecoder):
    """The Dual head (`tamtr_tpu/nn/graph.py:281-295`): the levels split in
    two halves, each decoded by ONE shared RT-DETR core (no VSS mixers,
    Linear score heads; `ch` are one half's widths). Eval: {"pred": [p1,
    p2], "dual": (o1, o2)}; train: {"dual": (o1, o2), **o1}, so a loss sees
    the first half's outputs only, as in JAX."""

    def __init__(self, **kw):
        super().__init__(use_text=False, use_vss=False, **kw)

    def forward(self, feats, text, targets=None, generator=None):
        half = len(feats) // 2
        o1 = super().forward(feats[:half], text, targets, generator)
        o2 = super().forward(feats[half:], text, targets, generator)
        if not (self.training and targets is not None):
            return {"pred": [o1["pred"], o2["pred"]], "dual": (o1, o2)}
        return {"dual": (o1, o2), **o1}


class LocationManbaDecoder(nn.Module):
    """The location-decoupled head (`tamtr_tpu/nn/decoder.py:691-843`):
    classes come from per-level conv heads, a ConvBN stack (`cv3.{i}`: two
    ConvBN to max(ch[0], min(nc, 100)) channels, then a biased 1x1 conv to
    `embed_dim`) and 2-D text scores (`cv4.{i}`, `ContrastiveHead2D`); the
    query selection takes the best of those maps, and the deformable
    decoder refines boxes only. Its CDN is class-free: box noise only, the
    dn queries zero embeddings. One score set, the selected pixels', serves
    every layer: in the train dict it is broadcast over the layers with the
    dn slots zero. Text (B, K, embed_dim), embed_dim 512. After the VSS
    mixers it computes in fp32 at any compute dtype: the JAX head's
    projections and norms carry no dtype, so flax promotes.

    Eval: {"pred" (B, nq, 4 + K), "enc_bboxes", "enc_scores"}; train: the
    train dict of `ManbaWorldDecoder`, with dec_scores (ndl, B, num_dn +
    nq, K)."""

    def __init__(self, nc: int = 80, ch: Sequence[int] = (128, 256, 512), hd: int = 512,
                 nq: int = 300, ndp: int = 4, nh: int = 8, ndl: int = 6, d_ffn: int = 1024,
                 embed_dim: int = 512, num_denoising: int = 100, max_gt: int = 128,
                 box_noise_scale: float = 1.0, vss_drop_path: float = 0.1):
        super().__init__()
        self.nc, self.hd, self.nq, self.ndl = nc, hd, nq, ndl
        self.num_denoising, self.max_gt, self.box_noise_scale = num_denoising, max_gt, box_noise_scale
        nl, c3 = len(ch), max(ch[0], min(nc, 100))
        self.VSSBlocks = nn.ModuleList(VSSBlock(c, drop_path=vss_drop_path) for c in ch)
        self.input_proj = nn.ModuleList(
            nn.Sequential(Conv2d(c, hd, 1, bias=False), BatchNorm2d(hd)) for c in ch
        )
        self.cv3 = nn.ModuleList(
            nn.Sequential(ConvBN(hd, c3, 1, 1), ConvBN(c3, c3, 1, 1), Conv2d(c3, embed_dim, 1)) for _ in ch
        )
        self.cv4 = nn.ModuleList(ContrastiveHead2D() for _ in ch)
        self.decoder = nn.ModuleDict({"layers": nn.ModuleList(
            DeformableDecoderLayer(hd, nh, d_ffn, nl, ndp) for _ in range(ndl)
        )})
        self.query_pos_head = MLP(4, 2 * hd, hd, 2)
        self.enc_output = nn.Sequential(Linear(hd, hd), LayerNorm(hd, eps=1e-5))
        self.enc_bbox_head = MLP(hd, hd, 4, 3)
        self.dec_bbox_head = nn.ModuleList(MLP(hd, hd, 4, 3) for _ in range(ndl))

    dn_groups = ManbaWorldDecoder.dn_groups
    num_dn = ManbaWorldDecoder.num_dn

    def forward(self, feats, text, targets=None, generator=None):
        train = self.training and targets is not None
        feats = [at_least_fp32(vss(f.permute(0, 2, 3, 1), generator)).permute(0, 3, 1, 2)
                 for vss, f in zip(self.VSSBlocks, feats)]
        shapes = [(f.shape[2], f.shape[3]) for f in feats]
        proj = [p(f) for p, f in zip(self.input_proj, feats)]
        flat = torch.cat([p.flatten(2).transpose(1, 2) for p in proj], 1)
        pred_scores = torch.cat([head(cv(p), text).flatten(2).transpose(1, 2)
                                 for cv, head, p in zip(self.cv3, self.cv4, proj)], 1)  # (B, L, K)
        B, K = flat.shape[0], pred_scores.shape[-1]

        num_dn, attn_mask = 0, None
        if train and self.num_denoising > 0:
            num_dn = self.num_dn
            _, dn_bbox = get_cdn_group(
                targets["cls"], targets["bboxes"], targets["mask"], self.nc,
                flat.new_zeros(self.nc + 1, self.hd), self.dn_groups, generator,
                cls_noise_ratio=0.0, box_noise_scale=self.box_noise_scale,
            )
            attn_mask = torch.from_numpy(cdn_attn_mask(num_dn, self.nq, 2 * self.max_gt)).to(flat.device)

        anchors_np, valid_np = generate_anchors(shapes)
        anchors = torch.from_numpy(anchors_np).to(flat.device)
        valid = torch.from_numpy(valid_np.astype(np.float32)).to(flat.device)
        features = self.enc_output(valid.to(flat.dtype) * flat)
        topk_ind = select_queries(pred_scores, self.nq)
        top_feats = take_rows(features, topk_ind)
        refer_logit = self.enc_bbox_head(top_feats) + anchors[topk_ind]
        enc_bboxes = torch.sigmoid(refer_logit)
        scores = take_rows(pred_scores, topk_ind)

        embeddings = top_feats
        if train:
            refer_logit, embeddings = refer_logit.detach(), embeddings.detach()
        if num_dn:
            refer_logit = torch.cat([dn_bbox.to(refer_logit.dtype), refer_logit], 1)
            embeddings = torch.cat([embeddings.new_zeros(B, num_dn, self.hd), embeddings], 1)

        output, refer = embeddings, torch.sigmoid(refer_logit)
        dec_bboxes, last_refined = [], None
        for i, layer in enumerate(self.decoder["layers"]):
            output = layer(output, refer, flat, shapes, self.query_pos_head(refer), attn_mask)
            last_refined, box = refined_boxes(self.dec_bbox_head[i](output), refer, last_refined, train, i)
            dec_bboxes.append(box)
            refer = last_refined.detach() if train else last_refined
        if not train:
            return {"pred": torch.cat([refer, torch.sigmoid(scores)], -1), "enc_bboxes": enc_bboxes,
                    "enc_scores": scores}
        padded = torch.cat([scores.new_zeros(B, num_dn, K), scores], 1)
        return {
            "dec_bboxes": torch.stack(dec_bboxes), "dec_scores": padded[None].expand(self.ndl, -1, -1, -1),
            "enc_bboxes": enc_bboxes, "enc_scores": scores,
            "num_dn": num_dn, "dn_groups": self.dn_groups if num_dn else 0,
        }
