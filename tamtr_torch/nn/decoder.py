"""MEH head in eval mode: VMamba mixers, a deformable decoder and
text-contrastive scoring (torch port of `tamtr_tpu/nn/decoder.py`).

Attribute names follow the reference checkpoint (`VSSBlocks.{i}`,
`input_proj.{i}.{0,1}`, `decoder.layers.{i}` with `in_proj_weight`,
`enc_output.{0,1}`, `dec_score_head.{i}`, `dec_bbox_head.{i}.layers.{j}`).
The CDN denoising branch belongs to the training slice; its class table
`denoising_class_embed` is held so that checkpoints load.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tamtr_torch.kernels.deform_scatter import bilinear_gather
from tamtr_torch.nn.layers import BN_EPS, MLP
from tamtr_torch.nn.ssm import VSSBlock


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
        self.value_proj = nn.Linear(d_model, d_model)
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(self, query, refer_bbox, value, shapes):
        """query (B, Q, C); refer_bbox (B, Q, 4) cxcywh in [0, 1]; value (B, Lv, C)."""
        B, Q, C = query.shape
        nh, nl, P = self.nh, self.nl, self.P
        v = self.value_proj(value).view(B, -1, nh, C // nh)
        off = self.sampling_offsets(query).view(B, Q, nh, nl, P, 2)
        w = self.attention_weights(query).view(B, Q, nh, nl * P).softmax(-1).view(B, Q, nh, nl, P)
        xy = refer_bbox[:, :, None, None, None, :2]
        wh = refer_bbox[:, :, None, None, None, 2:]
        loc = xy + off / P * wh * 0.5
        return self.output_proj(ms_deform_attn_core(v, shapes, loc, w))


class MultiHeadSelfAttention(nn.Module):
    """MHA with nn.MultiheadAttention's parameter names (`in_proj_weight`,
    `in_proj_bias`, `out_proj`); q, k and v take separate inputs."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.h = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, q, k, v):
        B, Q, C = q.shape
        h, d = self.h, C // self.h
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        qp = F.linear(q, wq, bq).view(B, Q, h, d).transpose(1, 2)
        kp = F.linear(k, wk, bk).view(B, -1, h, d).transpose(1, 2)
        vp = F.linear(v, wv, bv).view(B, -1, h, d).transpose(1, 2)
        att = (qp @ kp.transpose(-1, -2) / math.sqrt(d)).softmax(-1)
        return self.out_proj((att @ vp).transpose(1, 2).reshape(B, Q, C))


class ContrastiveHead(nn.Module):
    """Region-text similarity logits: cosine similarity scaled by
    exp(logit_scale), plus a bias."""

    def __init__(self):
        super().__init__()
        self.bias = nn.Parameter(torch.full((1,), -10.0))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (B, Q, C) region embeds; w (B, K, C) text embeds -> (B, Q, K)."""
        xn = x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        wn = w / w.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        return torch.einsum("bqc,bkc->bqk", xn, wn) * self.logit_scale.exp() + self.bias


class DeformableDecoderLayer(nn.Module):
    """Self-attention + deformable cross-attention + FFN, post-norm."""

    def __init__(self, d_model: int, n_heads: int, d_ffn: int, n_levels: int, n_points: int):
        super().__init__()
        self.self_attn = MultiHeadSelfAttention(d_model, n_heads)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, embed, refer_bbox, feats, shapes, query_pos):
        q = embed + query_pos
        embed = self.norm1(embed + self.self_attn(q, q, embed))
        embed = self.norm2(embed + self.cross_attn(embed + query_pos, refer_bbox, feats, shapes))
        return self.norm3(embed + self.linear2(F.relu(self.linear1(embed))))


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


class ManbaWorldDecoder(nn.Module):
    """The MEH head, eval mode: per-level VSS mixers, input projection,
    top-k query selection over encoder scores, `ndl` deformable decoder
    layers, and the last layer's boxes with its text-contrastive scores.

    feats: per-level NCHW maps; text (B, K, hd) -> dict with "pred"
    (B, nq, 4 + nc) normalized cxcywh + sigmoid scores.
    """

    def __init__(self, nc: int = 80, ch: Sequence[int] = (128, 256, 512), hd: int = 512,
                 nq: int = 100, ndp: int = 4, nh: int = 8, ndl: int = 3, d_ffn: int = 1024):
        super().__init__()
        self.nc, self.hd, self.nq, self.ndl = nc, hd, nq, ndl
        nl = len(ch)
        self.VSSBlocks = nn.ModuleList(VSSBlock(c) for c in ch)
        self.input_proj = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, hd, 1, bias=False), nn.BatchNorm2d(hd, eps=BN_EPS)) for c in ch
        )
        self.decoder = nn.ModuleDict({"layers": nn.ModuleList(
            DeformableDecoderLayer(hd, nh, d_ffn, nl, ndp) for _ in range(ndl)
        )})
        self.denoising_class_embed = nn.Embedding(nc + 1, hd)
        self.query_pos_head = MLP(4, 2 * hd, hd, 2)
        self.enc_output = nn.Sequential(nn.Linear(hd, hd), nn.LayerNorm(hd, eps=1e-5))
        self.enc_score_head = nn.Linear(hd, nc)
        self.enc_bbox_head = MLP(hd, hd, 4, 3)
        self.dec_score_head = nn.ModuleList(ContrastiveHead() for _ in range(ndl))
        self.dec_bbox_head = nn.ModuleList(MLP(hd, hd, 4, 3) for _ in range(ndl))

    def forward(self, feats: List[torch.Tensor], text: torch.Tensor):
        B = feats[0].shape[0]
        # the VSS mixers run channels-last
        feats = [vss(f.permute(0, 2, 3, 1)) for vss, f in zip(self.VSSBlocks, feats)]
        shapes = [(f.shape[1], f.shape[2]) for f in feats]
        flat = torch.cat([
            proj(f.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
            for proj, f in zip(self.input_proj, feats)
        ], 1)  # (B, L, hd), row-major per level

        anchors_np, valid_np = generate_anchors(shapes)
        anchors = torch.from_numpy(anchors_np).to(flat.device)
        valid = torch.from_numpy(valid_np.astype(np.float32)).to(flat.device)
        features = self.enc_output(valid * flat)
        enc_scores_all = self.enc_score_head(features)  # (B, L, nc)
        k_eff = min(self.nq, enc_scores_all.shape[1])
        topk_ind = enc_scores_all.max(-1).values.topk(k_eff, dim=1).indices
        if k_eff < self.nq:  # tiny inputs: tile the selection up to nq queries
            topk_ind = topk_ind.repeat(1, -(-self.nq // k_eff))[:, : self.nq]
        top_feats = torch.gather(features, 1, topk_ind[..., None].expand(-1, -1, self.hd))
        refer_logit = self.enc_bbox_head(top_feats) + anchors[topk_ind]
        enc_scores = torch.gather(enc_scores_all, 1, topk_ind[..., None].expand(-1, -1, self.nc))

        output, refer = top_feats, torch.sigmoid(refer_logit)
        for i, layer in enumerate(self.decoder["layers"]):
            output = layer(output, refer, flat, shapes, self.query_pos_head(refer))
            refer = torch.sigmoid(self.dec_bbox_head[i](output) + inverse_sigmoid(refer))
        scores = self.dec_score_head[self.ndl - 1](output, text)  # eval scores the last layer
        pred = torch.cat([refer, torch.sigmoid(scores)], -1)
        return {"pred": pred, "enc_scores": enc_scores, "enc_bboxes": torch.sigmoid(refer_logit)}
