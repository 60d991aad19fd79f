"""MEH head: VMamba mixers, a deformable decoder, text-contrastive scoring
and, in train mode, the static-shape CDN denoising branch (torch port of
`tamtr_tpu/nn/decoder.py`).

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
from tamtr_torch.nn.layers import MLP, BatchNorm2d, Conv2d, LayerNorm, Linear, at_input_dtype
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


class ManbaWorldDecoder(nn.Module):
    """The MEH head: per-level VSS mixers, input projection, top-k query
    selection over encoder scores, `ndl` deformable decoder layers with
    text-contrastive scores.

    feats: per-level NCHW maps; text (B, K, hd). Eval (`.eval()` or no
    targets): a dict with "pred" (B, nq, 4 + nc) normalized cxcywh + sigmoid
    scores. Train (`.train()` and targets {"cls", "bboxes", "mask"}): the
    JAX package's train dict, with the CDN queries in front (num_dn of them):
    dec_bboxes/dec_scores (ndl, B, num_dn + nq, .), enc_bboxes/enc_scores,
    num_dn and dn_groups. Random draws (DropPath, CDN noise) come from
    `generator`.
    """

    def __init__(self, nc: int = 80, ch: Sequence[int] = (128, 256, 512), hd: int = 512,
                 nq: int = 100, ndp: int = 4, nh: int = 8, ndl: int = 3, d_ffn: int = 1024,
                 num_denoising: int = 100, max_gt: int = 128, label_noise_ratio: float = 0.5,
                 box_noise_scale: float = 1.0, vss_drop_path: float = 0.1):
        super().__init__()
        self.nc, self.hd, self.nq, self.ndl = nc, hd, nq, ndl
        self.num_denoising, self.max_gt = num_denoising, max_gt
        self.label_noise_ratio, self.box_noise_scale = label_noise_ratio, box_noise_scale
        nl = len(ch)
        self.VSSBlocks = nn.ModuleList(VSSBlock(c, drop_path=vss_drop_path) for c in ch)
        self.input_proj = nn.ModuleList(
            nn.Sequential(Conv2d(c, hd, 1, bias=False), BatchNorm2d(hd)) for c in ch
        )
        self.decoder = nn.ModuleDict({"layers": nn.ModuleList(
            DeformableDecoderLayer(hd, nh, d_ffn, nl, ndp) for _ in range(ndl)
        )})
        self.denoising_class_embed = nn.Embedding(nc + 1, hd)
        self.query_pos_head = MLP(4, 2 * hd, hd, 2)
        self.enc_output = nn.Sequential(Linear(hd, hd), LayerNorm(hd, eps=1e-5))
        self.enc_score_head = Linear(hd, nc)
        self.enc_bbox_head = MLP(hd, hd, 4, 3)
        self.dec_score_head = nn.ModuleList(ContrastiveHead() for _ in range(ndl))
        self.dec_bbox_head = nn.ModuleList(MLP(hd, hd, 4, 3) for _ in range(ndl))

    @property
    def dn_groups(self) -> int:
        return max(1, self.num_denoising // self.max_gt)

    @property
    def num_dn(self) -> int:
        return 2 * self.dn_groups * self.max_gt

    def forward(self, feats: List[torch.Tensor], text: torch.Tensor,
                targets: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        train = self.training and targets is not None
        # the VSS mixers run channels-last
        feats = [vss(f.permute(0, 2, 3, 1), generator) for vss, f in zip(self.VSSBlocks, feats)]
        shapes = [(f.shape[1], f.shape[2]) for f in feats]
        flat = torch.cat([
            proj(f.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
            for proj, f in zip(self.input_proj, feats)
        ], 1)  # (B, L, hd), row-major per level

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
        k_eff = min(self.nq, enc_scores_all.shape[1])
        topk_ind = enc_scores_all.max(-1).values.topk(k_eff, dim=1).indices
        if k_eff < self.nq:  # tiny inputs: tile the selection up to nq queries
            topk_ind = topk_ind.repeat(1, -(-self.nq // k_eff))[:, : self.nq]
        top_feats = torch.gather(features, 1, topk_ind[..., None].expand(-1, -1, self.hd))
        refer_logit = self.enc_bbox_head(at_least_fp32(top_feats)) + anchors[topk_ind]  # box regression in fp32
        enc_scores = torch.gather(enc_scores_all, 1, topk_ind[..., None].expand(-1, -1, self.nc))
        enc_bboxes = torch.sigmoid(refer_logit)

        embeddings = top_feats
        if train:  # the decoder starts from the selection without its gradient
            refer_logit, embeddings = refer_logit.detach(), embeddings.detach()
        if num_dn:
            refer_logit = torch.cat([dn_bbox, refer_logit], 1)
            embeddings = torch.cat([dn_embed, embeddings], 1)

        output, refer = embeddings, torch.sigmoid(refer_logit)
        dec_bboxes, dec_scores, last_refined = [], [], None
        for i, layer in enumerate(self.decoder["layers"]):
            output = layer(output, refer, flat, shapes, self.query_pos_head(refer), attn_mask)
            bbox_delta = self.dec_bbox_head[i](at_least_fp32(output))
            refined = torch.sigmoid(bbox_delta + inverse_sigmoid(refer))
            if train:
                dec_scores.append(self.dec_score_head[i](output, text))
                # layer i > 0 boxes take their gradient through the previous
                # layer's refined boxes, not the detached reference
                dec_bboxes.append(refined if i == 0 else torch.sigmoid(bbox_delta + inverse_sigmoid(last_refined)))
            last_refined = refined
            refer = refined.detach() if train else refined
        if not train:
            scores = self.dec_score_head[self.ndl - 1](output, text)  # eval scores the last layer
            pred = torch.cat([refer, torch.sigmoid(scores)], -1)
            return {"pred": pred, "enc_scores": enc_scores, "enc_bboxes": enc_bboxes}
        return {
            "dec_bboxes": torch.stack(dec_bboxes), "dec_scores": torch.stack(dec_scores),
            "enc_bboxes": enc_bboxes, "enc_scores": enc_scores,
            "num_dn": num_dn, "dn_groups": self.dn_groups if num_dn else 0,
        }
