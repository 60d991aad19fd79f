"""RT-DETR detection loss: VFL class loss + L1 + RIOU, aux layers, CDN
(torch port of `tamtr_tpu/losses/detr_loss.py`, default path).

- Ground truth is padded to (B, M) with a validity mask; scatters drop
  invalid pairs into a spare column.
- Each prediction layer (encoder + every decoder layer) gets its own
  Hungarian match, all of them in ONE batched call.
- The denoising branch uses the static positive layout of `get_cdn_group`:
  dn query g*M + j reconstructs gt j for each positive group g < G.
- Gains and normalisers as the reference: class x1 (VFL, scaled by
  nq / max(num_gts, 1)), bbox x5 / num_gts, RIOU x2 / num_gts. Under
  `parallel.dist.data_parallel` num_gts is the global batch's: a rank's
  loss is then its share of the global loss, and the gradient of the
  global loss is the sum of the ranks' gradients.

The JAX package's ablation switches (`use_sl`, `use_svfl`, `nwd_loss`,
`use_wiseiou`, `losses/variants.py`) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from tamtr_torch.losses import variants
from tamtr_torch.losses.matcher import hungarian_match
from tamtr_torch.ops.boxes import bbox_iou
from tamtr_torch.parallel.dist import global_sum


@dataclass(frozen=True)
class DETRLossConfig:
    nc: int = 80
    gain_class: float = 1.0
    gain_bbox: float = 5.0
    gain_giou: float = 2.0
    use_vfl: bool = True
    vfl_alpha: float = 0.75
    vfl_gamma: float = 2.0
    fl_alpha: float = 0.25
    fl_gamma: float = 1.5
    aux_loss: bool = True
    match_method: str = "auto"
    # ablation variants, off as the reference ships them
    use_sl: bool = False
    use_svfl: bool = False
    nwd_loss: bool = False
    iou_ratio: float = 0.5
    use_wiseiou: bool = False


def _pair_losses(cfg: DETRLossConfig, pred_bboxes, pred_scores, gt_bboxes, gt_cls, q_idx, gt_idx,
                 valid) -> Dict[str, torch.Tensor]:
    """Class + bbox + RIOU losses for (query, gt) pairs: pred_bboxes
    (B, nq, 4), pred_scores (B, nq, nc), q_idx/gt_idx/valid (B, P)."""
    B, nq, nc = pred_scores.shape
    num = global_sum(valid.sum().float())
    denom = num.clamp(min=1.0)
    safe_q = torch.where(valid, q_idx, 0).long()
    safe_g = torch.where(valid, gt_idx, 0).long()
    pred_b = pred_bboxes.gather(1, safe_q[..., None].expand(-1, -1, 4))
    gt_b = gt_bboxes.gather(1, safe_g[..., None].expand(-1, -1, 4))
    pair_cls = gt_cls.long().gather(1, safe_g)
    vf = valid.float()

    loss_bbox = cfg.gain_bbox * ((pred_b - gt_b).abs().sum(-1) * vf).sum() / denom
    if cfg.use_wiseiou:
        giou_term, _ = variants.wise_iou(pred_b, gt_b, 1.0, monotonous=False)
    else:
        riou = torch.nan_to_num(bbox_iou(pred_b, gt_b, xywh=True, RIOU=True).squeeze(-1), nan=0.0)
        giou_term = 1.0 - riou
    if cfg.nwd_loss:
        nwd = variants.wasserstein_similarity(pred_b, gt_b).squeeze(-1)
        loss_giou = cfg.gain_giou * (cfg.iou_ratio * (giou_term * vf).sum() / denom
                                     + (1.0 - cfg.iou_ratio) * ((1.0 - nwd) * vf).sum() / denom)
    else:
        loss_giou = cfg.gain_giou * (giou_term * vf).sum() / denom

    # classification targets: matched classes at their queries, background nc
    drop_q = torch.where(valid, q_idx, nq).long()  # column nq: dropped
    targets = torch.full((B, nq + 1), nc, dtype=torch.long, device=pred_scores.device)
    targets = targets.scatter(1, drop_q, pair_cls)[:, :nq]
    iou_pair = bbox_iou(pred_b.detach(), gt_b, xywh=True).squeeze(-1)
    gt_scores = iou_pair.new_zeros((B, nq + 1))
    gt_scores = gt_scores.scatter(1, drop_q, iou_pair * vf)[:, :nq]

    one_hot = F.one_hot(targets, nc + 1)[..., :nc].float()  # a row of zeros for nc
    gt_full = gt_scores[..., None] * one_hot
    logits = pred_scores.float()
    softplus_neg = torch.log1p(torch.exp(-logits.abs()))
    bce = logits.clamp(min=0) - logits * gt_full + softplus_neg
    p = torch.sigmoid(logits)
    w = cfg.vfl_alpha * (p**cfg.vfl_gamma) * (1.0 - one_hot) + gt_full * one_hot
    vfl = (bce * w).mean(1).sum()
    bce0 = logits.clamp(min=0) + softplus_neg  # target 0
    fl = (bce0 * (1.0 - (1.0 - p)) ** cfg.fl_gamma * (1.0 - cfg.fl_alpha)).mean(1).sum()
    if cfg.use_sl or cfg.use_svfl:
        # the mean positive gt score (-1 with no gts), floored at 0.2
        positive = global_sum((gt_scores > 0).sum().float()).clamp(min=1)
        auto_iou = torch.where(num > 0, global_sum(gt_scores.sum()) / positive, -1.0).clamp(min=0.2)
    if cfg.use_sl:
        return {"loss_class": cfg.gain_class * variants.slide_loss(logits, gt_full, auto_iou).mean(1).sum(),
                "loss_bbox": loss_bbox, "loss_giou": loss_giou}
    if cfg.use_svfl:
        loss_cls = torch.where(num > 0, variants.slide_varifocal_loss(logits, gt_full, one_hot, auto_iou).mean(1).sum(),
                               fl)
    else:
        loss_cls = torch.where(num > 0, vfl, fl) if cfg.use_vfl else fl
    loss_cls = cfg.gain_class * loss_cls * nq / denom
    return {"loss_class": loss_cls, "loss_bbox": loss_bbox, "loss_giou": loss_giou}


def _dn_pair_indices(M: int, G: int, B: int, device):
    """Static dn positive layout: query g*M + j reconstructs gt j."""
    q = torch.arange(G * M, device=device)
    gt = torch.arange(M, device=device).repeat(G)
    return q[None].expand(B, G * M), gt[None].expand(B, G * M)


def rtdetr_detection_loss(outputs: Dict, targets: Dict[str, torch.Tensor], cfg: DETRLossConfig,
                          match: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full RT-DETR loss over the model's train dict.

    outputs: dec_bboxes/dec_scores (ndl, B, num_dn + nq, .), enc_bboxes,
    enc_scores, num_dn, dn_groups. targets: {"cls" (B, M), "bboxes"
    (B, M, 4), "mask" (B, M)}. `match`, if given, is a (layers, B, M)
    assignment used in place of the matcher's, so that two runs can be
    compared with the matching held fixed. Returns (total, items): every
    component, the main three again as giou/class/bbox, and "match", the
    (layers, B, M) assignment of the matched layers (encoder first).
    Every term is fp32 (at least) whatever the model's compute dtype: the
    model's boxes and scores come out of its fp32 islands, and the logits
    are cast up here as well (`tamtr_tpu/losses/detr_loss.py:113`), so the
    matcher's costs are fp32 too.
    """
    gt_cls, gt_bboxes, gt_mask = targets["cls"], targets["bboxes"], targets["mask"].bool()
    B, M = gt_cls.shape
    dec_bboxes, dec_scores = outputs["dec_bboxes"], outputs["dec_scores"]
    num_dn = int(outputs["num_dn"])
    G = int(outputs["dn_groups"]) if num_dn else 0
    if num_dn:
        dn_bboxes, dec_bboxes = dec_bboxes[:, :, :num_dn], dec_bboxes[:, :, num_dn:]
        dn_scores, dec_scores = dec_scores[:, :, :num_dn], dec_scores[:, :, num_dn:]

    # the encoder layer first, as the reference prepends it
    all_bboxes = torch.cat([outputs["enc_bboxes"][None], dec_bboxes], 0)
    all_scores = torch.cat([outputs["enc_scores"][None], dec_scores], 0)
    L = all_bboxes.shape[0]
    n_match = L if cfg.aux_loss else 1
    tile = lambda x: x.repeat((n_match,) + (1,) * (x.ndim - 1))  # noqa: E731
    if match is None:
        q_all = hungarian_match(
            all_bboxes[-n_match:].flatten(0, 1), all_scores[-n_match:].flatten(0, 1),
            tile(gt_bboxes), tile(gt_cls), tile(gt_mask), method=cfg.match_method,
        ).view(n_match, B, M)
    else:
        q_all = match.to(gt_cls.device).view(n_match, B, M)
    gt_idx = torch.arange(M, device=gt_cls.device)[None].expand(B, M)

    def layer_losses(bboxes, scores, q_for_gt):
        return _pair_losses(cfg, bboxes, scores, gt_bboxes, gt_cls, q_for_gt, gt_idx,
                            gt_mask & (q_for_gt >= 0))

    def summed(per_layer, suffix):
        return {f"{k}{suffix}": sum(li[k] for li in per_layer)
                for k in ("loss_class", "loss_bbox", "loss_giou")}

    losses = dict(layer_losses(all_bboxes[-1], all_scores[-1], q_all[-1]))
    if cfg.aux_loss:
        losses.update(summed([layer_losses(all_bboxes[i], all_scores[i], q_all[i])
                              for i in range(L - 1)], "_aux"))
    if num_dn:
        q_idx, dn_gt = _dn_pair_indices(M, G, B, gt_cls.device)
        valid = gt_mask.repeat(1, G)
        dn = [_pair_losses(cfg, dn_bboxes[i], dn_scores[i], gt_bboxes, gt_cls, q_idx, dn_gt, valid)
              for i in range(dn_bboxes.shape[0])]
        losses.update({f"{k}_dn": v for k, v in dn[-1].items()})
        if cfg.aux_loss:
            losses.update(summed(dn[:-1], "_aux_dn"))

    total = sum(losses.values())
    items = {**losses, "giou": losses["loss_giou"], "class": losses["loss_class"],
             "bbox": losses["loss_bbox"], "match": q_all}
    return total, items
