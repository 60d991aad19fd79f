"""Optional loss variants: Slide / EMASlide (and their varifocal form), NWD
and Wise-IoU (torch port of `tamtr_tpu/losses/variants.py`).

The reference ships all of them off (`models/utils/loss.py:69-83`); they
are here for ablations. As in the JAX package the running statistics (the
EMA iou mean, Wise-IoU's mean) are explicit inputs and outputs, not module
state. Under `parallel.dist.data_parallel` Wise-IoU's batch mean is the
global batch's, so that n data ranks compute the one-process loss.

`jnp.maximum` / `jnp.minimum` split the gradient evenly at a tie, and so do
`torch.maximum` / `torch.minimum`; `torch.clamp` passes all of it. Where the
JAX functions take a maximum the port takes `torch.maximum`, so that
degenerate boxes (touching edges, zero sizes) get JAX's gradient too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tamtr_torch.parallel.dist import global_sum


def _max(x: torch.Tensor, v) -> torch.Tensor:
    return torch.maximum(x, torch.as_tensor(v, dtype=x.dtype, device=x.device))


def _min(x: torch.Tensor, v) -> torch.Tensor:
    return torch.minimum(x, torch.as_tensor(v, dtype=x.dtype, device=x.device))


def slide_weight(true: torch.Tensor, auto_iou) -> torch.Tensor:
    """Slide modulating weight (reference `utils/loss.py:23-32`): 1 below
    auto_iou - 0.1, e^(1 - auto_iou) in the ramp band, e^-(true - 1) from
    auto_iou on; auto_iou is floored at 0.2."""
    auto_iou = _max(torch.as_tensor(auto_iou, dtype=torch.float32, device=true.device), 0.2)
    b1 = true <= auto_iou - 0.1
    b2 = (true > auto_iou - 0.1) & (true < auto_iou)
    b3 = true >= auto_iou
    return 1.0 * b1 + torch.exp(1.0 - auto_iou) * b2 + torch.exp(-(true - 1.0)) * b3


def bce_logits(pred: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE with logits, in JAX's form."""
    return _max(pred, 0.0) - pred * true + torch.log1p(torch.exp(-pred.abs()))


def slide_loss(pred: torch.Tensor, true: torch.Tensor, auto_iou=0.5) -> torch.Tensor:
    """SlideLoss over BCE with logits, elementwise (`utils/loss.py:15-38`)."""
    return bce_logits(pred, true) * slide_weight(true, auto_iou)


def ema_slide_update(iou_mean: torch.Tensor, updates: torch.Tensor, auto_iou, decay: float = 0.999,
                     tau: float = 2000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """EMASlide's running-mean update (`utils/loss.py:41-57`): (new
    iou_mean, new updates). auto_iou = -1 skips the update (the reference's
    num_gts == 0 sentinel)."""
    auto_iou = torch.as_tensor(auto_iou, dtype=torch.float32, device=iou_mean.device)
    do = auto_iou != -1.0
    new_updates = updates + do.to(updates.dtype)
    d = decay * (1.0 - torch.exp(-new_updates.float() / tau))
    return torch.where(do, d * iou_mean + (1.0 - d) * auto_iou, iou_mean), new_updates


def ema_slide_loss(pred: torch.Tensor, true: torch.Tensor, iou_mean: torch.Tensor, updates: torch.Tensor,
                   auto_iou=0.5) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """EMASlideLoss: the slide weight keyed on the EMA of auto_iou; returns
    (elementwise loss, new iou_mean, new updates)."""
    new_mean, new_updates = ema_slide_update(iou_mean, updates, auto_iou)
    return slide_loss(pred, true, new_mean), new_mean, new_updates


def slide_varifocal_loss(pred_score: torch.Tensor, gt_score: torch.Tensor, label: torch.Tensor, auto_iou=0.5,
                         alpha: float = 0.75, gamma: float = 2.0) -> torch.Tensor:
    """SlideVarifocalLoss (`utils/loss.py:76-100`), elementwise (the caller
    reduces as the reference does, `.mean(1).sum()`)."""
    weight = alpha * torch.sigmoid(pred_score) ** gamma * (1 - label) + gt_score * label
    loss = bce_logits(pred_score.float(), gt_score.float()) * weight
    return loss * slide_weight(gt_score, auto_iou)


def wasserstein_similarity(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True, eps: float = 1e-7,
                           constant: float = 12.8) -> torch.Tensor:
    """Normalized Wasserstein distance similarity (NWD, `utils/metrics.py:
    526-559`): exp(-sqrt(W2) / C), W2 the centres' squared distance plus a
    quarter of the squared width and height differences. (..., 1)."""
    if xywh:
        c1x, c1y, w1, h1 = box1.split(1, -1)
        c2x, c2y, w2, h2 = box2.split(1, -1)
    else:
        b1x1, b1y1, b1x2, b1y2 = box1.split(1, -1)
        b2x1, b2y1, b2x2, b2y2 = box2.split(1, -1)
        w1, h1 = b1x2 - b1x1, b1y2 - b1y1 + eps
        w2, h2 = b2x2 - b2x1, b2y2 - b2y1 + eps
        c1x, c1y = b1x1 + w1 / 2, b1y1 + h1 / 2
        c2x, c2y = b2x1 + w2 / 2, b2y1 + h2 / 2
    center = (c1x - c2x) ** 2 + (c1y - c2y) ** 2 + eps
    wh = ((w1 - w2) ** 2 + (h1 - h2) ** 2) / 4
    return torch.exp(-torch.sqrt(center + wh) / constant)


def wise_iou(pred: torch.Tensor, target: torch.Tensor, iou_mean, monotonous: Optional[bool] = False,
             training: bool = True, momentum: float = 1e-2, alpha: float = 1.7, delta: float = 2.7,
             d: float = 0.0, u: float = 0.95) -> Tuple[torch.Tensor, torch.Tensor]:
    """Wise-IoU v1 / v2 / v3 (`utils/metrics.py:560-660`, ltype 'WIoU').

    pred, target: (..., 4) cxcywh. monotonous: None v1, True v2 (sqrt focal
    factor), False v3 (the non-monotonic one, the reference's default).
    Returns (elementwise loss, new iou_mean); the mean the update takes is
    over every element, of the global batch under `data_parallel`."""
    px, py, pw, ph = pred.unbind(-1)
    tx, ty, tw, th = target.unbind(-1)
    p1, p2 = px - pw / 2, px + pw / 2
    q1, q2 = py - ph / 2, py + ph / 2
    t1, t2 = tx - tw / 2, tx + tw / 2
    s1, s2 = ty - th / 2, ty + th / 2
    iw = _max(torch.minimum(p2, t2) - torch.maximum(p1, t1), 0.0)
    ih = _max(torch.minimum(q2, s2) - torch.maximum(q1, s1), 0.0)
    inter = iw * ih
    iou_plain = inter / _max(pw * ph + tw * th - inter, 1e-9)
    # the reference's default path applies the Focaler clamp (d = 0, u = 0.95)
    iou = 1.0 - _min(_max((iou_plain - d) / (u - d), 0.0), 1.0)

    # the enclosing box and the centres' distance (WIoU's distance term)
    ew = torch.maximum(p2, t2) - torch.minimum(p1, t1)
    eh = torch.maximum(q2, s2) - torch.minimum(q1, s1)
    l2_center = (px - tx) ** 2 + (py - ty) ** 2
    loss = torch.exp(l2_center / _max(ew**2 + eh**2, 1e-9).detach()) * iou

    iou_mean = torch.as_tensor(iou_mean, dtype=iou.dtype, device=iou.device)
    if training:
        total = global_sum(iou.detach().sum())
        count = global_sum(torch.tensor(float(iou.numel()), device=iou.device))
        new_mean = (1.0 - momentum) * iou_mean + momentum * total / count
    else:
        new_mean = iou_mean
    if monotonous is not None:
        beta = iou.detach() / new_mean
        if monotonous:
            loss = loss * torch.sqrt(beta)
        else:
            loss = loss * (beta / (delta * torch.pow(alpha, beta - delta)))
    return loss, new_mean
