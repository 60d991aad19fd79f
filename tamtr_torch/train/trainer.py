"""One training step of TAM-TR: optimizer schedule, gradient accumulation,
NaN guard and EMA (torch port of the semantics of
`tamtr_tpu/train/trainer.py:make_optimizer` and `make_train_step`).

The loss is the head's (`loss_config_for`, the JAX engine's
`_loss_callable_for`): the DETR loss, with its variant switches, for the
ManbaWorldDecoder; the v8 loss (TAL, BCE, CIoU, DFL) for a YOLO Detect
head, with its mask term for a Segment head and its keypoint terms for a
Pose head; the softmax cross-entropy for a Classify head (`ce_loss`, the
JAX engine's). The step reports the loss's items as the JAX step does.

- AdamW, betas (momentum, 0.999), weight decay scaled by
  bs * accumulate / nbs, on the reference's three parameter groups: weights
  with decay, norm scales and other 1-D leaves without, and biases, which
  also get the bias warmup. The groups follow the JAX tree's leaves, so the
  SS2D `dt_projs_bias`, `A_logs` and `Ds`, which are 2-D or more there, decay.
- Gradients are summed over minibatches; the optimizer steps when
  ni - last_opt >= accumulate, which ramps 1 -> nbs/bs during warmup.
  The accumulated gradient is clipped to global norm 10 at the step.
- LR per minibatch `ni`: linear warmup over `warmup_iters` from 0 (bias
  group from `warmup_bias_lr`), then `lr0 * lf(epoch)`.
- A minibatch whose loss or gradient norm is not finite adds no gradient;
  if it falls on a step, the moments still move and the parameters do not.
- EMA of the parameters and BatchNorm statistics with decay
  0.9999 (1 - exp(-t / 2000)), t the optimizer step count, ticking only on
  optimizer steps.
- A model computing in bf16 (`TAMTRModel.dtype`) trains its fp32
  parameters as the masters: each layer casts its weight at use, so the
  gradients come back fp32, and the clip, AdamW, the EMA and the guard run
  as at fp32 (the JAX package's flat bf16 pre-cast of the parameters is a
  TPU workaround, not ported).

On several ranks (`groups`, `parallel/dist.py`) a step on n data ranks of
B/n images each is the one-process step on the global batch of B, as the
JAX step is under pjit: the forward and the loss run under `data_parallel`
(global BatchNorm moments, CDN noise and DropPath masks, loss normalisers)
and `sequence_parallel` over the sp group, and each rank's gradient, its
share of the global loss's, is summed over the data group in buckets
before the norm, the guard and the clip, which then decide the same way on
every rank. `zero=True` (the config's fsdp > 1) shards the AdamW moments
over all ranks with `ZeroRedundancyOptimizer` (ZeRO-1); the accumulated
gradient and the EMA stay replicated. `state_dict` consolidates the
optimizer on rank 0.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tamtr_torch.losses.detr_loss import DETRLossConfig, rtdetr_detection_loss
from tamtr_torch.losses.v8_loss import V8LossConfig, v8_detection_loss
from tamtr_torch.losses.v8_pose_loss import V8PoseLossConfig, v8_pose_loss
from tamtr_torch.losses.v8_seg_loss import V8SegLossConfig, v8_segmentation_loss
from tamtr_torch.nn.ssm import sequence_parallel
from tamtr_torch.parallel.dist import Groups, all_reduce_grads, data_parallel, global_sum


@dataclass(frozen=True)
class TrainConfig:
    lr0: float = 1e-4
    lrf: float = 1.0
    momentum: float = 0.937  # Adam beta1
    weight_decay: float = 1e-4
    warmup_iters: int = 2000
    warmup_bias_lr: float = 0.1
    warmup_momentum: float = 0.8
    momentum_warmup: bool = False  # ramp beta1 warmup_momentum -> momentum (off in the recipe)
    epochs: int = 300
    batch_size: int = 6
    nbs: int = 64  # nominal batch size for accumulation and weight-decay scaling
    accumulate: int = 0  # 0 => round(nbs / batch_size), ramped during warmup
    grad_clip: float = 10.0
    ema_decay: float = 0.9999
    ema_tau: float = 2000.0
    match_method: str = "auto"
    skip_nonfinite: bool = True

    @property
    def accum_steps(self) -> int:
        return self.accumulate or max(round(self.nbs / self.batch_size), 1)

    @property
    def scaled_wd(self) -> float:
        return self.weight_decay * self.batch_size * self.accum_steps / self.nbs


def param_group(module: nn.Module, name: str, p: torch.Tensor) -> str:
    """"bias", "no_decay" or "decay" for parameter `name` of `module`, as
    the JAX package's `_bias_mask` / `_decay_mask` classify its flax leaf."""
    if name in ("bias", "in_proj_bias"):
        return "bias"
    if isinstance(module, (nn.LayerNorm, nn.BatchNorm2d)) and name == "weight":
        return "no_decay"  # flax "scale"
    if name == "Ds":
        return "decay"  # (4, D) in the JAX tree
    return "no_decay" if p.ndim <= 1 else "decay"


def param_groups(model: nn.Module) -> Dict[str, str]:
    """Group of every named parameter of `model`."""
    return {f"{mname}.{pname}" if mname else pname: param_group(mod, pname, p)
            for mname, mod in model.named_modules() for pname, p in mod.named_parameters(recurse=False)}


def lr_at(cfg: TrainConfig, ni: int, steps_per_epoch: int, warmup_from: float) -> float:
    """LR of minibatch ni: warmup from `warmup_from`, then lr0 * lf(epoch)."""
    epoch = ni / max(steps_per_epoch, 1)
    target = cfg.lr0 * ((1.0 - epoch / cfg.epochs) * (1.0 - cfg.lrf) + cfg.lrf)
    nw = float(max(cfg.warmup_iters, 1))
    if ni < nw:
        return warmup_from + (target - warmup_from) * min(ni / nw, 1.0)
    return target


def accumulate_at(cfg: TrainConfig, ni: int) -> float:
    """Minibatches per optimizer step at ni: max(1, round(1 + frac (nbs/bs - 1))),
    frac = ni / warmup_iters clipped, in float32 as the JAX package rounds it."""
    if cfg.accumulate > 0:
        return float(cfg.accumulate)
    f32 = np.float32
    frac = np.clip(f32(ni) / f32(max(cfg.warmup_iters, 1)), f32(0), f32(1))
    return float(max(np.round(f32(1) + frac * (f32(cfg.nbs / cfg.batch_size) - f32(1))), f32(1)))


# the step's reported loss items (the JAX step's), of whichever loss ran
REPORTED = ("giou", "class", "bbox", "box", "cls", "dfl", "seg", "pose", "kobj", "top1")


@dataclass(frozen=True)
class CELossConfig:
    """The classification loss: the mean softmax cross-entropy of a
    Classify head's logits against `targets["cls"][:, 0]`."""

    nc: int = 1000


def ce_loss(out: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor]):
    """(loss, {"cls", "top1"}) of a Classify head's train dict, as the JAX
    engine's `ce_loss` (`tamtr_tpu/engine/model.py:475-482`): the mean
    softmax cross-entropy over the batch and the share of top-1 hits, in
    fp32 at least. Under `data_parallel` both are this rank's share of the
    global batch's mean (divided by the global batch size), so their sum
    over the data ranks is the one-process value."""
    logits = out["logits"]
    logits = logits.float() if logits.dtype == torch.bfloat16 else logits
    labels = targets["cls"][:, 0].long()
    n = global_sum(torch.tensor(float(len(labels)), device=logits.device, dtype=logits.dtype))
    loss = F.cross_entropy(logits, labels, reduction="sum") / n
    top1 = (logits.detach().argmax(-1) == labels).sum().to(logits.dtype) / n
    return loss, {"cls": loss.detach(), "top1": top1}
# the batch keys that ride into the loss's targets when present: Segment's
# gt masks, Pose's gt keypoints
EXTRA_TARGETS = ("masks", "keypoints")


def loss_config_for(model: nn.Module, nc: Optional[int] = None, imgsz: int = 640, box: float = 7.5,
                    cls: float = 0.5, dfl: float = 1.5, match_method: str = "auto", pose: float = 12.0,
                    kobj: float = 1.0):
    """The loss of `model`'s head, as the JAX engine's `_loss_callable_for`
    picks it: a Detect head's `V8LossConfig` (gains box, cls, dfl; gts
    scaled to `imgsz` pixels), a Segment head's `V8SegLossConfig`, a Pose
    head's `V8PoseLossConfig` (its gains pose and kobj; the head's
    kpt_shape), a Classify head's `CELossConfig`, any other head's
    `DETRLossConfig`."""
    nc = model.nc if nc is None else nc
    head_type = getattr(model, "head_type", None)
    v8 = dict(nc=nc, box=box, cls=cls, dfl=dfl, imgsz=imgsz)
    if head_type == "Classify":
        return CELossConfig(nc=nc)
    if head_type == "Detect":
        return V8LossConfig(**v8)
    if head_type == "Segment":
        return V8SegLossConfig(**v8)
    if head_type == "Pose":
        return V8PoseLossConfig(**v8, kpt_shape=model.model[-1].kpt_shape, pose=pose, kobj=kobj)
    return DETRLossConfig(nc=nc, match_method=match_method)


def head_loss(out: Dict, targets: Dict[str, torch.Tensor], loss_cfg):
    """(total, items) of the loss `loss_cfg` names, on the head's train dict."""
    if isinstance(loss_cfg, CELossConfig):
        return ce_loss(out, targets)
    if isinstance(loss_cfg, V8SegLossConfig):
        return v8_segmentation_loss(out, targets, loss_cfg)
    if isinstance(loss_cfg, V8PoseLossConfig):
        return v8_pose_loss(out, targets, loss_cfg)
    if isinstance(loss_cfg, V8LossConfig):
        return v8_detection_loss(out, targets, loss_cfg)
    return rtdetr_detection_loss(out, targets, loss_cfg)


def _global_norm(ts: List[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(ts)))


class Trainer:
    """Trains a port `TAMTRModel` one minibatch at a time.

    Args:
      model: the model; moved to `device` and put in train mode.
      cfg: optimizer, schedule and EMA settings.
      loss_cfg: the loss: a `DETRLossConfig` (the DETR loss, with its
        variant switches), a `V8LossConfig` (the YOLO Detect loss; its
        `V8SegLossConfig` and `V8PoseLossConfig` the Segment and Pose ones)
        or a `CELossConfig` (a Classify head's cross-entropy); by
        default the head's (`loss_config_for`, at 640 px and the config's
        match method).
      steps_per_epoch: minibatches per epoch, for the LR schedule.
      device: "cuda" by default; "cpu" only when asked for.
      seed: seed of the generator that draws the CDN noise and DropPath masks.
      groups: this rank's data and sp groups (`parallel.dist.make_groups`),
        or None for one process; every rank starts from the same model.
      zero: shard the optimizer state over every rank (ZeRO-1).
    """

    def __init__(self, model: nn.Module, cfg: TrainConfig = TrainConfig(),
                 loss_cfg: Optional[Union[DETRLossConfig, V8LossConfig]] = None, steps_per_epoch: int = 1000,
                 device: Optional[Union[str, torch.device]] = None, seed: int = 0,
                 groups: Optional[Groups] = None, zero: bool = False):
        if device is None and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to train on the CPU")
        self.device = torch.device("cuda" if device is None else device)
        self.cfg, self.steps_per_epoch = cfg, steps_per_epoch
        self.loss_cfg = loss_cfg or loss_config_for(model, match_method=cfg.match_method)
        self.model = model.to(self.device).train()
        kinds = param_groups(self.model)
        named = dict(self.model.named_parameters())
        self.params = list(named.values())
        by = {g: [named[n] for n in named if kinds[n] == g] for g in ("decay", "no_decay", "bias")}
        opt_groups = [{"params": by["decay"], "weight_decay": cfg.scaled_wd, "group": "decay"},
                      {"params": by["no_decay"], "weight_decay": 0.0, "group": "no_decay"},
                      {"params": by["bias"], "weight_decay": 0.0, "group": "bias"}]
        hyper = dict(lr=0.0, betas=(cfg.momentum, 0.999), eps=1e-8)
        self.groups, self.zero = groups, zero
        if zero:
            if groups is None:
                raise ValueError("zero=True shards the optimizer over ranks: pass the groups")
            from torch.distributed.optim import ZeroRedundancyOptimizer

            self.optimizer = ZeroRedundancyOptimizer(opt_groups, optimizer_class=torch.optim.AdamW, **hyper)
        else:
            self.optimizer = torch.optim.AdamW(opt_groups, **hyper)
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.ema = copy.deepcopy(self.model).eval().requires_grad_(False)
        # EMA'd tensors: parameters and BN running statistics (state-dict
        # entries share storage with the modules)
        pairs = [(e, p) for e, p in zip(self.ema.state_dict().values(), self.model.state_dict().values())
                 if e.dtype.is_floating_point]
        self._ema, self._cur = [e for e, _ in pairs], [p for _, p in pairs]
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.ni, self.last_opt, self.count = 0, -1, 0

    def state_dict(self) -> Dict:
        """Everything a resumed run needs to continue bitwise: the model, the
        EMA, the optimizer, the accumulated gradient, the counters and the
        generator of the CDN noise and DropPath masks. With zero=True every
        rank calls it and the optimizer's shards meet on rank 0; the other
        ranks' dicts hold no optimizer."""
        if self.zero:
            self.optimizer.consolidate_state_dict(to=0)
            opt = self.optimizer.state_dict() if dist.get_rank() == 0 else None
        else:
            opt = self.optimizer.state_dict()
        return {"model": self.model.state_dict(), "ema": self.ema.state_dict(),
                "optimizer": opt, "acc": self.acc, "ni": self.ni,
                "count": self.count, "last_opt": self.last_opt, "generator": self.generator.get_state()}

    def load_state_dict(self, state: Dict) -> None:
        self.model.load_state_dict(state["model"])
        self.ema.load_state_dict(state["ema"])
        self.optimizer.load_state_dict(state["optimizer"])
        with torch.no_grad():
            torch._foreach_copy_(self.acc, [a.to(self.device) for a in state["acc"]])
        self.ni, self.count, self.last_opt = state["ni"], state["count"], state["last_opt"]
        self.generator.set_state(state["generator"])

    def _batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        out = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        img = out["img"]
        out["img"] = img.float() / 255.0 if img.dtype == torch.uint8 else img.float()
        out["mask"] = out["mask"].bool()
        return out

    def step(self, batch: Dict) -> Dict[str, float]:
        """One minibatch: forward, loss, backward, accumulation and, when the
        cadence says so, the optimizer step and the EMA update.

        batch: img (B, H, W, 3) uint8 or float in [0, 1]; txt_feats (B or 1,
        K, hd); cls (B, M) int; bboxes (B, M, 4) normalized cxcywh; mask
        (B, M) bool; a Segment model's masks (B, M, Hm, Wm), a Pose model's
        keypoints (B, M, nk, 3) in pixels; a Classify model's labels are
        cls[:, 0]. Returns loss, the loss's items
        (giou, class and bbox of the DETR loss; box, cls and dfl of the
        Detect loss, and seg, or pose and kobj; cls and top1 of the
        cross-entropy), grad_norm (of
        this minibatch's gradient) and stepped (1.0 when the optimizer
        stepped).
        """
        cfg = self.cfg
        b = self._batch(batch)
        targets = {"cls": b["cls"], "bboxes": b["bboxes"].float(), "mask": b["mask"],
                   **{k: b[k].float() for k in EXTRA_TARGETS if k in b}}
        self.model.train()
        for p in self.params:
            p.grad = None
        groups = self.groups
        with data_parallel(groups), sequence_parallel(groups.sp if groups is not None else None):
            out = self.model(b["img"], b["txt_feats"].float(), targets, self.generator)
            loss, items = head_loss(out, targets, self.loss_cfg)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        keys = [k for k in REPORTED if k in items]
        reported = torch.stack([loss.detach()] + [items[k].detach() for k in keys])
        if groups is not None:  # the global loss's gradient, and the global loss
            all_reduce_grads(grads, groups.data)
            dist.all_reduce(reported, group=groups.data)
        gnorm = _global_norm(grads)
        ok = bool(torch.isfinite(reported[0]) & torch.isfinite(gnorm)) or not cfg.skip_nonfinite
        if ok:
            torch._foreach_add_(self.acc, grads)

        ni = self.ni
        stepped = ni - self.last_opt >= accumulate_at(cfg, ni)
        if stepped:
            coef = min(1.0, cfg.grad_clip / max(float(_global_norm(self.acc)), 1e-6))
            for p, a in zip(self.params, self.acc):
                p.grad = a * coef
            lr_main = lr_at(cfg, ni, self.steps_per_epoch, 0.0)
            lr_bias = lr_at(cfg, ni, self.steps_per_epoch, cfg.warmup_bias_lr)
            b1 = cfg.momentum
            if cfg.momentum_warmup:
                frac = min(max(ni / max(cfg.warmup_iters, 1), 0.0), 1.0)
                b1 = cfg.warmup_momentum + frac * (cfg.momentum - cfg.warmup_momentum)
            for group in self.optimizer.param_groups:
                group["lr"] = lr_bias if group["group"] == "bias" else lr_main
                group["betas"] = (b1, 0.999)
            keep = None if ok else [p.detach().clone() for p in self.params]
            self.optimizer.step()
            if keep is not None:  # a non-finite minibatch moves the moments only
                with torch.no_grad():
                    torch._foreach_copy_(self.params, keep)
            for a in self.acc:
                a.zero_()
            self.count += 1
            self.last_opt = ni
            d = cfg.ema_decay * (1.0 - math.exp(-self.count / cfg.ema_tau))
            with torch.no_grad():
                torch._foreach_mul_(self._ema, d)
                torch._foreach_add_(self._ema, self._cur, alpha=1.0 - d)
        for p in self.params:
            p.grad = None
        self.ni += 1
        metrics = dict(zip(["loss"] + keys, reported.tolist()))
        metrics.update(grad_norm=float(gnorm), stepped=float(stepped))
        return metrics
