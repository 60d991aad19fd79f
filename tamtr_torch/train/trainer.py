"""One training step of TAM-TR: optimizer schedule, gradient accumulation,
NaN guard and EMA (torch port of the semantics of
`tamtr_tpu/train/trainer.py:make_optimizer` and `make_train_step`).

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
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn

from tamtr_torch.losses.detr_loss import DETRLossConfig, rtdetr_detection_loss


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


def _global_norm(ts: List[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(ts)))


class Trainer:
    """Trains a port `TAMTRModel` one minibatch at a time.

    Args:
      model: the model; moved to `device` and put in train mode.
      cfg: optimizer, schedule and EMA settings.
      loss_cfg: the loss; by default `DETRLossConfig(nc=model.nc)` with the
        config's match method.
      steps_per_epoch: minibatches per epoch, for the LR schedule.
      device: "cuda" by default; "cpu" only when asked for.
      seed: seed of the generator that draws the CDN noise and DropPath masks.
    """

    def __init__(self, model: nn.Module, cfg: TrainConfig = TrainConfig(),
                 loss_cfg: Optional[DETRLossConfig] = None, steps_per_epoch: int = 1000,
                 device: Optional[Union[str, torch.device]] = None, seed: int = 0):
        if device is None and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to train on the CPU")
        self.device = torch.device("cuda" if device is None else device)
        self.cfg, self.steps_per_epoch = cfg, steps_per_epoch
        self.loss_cfg = loss_cfg or DETRLossConfig(nc=model.nc, match_method=cfg.match_method)
        self.model = model.to(self.device).train()
        groups = param_groups(self.model)
        named = dict(self.model.named_parameters())
        self.params = list(named.values())
        by = {g: [named[n] for n in named if groups[n] == g] for g in ("decay", "no_decay", "bias")}
        self.optimizer = torch.optim.AdamW(
            [{"params": by["decay"], "weight_decay": cfg.scaled_wd, "group": "decay"},
             {"params": by["no_decay"], "weight_decay": 0.0, "group": "no_decay"},
             {"params": by["bias"], "weight_decay": 0.0, "group": "bias"}],
            lr=0.0, betas=(cfg.momentum, 0.999), eps=1e-8,
        )
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
        generator of the CDN noise and DropPath masks."""
        return {"model": self.model.state_dict(), "ema": self.ema.state_dict(),
                "optimizer": self.optimizer.state_dict(), "acc": self.acc, "ni": self.ni,
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
        (B, M) bool. Returns loss, giou, class, bbox, grad_norm (of this
        minibatch's gradient) and stepped (1.0 when the optimizer stepped).
        """
        cfg = self.cfg
        b = self._batch(batch)
        targets = {"cls": b["cls"], "bboxes": b["bboxes"].float(), "mask": b["mask"]}
        self.model.train()
        for p in self.params:
            p.grad = None
        out = self.model(b["img"], b["txt_feats"].float(), targets, self.generator)
        loss, items = rtdetr_detection_loss(out, targets, self.loss_cfg)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        gnorm = _global_norm(grads)
        ok = bool(torch.isfinite(loss) & torch.isfinite(gnorm)) or not cfg.skip_nonfinite
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
        metrics = {"loss": float(loss.detach())}
        metrics.update({k: float(items[k].detach()) for k in ("giou", "class", "bbox")})
        metrics.update(grad_norm=float(gnorm), stepped=float(stepped))
        return metrics
