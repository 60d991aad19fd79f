"""Checkpoints of training runs (the JAX package's `engine/checkpoint.py`,
with `torch.save` for orbax).

A checkpoint is one file, `<run_dir>/weights/{last,best}.pt`, holding
`Trainer.state_dict()` (the model, the EMA, the optimizer, the accumulated
gradient, `ni`, `count`, `last_opt` and the generator's state) and the
run's meta: epoch, nc, names, model_cfg, imgsz, max_gt. A resumed run
continues from `epoch + 1`.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Tuple

import torch

from tamtr_torch.train.trainer import Trainer


def save_checkpoint(path: str | Path, trainer: Trainer, meta: Dict[str, Any]) -> None:
    """Write atomically: a partial file never replaces a good one."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    torch.save({"trainer": trainer.state_dict(), "meta": meta}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str | Path, trainer: Trainer) -> Dict[str, Any]:
    """Restore `trainer` from a checkpoint; returns its meta. Tensors load
    on the CPU (a generator's state must be a CPU tensor); the model and
    optimizer copy theirs to their device."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    trainer.load_state_dict(ckpt["trainer"])
    return ckpt["meta"]


def load_checkpoint_raw(path: str | Path) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """(the EMA's state dict on the CPU, meta): the weights for inference."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt["trainer"]["ema"], ckpt["meta"]
