"""The training batch that fits the card's memory (a port of
`tamtr_tpu/utils/autobatch.py`; the reference's `utils/autobatch.py`).

The arithmetic is the JAX package's: peaks at batch 1 and 2, an affine fit
peak(b) = fixed + per_item * b, and the largest batch whose fitted peak is
`fraction` (0.60) of the card's memory, clamped to [1, max_batch]; the
default when the memory or a probe is unknown. JAX reads each peak from
XLA's memory analysis of the compiled step without running it. Here a probe
runs one real `Trainer.step` (forward, the head's own loss, backward, clip,
AdamW, EMA) on a
throwaway model of the same config, `max_gt` and `imgsz`, on a synthetic
batch whose `max_gt` slots all hold a box, and reads
`torch.cuda.max_memory_allocated()`; then frees it. On the CPU there is no
memory to fit: `autobatch_train` returns the default.
"""

from __future__ import annotations

import gc
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from tamtr_torch.utils.log import LOGGER

DEFAULT_FRACTION = 0.60  # the reference's CUDA fraction


def device_memory_bytes(device: Union[str, torch.device, None] = None) -> Optional[int]:
    """Total memory of a CUDA device; None for any other."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return int(torch.cuda.mem_get_info(device)[1])


def autobatch(peak_bytes: Callable[[int], Optional[int]], limit: Optional[int], fraction: float = DEFAULT_FRACTION,
              max_batch: int = 64, default: int = 4) -> int:
    """The largest batch whose affine fit of `peak_bytes` at batch 1 and 2
    stays within `fraction` of `limit` bytes, in [1, max_batch]; `default`
    when the limit or a probe is unknown or the peak does not grow."""
    if limit is None:
        return default
    b0, b1 = 1, 2
    m0, m1 = peak_bytes(b0), peak_bytes(b1)
    if not m0 or not m1 or m1 <= m0:
        return default
    per_item = m1 - m0
    fixed = m0 - per_item * b0
    budget = fraction * limit
    fit = max(1, min(int((budget - fixed) // per_item), max_batch))
    LOGGER.info(f"autobatch: peak(b)~{fixed / 1e9:.2f}GB + {per_item / 1e9:.2f}GB/img; "
                f"{fraction:.0%} of {limit / 1e9:.1f}GB -> batch {fit}")
    return fit


def probe_batch(batch: int, imgsz: int, max_gt: int, nc: int, hd: int, seed: int = 0,
                head_type: Optional[str] = None):
    """A seeded synthetic training batch: uint8 images, every one of the
    max_gt slots a box, unit-norm class text rows; for a Segment head each
    box's mask (its rectangle at imgsz / 4), for a Pose head 17 visible
    keypoints in each box."""
    rng = np.random.default_rng(seed)
    boxes = np.concatenate([rng.uniform(0.05, 0.95, (batch, max_gt, 2)),
                            rng.uniform(0.01, 0.1, (batch, max_gt, 2))], -1).astype(np.float32)
    txt = rng.standard_normal((1, max(nc, 1), hd)).astype(np.float32)
    out = {"img": rng.integers(0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8),
           "txt_feats": txt / np.linalg.norm(txt, axis=-1, keepdims=True),
           "cls": rng.integers(0, max(nc, 1), (batch, max_gt)).astype(np.int32),
           "bboxes": boxes, "mask": np.ones((batch, max_gt), bool)}
    lo, hi = boxes[..., :2] - boxes[..., 2:] / 2, boxes[..., :2] + boxes[..., 2:] / 2  # (B, M, 2) normalized
    if head_type == "Segment":
        g = (np.arange(imgsz // 4) + 0.5) / (imgsz // 4)
        inside = [(g >= lo[..., k, None]) & (g < hi[..., k, None]) for k in (0, 1)]  # (B, M, Hm) each
        out["masks"] = (inside[1][..., :, None] & inside[0][..., None, :]).astype(np.float32)
    elif head_type == "Pose":
        xy = lo[:, :, None] + rng.random((batch, max_gt, 17, 2)) * (hi - lo)[:, :, None]
        out["keypoints"] = np.concatenate([xy * imgsz, np.full((batch, max_gt, 17, 1), 2.0)], -1).astype(np.float32)
    return out


def train_step_peak(model_cfg: str, nc: int, imgsz: int, max_gt: int, batch: int,
                    device: Union[str, torch.device] = "cuda") -> Tuple[int, Dict[str, float]]:
    """Peak bytes allocated on the card by one `Trainer.step` at `batch`, of
    a throwaway model that is freed before returning, and the step's
    metrics. The caller's models, generators and cuDNN settings are left as
    they were."""
    from tamtr_torch.nn.graph import TAMTRModel
    from tamtr_torch.train.trainer import TrainConfig, Trainer, loss_config_for
    from tamtr_torch.weights import init_parameters

    with torch.random.fork_rng(devices=[device]):
        model = TAMTRModel.from_cfg(model_cfg, nc=nc, max_gt=max_gt)
        init_parameters(model, 0)
        batch_np = probe_batch(batch, imgsz, max_gt, nc, model.text_width, head_type=model.head_type)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        trainer = Trainer(model, TrainConfig(batch_size=batch, accumulate=1),
                          loss_cfg=loss_config_for(model, imgsz=imgsz), device=device, seed=0)
        metrics = trainer.step(batch_np)  # ends in host reads of the metrics: the step is done
        peak = torch.cuda.max_memory_allocated(device)
        del trainer, model
        gc.collect()
        torch.cuda.empty_cache()
    return int(peak), metrics


def autobatch_train(model_cfg: str, nc: int, imgsz: int, max_gt: int,
                    device: Union[str, torch.device, None] = None, fraction: float = DEFAULT_FRACTION,
                    max_batch: int = 64, default: int = 4) -> int:
    """The batch that `Engine.train(batch=-1)` trains at (module docstring)."""
    device = torch.device("cuda" if device is None else device)
    return autobatch(lambda b: train_step_peak(model_cfg, nc, imgsz, max_gt, b, device)[0],
                     device_memory_bytes(device), fraction=fraction, max_batch=max_batch, default=default)
