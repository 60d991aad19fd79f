"""`check_imgsz` (the JAX package's `utils/checks.py:check_imgsz`)."""

from __future__ import annotations

from typing import List, Sequence, Union

from tamtr_torch.utils.log import LOGGER


def check_imgsz(
    imgsz: Union[int, Sequence[int]], stride: int = 32, min_dim: int = 1, floor: int = 0
) -> Union[int, List[int]]:
    """Round image size(s) up to a multiple of the model stride."""
    scalar = isinstance(imgsz, int)
    sizes = [imgsz] if scalar else list(imgsz)
    out = [max(int(-(-s // stride) * stride), floor) for s in sizes]
    if out != sizes:
        LOGGER.warning(f"imgsz {sizes} not multiple of stride {stride}, updated to {out}")
    if min_dim == 2 and len(out) == 1:
        out = out * 2
    return out[0] if scalar and min_dim == 1 else out
