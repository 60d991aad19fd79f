"""FastSAM's prompt selection over a segment model's `Results` (a port of
the JAX package's `tamtr_tpu/models/fastsam.py`, the reference's
`models/fastsam/prompt.py`): given every instance's mask of one image,
select masks by box, point or text. The reference's text prompt scores
image crops with CLIP; here, as in the JAX package, the text matches the
detected class names through a text-embedding function (`embed_fn`, the
hash table of `data/text.py` by default).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from tamtr_torch.data.imgproc import resize_linear_f32
from tamtr_torch.engine.results import Results


def _mask_to_fullres(mask: np.ndarray, shape_hw: Tuple[int, int]) -> np.ndarray:
    """A mask of probabilities resized to (h, w) (float32 bilinear, as
    cv2) and thresholded at 0.5."""
    return resize_linear_f32(mask.astype(np.float32), (shape_hw[1], shape_hw[0])) > 0.5


class FastSAMPrompt:
    """Prompt-based selection over one image's segmentation `Results`."""

    def __init__(self, result: Results):
        assert result.masks is not None, "prompting needs a segmentation Results"
        self.result = result
        self.shape = result.orig_shape or (1, 1)

    def everything(self) -> np.ndarray:
        """(N, H, W) bool masks at the image's size."""
        if not len(self.result):
            return np.zeros((0,) + tuple(self.shape), bool)
        return np.stack([_mask_to_fullres(m, self.shape) for m in self.result.masks])

    def box_prompt(self, box_xyxy: Sequence[float]) -> np.ndarray:
        """The mask whose box has the best IoU with the prompt box."""
        b = np.asarray(self.result.boxes.xyxy)
        if not len(b):
            return np.zeros(self.shape, bool)
        p = np.asarray(box_xyxy, np.float32)
        inter = np.clip(np.minimum(b[:, 2:], p[2:]) - np.maximum(b[:, :2], p[:2]), 0, None).prod(-1)
        union = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]) + (p[2] - p[0]) * (p[3] - p[1]) - inter
        return _mask_to_fullres(self.result.masks[int(np.argmax(inter / (union + 1e-9)))], self.shape)

    def point_prompt(self, points: Sequence[Sequence[float]], labels: Optional[Sequence[int]] = None) -> np.ndarray:
        """The union of the masks holding a positive point, less those
        holding a negative one, in the points' order."""
        labels = list(labels) if labels is not None else [1] * len(points)
        out = np.zeros(self.shape, bool)
        full = self.everything()
        for (x, y), lab in zip(points, labels):
            xi, yi = int(np.clip(x, 0, self.shape[1] - 1)), int(np.clip(y, 0, self.shape[0] - 1))
            for i in range(len(full)):
                if full[i, yi, xi]:
                    out = out | full[i] if lab == 1 else out & ~full[i]
        return out

    def text_prompt(self, text: str, embed_fn=None) -> np.ndarray:
        """The mask of the most confident detection of the class whose
        name's embedding is closest to the text's (`embed_fn(list of
        strings) -> (K, D)`, `data/text.py:class_text_embeddings` by
        default)."""
        if embed_fn is None:
            from tamtr_torch.data.text import class_text_embeddings

            embed_fn = class_text_embeddings
        names = [self.result.names[int(c)] for c in self.result.boxes.cls]
        if not names:
            return np.zeros(self.shape, bool)
        keys = list(dict.fromkeys(names))
        embs = embed_fn(keys + [text])
        best_name = keys[int(np.argmax(embs[:-1] @ embs[-1]))]
        best = max((i for i, n in enumerate(names) if n == best_name), key=lambda i: float(self.result.boxes.conf[i]))
        return _mask_to_fullres(self.result.masks[best], self.shape)
