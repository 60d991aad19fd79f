"""User entry point: `TAMTR(...).predict(images, text)` and
`TAMTR(...).trainer()`.

`predict` mirrors the per-image results of the JAX package's predict
(`tamtr_tpu/engine/model.py:predict`): each image is resized to `imgsz`,
run through the eval forward, postprocessed (conf filter, class-offset NMS),
and its boxes scaled back to the image's own pixels. Decoding image files
and test-time augmentation are not ported yet. `trainer` returns a
`tamtr_torch.train.trainer.Trainer` over the same model, whose
`step(batch)` is one training step.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from tamtr_torch.nn.graph import TAMTRModel
from tamtr_torch.ops.nms import postprocess_predictions
from tamtr_torch.train.trainer import Trainer, TrainConfig
from tamtr_torch.weights import from_jax_variables, init_parameters

ImageLike = Union[np.ndarray, torch.Tensor]


class TAMTR:
    """A TAM-TR detector in eval mode.

    Args:
      model: config name or path ("tamtr.yaml" resolves to the bundled JSON).
      nc: number of classes.
      device: "cuda" by default; "cpu" only when asked for.
      seed: seed of the generator that initialises the weights.
      imgsz: square input size of the network.
      max_gt: ground-truth slots per training image (the CDN layout); 300 as
        the JAX package's training config.
    """

    def __init__(self, model: Union[str, Path] = "tamtr.yaml", nc: int = 10,
                 device: Optional[Union[str, torch.device]] = None, seed: int = 0, imgsz: int = 640,
                 max_gt: int = 300):
        if device is None and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        self.device = torch.device("cuda" if device is None else device)
        self.imgsz = imgsz
        net = TAMTRModel.from_cfg(model, nc=nc, max_gt=max_gt)
        init_parameters(net, seed)
        self.model = net.to(self.device).eval()

    def load_jax_variables(self, params: Dict, batch_stats: Dict) -> "TAMTR":
        """Load the JAX package's flax variables (nested dicts of arrays)."""
        sd, report = from_jax_variables(params, batch_stats, self.model)
        problems = {k: v for k, v in report.items() if v}
        if problems:
            raise ValueError(f"incomplete weight bridge: {problems}")
        self.model.load_state_dict(sd, strict=True)
        return self

    def trainer(self, cfg: TrainConfig = TrainConfig(), seed: int = 0) -> Trainer:
        """A `Trainer` over this detector's model and device; `step(batch)`
        is one training step (see `Trainer.step`). Predict puts the model
        back in eval mode itself."""
        return Trainer(self.model, cfg, device=self.device, seed=seed)

    def _to_batch(self, images: Union[ImageLike, Sequence[ImageLike]]):
        """(B, imgsz, imgsz, 3) float in [0, 1] on the device, and each image's (h, w)."""
        if isinstance(images, (np.ndarray, torch.Tensor)) and images.ndim == 4:
            images = list(images)
        elif isinstance(images, (np.ndarray, torch.Tensor)):
            images = [images]
        batch, sizes = [], []
        for im in images:
            t = torch.as_tensor(np.asarray(im) if isinstance(im, np.ndarray) else im)
            if t.ndim != 3 or t.shape[-1] != 3:
                raise ValueError(f"an image must be (H, W, 3), got {tuple(t.shape)}")
            is_uint8 = t.dtype == torch.uint8
            t = t.to(self.device, torch.float32)
            if is_uint8:
                t = t / 255.0
            sizes.append((t.shape[0], t.shape[1]))
            if t.shape[:2] != (self.imgsz, self.imgsz):
                t = F.interpolate(
                    t.permute(2, 0, 1)[None], size=(self.imgsz, self.imgsz),
                    mode="bilinear", align_corners=False,
                )[0].permute(1, 2, 0)
            batch.append(t)
        return torch.stack(batch), sizes

    @torch.inference_mode()
    def predict(self, images, text, conf: float = 0.25, iou: float = 0.7,
                max_det: int = 300) -> List[Dict[str, np.ndarray]]:
        """Detect objects of the K classes embedded in `text`.

        Args:
          images: (B, H, W, 3) or (H, W, 3) uint8 or float in [0, 1], or a
            list of (H, W, 3) images of any sizes.
          text: (K, hd) or (1|B, K, hd) class embeddings.
        Returns:
          one dict per image: "boxes" (n, 4) xyxy in the image's pixels,
          "scores" (n,), "labels" (n,) int32.
        """
        img, sizes = self._to_batch(images)
        txt = torch.as_tensor(np.asarray(text) if isinstance(text, np.ndarray) else text)
        txt = txt.to(self.device, torch.float32)
        if txt.ndim == 2:
            txt = txt[None]
        self.model.eval()
        pred = self.model(img, txt)["pred"]
        boxes, scores, labels, valid = postprocess_predictions(pred, conf, iou, max_det)
        results = []
        for i, (h, w) in enumerate(sizes):
            sel = valid[i] & (scores[i] > 0)
            scale = torch.tensor([w, h, w, h], dtype=torch.float32, device=boxes.device)
            results.append({
                "boxes": (boxes[i][sel] * scale).cpu().numpy(),
                "scores": scores[i][sel].cpu().numpy(),
                "labels": labels[i][sel].cpu().numpy(),
            })
        return results
