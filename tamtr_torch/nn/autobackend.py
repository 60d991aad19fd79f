"""One inference wrapper over the port's model sources (a port of the JAX
package's `tamtr_tpu/nn/autobackend.py`).

Backends:
- "torch": a checkpoint written by `Engine.train` (`weights/best.pt` or
  `last.pt`: the EMA model, with the run's nc, names, model config and
  imgsz), a model config (`.yaml`/`.json`, weights from `seed`), or a
  `TAMTRModel` itself; on the card unless `device="cpu"` is given.
- "remote": an `http://host:port/<endpoint>` URL, served by
  `tamtr_torch.serve.ModelServer` (`serve.RemoteModel`).

`__call__(img, txt_feats) -> pred` takes and returns numpy arrays, as the
JAX package's does. The JAX package's export formats (SavedModel, TFLite,
StableHLO, frozen GraphDef, flat npz) raise NotImplementedError: they come
with the exporter (ROADMAP queue A, item 7).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from tamtr_torch.nn.graph import TAMTRModel

EXPORT_SUFFIXES = {".tflite", ".stablehlo", ".pb", ".npz", ".onnx", ".engine", ".torchscript"}


class AutoBackend:
    """Args:
      weights: a checkpoint path, a model config, a `TAMTRModel`, or a URL.
      model_cfg: the config of a checkpoint without one in its meta.
      nc: classes (a checkpoint's or the server's when not given; 10 for a
        config).
      imgsz: square input size of `warmup` (a checkpoint's when not
        given, else 640).
      device: "cuda" by default; "cpu" only when asked for.
      seed: weights of a model built from a config.
    """

    def __init__(self, weights: Union[str, Path, TAMTRModel], model_cfg: str = "tamtr.yaml",
                 nc: Optional[int] = None, imgsz: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = None, seed: int = 0) -> None:
        self.imgsz = imgsz or 640
        self.names = None
        if isinstance(weights, str) and "://" in weights:
            # a remote serving endpoint (the reference's triton row)
            from tamtr_torch.serve import RemoteModel

            self.backend = "remote"
            self._remote = RemoteModel(weights)
            self.nc = nc or self._remote.meta.get("nc")
            self.text_width = self._remote.meta.get("text_width")
            return
        if device is None and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        self.device = torch.device("cuda" if device is None else device)
        self.backend = "torch"
        if isinstance(weights, TAMTRModel):
            model = weights
        else:
            p = Path(weights)
            if p.suffix in EXPORT_SUFFIXES or (p.is_dir() and (p / "saved_model.pb").exists()):
                raise NotImplementedError(f"{p}: exported models need the exporter, which tamtr_torch does not "
                                          "have yet (ROADMAP queue A, item 7); give a checkpoint or a model config")
            if p.suffix in (".yaml", ".yml", ".json"):
                from tamtr_torch.weights import init_parameters

                model = TAMTRModel.from_cfg(str(weights), nc=nc or 10)
                init_parameters(model, seed)
            else:
                from tamtr_torch.engine.checkpoint import load_checkpoint_raw

                ema, meta = load_checkpoint_raw(p)
                nc = nc or meta.get("nc")
                if not nc:
                    raise ValueError(f"{p}: the checkpoint has no nc; pass nc=...")
                model = TAMTRModel.from_cfg(meta.get("model_cfg", model_cfg), nc=nc, max_gt=meta.get("max_gt", 128))
                model.load_state_dict(ema)
                self.names = meta.get("names")
                self.imgsz = imgsz or meta.get("imgsz", 640)
        self.model = model.to(self.device).eval()
        self.nc = self.model.nc
        self.text_width = self.model.text_width

    @torch.inference_mode()
    def __call__(self, img: np.ndarray, txt_feats: np.ndarray) -> np.ndarray:
        """img (B, H, W, 3) float32 in [0, 1]; txt_feats (B|1, K, hd) ->
        pred (B, nq, 4 + K) float32."""
        if self.backend == "remote":
            return self._remote(img, txt_feats)[0]
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(self.device)
        t = torch.from_numpy(np.ascontiguousarray(txt_feats, np.float32)).to(self.device)
        return self.model(x, t)["pred"].cpu().numpy()

    def warmup(self, batch: int = 1, n_text: Optional[int] = None) -> None:
        """One forward of zeros at imgsz: builds the kernels and picks the
        convolution algorithms before the first request."""
        width = self.text_width or 512
        self(np.zeros((batch, self.imgsz, self.imgsz, 3), np.float32),
             np.zeros((batch, n_text or self.nc or 10, width), np.float32))
