"""One inference wrapper over the port's model sources (a port of the JAX
package's `tamtr_tpu/nn/autobackend.py`).

Backends:
- "torch": a checkpoint written by `Engine.train` (`weights/best.pt` or
  `last.pt`: the EMA model, with the run's nc, names, model config and
  imgsz) or by the exporter's "torch" format (`model.pt`, the same layout;
  bf16 leaves of a half export load as the fp32 weights they round), a
  model config (`.yaml`/`.json`, weights from `seed`), a `TAMTRModel`
  itself, or an `.npz` archive of either package's exporter (flax paths of
  {params, batch_stats}, float16 leaves cast up; it carries no meta, so
  `nc` must be given, and `model_cfg` names the config).
- "torch_export": a `.pt2` program of the exporter's "torch_export" format,
  run as it was captured: no model class needed, the kernels B1 and B2
  launched through the `tamtr::` ops (registered by importing
  `tamtr_torch.kernels`). A program captured on the card runs only on the
  card, one captured on the CPU only on the CPU: it is refused on the other
  kind of device, never moved.
- "remote": an `http://host:port/<endpoint>` URL, served by
  `tamtr_torch.serve.ModelServer` (`serve.RemoteModel`).

Everything but "remote" runs on the card unless `device="cpu"` is given.
`__call__(img, txt_feats) -> pred` takes and returns numpy arrays, as the
JAX package's does. The artifacts of formats the port does not write
(StableHLO, SavedModel, TFLite, frozen GraphDef, ONNX, an orbax directory)
raise RuntimeError naming what would load them; so does a reference
(ultralytics) checkpoint, naming `Engine.load` and
`tools/port_torch_weights_torch.py`, which converts it to the "torch"
layout.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

from tamtr_torch.nn.graph import TAMTRModel

# artifacts the port does not load, and what would
FOREIGN = {".stablehlo": "jax (the JAX package's AutoBackend runs StableHLO)", ".tflite": "tensorflow",
           ".pb": "tensorflow", ".onnx": "onnxruntime", ".engine": "tensorrt",
           ".torchscript": "torch.jit (the port's programs are torch.export's .pt2)"}


def load_npz_variables(path: Union[str, Path]) -> Dict[str, Dict]:
    """An exporter's npz archive as nested flax variables ({params,
    batch_stats}, float32 numpy arrays; float16 leaves of a half export cast
    up), as the JAX package's AutoBackend reads it."""
    variables: Dict[str, Dict] = {}
    with np.load(path) as data:
        for key in data.files:
            node = variables
            *parents, leaf = key.split("/")
            for q in parents:
                node = node.setdefault(q, {})
            node[leaf] = data[key].astype(np.float32)
    return variables


class AutoBackend:
    """Args:
      weights: a checkpoint or exported `model.pt`, an `.npz` archive, a
        `.pt2` program, a model config, a `TAMTRModel`, or a URL.
      model_cfg: the config of an npz archive, or of a checkpoint without
        one in its meta.
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
        self.n_text = None  # a program's fixed class count (its text rows)
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
            if p.suffix in FOREIGN:
                raise RuntimeError(f"{p}: loading a {p.suffix} artifact needs {FOREIGN[p.suffix]}, which tamtr_torch "
                                   "does not use; export the model as torch, npz or torch_export")
            if p.is_dir():
                kind = "a TF SavedModel" if (p / "saved_model.pb").exists() else "an orbax checkpoint"
                need = "tensorflow" if kind == "a TF SavedModel" else "orbax and the JAX package"
                raise RuntimeError(f"{p}: {kind} directory needs {need}, which tamtr_torch does not use; "
                                   "export the model as torch, npz or torch_export")
            if p.suffix == ".pt2":
                self._load_program(p, device)
                return
            if p.suffix in (".yaml", ".yml", ".json"):
                from tamtr_torch.weights import init_parameters

                model = TAMTRModel.from_cfg(str(weights), nc=nc or 10)
                init_parameters(model, seed)
            elif p.suffix == ".npz":
                from tamtr_torch.weights import from_jax_variables

                if not nc:
                    raise ValueError(f"{p}: npz archives carry no metadata; pass nc=...")
                variables = load_npz_variables(p)
                model = TAMTRModel.from_cfg(model_cfg, nc=nc)
                sd, report = from_jax_variables(variables.get("params", {}), variables.get("batch_stats", {}), model)
                if report["missing"] or report["shape_mismatch"]:
                    raise ValueError(f"{p} does not hold {model_cfg} at nc={nc}: missing {report['missing'][:3]}, "
                                     f"shape mismatches {report['shape_mismatch'][:3]}")
                model.load_state_dict(sd)
            else:
                from tamtr_torch.engine.checkpoint import load_checkpoint_raw
                from tamtr_torch.weight_files import is_reference_checkpoint

                if is_reference_checkpoint(p):
                    raise RuntimeError(f"{p}: a reference (ultralytics) checkpoint; load it with Engine.load / "
                                       "TAMTR.load, or convert it for AutoBackend with "
                                       "`python tools/port_torch_weights_torch.py <ref>.pt <out>.pt`")
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

    def _load_program(self, path: Path, device) -> None:
        """A `.pt2` of the exporter: the program, and its meta (nc, names,
        imgsz, n_text, text width); refused where it was captured on another
        kind of device."""
        import json

        import tamtr_torch.kernels  # noqa: F401  (registers the tamtr:: ops the program calls)
        from tamtr_torch.engine.exporter import META_FILE

        extra = {META_FILE: ""}
        program = torch.export.load(str(path), extra_files=extra)
        meta = json.loads(extra[META_FILE] or "{}")
        # the device its weights were captured on (a program may also hold 0-d CPU constants)
        kinds = {t.device.type for t in program.state_dict.values()}
        if kinds != {self.device.type}:
            raise RuntimeError(f"{path} was exported on {'/'.join(sorted(kinds))} and runs there only, not on "
                               f"{self.device.type}: export it on the device that will run it")
        self.backend = "torch_export"
        self.model = program.module()
        self.nc, self.names, self.text_width = meta.get("nc"), meta.get("names"), meta.get("text_width")
        self.imgsz, self.n_text = meta.get("imgsz", self.imgsz), meta.get("n_text")

    @torch.inference_mode()
    def __call__(self, img: np.ndarray, txt_feats: np.ndarray) -> np.ndarray:
        """img (B, H, W, 3) float32 in [0, 1]; txt_feats (B|1, K, hd) ->
        pred (B, nq, 4 + K) float32."""
        if self.backend == "remote":
            return self._remote(img, txt_feats)[0]
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(self.device)
        t = torch.from_numpy(np.ascontiguousarray(txt_feats, np.float32)).to(self.device)
        if self.backend == "torch_export":  # the program returns pred
            return self.model(x, t).cpu().numpy()
        return self.model(x, t)["pred"].cpu().numpy()

    def warmup(self, batch: int = 1, n_text: Optional[int] = None) -> None:
        """One forward of zeros at imgsz: builds the kernels and picks the
        convolution algorithms before the first request."""
        width = self.text_width or 512
        self(np.zeros((batch, self.imgsz, self.imgsz, 3), np.float32),
             np.zeros((batch, n_text or self.n_text or self.nc or 10, width), np.float32))
