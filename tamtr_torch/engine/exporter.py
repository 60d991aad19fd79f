"""Model export (a port of the JAX package's `tamtr_tpu/engine/exporter.py`).

Formats, each the counterpart of a JAX one:
- "torch" (JAX's "orbax", weights only): `model.pt`, the EMA state dict and
  the run's meta (nc, names, model_cfg, imgsz, max_gt) in the checkpoint
  layout of `engine/checkpoint.py`, so that `Engine.load`, `AutoBackend`
  and `serve` read it as they read a training checkpoint.
- "npz": `model.npz`, the JAX package's archive: "/"-joined flax paths of
  {params, batch_stats} (`weights.to_jax_variables`), so either package
  loads the other's.
- "torch_export" (JAX's "stablehlo"): `model.pt2`, `torch.export` of the
  eval forward's `pred` at fixed (batch, imgsz, imgsz, 3) and (batch,
  n_text, text width) inputs, saved with `torch.export.save`. Kernels B1
  and B2 are nodes of the program (the `tamtr::` ops of
  `tamtr_torch.kernels`), so the loaded program launches them on the card.
  The program is captured on the model's device and runs only on a device
  of that kind: its constants (the decoder's anchors and masks) are baked
  in with their device.
- "savedmodel", "tflite", "pb", "onnx": need tensorflow (and tf2onnx), which
  the port does not use; they raise RuntimeError naming the package, as
  the JAX package's do without tensorflow.

half=True (the JAX format matrix's half column): "torch" stores its float
leaves in bf16 (loaded, they are the fp32 weights rounded to bf16); "npz"
in float16, as JAX's (np.save has no bf16); "torch_export" stores bf16
weights and computes as JAX's half StableHLO program does: fp32 against
weights rounded to bf16 (flax promotes bf16 parameters against fp32
activations), with the two parameter-only expressions that program
evaluates in bf16 evaluated in bf16 here too: each BatchNorm's
rsqrt(var + eps) * scale and each contrastive head's exp(logit_scale)
(`_HalfPred`). int8=True is a tflite-only flag in JAX: it raises for every
format here.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

FORMATS = ("torch", "savedmodel", "tflite", "npz", "torch_export", "onnx", "pb")
# the JAX package's formats that the port writes under another name
JAX_COUNTERPART = {"orbax": "torch", "stablehlo": "torch_export"}
# the formats that need a package the port does not use
NEEDS = {"savedmodel": "tensorflow", "tflite": "tensorflow", "pb": "tensorflow", "onnx": "tensorflow and tf2onnx"}
META_FILE = "tamtr_meta.json"  # the meta a `.pt2` carries beside its program (`torch.export.save` extra file)


class _Pred(nn.Module):
    """The eval forward's `pred` (B, nq, 4 + nc), what JAX's exported
    `infer` returns."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, img: torch.Tensor, txt: torch.Tensor) -> torch.Tensor:
        return self.model(img, txt)["pred"]


class _HalfBatchNorm(nn.Module):
    """An eval BatchNorm as flax evaluates it on bf16 statistics and
    parameters against an fp32 input: (x - mean) * mul + bias in fp32, with
    mul = rsqrt(var + eps) * scale computed in bf16, each step rounded (the
    value XLA folds into JAX's half program). Holds mean, mul and bias in
    bf16."""

    def __init__(self, bn: nn.BatchNorm2d):
        super().__init__()
        half = lambda t: t.detach().to(torch.bfloat16)  # noqa: E731
        eps = torch.tensor(bn.eps, dtype=torch.bfloat16, device=bn.running_var.device)
        # rsqrt in fp32, then rounded, as XLA evaluates a bf16 rsqrt (torch's bf16 rsqrt on the CPU is
        # not always the nearest bf16); the sum and product of bf16 values rounded once, as in bf16
        inv = torch.rsqrt((half(bn.running_var) + eps).float()).to(torch.bfloat16)
        self.register_buffer("mean", half(bn.running_mean))
        self.register_buffer("mul", inv * half(bn.weight))
        self.register_buffer("bias", half(bn.bias))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean[:, None, None]) * self.mul[:, None, None] + self.bias[:, None, None]


class _HalfPred(nn.Module):
    """`_Pred` of a model whose weights are stored in bf16, computing as
    JAX's half program computes: every float tensor rounded to bf16 and
    cast up to fp32 where it is used (`torch.func.functional_call`), but
    each BatchNorm a `_HalfBatchNorm` and each contrastive `logit_scale`
    kept in bf16, so that its exp is taken in bf16 and then promoted
    against the fp32 similarities."""

    def __init__(self, model: nn.Module):
        super().__init__()
        twin = copy.deepcopy(model).eval()
        for mod in list(twin.modules()):
            for child_name, child in list(mod.named_children()):
                if isinstance(child, nn.BatchNorm2d):
                    setattr(mod, child_name, _HalfBatchNorm(child))
        twin.dtype = torch.float32  # computes in fp32 whatever its weights' dtype
        self.model = twin.to(torch.bfloat16)  # the float parameters and buffers

    def forward(self, img: torch.Tensor, txt: torch.Tensor) -> torch.Tensor:
        values = {k: v.float() if v.is_floating_point() and not k.endswith("logit_scale") else v
                  for k, v in [*self.model.named_parameters(), *self.model.named_buffers()]}
        return torch.func.functional_call(self.model, values, (img, txt))["pred"]


def program_of(model: nn.Module, half: bool = False) -> nn.Module:
    """The module `torch_export` captures: `model`'s eval forward returning
    `pred`, with bf16 weights and JAX's half computation when `half`."""
    return _HalfPred(model) if half else _Pred(model)


def _check_format(fmt: str, int8: bool) -> None:
    """JAX's checks, in its order: int8 outside tflite, then the formats
    this port writes under another name, the unavailable ones and unknown
    ones."""
    if int8 and fmt != "tflite":
        raise ValueError(f"int8 post-training quantization is a tflite-only flag (reference format matrix); got "
                         f"fmt={fmt!r}")
    if fmt in JAX_COUNTERPART:
        raise ValueError(f"{fmt!r} is a format of the JAX package; the port's counterpart is "
                         f"{JAX_COUNTERPART[fmt]!r}")
    if fmt in NEEDS:
        raise RuntimeError(f"{fmt} export requires {NEEDS[fmt]}, which tamtr_torch does not use")
    if fmt not in FORMATS:
        raise ValueError(f"unknown export format {fmt!r}; valid: {FORMATS}")


def export_model(
    model: nn.Module,
    imgsz: int,
    n_text: int,
    out_dir: str | Path,
    fmt: str = "torch",
    batch: int = 1,
    half: bool = False,
    int8: bool = False,
    meta: Optional[Dict[str, Any]] = None,
) -> Path:
    """Write `model` (its weights as they are: the caller passes the EMA) in
    `fmt` under `out_dir`; returns the artifact's path. `meta` (nc, names,
    model_cfg, imgsz, max_gt) goes with the "torch" and "torch_export"
    artifacts; the "npz" archive carries none, as JAX's. `imgsz`, `n_text`
    and `batch` fix the "torch_export" program's input shapes."""
    _check_format(fmt, int8)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    model = model.eval()
    if fmt == "torch":
        state = {k: v.to(torch.bfloat16) if half and v.is_floating_point() else v
                 for k, v in model.state_dict().items()}
        path = out_dir / "model.pt"
        torch.save({"trainer": {"ema": {k: v.detach().cpu() for k, v in state.items()}}, "meta": dict(meta or {})},
                   path)
        return path
    if fmt == "npz":
        from tamtr_torch.weights import to_jax_variables

        half_t = np.float16 if half else np.float32
        arrs: Dict[str, np.ndarray] = {}

        def flatten(tree: Dict, prefix: str) -> None:  # sorted keys: the order of JAX's tree_flatten
            for k in sorted(tree):
                if isinstance(tree[k], dict):
                    flatten(tree[k], f"{prefix}{k}/")
                else:
                    arrs[f"{prefix}{k}"] = tree[k].astype(half_t)

        flatten(to_jax_variables(model), "")
        path = out_dir / "model.npz"
        np.savez_compressed(path, **arrs)
        return path
    dev = next(model.parameters()).device
    img = torch.zeros(batch, imgsz, imgsz, 3, device=dev)
    txt = torch.zeros(batch, n_text, model.text_width, device=dev)
    with torch.no_grad():
        program = torch.export.export(program_of(model, half), (img, txt), strict=False)
    for node in program.graph.nodes:  # the Python source lines it was traced through: not part of the program
        node.meta.pop("stack_trace", None)
    info = {**(meta or {}), "imgsz": imgsz, "batch": batch, "n_text": n_text, "text_width": model.text_width,
            "half": half, "device": dev.type}
    path = out_dir / "model.pt2"
    torch.export.save(program, path, extra_files={META_FILE: json.dumps(info)})
    return path
