"""Write a checkpoint as ultralytics 8.0.201 writes the reference's
(`engine/trainer.py:save_model`, `utils/torch_utils.py:strip_optimizer`),
from a port model's weights, with torch and the port alone: the fixture of
`tamtr_torch/weight_files.py:read_reference_checkpoint`.

Usage (from the repo's root, with `tools` on the path):
  from make_reference_ckpt_torch import write_reference_checkpoint
  write_reference_checkpoint("last.pt", model, names, cfg_path="tamtr.yaml", layout="train")

The port model's module tree is copied into one whose classes pickle under
the reference's paths: the root `ultralytics.nn.tasks.RTDETRDetectionWorldModel`
with `model` a `torch.nn.Sequential`; the layers under
`ultralytics.nn.modules.conv`, `ultralytics.nn.extra_modules.block`,
`ultralytics.nn.extra_modules.VManba.vmamba`, `ultralytics.nn.modules.head`,
`ultralytics.nn.modules.transformer` and `ultralytics.nn.modules.block`;
DropPath under `timm.models.layers.drop`; torch's own Conv2d, BatchNorm2d
(with `num_batches_tracked`), Linear, LayerNorm, Embedding, Upsample, the
containers and `nn.MultiheadAttention` for the decoder's self-attention. Each SS2D
carries `forward_core`, a `functools.partial` of its bound `forward_corev2`
naming the `csms6s` classes and a module-level function, as VMamba's
`FORWARD_TYPES` do; the root carries `yaml`, `names`, `nc`, `args`, `stride`
and the `txt_feats` placeholder. The weights go in half, the parameters
without gradients, as the trainer's EMA holds them.

Layouts: "train" (`save_model`): {"epoch", "best_fitness", "model": None,
"ema": the half module, "updates", "optimizer": a state dict, "train_args"
(a `PosixPath` among them), "date", "version"}; "stripped"
(`strip_optimizer`): "model" the half module, "ema", "optimizer",
"best_fitness" and "updates" None, "epoch" -1. The fake ultralytics and timm
modules sit in `sys.modules` only while the file is written.
"""

from __future__ import annotations

import contextlib
import functools
import pathlib
import sys
import types
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch
from torch import nn

CONV, BLOCK = "ultralytics.nn.modules.conv", "ultralytics.nn.extra_modules.block"
VMAMBA, CSMS6S = "ultralytics.nn.extra_modules.VManba.vmamba", "ultralytics.nn.extra_modules.VManba.csms6s"
HEAD, TRANSFORMER = "ultralytics.nn.modules.head", "ultralytics.nn.modules.transformer"
MODULE_BLOCK, TASKS, UTILS = "ultralytics.nn.modules.block", "ultralytics.nn.tasks", "ultralytics.utils"
DROP = "timm.models.layers.drop"

# the port's module classes -> the reference's (module, class); a port class
# not named here pickles under the extra-modules block file with its own name
REFERENCE_CLASSES = {
    "TAMTRModel": (TASKS, "RTDETRDetectionWorldModel"),
    "ConvBN": (CONV, "Conv"), "DWConvBN": (CONV, "DWConv"), "Concat": (CONV, "Concat"),
    "VSSBlock": (VMAMBA, "VSSBlock"), "SS2D": (VMAMBA, "SS2D"), "Mlp": (VMAMBA, "Mlp"),
    "ManbaWorldDecoder": (HEAD, "ManbaWorldDecoder"), "LocationManbaDecoder": (HEAD, "locationManbaDecoder"),
    "DualRTDETRDecoder": (HEAD, "DualRTDETRDecoder"),
    "DeformableDecoderLayer": (TRANSFORMER, "DeformableTransformerDecoderLayer"),
    "DecouplingDecoderLayer": (TRANSFORMER, "DecouplingDeformableTransformerDecoderLayer"),
    "MSDeformAttn": (TRANSFORMER, "MSDeformAttn"), "MLP": (TRANSFORMER, "MLP"), "AIFI": (TRANSFORMER, "AIFI"),
    "ContrastiveHead": (MODULE_BLOCK, "ContrastiveHeadMLP"), "ContrastiveHead2D": (MODULE_BLOCK, "ContrastiveHead"),
    "DropPath": (DROP, "DropPath"),
}
# torch's own leaf classes, which the port's subclass
TORCH_LEAVES = (nn.Conv2d, nn.BatchNorm2d, nn.Linear, nn.LayerNorm, nn.Embedding,
                nn.Sequential, nn.ModuleList, nn.ModuleDict)
PLAIN = (bool, int, float, str, type(None))


def _stand_in(*args, **kwargs):  # SS2D's bound method and the module-level function its partial names
    raise RuntimeError("a stand-in of a reference function; never called")


class _Fakes:
    """The fake ultralytics / timm modules and their classes, made on use."""

    def __init__(self):
        self.modules: Dict[str, types.ModuleType] = {}

    def module(self, name: str) -> types.ModuleType:
        if name not in self.modules:
            self.modules[name] = types.ModuleType(name)
            parent, _, leaf = name.rpartition(".")
            if parent:
                setattr(self.module(parent), leaf, self.modules[name])
        return self.modules[name]

    def cls(self, module: str, name: str, base: type = nn.Module, attrs: Optional[dict] = None) -> type:
        mod = self.module(module)
        if not hasattr(mod, name):
            setattr(mod, name, type(name, (base,), {"__module__": module, "__qualname__": name, **(attrs or {})}))
        return getattr(mod, name)

    def function(self, module: str, name: str):
        mod = self.module(module)
        if not hasattr(mod, name):
            fn = types.FunctionType(_stand_in.__code__, _stand_in.__globals__, name)
            fn.__module__, fn.__qualname__ = module, name
            setattr(mod, name, fn)
        return getattr(mod, name)


@contextlib.contextmanager
def _registered(fakes: _Fakes) -> Iterator[None]:
    saved = {name: sys.modules.get(name) for name in fakes.modules}
    sys.modules.update(fakes.modules)
    try:
        yield
    finally:
        for name, old in saved.items():
            if old is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = old


def _half(t: Optional[torch.Tensor], param: bool):
    if t is None:
        return None
    t = t.detach().cpu().clone()
    t = t.half() if t.is_floating_point() else t
    return nn.Parameter(t, requires_grad=False) if param else t


def _copy_tree(mod: nn.Module, fakes: _Fakes) -> nn.Module:
    """`mod` as the reference's module tree: the same parameter, buffer and
    child names, half weights, reference classes."""
    children = {k: (_copy_tree(c, fakes) if c is not None else None) for k, c in mod._modules.items()}
    params = {k: _half(v, True) for k, v in mod._parameters.items()}
    buffers = {k: _half(v, False) for k, v in mod._buffers.items()}
    kind = type(mod).__name__
    if kind == "MultiHeadSelfAttention":
        d = mod.in_proj_weight.shape[1]
        out = nn.MultiheadAttention(d, mod.h, dropout=0.0)
        out._parameters.update({k: params[k] for k in ("in_proj_weight", "in_proj_bias")})
        out.out_proj._parameters.update(children["out_proj"]._parameters)
        return out.eval()
    if kind == "Upsample":  # the config's nn.Upsample(None, scale, "nearest")
        return nn.Upsample(scale_factor=float(mod.scale), mode="nearest").eval()
    torch_base = next((b for b in TORCH_LEAVES if isinstance(mod, b)), None)
    if torch_base is not None:
        out = torch_base.__new__(torch_base)
        nn.Module.__init__(out)
        if isinstance(mod, nn.BatchNorm2d):
            buffers["num_batches_tracked"] = torch.tensor(14300, dtype=torch.long)  # 300 epochs of VisDrone at 6
    else:
        module, ref_name = REFERENCE_CLASSES.get(kind, (BLOCK, kind))
        extra = {"forward_corev2": _stand_in} if kind == "SS2D" else None
        cls = fakes.cls(module, ref_name, attrs=extra)
        out = cls.__new__(cls)
        nn.Module.__init__(out)
        if kind == "SS2D":  # VMamba's FORWARD_TYPES["v2"] (vmamba.py:404-426)
            out.__dict__["forward_core"] = functools.partial(
                out.forward_corev2, force_fp32=True, SelectiveScan=fakes.cls(CSMS6S, "SelectiveScanCore", object),
                CrossScan=fakes.cls(CSMS6S, "CrossScan", object),
                cross_selective_scan=fakes.function(VMAMBA, "cross_selective_scan"))
    out.__dict__.update({k: v for k, v in mod.__dict__.items() if not k.startswith("_") and k != "training" and (
        isinstance(v, PLAIN) or (isinstance(v, tuple) and all(isinstance(x, PLAIN) for x in v)))})
    out._parameters.update(params)
    out._buffers.update(buffers)
    out._non_persistent_buffers_set = set(mod._non_persistent_buffers_set)
    if kind == "TAMTRModel":
        children["model"] = nn.Sequential(*children["model"])
    out._modules.update(children)
    out.training = False
    return out


def reference_module(model: nn.Module, fakes: _Fakes, names: Sequence[str], cfg_path: str) -> nn.Module:
    """The reference's RTDETRDetectionWorldModel holding `model`'s weights
    in half, with the attributes the trainer sets on it."""
    from tamtr_torch.nn.graph import load_model_cfg

    root = _copy_tree(model, fakes)
    nc = model.nc
    args = fakes.cls(UTILS, "IterableSimpleNamespace", types.SimpleNamespace)(
        task="detect", mode="train", model=str(cfg_path), data="VisDrone.yaml", epochs=300, batch=6, imgsz=640,
        save_dir=pathlib.PosixPath("runs/detect/train"))
    root.__dict__.update(yaml={**load_model_cfg(cfg_path), "nc": nc, "yaml_file": str(cfg_path)},
                         names=dict(enumerate(names)), nc=nc, args=args, task="detect",
                         stride=torch.tensor([8.0, 16.0, 32.0]), save=sorted(model.save),
                         txt_feats=torch.zeros(1, nc, 512, dtype=torch.float16))
    return root


def write_reference_checkpoint(path, model: nn.Module, names: Optional[Sequence[str]] = None,
                               cfg_path: str = "tamtr.yaml", layout: str = "train",
                               model_slot: Optional[nn.Module] = None, extra: Optional[dict] = None) -> Path:
    """Write `model`'s weights as the reference's checkpoint at `path`
    (layout "train" or "stripped", module docstring). In the train layout
    `model_slot`, when given, fills the "model" entry (ultralytics before
    8.0.201 kept the trained module there beside the EMA); `extra` adds
    entries to the top-level dict."""
    if layout not in ("train", "stripped"):
        raise ValueError(f"layout {layout!r}: 'train' or 'stripped'")
    names = list(names) if names is not None else [f"class{i}" for i in range(model.nc)]
    fakes = _Fakes()
    root = reference_module(model, fakes, names, cfg_path)
    train_args = {"task": "detect", "mode": "train", "model": str(cfg_path), "epochs": 300, "batch": 6,
                  "imgsz": 640, "optimizer": "AdamW", "lr0": 1e-4, "save_dir": pathlib.PosixPath("runs/detect/train"),
                  "project": None, "name": "train"}
    if layout == "train":
        n = len(list(model.parameters()))
        optimizer = {"state": {i: {"step": torch.tensor(14300.0), "exp_avg": torch.zeros(2),
                                   "exp_avg_sq": torch.zeros(2)} for i in range(3)},
                     "param_groups": [{"lr": 1e-4, "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 1e-4,
                                       "params": list(range(n))}]}
        other = reference_module(model_slot, fakes, names, cfg_path) if model_slot is not None else None
        ckpt = {"epoch": 299, "best_fitness": np.float64(0.397), "model": other, "ema": root, "updates": 14300,
                "optimizer": optimizer, "train_args": train_args, "date": "2023-10-28T12:00:00", "version": "8.0.201"}
    else:
        ckpt = {"epoch": -1, "best_fitness": None, "model": root, "ema": None, "updates": None, "optimizer": None,
                "train_args": train_args, "date": "2023-10-28T12:00:00", "version": "8.0.201"}
    ckpt.update(extra or {})
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with _registered(fakes):
        torch.save(ckpt, path)
    return path

