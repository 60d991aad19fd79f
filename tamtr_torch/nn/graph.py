"""Model-graph front end and the TAM-TR detector (torch port of
`tamtr_tpu/nn/graph.py`).

A config is the JSON form of the JAX package's YAML graph:
`[from, repeats, module, args]` rows for the backbone and head. The model
holds its layers in `self.model`, so state-dict keys are the reference
checkpoint's `model.{i}.…`, with the detection head last (`model.41`).
Unlike flax, torch needs input widths at construction, so `TAMTRModel`
threads the channel count of every layer through the graph.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from tamtr_torch.nn import layers as L
from tamtr_torch.nn.decoder import ManbaWorldDecoder

CFG_DIR = Path(__file__).resolve().parent.parent / "cfg" / "models"


def load_model_cfg(path: str | Path) -> Dict[str, Any]:
    """Read a model config; a bare name such as "tamtr.yaml" resolves to the
    bundled JSON of the same stem."""
    p = Path(path)
    if not p.exists():
        cand = CFG_DIR / f"{p.stem}.json"
        if not cand.exists():
            raise FileNotFoundError(f"model config not found: {path}")
        p = cand
    with open(p) as f:
        return json.load(f)


def parse_graph(cfg: Dict[str, Any], nc: Optional[int] = None):
    """Lower the graph to (layer_specs, head_spec, save_set, nc).

    Each layer spec is (idx, from, module, args) with hashable args.
    """
    nc = nc if nc is not None else int(cfg.get("nc", 80))
    gw = float(cfg.get("width_multiple", 1.0))
    entries = list(cfg["backbone"]) + list(cfg["head"])
    specs = []
    head_spec = None
    save = set()
    for i, (f, _, m, args) in enumerate(entries):  # repeats are 1 in every config
        args = [nc if a == "nc" else a for a in args]
        args = [tuple(a) if isinstance(a, list) else a for a in args]
        if m == "ManbaWorldDecoder":
            if i != len(entries) - 1:
                raise ValueError("the detection head must be the last layer")
            head_spec = (tuple(f), tuple(args))
            save.update(j if j >= 0 else i + j for j in f)
            continue
        for j in f if isinstance(f, list) else [f]:
            if j != -1:
                save.add(j if j >= 0 else i + j)
        if m == "Conv" and gw != 1.0:
            args = [math.ceil(args[0] * gw / 8) * 8] + args[1:]
        specs.append((i, tuple(f) if isinstance(f, list) else f, m, tuple(args)))
    if head_spec is None:
        raise ValueError("the graph must end with a ManbaWorldDecoder head")
    return tuple(specs), head_spec, tuple(sorted(save)), nc


def _build_layer(m: str, args, c_in: List[int], gc: int):
    """(module, output channels) for one graph row; c_in are its input widths."""
    c1 = c_in[0]
    if m == "Conv":
        c2, k, s = (list(args) + [1, 1])[:3]
        return L.ConvBN(c1, c2, k, s), c2
    if m == "RepNCSPELAN4":
        c2, c3, c4, n = args
        return L.RepNCSPELAN4(c1, c2, c3, c4, n), c2
    if m == "TIAGELAN":
        c2, c3, c4, n, nh = args
        return L.TIAGELAN(c1, c2, c3, c4, n, nh, gc=gc), c2
    if m == "SPPELAN":
        c2, c3 = args
        return L.SPPELAN(c1, c2, c3), c2
    if m == "CPAM":
        return L.CPAM(), c1
    if m == "Concat":
        return L.Concat(), sum(c_in)
    if m == "nn.Upsample":
        return L.Upsample(float(args[1])), c1
    raise ValueError(f"unknown module {m}")


class TAMTRModel(nn.Module):
    """TAM-TR detector, eval mode: CSP-ELAN backbone, BTA-PAN neck guided by
    text, ManbaWorldDecoder head.

    forward(img (B, H, W, 3) float in [0, 1], text (B or 1, K, hd)) -> dict
    with "pred" (B, nq, 4 + nc): normalized cxcywh boxes and sigmoid scores.
    """

    def __init__(self, cfg: Dict[str, Any], nc: Optional[int] = None):
        super().__init__()
        self.specs, (self.head_from, head_args), self.save, self.nc = parse_graph(cfg, nc)
        _, hd, nq, ndp, nh, ndl = head_args[:6]
        ch: List[int] = []
        layers = []
        for idx, f, m, args in self.specs:
            froms = f if isinstance(f, tuple) else (f,)
            c_in = [ch[j if j >= 0 else idx + j] if j != -1 else (ch[-1] if ch else 3) for j in froms]
            mod, c2 = _build_layer(m, args, c_in, gc=hd)
            layers.append(mod)
            ch.append(c2)
        layers.append(ManbaWorldDecoder(
            nc=self.nc, ch=tuple(ch[j] for j in self.head_from), hd=hd, nq=nq, ndp=ndp, nh=nh, ndl=ndl,
        ))
        self.model = nn.ModuleList(layers)

    @classmethod
    def from_cfg(cls, path: str | Path, nc: Optional[int] = None) -> "TAMTRModel":
        return cls(load_model_cfg(path), nc)

    def forward(self, img: torch.Tensor, text: torch.Tensor):
        if text.shape[0] != img.shape[0]:
            text = text.expand(img.shape[0], *text.shape[1:])
        x = img.permute(0, 3, 1, 2)  # convolutions run NCHW
        y: List[Optional[torch.Tensor]] = []
        for (idx, f, m, _), mod in zip(self.specs, self.model):
            if isinstance(f, tuple):
                inp = [x if j == -1 else y[j if j >= 0 else idx + j] for j in f]
            else:
                inp = x if f == -1 else y[f]
            x = mod(inp, text) if m == "TIAGELAN" else mod(inp)
            y.append(x if idx in self.save else None)
        return self.model[-1]([y[j] for j in self.head_from], text)
