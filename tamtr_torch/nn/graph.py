"""Model-graph front end and the TAM-TR detector (torch port of
`tamtr_tpu/nn/graph.py`).

A config is the JSON form of the JAX package's YAML graph:
`[from, repeats, module, args]` rows for the backbone and head. The model
holds its layers in `self.model`, so state-dict keys are the reference
checkpoint's `model.{i}.…`, with the detection head last (`model.41` in
`tamtr.yaml`, `model.22` in `yolo-gelan.yaml`). Unlike flax, torch needs
input widths at construction, so `TAMTRModel` threads the channel count of
every layer through the graph (a tuple of widths after a CBLinear).

Heads: the DETR family, built as in the JAX package
(`tamtr_tpu/nn/graph.py:281-329`): `ManbaWorldDecoder` (TAM-TR) and, by its
switches, RTDETRDecoder, ManbaDecoder and the two Decoupling heads; the
locationManbaDecoder and the DualRTDETRDecoder; the YOLO `Detect`,
`Segment` and `Pose`, and `Classify` (`nn/yolo_head.py`).
"""

from __future__ import annotations

import copy
import json
import math
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from tamtr_torch.nn import layers as L
from tamtr_torch.nn.decoder import DualRTDETRDecoder, LocationManbaDecoder, ManbaWorldDecoder
from tamtr_torch.nn.yolo_head import Classify, Detect, Pose, Segment

CFG_DIR = Path(__file__).resolve().parent.parent / "cfg" / "models"
HEADS = ("ManbaWorldDecoder", "RTDETRDecoder", "ManbaDecoder", "DecouplingManbaWorldDecoder",
         "DecouplingDFLManbaWorldDecoder", "locationManbaDecoder", "DualRTDETRDecoder",
         "Detect", "Segment", "Pose", "Classify")
PORTED_HEADS = HEADS
YOLO_HEADS = ("Detect", "Segment", "Pose")  # the pixel heads: features in, no text, targets or generator
FEATURE_HEADS = YOLO_HEADS + ("Classify",)  # the heads that take the features alone
TEXT_WIDTH = 512  # the text table of a head that takes none (the JAX engine's width)
# ManbaWorldDecoder's switches (use_text, use_vss, variant) for each head
# built from it (`tamtr_tpu/nn/graph.py:296-310`); use_text None: the config's
# seventh head argument, True when absent
HEAD_SWITCHES = {
    "ManbaWorldDecoder": (None, True, "base"), "RTDETRDecoder": (False, False, "base"),
    "ManbaDecoder": (False, True, "base"), "DecouplingManbaWorldDecoder": (None, True, "decouple"),
    "DecouplingDFLManbaWorldDecoder": (None, True, "dfl"),
}


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
    """Lower the graph to (layer_specs, head_spec, save_set, nc, head_type).

    Each layer spec is (idx, from, module, args) with hashable args.
    """
    nc = nc if nc is not None else int(cfg.get("nc", 80))
    gw = float(cfg.get("width_multiple", 1.0))
    entries = list(cfg["backbone"]) + list(cfg["head"])
    specs = []
    head_spec = head_type = None
    save = set()
    for i, (f, _, m, args) in enumerate(entries):  # repeats are 1 in every config
        args = [nc if a == "nc" else a for a in args]
        args = [tuple(a) if isinstance(a, list) else a for a in args]
        if m in HEADS:
            if i != len(entries) - 1:
                raise ValueError("the detection head must be the last layer")
            head_spec, head_type = (tuple(f), tuple(args)), m
            save.update(j if j >= 0 else i + j for j in f)
            continue
        for j in f if isinstance(f, list) else [f]:
            if j != -1:
                save.add(j if j >= 0 else i + j)
        if m == "Conv" and gw != 1.0:
            args = [math.ceil(args[0] * gw / 8) * 8] + args[1:]
        specs.append((i, tuple(f) if isinstance(f, list) else f, m, tuple(args)))
    if head_spec is None:
        raise ValueError(f"the graph must end with a detection head, one of {HEADS}")
    return tuple(specs), head_spec, tuple(sorted(save)), nc, head_type


def head_type_of(path: str | Path) -> str:
    """The head name of a model config (its last row's module)."""
    return parse_graph(load_model_cfg(path))[4]


def _build_layer(m: str, args, c_in: List[int], gc: int, deploy: bool = False):
    """(module, output channels) for one graph row; c_in are its input widths;
    deploy=True builds the RepConvN blocks fused."""
    c1 = c_in[0]
    if m == "Conv":
        c2, k, s = (list(args) + [1, 1])[:3]
        return L.ConvBN(c1, c2, k, s), c2
    if m == "RepNCSPELAN4":
        c2, c3, c4, n = args
        return L.RepNCSPELAN4(c1, c2, c3, c4, n, deploy=deploy), c2
    if m == "TIAGELAN":
        c2, c3, c4, n, nh = args
        return L.TIAGELAN(c1, c2, c3, c4, n, nh, gc=gc, deploy=deploy), c2
    if m == "SPPELAN":
        c2, c3 = args
        return L.SPPELAN(c1, c2, c3), c2
    if m == "CPAM":
        return L.CPAM(), c1
    if m == "AIFI":
        cm, nh = (list(args) + [2048, 8])[:2]
        return L.AIFI(c1, cm, nh), c1
    if m == "ADown":
        return L.ADown(c1, args[0]), args[0]
    if m == "Concat":
        return L.Concat(), sum(c_in)
    if m == "nn.Upsample":
        return L.Upsample(float(args[1])), c1
    if m == "Silence":
        return L.Silence(), c1
    if m == "CBLinear":
        k, s = (list(args[1:]) + [1, 1])[:2]
        return L.CBLinear(c1, args[0], k, s), tuple(args[0])
    if m == "CBFuse":
        return L.CBFuse(args[0]), c_in[-1]
    raise ValueError(f"unknown module {m}")


class TAMTRModel(nn.Module):
    """TAM-TR detector: CSP-ELAN backbone, BTA-PAN neck guided by text,
    ManbaWorldDecoder head; from another config the graph's layers and its
    head: RT-DETR (`rtdetr.yaml`: AIFI, RTDETRDecoder), any DETR variant
    head (`HEAD_SWITCHES`, locationManbaDecoder, DualRTDETRDecoder), or a
    YOLO Detect, Segment or Pose head (`yolo-gelan.yaml`,
    `yolo-seg-gelan.yaml`, `yolo-pose-gelan.yaml`). `head_type` is the
    config's head name, as the JAX `TAMTRModel.head_type`.

    forward(img (B, H, W, 3) float in [0, 1], text (B or 1, K, hd),
    targets=None, generator=None): in `.eval()`, or without targets, a dict
    with "pred" (B, nq, 4 + nc): normalized cxcywh boxes and sigmoid scores.
    In `.train()` with targets {"cls" (B, M), "bboxes" (B, M, 4) cxcywh,
    "mask" (B, M)} padded to `max_gt`, the head's train dict (see
    `ManbaWorldDecoder`); DropPath and CDN noise draw from `generator`. A
    Dual head's eval "pred" is a list of two, one a half of its levels.
    A YOLO head (`YOLO_HEADS`) takes only the features (no text, targets or
    generator) and returns its dict (`nn/yolo_head.py`), whose eval "pred"
    (B, A, 4 + nc) holds xywh boxes in input pixels (and Segment's
    mask_coefs and NCHW protos, Pose's kpt_raw and, in eval, keypoints);
    a Classify head (`classify-gelan.yaml`) takes the last map alone and
    returns {"logits", "pred": softmax} in train and eval. For these
    `uses_text` is False and `text_width` the JAX engine's 512, a table the
    model ignores.

    `max_gt`, `num_denoising`, `vss_drop_path` and `deploy` are the JAX
    `TAMTRModel`'s settings (`tamtr_tpu/nn/graph.py:160-171`), with its
    defaults; the CDN noise settings are the head's (`label_noise_ratio`,
    `box_noise_scale`). deploy=True builds every RepConvN fused (the layout
    of JAX's `fuse_repconv_variables`).

    `dtype` is the compute dtype, the JAX `TAMTRModel.dtype`
    (`tamtr_tpu/nn/graph.py:188, 221-222`): forward casts the image and the
    text table to it and the layers follow their inputs, with the fp32
    islands of `nn/layers.py`, `nn/ssm.py` and `nn/decoder.py`. The
    parameters and buffers stay fp32 at any dtype, as flax's `param_dtype`;
    the outputs are fp32. dtype=None (the default) computes in the
    parameters' own dtype, so a model cast with `.double()` computes in fp64.
    """

    def __init__(self, cfg: Dict[str, Any], nc: Optional[int] = None, max_gt: int = 128,
                 num_denoising: int = 100, vss_drop_path: float = 0.1,
                 label_noise_ratio: float = 0.5, box_noise_scale: float = 1.0, deploy: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.specs, (self.head_from, self.head_args), self.save, self.nc, self.head_type = parse_graph(cfg, nc)
        head_type = self.head_type
        ch: List[Any] = []
        layers = []
        for idx, f, m, args in self.specs:
            froms = f if isinstance(f, tuple) else (f,)
            c_in = [ch[j if j >= 0 else idx + j] if j != -1 else (ch[-1] if ch else 3) for j in froms]
            mod, c2 = _build_layer(m, args, c_in, gc=self.text_width, deploy=deploy)
            layers.append(mod)
            ch.append(c2)
        head_ch = tuple(ch[j] for j in self.head_from)
        if head_type == "Detect":
            layers.append(Detect(nc=self.nc, ch=head_ch))
        elif head_type == "Segment":
            layers.append(Segment(nc=self.nc, ch=head_ch))
        elif head_type == "Classify":
            layers.append(Classify(nc=self.nc, ch=head_ch))
        elif head_type == "Pose":  # kpt_shape: the row's second argument (`tamtr_tpu/nn/graph.py:262`)
            kpt = tuple(self.head_args[1]) if len(self.head_args) > 1 else (17, 3)
            layers.append(Pose(nc=self.nc, ch=head_ch, kpt_shape=kpt))
        else:
            _, hd, nq, ndp, nh, ndl = self.head_args[:6]
            kw = dict(nc=self.nc, hd=hd, nq=nq, ndp=ndp, nh=nh, ndl=ndl, num_denoising=num_denoising,
                      max_gt=max_gt, box_noise_scale=box_noise_scale)
            if head_type == "locationManbaDecoder":
                head = LocationManbaDecoder(ch=head_ch, vss_drop_path=vss_drop_path, **kw)
            elif head_type == "DualRTDETRDecoder":  # one core shared by the two halves of the levels
                head = DualRTDETRDecoder(ch=head_ch[:len(head_ch) // 2], label_noise_ratio=label_noise_ratio, **kw)
            else:
                _, use_vss, variant = HEAD_SWITCHES[head_type]
                head = ManbaWorldDecoder(ch=head_ch, label_noise_ratio=label_noise_ratio, vss_drop_path=vss_drop_path,
                                         use_text=self.uses_text, use_vss=use_vss, variant=variant, **kw)
            layers.append(head)
        self.model = nn.ModuleList(layers)

    @property
    def uses_text(self) -> bool:
        """True when the head scores against the text table (contrastive
        scores), as the JAX `TAMTRModel.uses_text` decides: ManbaWorldDecoder
        and the two Decoupling heads, unless their seventh head argument is
        false. Never RTDETRDecoder, ManbaDecoder, Dual, Location or a YOLO head."""
        switches = HEAD_SWITCHES.get(self.head_type)
        return switches is not None and switches[0] is None and (
            len(self.head_args) <= 6 or bool(self.head_args[6]))

    @property
    def text_width(self) -> int:
        """The width of the text table the model takes: the head's hidden
        width where it uses text; else the JAX engine's 512, which the
        locationManbaDecoder's 2-D text scores project to (its embed_dim)
        and any other head ignores."""
        return self.head_args[1] if self.uses_text else TEXT_WIDTH

    @classmethod
    def from_cfg(cls, path: str | Path, nc: Optional[int] = None, **kw) -> "TAMTRModel":
        return cls(load_model_cfg(path), nc, **kw)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: the one set, else the parameters'."""
        return self._dtype or next(self.parameters()).dtype

    @dtype.setter
    def dtype(self, dtype: Optional[torch.dtype]) -> None:
        self._dtype = dtype

    def with_dtype(self, dtype: torch.dtype) -> "TAMTRModel":
        """A twin computing at `dtype` that shares this model's modules,
        parameters and buffers (the JAX `model.clone(dtype=...)` over the
        same variables); `self` itself keeps its dtype."""
        twin = copy.copy(self)
        twin.dtype = dtype
        return twin

    def forward(self, img: torch.Tensor, text: torch.Tensor,
                targets: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        if text.shape[0] != img.shape[0]:
            text = text.expand(img.shape[0], *text.shape[1:])
        x, text = img.permute(0, 3, 1, 2).to(self.dtype), text.to(self.dtype)  # convolutions run NCHW
        y: List[Optional[torch.Tensor]] = []
        for (idx, f, m, _), mod in zip(self.specs, self.model):
            if isinstance(f, tuple):
                inp = [x if j == -1 else y[j if j >= 0 else idx + j] for j in f]
            else:
                inp = x if f == -1 else y[f]
            x = mod(inp, text) if m == "TIAGELAN" else mod(inp)
            y.append(x if idx in self.save else None)
        feats = [y[j] for j in self.head_from]
        if self.head_type in FEATURE_HEADS:
            return self.model[-1](feats)
        return self.model[-1](feats, text, targets, generator)
