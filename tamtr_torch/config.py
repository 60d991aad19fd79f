"""Run configuration with the JAX package's keys and defaults
(`tamtr_tpu/config.py`, the reference's `cfg/default.yaml`), without yaml.

`get_cfg` merges default <- cfg (dict, `Config` or file) <- overrides and
rejects unknown keys. `load_data_yaml` reads a dataset file with the
reference's schema checks. Files are JSON, or the YAML subset dataset and
config files use: flat `key: value` scalars, flow lists `[a, b]`, and one
level of block mapping (`names:` then `  0: name`) or block list (`- name`).
JSON is valid YAML, so one `data.json` serves both packages. Keys that only
the JAX package acts on (the mesh, sp, ZeRO, remat, bf16, export) are kept
so that one config file serves both.
"""

from __future__ import annotations

import dataclasses
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Union


@dataclass
class Config:
    # task / mode
    task: str = "detect"
    mode: str = "train"
    # train
    model: Optional[str] = None
    data: Optional[str] = None
    epochs: int = 300
    patience: int = 0  # 0 => early stopping disabled (TAM-TR default)
    # reference recipe batch (trainTAMTR.py). Throughput note: on a 16 GB
    # v5e chip the measured per-image optimum is batch=2 (6.55 vs 5.74
    # img/s at 4) — gradient accumulation (nbs) keeps the effective-batch
    # cadence identical, so prefer batch=2 per chip when HBM-bound.
    batch: int = 6
    imgsz: int = 640
    save: bool = True
    save_period: int = -1
    cache: Union[bool, str] = False  # False | True/"ram" | "disk" decoded-image cache
    tracker: str = "bytetrack"  # track mode: bytetrack | botsort
    stream_buffer: bool = False  # buffer all stream frames vs newest-only
    device: Optional[str] = None
    workers: int = 8
    project: Optional[str] = None
    name: Optional[str] = None
    exist_ok: bool = False
    pretrained: bool = True
    optimizer: str = "AdamW"
    verbose: bool = True
    seed: int = 0
    deterministic: bool = True
    single_cls: bool = False
    rect: bool = False
    cos_lr: bool = False
    close_mosaic: int = 0
    resume: bool = False
    amp: bool = False  # TAM-TR trains fp32 (NaN in matching under fp16)
    fraction: float = 1.0
    profile: bool = False
    freeze: Optional[List[int]] = None
    # segmentation/classification placeholders (API parity)
    overlap_mask: bool = True
    mask_ratio: int = 4
    dropout: float = 0.0
    # val / test
    val: bool = True
    split: str = "val"
    save_json: bool = False
    save_hybrid: bool = False
    conf: Optional[float] = None
    iou: float = 0.7
    max_det: int = 300
    half: bool = False
    dnn: bool = False
    plots: bool = True
    # predict
    source: Optional[str] = None
    show: bool = False
    save_txt: bool = False
    save_conf: bool = False
    save_crop: bool = False
    show_labels: bool = True
    show_conf: bool = True
    vid_stride: int = 1
    line_width: Optional[int] = None
    visualize: bool = False
    augment: bool = False
    # deploy-time RepConvN fusion for inference (reference `fuse()` /
    # `switch_to_deploy`); params transformed via tamtr_tpu.nn.fuse
    fuse: bool = False
    # rematerialize graph layers in the train backward (activation memory
    # O(layer inputs) instead of ~14GB at 640px b4; ~30% recompute)
    remat: bool = True
    # size-aware selective remat: skip remat on layers whose per-item input
    # activation (H*W*C) is below this. 0 (remat every heavy layer) measured
    # fastest at 640px b4 — the backward is HBM-bound; see nn/graph.py.
    remat_min_elems: int = 0
    agnostic_nms: bool = False
    classes: Optional[List[int]] = None
    retina_masks: bool = False
    boxes: bool = True
    # export
    format: str = "savedmodel"
    keras: bool = False
    optimize: bool = False
    int8: bool = False
    dynamic: bool = False
    simplify: bool = False
    opset: Optional[int] = None
    workspace: int = 4
    nms: bool = False
    # hyperparameters (train recipe)
    lr0: float = 1e-4
    lrf: float = 1.0
    momentum: float = 0.937
    weight_decay: float = 1e-4
    warmup_epochs: float = 2000.0  # iterations (reference reads it as such)
    warmup_momentum: float = 0.8
    warmup_bias_lr: float = 0.1
    box: float = 7.5
    cls: float = 0.5
    dfl: float = 1.5
    pose: float = 12.0
    kobj: float = 1.0
    label_smoothing: float = 0.0
    nbs: int = 64
    hsv_h: float = 0.015
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    degrees: float = 0.0
    translate: float = 0.1
    scale: float = 0.9
    shear: float = 0.0
    perspective: float = 0.0
    flipud: float = 0.0
    fliplr: float = 0.5
    mosaic: float = 0.0
    mixup: float = 0.0
    copy_paste: float = 0.3
    # TPU-native extensions
    # static ground-truth padding. VisDrone images carry up to ~500 objects;
    # 300 keeps truncation negligible (99.9th pct) while bounding the CDN
    # group size (reference uses the dynamic per-batch max, ops.py:196-198)
    max_gt: int = 300
    scan_chunk: int = 128
    match_method: str = "auto"
    text_embeddings: Optional[str] = None  # npz with per-class CLIP embeddings
    n_devices: Optional[int] = None
    # ZeRO-1: fsdp>1 shards the flat master-params/Adam/EMA vectors over the
    # SAME 'data' axis the batch shards over (sharding degree = device
    # count; the exact value beyond "on" is ignored). Per-chip optimizer
    # state drops by the device count at NO data-parallel throughput cost —
    # the step all-gathers params once and reduce-scatters the flat
    # gradient. 1 = pure DP (replicated state, the reference's only mode).
    fsdp: int = 1
    # sequence parallelism: sp>1 builds a 2-D ('data', 'sp') mesh — the
    # batch shards over 'data', every SS2D token axis shards over 'sp'
    # (two-phase blocked scan, parallel/seq_scan.py), and ZeRO flat vectors
    # shard over both axes. For imagery large enough that one chip cannot
    # hold a level-0 sequence (capability extension; reference is DP-only).
    sp: int = 1
    bf16: bool = False
    val_interval: int = 1  # validate every N epochs (1 = reference behavior)
    # save `last` every N epochs (1 = reference behavior). Each save fetches
    # the full train state (params+EMA+optimizer, ~0.8 GB for TAM-TR) from
    # device to host — on tunneled runtimes that dwarfs the step time, so
    # short runs should raise this. best/final/preemption saves always happen.
    save_interval: int = 1

    def asdict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


_FIELDS = {f.name: f for f in dataclasses.fields(Config)}


# PyYAML's (YAML 1.1) implicit scalar types, so that a file reads as
# `yaml.safe_load` reads it
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")})
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")


def _scalar(text: str) -> Any:
    """A YAML scalar or flow list of the subset."""
    s = text.strip()
    if s in ("", "~", "null", "Null", "NULL"):
        return None
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    if s.startswith("[") and s.endswith("]"):
        inner = s[1:-1].strip()
        return [_scalar(x) for x in inner.split(",")] if inner else []
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s) and s not in (".", "+.", "-."):
        return float(s.replace("_", ""))
    return s


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_config_text(text: str, name: str = "<config>") -> Dict[str, Any]:
    """A mapping from JSON text or from the YAML subset (module docstring)."""
    if text.lstrip().startswith("{"):
        return json.loads(text)
    out: Dict[str, Any] = {}
    block_key = None
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() == "---":
            continue
        if line[0] in " \t" or line.startswith("- "):
            if block_key is None:
                raise SyntaxError(f"{name}: nested line outside a block: {raw!r}")
            item = line.strip()
            if item.startswith("- ") or item == "-":
                if out[block_key] is None:
                    out[block_key] = []
                if not isinstance(out[block_key], list):
                    raise SyntaxError(f"{name}: list item in the mapping {block_key!r}")
                out[block_key].append(_scalar(item[1:]))
            else:
                k, sep, v = item.partition(":")
                if not sep:
                    raise SyntaxError(f"{name}: expected 'key: value', got {raw!r}")
                if out[block_key] is None:
                    out[block_key] = {}
                if not isinstance(out[block_key], dict):
                    raise SyntaxError(f"{name}: mapping entry in the list {block_key!r}")
                out[block_key][_scalar(k)] = _scalar(v)
            continue
        k, sep, v = line.partition(":")
        if not sep:
            raise SyntaxError(f"{name}: expected 'key: value', got {raw!r}")
        key = k.strip()
        out[key] = _scalar(v)
        block_key = key if not v.strip() else None
    return out


def _load_mapping(path: str | Path) -> Dict[str, Any]:
    return parse_config_text(Path(path).read_text(), str(path)) or {}


def get_cfg(
    cfg: Union[str, Path, Dict[str, Any], Config, None] = None,
    overrides: Optional[Dict[str, Any]] = None,
) -> Config:
    """default <- cfg file/dict <- overrides, with unknown-key detection;
    `cfg=<file>` among the overrides loads that file's keys under them."""
    base = dataclasses.asdict(Config()) if not isinstance(cfg, Config) else dataclasses.asdict(cfg)
    if isinstance(cfg, (str, Path)):
        base.update(_load_mapping(cfg))
    elif isinstance(cfg, dict):
        base.update(cfg)
    overrides = dict(overrides or {})
    custom = overrides.pop("cfg", None)
    if custom:
        loaded = _load_mapping(custom)
        overrides = {**{k: v for k, v in loaded.items() if k != "cfg"}, **overrides}
    for k, v in overrides.items():
        if k not in _FIELDS:
            close = [n for n in _FIELDS if k.lower() in n.lower() or n.lower() in k.lower()]
            hint = f" (did you mean {close[0]!r}?)" if close else ""
            raise KeyError(f"unknown config key {k!r}{hint}")
        base[k] = v
    known = {k: v for k, v in base.items() if k in _FIELDS}
    return Config(**known)


def load_data_yaml(path: str | Path, check: bool = True) -> Dict[str, Any]:
    """Dataset file: path/train/val/test/nc/names, with the reference's
    schema checks: train and val required ('validation' renamed), names or
    nc required and of one length, class_<i> names made up from nc, and an
    error when the resolved val path is missing."""
    d = parse_config_text(Path(path).read_text(), str(path))
    if not isinstance(d, dict):
        raise SyntaxError(f"{path}: dataset yaml must be a mapping")
    if "val" not in d and "validation" in d:
        d["val"] = d.pop("validation")
    if check:
        for k in ("train", "val"):
            if k not in d:
                raise SyntaxError(
                    f"{path} '{k}:' key missing — 'train' and 'val' are "
                    f"required in all data YAMLs"
                )
        if "names" not in d and "nc" not in d:
            raise SyntaxError(f"{path} key missing — either 'names' or 'nc' is required")
        if "names" in d and "nc" in d and len(d["names"]) != int(d["nc"]):
            raise SyntaxError(
                f"{path} 'names' length {len(d['names'])} and "
                f"'nc: {d['nc']}' must match"
            )
    root = Path(d.get("path", Path(path).parent))
    out = dict(d)
    for split in ("train", "val", "test"):
        if d.get(split):
            p = Path(d[split])
            out[split] = str(p if p.is_absolute() else root / p)
    names = d.get("names")
    if names is None:
        names = [f"class_{i}" for i in range(int(d["nc"]))]
    if isinstance(names, dict):
        names = [names[k] for k in sorted(names, key=int)]
    out["names"] = list(names)
    out["nc"] = int(d.get("nc", len(out["names"])))
    if check and out.get("val") and not Path(out["val"]).exists():
        raise FileNotFoundError(
            f"dataset '{path}' images not found: missing path '{out['val']}' "
            f"(no autodownload; see tools/get_visdrone.py)"
        )
    return out
