"""Weights for the port: its own seeded initialisation, and the bridge from
the JAX package's flax variables.

`from_jax_variables` keeps the port's copy of the key mapping in
`tools/port_torch_weights.py` (`map_torch_key`, `export_state_dict`): the
port's state-dict keys are the reference checkpoint's, so each key names one
flax leaf. Conv kernels go HWIO -> OIHW (depthwise (3, 3, 1, C) ->
(C, 1, 3, 3)), Linear kernels transpose, the q/k/v projections merge into
`in_proj_*`, and the SS2D `A_logs` (K, D, N) / `Ds` (K, D) flatten to
(K*D, N) / (K*D,). The Detect head's `cv2.{i}.{j}` / `cv3.{i}.{j}` are
flax's `head/cv2_{i}_{j}` / `head/cv3_{i}_{j}` (the locationManbaDecoder's
`cv3.{i}.{j}` too, and its `cv4.{i}` flax's `head/cv4_{i}`), and a
CBLinear's `conv` is flax's `conv` (not `Conv_0`). The Segment and Pose
heads nest their Detect in flax's `head/detect` scope: `cv2.{i}.{j}` and
`cv3.{i}.{j}` are `head/detect/cv2_{i}_{j}`, their own `cv4.{i}.{j}` are
`head/cv4_{i}_{j}` and `proto.*` `head/proto/*`; the Proto's transposed
conv kernel (kH, kW, in, out) becomes torch's (in, out, kH, kW) flipped in
both spatial axes. The Classify head's `conv` and `linear` are flax's
`head/ConvBN_0` and `head/Dense_0`. AIFI's `ma.in_proj_*`
merge the layer's own `q_proj`, `k_proj` and `v_proj`, as the decoder's
`self_attn`, `self_attn1` and `self_attn2` merge theirs; the Dual head's
one core is flax's `head`. `to_jax_variables` is the inverse: a port
model's state dict as the JAX package's flax variables (its npz export).

`from_jax_sam_variables` bridges the JAX package's SAM (three flax trees:
image encoder, prompt encoder, mask decoder, and TinyViT's BatchNorm
statistics) onto the port's `models/sam` modules, whose keys are the
reference checkpoint's (`sam_flax_route`); `init_sam_parameters` is the
port's seeded SAM init with flax's default initialisers.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tamtr_torch.nn.decoder import (
    ContrastiveHead, ContrastiveHead2D, MSDeformAttn, MultiHeadSelfAttention, sampling_offset_bias,
)
from tamtr_torch.nn.layers import MaxSigmoidAttnBlock
from tamtr_torch.nn.ssm import K_DIRS, SS2D
from tamtr_torch.nn.yolo_head import Classify, Detect

_BN_LEAF = {
    "weight": ("params", "scale"),
    "bias": ("params", "bias"),
    "running_mean": ("batch_stats", "mean"),
    "running_var": ("batch_stats", "var"),
}
# stacked SS2D params copied without transpose
_VERBATIM_LEAVES = {"x_proj_weight", "dt_projs_weight", "dt_projs_bias"}


def map_torch_key(key: str, shape: Tuple[int, ...], layer_names: Dict[int, str],
                  head_index: int, head_type: Optional[str] = None) -> Optional[Tuple[str, List[str], Optional[str]]]:
    """One reference state-dict key -> (collection, flax path, special), or
    None for keys with no flax twin. `special` names the structured cases:
    "qkv" (in_proj merge), "flatten" (A_logs/Ds) and "conv_transpose" (the
    Proto's upsample kernel). `head_type` "Segment" or "Pose" routes the
    head's Detect branches into flax's `detect` scope; "Classify" names its
    `conv` and `linear` flax's `ConvBN_0` and `Dense_0`."""
    nested = head_type in ("Segment", "Pose")
    parts = key.split(".")
    if parts[0] != "model" or not parts[1].isdigit() or parts[-1] == "num_batches_tracked":
        return None
    idx = int(parts[1])
    rest = parts[2:]
    prefix = "head" if idx == head_index else f"m{idx}_{layer_names[idx]}"
    out_path: List[str] = [prefix]
    i = 0
    while i < len(rest):
        tok = rest[i]
        nxt = rest[i + 1] if i + 1 < len(rest) else None
        if prefix == "head":
            if head_type == "Classify" and i == 0 and tok in ("conv", "linear"):  # flax's compact names
                out_path.append("ConvBN_0" if tok == "conv" else "Dense_0")
                i += 1
                continue
            if tok in ("cv2", "cv3") and nxt and nxt.isdigit():  # the Detect head's branches
                out_path += (["detect"] if nested else []) + [f"{tok}_{nxt}_{rest[i + 2]}"]
                i += 3
                continue
            if nested and tok == "cv4":  # Segment's mask coefficients, Pose's keypoints
                out_path.append(f"cv4_{nxt}_{rest[i + 2]}")
                i += 3
                continue
            if tok == "upsample" and nxt in ("weight", "bias"):  # Proto's transposed conv
                leaf = "kernel" if nxt == "weight" else "bias"
                return "params", out_path + ["upsample", leaf], "conv_transpose" if leaf == "kernel" else None
            if tok == "input_proj":
                j, sub = rest[i + 1], rest[i + 2]
                if sub == "0":  # conv
                    return "params", out_path + [f"input_proj{j}_conv", "kernel"], None
                col, leaf = _BN_LEAF[rest[i + 3]]
                return col, out_path + [f"input_proj{j}_bn", leaf], None
            if tok == "VSSBlocks":
                out_path.append(f"vss{rest[i + 1]}")
                i += 2
                continue
            if tok == "decoder" and nxt == "layers":
                out_path.append(f"layer{rest[i + 2]}")
                i += 3
                continue
            if tok in ("self_attn", "self_attn1", "self_attn2") and nxt in ("in_proj_weight", "in_proj_bias"):
                return "params", out_path + [tok], "qkv"
            if tok == "cv4" and nxt and nxt.isdigit():  # Location's 2-D text score heads
                out_path.append(f"cv4_{nxt}")
                i += 2
                continue
            if tok in ("dec_score_head", "dec_bbox_head") and nxt and nxt.isdigit():
                out_path.append(f"{tok}{nxt}")
                i += 2
                continue
            if tok == "enc_output" and nxt in ("0", "1"):
                out_path.append("enc_output_dense" if nxt == "0" else "enc_output_norm")
                i += 2
                continue
            if tok == "layers" and nxt and nxt.isdigit():  # MLP lists
                out_path.append(f"layers{nxt}")
                i += 2
                continue
            if tok == "denoising_class_embed":
                return "params", out_path + ["denoising_class_embed"], None
            if tok in ("A_logs", "Ds"):
                return "params", out_path + [tok], "flatten"
        if tok == "ma":  # AIFI's attention: flax's q/k/v_proj and out_proj sit on the layer itself
            if nxt in ("in_proj_weight", "in_proj_bias"):
                return "params", out_path, "qkv"
            i += 1
            continue
        if tok in ("cv2", "cv3") and nxt in ("0", "1") and prefix != "head":
            out_path.append(f"{tok}_csp" if nxt == "0" else f"{tok}_conv")
            i += 2
            continue
        if tok == "m" and nxt and nxt.isdigit():  # RepNCSP bottleneck list
            out_path.append(f"m{nxt}")
            i += 2
            continue
        if tok == "conv" and nxt == "weight":
            out_path += ["conv" if layer_names.get(idx) == "CBLinear" else "Conv_0", "kernel"]
            i += 2
            continue
        if tok == "bn" and nxt in _BN_LEAF:
            col, leaf = _BN_LEAF[nxt]
            return col, out_path + ["BatchNorm_0", leaf], None
        if tok == "weight" and i == len(rest) - 1:
            # LayerNorm scale (1-D) or Linear/conv kernel
            out_path.append("scale" if len(shape) == 1 else "kernel")
            i += 1
            continue
        out_path.append(tok)
        i += 1
    return "params", out_path, None


def _flatten_tree(tree: Dict, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten_tree(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def from_jax_variables(params: Dict, batch_stats: Dict, model: nn.Module):
    """Flax variables of the JAX `TAMTRModel` (nested dicts of arrays) ->
    (state_dict for the port's `model`, report).

    The report lists port keys left unfilled, shape mismatches, and flax
    leaves never used; all three are empty for a complete bridge.
    """
    layer_names = {idx: m.replace(".", "_") for idx, _, m, _ in model.specs}
    head_index = model.specs[-1][0] + 1
    head_type = getattr(model, "head_type", None)
    trees = {
        "params": _flatten_tree(params),
        "batch_stats": _flatten_tree(batch_stats),
    }
    used = set()

    def get(col: str, path: List[str]) -> Optional[np.ndarray]:
        leaf = trees[col].get(tuple(path))
        if leaf is None:
            return None
        used.add((col, tuple(path)))
        return np.asarray(leaf, np.float32)

    sd: Dict[str, torch.Tensor] = {}
    missing: List[str] = []
    mismatched: List[str] = []
    for key, tmpl in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.zeros_like(tmpl)  # torch-side counter, no flax twin
            continue
        route = map_torch_key(key, tuple(tmpl.shape), layer_names, head_index, head_type)
        if route is None:
            missing.append(key)
            continue
        col, path, special = route
        leaf = path[-1]
        if special == "qkv":
            kind = "kernel" if key.endswith("weight") else "bias"
            pieces = [get("params", path + [name, kind]) for name in ("q_proj", "k_proj", "v_proj")]
            val = None if any(p is None for p in pieces) else np.concatenate(
                [p.T if p.ndim == 2 else p for p in pieces], 0
            )
        elif special == "conv_transpose":  # (kH, kW, in, out) -> (in, out, kH, kW), flipped
            val = get("params", path)
            val = None if val is None else np.ascontiguousarray(np.transpose(val, (2, 3, 0, 1))[:, :, ::-1, ::-1])
        elif special == "flatten":
            val = get("params", path)
            val = None if val is None else val.reshape((-1,) + val.shape[2:])
        else:
            val = get(col, path)
            is_verbatim = leaf in _VERBATIM_LEAVES or path[-2:] == ["attn", "bias"] \
                or leaf == "denoising_class_embed"
            if val is not None and not is_verbatim:
                if val.ndim == 4:  # HWIO -> OIHW
                    val = np.transpose(val, (3, 2, 0, 1))
                elif val.ndim == 2 and leaf == "kernel":
                    val = val.T
        if val is None:
            missing.append(key)
        elif tuple(val.shape) != tuple(tmpl.shape):
            mismatched.append(f"{key}: port{tuple(tmpl.shape)} vs jax{tuple(val.shape)}")
        else:
            sd[key] = torch.from_numpy(np.array(val, np.float32))
    unused = sorted(
        f"{col}/{'/'.join(p)}" for col, tree in trees.items() for p in tree if (col, p) not in used
    )
    return sd, {"missing": missing, "shape_mismatch": mismatched, "unused_jax": unused}


def to_jax_variables(model: nn.Module) -> Dict[str, Dict]:
    """A port model's state dict -> the flax variables of the JAX
    `TAMTRModel` of the same config, {"params": ..., "batch_stats": ...} as
    nested dicts of float32 numpy arrays: the inverse of
    `from_jax_variables`, route for route (the q/k/v split of `in_proj_*`,
    `A_logs` / `Ds` unflattened to (K, D, N) / (K, D), the Proto's
    transposed kernel flipped back, OIHW -> HWIO, Linear kernels
    transposed). `num_batches_tracked` has no flax twin and is left out."""
    layer_names = {idx: m.replace(".", "_") for idx, _, m, _ in model.specs}
    head_index = model.specs[-1][0] + 1
    head_type = getattr(model, "head_type", None)
    trees: Dict[str, Dict] = {"params": {}, "batch_stats": {}}

    def put(col: str, path: List[str], val: np.ndarray) -> None:
        node = trees[col]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(val, np.float32, order="C")  # a C-ordered copy; 0-d stays 0-d

    for key, t in model.state_dict().items():
        route = map_torch_key(key, tuple(t.shape), layer_names, head_index, head_type)
        if route is None:
            continue
        col, path, special = route
        val = t.detach().cpu().float().numpy()
        if special == "qkv":
            kind = "kernel" if key.endswith("weight") else "bias"
            for name, piece in zip(("q_proj", "k_proj", "v_proj"), np.split(val, 3, 0)):
                put("params", path + [name, kind], piece.T if piece.ndim == 2 else piece)
        elif special == "conv_transpose":  # (in, out, kH, kW) flipped -> (kH, kW, in, out)
            put(col, path, val[:, :, ::-1, ::-1].transpose(2, 3, 0, 1))
        elif special == "flatten":  # (K*D, N) / (K*D,) -> (K, D, N) / (K, D)
            put(col, path, val.reshape((K_DIRS, -1) + val.shape[1:]))
        else:
            leaf = path[-1]
            if not (leaf in _VERBATIM_LEAVES or path[-2:] == ["attn", "bias"] or leaf == "denoising_class_embed"):
                if val.ndim == 4:  # OIHW -> HWIO
                    val = val.transpose(2, 3, 1, 0)
                elif val.ndim == 2 and leaf == "kernel":
                    val = val.T
            put(col, path, val)
    return trees


# ---------------------------------------------------------------------------
# Seeded initialisation
# ---------------------------------------------------------------------------


def _normal_fan_in(t: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    t.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=g)


def _xavier_uniform(t: torch.Tensor, fan_in: int, fan_out: int, g: torch.Generator) -> None:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    t.uniform_(-bound, bound, generator=g)


def dt_bias_init(shape, g: torch.Generator, dt_min=0.001, dt_max=0.1, dt_floor=1e-4) -> torch.Tensor:
    """Inverse softplus of a log-uniform dt in [dt_min, dt_max]."""
    u = torch.rand(shape, generator=g)
    dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min)).clamp(min=dt_floor)
    return dt + torch.log(-torch.expm1(-dt))


@torch.no_grad()
def init_parameters(model: nn.Module, seed: int = 0) -> None:
    """Initialise every parameter and buffer of a port `TAMTRModel` from one
    CPU generator seeded with `seed` (the model must be on the CPU).

    Generic layers: conv and Linear weights N(0, 1/fan_in), biases 0,
    norms 1/0, BN statistics 0/1. Then the special inits of the JAX package:
    xavier-uniform projections in the head, the rotated-grid sampling-offset
    bias with zero offset and attention weights, zeroed last bbox-MLP layers,
    SS2D `A_logs = log(1..N)`, `Ds = 1` and the inverse-softplus dt bias,
    contrastive bias -10 and logit scale log(1/0.07) (the 1-D and 2-D
    heads), and the encoder score bias -log((1 - 0.01) / 0.01) / 80 * nc.
    The Linear score heads of the text-free heads keep the generic init, as
    flax's Dense (fan-in normal kernel, zero bias); so do Location's cv3
    stacks and AIFI. A Detect head keeps the generic
    init but for its class biases, the prior log(5 / nc / (640 / stride)^2)
    of each level (`tamtr_tpu/nn/yolo_head.py:90-97`); its box biases are 0.
    So do the Segment and Pose heads, whose Detect takes the same prior,
    their `cv4` convs and the Proto; its transposed conv's weight is
    N(0, 1/fan_in) with fan_in = in * kH * kW, its bias 0, as flax's
    `ConvTranspose` default. A Classify head keeps the generic init, as
    flax's ConvBN and Dense defaults.
    """
    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            w = mod.weight
            _normal_fan_in(w, w[0].numel(), g)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.ConvTranspose2d):
            w = mod.weight
            _normal_fan_in(w, w.shape[0] * w.shape[2] * w.shape[3], g)
            mod.bias.zero_()
        elif isinstance(mod, (nn.BatchNorm2d, nn.LayerNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, nn.BatchNorm2d):
                mod.reset_running_stats()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 1.0, generator=g)
        elif isinstance(mod, MultiHeadSelfAttention):
            w = mod.in_proj_weight
            _normal_fan_in(w, w.shape[1], g)
            mod.in_proj_bias.zero_()
        elif isinstance(mod, MaxSigmoidAttnBlock):
            mod.bias.zero_()
        elif isinstance(mod, (ContrastiveHead, ContrastiveHead2D)):
            mod.bias.fill_(-10.0)
            mod.logit_scale.fill_(math.log(1 / 0.07))
        elif isinstance(mod, SS2D):
            b = 1.0 / math.sqrt(mod.d_inner)
            mod.x_proj_weight.uniform_(-b, b, generator=g)
            mod.dt_projs_weight.uniform_(-mod.R**-0.5, mod.R**-0.5, generator=g)
            mod.dt_projs_bias.copy_(dt_bias_init(mod.dt_projs_bias.shape, g))
            mod.A_logs.copy_(torch.log(torch.arange(1, mod.N + 1, dtype=torch.float32)).expand_as(mod.A_logs))
            mod.Ds.fill_(1.0)

    head = model.model[-1]
    if isinstance(head, Classify):
        return
    if isinstance(head, Detect):
        for i, branch in enumerate(head.cv3):
            branch[2].bias.fill_(head.bias_prior(i))
        return
    for mod in head.modules():
        if isinstance(mod, MSDeformAttn):
            for lin in (mod.value_proj, mod.output_proj):
                _xavier_uniform(lin.weight, lin.in_features, lin.out_features, g)
            mod.sampling_offsets.weight.zero_()
            mod.sampling_offsets.bias.copy_(sampling_offset_bias(mod.nh, mod.nl, mod.P))
            mod.attention_weights.weight.zero_()
            mod.attention_weights.bias.zero_()
    for conv, _ in head.input_proj:
        _xavier_uniform(conv.weight, conv.in_channels, conv.out_channels, g)
    dense = head.enc_output[0]
    _xavier_uniform(dense.weight, dense.in_features, dense.out_features, g)
    if hasattr(head, "enc_score_head"):  # not Location's, which selects on its conv class maps
        head.enc_score_head.bias.fill_(-math.log((1 - 0.01) / 0.01) / 80 * head.nc)
    for mlp in [head.enc_bbox_head, *head.dec_bbox_head]:
        mlp.layers[-1].weight.zero_()
        mlp.layers[-1].bias.zero_()


# ---------------------------------------------------------------------------
# Segment Anything
# ---------------------------------------------------------------------------

# module path of the port (the reference's) -> flax scope, per SAM module
_SAM_SCOPES = [
    (r"^patch_embed\.proj$", "patch_embed"), (r"^patch_embed\.seq\.0", "patch_embed_conv1"),
    (r"^patch_embed\.seq\.2", "patch_embed_conv2"), (r"^blocks\.(\d+)", r"blocks_\1"),
    (r"^neck\.0$", "neck_conv1"), (r"^neck\.1$", "neck_ln1.LayerNorm_0"), (r"^neck\.2$", "neck_conv2"),
    (r"^neck\.3$", "neck_ln2.LayerNorm_0"), (r"^layers\.(\d+)\.blocks\.(\d+)", r"layer\1_block\2"),
    (r"^layers\.(\d+)\.downsample", r"layer\1_downsample"), (r"\.mlp\.(norm|fc1|fc2)$", r".mlp_\1"),
    (r"^mask_downscaling\.0$", "mask_down1"), (r"^mask_downscaling\.1$", "mask_ln1.LayerNorm_0"),
    (r"^mask_downscaling\.3$", "mask_down2"), (r"^mask_downscaling\.4$", "mask_ln2.LayerNorm_0"),
    (r"^mask_downscaling\.6$", "mask_proj"), (r"^transformer\.layers\.(\d+)", r"transformer.layers_\1"),
    (r"^output_upscaling\.0$", "upscale_conv1"), (r"^output_upscaling\.1$", "upscale_ln.LayerNorm_0"),
    (r"^output_upscaling\.3$", "upscale_conv2"),
    (r"^output_hypernetworks_mlps\.(\d+)\.layers\.(\d+)$", r"hyper_mlps_\1.layers_\2"),
    (r"^iou_prediction_head\.layers\.(\d+)$", r"iou_prediction_head.layers_\1"),
]
def sam_flax_route(sam: nn.Module) -> Dict[str, Tuple[str, str, List[str], Optional[str]]]:
    """Each state-dict key of a port `SamModel` -> (flax module, collection,
    flax path, kind). kind "conv_transpose": torch's (in, out, kH, kW)
    kernel is flax's (kH, kW, in, out) flipped in both spatial axes;
    "conv": OIHW <-> HWIO; "linear": transposed; ("row", k): row k of the
    flax (4, C) `point_embeddings`; None: as it is. `num_batches_tracked`
    has no flax twin and no entry."""
    routes = {}
    keys = set(sam.state_dict())
    for mpath, mod in sam.named_modules():
        if not mpath:
            continue
        top, _, local = mpath.partition(".")
        for name, t in list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False)):
            key = f"{mpath}.{name}"
            if key not in keys or name == "num_batches_tracked":
                continue
            if isinstance(mod, nn.Embedding):
                m = re.match(r"^point_embeddings\.(\d+)$", local)
                routes[key] = (top, "params", ["point_embeddings"] if m else [local], ("row", int(m[1])) if m else None)
                continue
            scope = local
            for pat, rep in _SAM_SCOPES:
                scope = re.sub(pat, rep, scope)
            path = scope.split(".") if scope else []
            if isinstance(mod, nn.BatchNorm2d):
                col, leaf = {"weight": ("params", "scale"), "bias": ("params", "bias"),
                             "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}[name]
                routes[key] = (top, col, path + [leaf], None)
            elif isinstance(mod, nn.LayerNorm):
                routes[key] = (top, "params", path + ["scale" if name == "weight" else "bias"], None)
            elif isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                kind = None if name == "bias" else "conv_transpose" if isinstance(mod, nn.ConvTranspose2d) \
                    else "conv" if isinstance(mod, nn.Conv2d) else "linear"
                routes[key] = (top, "params", path + ["kernel" if name == "weight" else "bias"], kind)
            else:  # a tensor of its own: pos_embed, rel_pos_*, attention_biases, the gaussian matrix
                routes[key] = (top, "params", path + [name], None)
    return routes


def from_jax_sam_variables(variables: Dict, sam: nn.Module):
    """The JAX package's SAM variables ({"image_encoder": {"params", and
    for TinyViT "batch_stats"}, "prompt_encoder": {"params"},
    "mask_decoder": {"params"}}, nested dicts of arrays) -> (state dict of
    the port's `sam`, report of missing keys, shape mismatches and unused
    flax leaves; all empty for a complete bridge)."""
    trees = {(m, col): _flatten_tree(v.get(col, {})) for m, v in variables.items()
             for col in ("params", "batch_stats")}
    used = set()
    sd: Dict[str, torch.Tensor] = {}
    missing, mismatched = [], []
    templates = sam.state_dict()
    for key, (top, col, path, kind) in sam_flax_route(sam).items():
        leaf = trees.get((top, col), {}).get(tuple(path))
        if leaf is None:
            missing.append(key)
            continue
        used.add((top, col, tuple(path)))
        val = np.asarray(leaf, np.float32)
        if isinstance(kind, tuple):  # one row of point_embeddings
            val = val[kind[1]:kind[1] + 1]
        elif kind == "conv_transpose":  # (kH, kW, in, out) -> (in, out, kH, kW), flipped
            val = np.transpose(val, (2, 3, 0, 1))[:, :, ::-1, ::-1]
        elif kind == "conv":
            val = np.transpose(val, (3, 2, 0, 1))
        elif kind == "linear":
            val = val.T
        if tuple(val.shape) != tuple(templates[key].shape):
            mismatched.append(f"{key}: port{tuple(templates[key].shape)} vs jax{tuple(val.shape)}")
        else:
            sd[key] = torch.from_numpy(np.array(val, np.float32))
    unused = sorted(f"{m}/{col}/{'/'.join(p)}" for (m, col), tree in trees.items() for p in tree
                    if (m, col, p) not in used)
    return sd, {"missing": missing, "shape_mismatch": mismatched, "unused_jax": unused}


@torch.no_grad()
def init_sam_parameters(sam: nn.Module, seed: int = 0) -> None:
    """Seeded weights of a port `SamModel` from one CPU generator, with the
    JAX modules' flax initialisers: Linear and conv kernels (the transposed
    convs too) N(0, 1/fan_in), biases 0; LayerNorm and BatchNorm scale 1
    (an MBConv's last BatchNorm 0), bias 0, statistics 0 / 1; `pos_embed`,
    `rel_pos_*` and TinyViT's `attention_biases` 0; the tokens, the point,
    not-a-point and no-mask embeddings and the gaussian matrix N(0, 1)."""
    from tamtr_torch.models.sam.modules import ConvBN2d, PositionEmbeddingRandom

    g = torch.Generator().manual_seed(seed)
    for mod in sam.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            _normal_fan_in(mod.weight, mod.weight[0].numel(), g)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.ConvTranspose2d):
            w = mod.weight
            _normal_fan_in(w, w.shape[0] * w.shape[2] * w.shape[3], g)
            mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, nn.BatchNorm2d):
                mod.reset_running_stats()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 1.0, generator=g)
        elif isinstance(mod, PositionEmbeddingRandom):
            mod.positional_encoding_gaussian_matrix.normal_(0.0, 1.0, generator=g)
        if isinstance(mod, ConvBN2d):
            mod.bn.weight.fill_(mod.bn_weight_init)
        for name in ("pos_embed", "rel_pos_h", "rel_pos_w", "attention_biases"):
            t = getattr(mod, name, None)
            if isinstance(t, nn.Parameter):
                t.zero_()
