"""Weights for the port: its own seeded initialisation, and the bridge from
the JAX package's flax variables.

`from_jax_variables` keeps the port's copy of the key mapping in
`tools/port_torch_weights.py` (`map_torch_key`, `export_state_dict`): the
port's state-dict keys are the reference checkpoint's, so each key names one
flax leaf. Conv kernels go HWIO -> OIHW (depthwise (3, 3, 1, C) ->
(C, 1, 3, 3)), Linear kernels transpose, the q/k/v projections merge into
`in_proj_*`, and the SS2D `A_logs` (K, D, N) / `Ds` (K, D) flatten to
(K*D, N) / (K*D,).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tamtr_torch.nn.decoder import (
    ContrastiveHead, MSDeformAttn, MultiHeadSelfAttention, sampling_offset_bias,
)
from tamtr_torch.nn.layers import MaxSigmoidAttnBlock
from tamtr_torch.nn.ssm import SS2D

_BN_LEAF = {
    "weight": ("params", "scale"),
    "bias": ("params", "bias"),
    "running_mean": ("batch_stats", "mean"),
    "running_var": ("batch_stats", "var"),
}
# stacked SS2D params copied without transpose
_VERBATIM_LEAVES = {"x_proj_weight", "dt_projs_weight", "dt_projs_bias"}


def map_torch_key(key: str, shape: Tuple[int, ...], layer_names: Dict[int, str],
                  head_index: int) -> Optional[Tuple[str, List[str], Optional[str]]]:
    """One reference state-dict key -> (collection, flax path, special), or
    None for keys with no flax twin. `special` names the structured cases:
    "qkv" (in_proj merge) and "flatten" (A_logs/Ds)."""
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
            if tok == "self_attn" and nxt in ("in_proj_weight", "in_proj_bias"):
                return "params", out_path + ["self_attn"], "qkv"
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
        if tok in ("cv2", "cv3") and nxt in ("0", "1") and prefix != "head":
            out_path.append(f"{tok}_csp" if nxt == "0" else f"{tok}_conv")
            i += 2
            continue
        if tok == "m" and nxt and nxt.isdigit():  # RepNCSP bottleneck list
            out_path.append(f"m{nxt}")
            i += 2
            continue
        if tok == "conv" and nxt == "weight":
            out_path += ["Conv_0", "kernel"]
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
        route = map_torch_key(key, tuple(tmpl.shape), layer_names, head_index)
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
    contrastive bias -10 and logit scale log(1/0.07), and the encoder score
    bias -log((1 - 0.01) / 0.01) / 80 * nc.
    """
    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            w = mod.weight
            _normal_fan_in(w, w[0].numel(), g)
            if mod.bias is not None:
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
        elif isinstance(mod, ContrastiveHead):
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
    head.enc_score_head.bias.fill_(-math.log((1 - 0.01) / 0.01) / 80 * head.nc)
    for mlp in [head.enc_bbox_head, *head.dec_bbox_head]:
        mlp.layers[-1].weight.zero_()
        mlp.layers[-1].bias.zero_()
