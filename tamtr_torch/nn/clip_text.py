"""CLIP's text tower (ViT-B/32's: 12 pre-LN layers of width 512, 8 heads,
77 positions, a 512-wide projection), the encoder of the class-text table.

`CLIPTextTower` computes what `transformers.CLIPTextModelWithProjection`
gives as `text_embeds` (`modeling_clip.py`): token + position embeddings,
pre-LN layers (causal mask, and the padding mask when one is given;
`quick_gelu` or `gelu` in the MLP), the final LayerNorm, one position a
row pooled, and `text_projection` without bias. Pooling takes transformers'
two branches: a config with `eos_token_id` 2 (the legacy hub configs, as
openai/clip-vit-base-patch32's) pools at `argmax(input_ids)`, where the
end token is the largest id; any other pools at the first position of
`eos_token_id`. The attention and matrix products are plain torch ops, as
transformers' own are.

Its parameter names are transformers' without the `text_model.` prefix.
`clip_state_from_transformers` reads them from a `CLIPTextModelWithProjection`
or a full `CLIPModel` save (safetensors or `.bin`; the vision tower's keys
are not read); `clip_state_from_openai` from an OpenAI torchscript archive
(`ViT-B-32.pt`), without running its code: `attn.in_proj_*` split into q,
k and v, `text_projection` (applied there as `x @ P`) transposed, fp16 cast
to fp32 as `.float()` does.
"""

from __future__ import annotations

import json
import warnings
from dataclasses import asdict, dataclass, fields
from pathlib import Path
from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from tamtr_torch.weight_files import read_state

PathLike = Union[str, Path]


@dataclass
class CLIPTextConfig:
    """`transformers.CLIPTextConfig`'s fields the tower reads, with its
    defaults (ViT-B/32's text tower)."""
    vocab_size: int = 49408
    hidden_size: int = 512
    intermediate_size: int = 2048
    projection_dim: int = 512
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    bos_token_id: int = 49406
    eos_token_id: int = 49407

    @classmethod
    def from_dict(cls, d: Dict) -> "CLIPTextConfig":
        """A text config, or a full `CLIPConfig`'s: its `text_config`, with
        `projection_dim` from the top level. Absent keys take the defaults."""
        if isinstance(d.get("text_config"), dict):
            top = d
            d = dict(d["text_config"])
            if "projection_dim" in top:
                d["projection_dim"] = top["projection_dim"]
        return cls(**{f.name: d[f.name] for f in fields(cls) if d.get(f.name) is not None})

    @classmethod
    def from_json(cls, path: PathLike) -> "CLIPTextConfig":
        """`config.json` of a transformers directory (or the file itself)."""
        p = Path(path)
        p = p / "config.json" if p.is_dir() else p
        return cls.from_dict(json.loads(p.read_text()))

    def to_dict(self) -> Dict:
        return {"model_type": "clip_text_model", **asdict(self)}


def _activation(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu
    raise ValueError(f"hidden_act {name!r}: the CLIP text tower takes 'quick_gelu' or 'gelu'")


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d, self.heads = cfg.hidden_size, cfg.num_attention_heads
        if d % self.heads:
            raise ValueError(f"hidden_size {d} is not a multiple of num_attention_heads {self.heads}")
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(d, d) for _ in range(4))

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        q, k, v = (p(x).view(B, L, self.heads, -1).transpose(1, 2) for p in (self.q_proj, self.k_proj, self.v_proj))
        w = torch.matmul(q, k.transpose(-1, -2)) * (D // self.heads) ** -0.5 + bias
        w = torch.softmax(w, dim=-1, dtype=torch.float32).to(q.dtype)
        return self.out_proj(torch.matmul(w, v).transpose(1, 2).reshape(B, L, D))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = _activation(cfg.hidden_act)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, bias):
        x = x + self.self_attn(self.layer_norm1(x), bias)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg) for _ in range(cfg.num_hidden_layers))


def pooled_positions(input_ids: torch.Tensor, eos_token_id: int) -> torch.Tensor:
    """Each row's pooled position: argmax of the ids when eos_token_id is 2
    (legacy configs), else the first position of eos_token_id (0 when a
    row has none, as transformers gives)."""
    ids = input_ids.to(torch.int32)
    if eos_token_id == 2:
        return ids.argmax(dim=-1)
    return (ids == eos_token_id).to(torch.int32).argmax(dim=-1)


class CLIPTextTower(nn.Module):
    """(K, T) token ids (and a (K, T) padding mask) -> (K, projection_dim)
    text embeddings, not normalised."""

    def __init__(self, cfg: Optional[CLIPTextConfig] = None):
        super().__init__()
        self.config = cfg = cfg or CLIPTextConfig()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.text_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, L = input_ids.shape
        if L > self.config.max_position_embeddings:
            raise ValueError(f"{L} tokens a row; the tower has {self.config.max_position_embeddings} positions")
        emb = self.embeddings
        x = emb.token_embedding(input_ids) + emb.position_embedding.weight[:L]
        keep = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()[None, None]
        if attention_mask is not None:
            keep = keep & attention_mask.to(device=x.device, dtype=torch.bool)[:, None, None, :]
        bias = torch.zeros(keep.shape, dtype=x.dtype, device=x.device).masked_fill(~keep, torch.finfo(x.dtype).min)
        for layer in self.encoder.layers:
            x = layer(x, bias)
        x = self.final_layer_norm(x)
        pooled = x[torch.arange(B, device=x.device), pooled_positions(input_ids, self.config.eos_token_id).to(x.device)]
        return self.text_projection(pooled)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> "CLIPTextTower":
        """Seeded weights at transformers' CLIP initialisation (factor 1):
        token embeddings N(0, 0.02), positions N(0, 0.01), q/k/v
        N(0, d^-0.5 (2 layers)^-0.5), out N(0, d^-0.5), fc1 N(0, (2d)^-0.5),
        fc2 as q/k/v, the projection N(0, d^-0.5), biases 0, LayerNorms 1, 0."""
        cfg, g = self.config, torch.Generator().manual_seed(seed)
        d = cfg.hidden_size
        in_std = d ** -0.5 * (2 * cfg.num_hidden_layers) ** -0.5

        def normal_(t, std):
            t.copy_(torch.randn(t.shape, generator=g) * std)

        normal_(self.embeddings.token_embedding.weight, 0.02)
        normal_(self.embeddings.position_embedding.weight, 0.01)
        for layer in self.encoder.layers:
            a = layer.self_attn
            for p, std in ((a.q_proj, in_std), (a.k_proj, in_std), (a.v_proj, in_std), (a.out_proj, d ** -0.5),
                           (layer.mlp.fc1, (2 * d) ** -0.5), (layer.mlp.fc2, in_std)):
                normal_(p.weight, std)
                p.bias.zero_()
        for m in self.modules():
            if isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        normal_(self.text_projection.weight, d ** -0.5)
        return self

    @classmethod
    def from_pretrained(cls, path: PathLike, device: Union[str, torch.device, None] = None) -> "CLIPTextTower":
        """A transformers directory (`config.json` and its weights), on
        `device` (the card when None)."""
        tower = cls(CLIPTextConfig.from_json(path))
        load_state(tower, clip_state_from_transformers(path), path)
        return tower.to(resolve_device(device)).eval()

    @classmethod
    def from_openai(cls, path: PathLike, device: Union[str, torch.device, None] = None) -> "CLIPTextTower":
        """An OpenAI torchscript archive's text tower, on `device` (the card
        when None)."""
        state = clip_state_from_openai(path)
        tower = cls(openai_text_config(state))
        load_state(tower, state, path)
        return tower.to(resolve_device(device)).eval()


def resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the CLIP text tower on the CPU")
    return dev


def load_state(tower: CLIPTextTower, state: Dict[str, torch.Tensor], path: PathLike) -> None:
    """`load_state_dict`, strict, with the checkpoint named in the error."""
    missing = sorted(set(tower.state_dict()) - set(state))
    extra = sorted(set(state) - set(tower.state_dict()))
    if missing or extra:
        raise KeyError(f"{path}: the CLIP text tower's weights do not match: missing {missing[:6]}, "
                       f"unexpected {extra[:6]}")
    try:
        tower.load_state_dict(state)
    except RuntimeError as e:
        raise ValueError(f"{path}: {e}") from None


def clip_state_from_transformers(path: PathLike) -> Dict[str, torch.Tensor]:
    """The tower's state dict from a transformers save (a directory or a
    weights file): `text_model.*` (not its `position_ids` buffer) and
    `text_projection.weight`, as fp32."""
    def select(k):
        return (k.startswith("text_model.") and not k.endswith("position_ids")) or k == "text_projection.weight"

    state = read_state(path, select)
    return {k.removeprefix("text_model."): v.float() for k, v in state.items()}


_OPENAI_LAYER = {"ln_1": "layer_norm1", "ln_2": "layer_norm2", "mlp.c_fc": "mlp.fc1", "mlp.c_proj": "mlp.fc2",
                 "attn.out_proj": "self_attn.out_proj"}


def clip_state_from_openai(path: PathLike) -> Dict[str, torch.Tensor]:
    """The tower's state dict from an OpenAI CLIP torchscript archive, read
    by `torch.jit.load` (its scripted code is not called), as fp32."""
    with warnings.catch_warnings():  # torch.jit is deprecated, and the only reader of this format
        warnings.simplefilter("ignore", DeprecationWarning)
        archive = torch.jit.load(str(path), map_location="cpu")
    src = {k: v.float() for k, v in archive.state_dict().items() if not k.startswith("visual.")}
    try:
        state = {"embeddings.token_embedding.weight": src["token_embedding.weight"],
                 "embeddings.position_embedding.weight": src["positional_embedding"],
                 "final_layer_norm.weight": src["ln_final.weight"], "final_layer_norm.bias": src["ln_final.bias"],
                 "text_projection.weight": src["text_projection"].t().contiguous()}
    except KeyError as e:
        raise KeyError(f"{path}: no {e.args[0]!r}: not an OpenAI CLIP archive") from None
    for k, v in src.items():
        if not k.startswith("transformer.resblocks."):
            continue
        i, rest = k.split(".", 3)[2:]
        pre = f"encoder.layers.{i}."
        if rest.startswith("attn.in_proj_"):
            kind = rest.removeprefix("attn.in_proj_")
            for name, part in zip(("q_proj", "k_proj", "v_proj"), v.chunk(3, dim=0)):
                state[f"{pre}self_attn.{name}.{kind}"] = part.contiguous()
            continue
        mod, leaf = rest.rsplit(".", 1)
        if mod not in _OPENAI_LAYER:
            raise KeyError(f"{path}: unexpected key {k!r} in the text tower")
        state[f"{pre}{_OPENAI_LAYER[mod]}.{leaf}"] = v
    return state


def openai_text_config(state: Dict[str, torch.Tensor]) -> CLIPTextConfig:
    """The config of an OpenAI tower from its weights' shapes, as OpenAI's
    `build_model` reads them: heads = width / 64, quick_gelu, and the end
    token pooled as the largest id (`eos_token_id` 2, transformers' legacy
    branch)."""
    vocab, width = state["embeddings.token_embedding.weight"].shape
    layers = 1 + max(int(k.split(".")[2]) for k in state if k.startswith("encoder.layers."))
    return CLIPTextConfig(vocab_size=vocab, hidden_size=width,
                          intermediate_size=state["encoder.layers.0.mlp.fc1.weight"].shape[0],
                          projection_dim=state["text_projection.weight"].shape[0], num_hidden_layers=layers,
                          num_attention_heads=width // 64,
                          max_position_embeddings=state["embeddings.position_embedding.weight"].shape[0],
                          eos_token_id=2)


def transformers_state(tower: CLIPTextTower) -> Dict[str, torch.Tensor]:
    """The tower's weights under transformers' `CLIPTextModelWithProjection`
    names (the inverse of `clip_state_from_transformers`)."""
    return {(k if k == "text_projection.weight" else f"text_model.{k}"): v.detach().cpu()
            for k, v in tower.state_dict().items()}
