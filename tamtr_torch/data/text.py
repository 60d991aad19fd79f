"""Frozen text embeddings for the open-vocabulary branch (a port of the JAX
package's `tamtr_tpu/data/text.py`).

Sources, in the JAX package's order:
1. an `.npz` table made offline by `tools/encode_texts_torch.py` (or the JAX
   package's `tools/encode_texts.py`) with a real CLIP ViT-B/32: keys
   "texts" (K,) and "embeddings" (K, 512); files with only "embeddings"
   are matched by position;
2. a local CLIP checkpoint in transformers' layout (`clip_model=` a
   directory: `config.json`, its weights, `vocab.json` and `merges.txt`),
   read and run by the port's own tokenizer (`data/clip_tokenizer.py`) and
   text tower (`nn/clip_text.py`) on `device` (the card unless the caller
   passes another), one tower a (path, device) kept for the process; the
   rows come L2-normalised, as transformers' `text_embeds` normalised by
   the JAX package;
3. deterministic hash stand-ins: unit vectors seeded by the text's sha256,
   bitwise the JAX package's at the CLIP width of 512. They keep the
   pipeline trainable (classes stay distinct) but carry no CLIP semantics,
   so using them logs a loud warning.
`dim` asks for another width: the text width of a model is its head's
hidden width (512 for `tamtr.yaml`, 128 for `tamtr-nano.yaml`), and an npz
table or a checkpoint's projection must have that width.

Where the JAX package swallows any error of source 2 and falls back to hash
stand-ins, the port raises naming the checkpoint: one that cannot be read,
and a text longer than the tower's 77 positions.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tamtr_torch.utils.log import LOGGER

EMBED_DIM = 512
_WARNED = False
_TOWERS: Dict[Tuple[str, str], tuple] = {}  # (checkpoint, device) -> (tokenizer, tower)


def _warn_hash_fallback(texts: Sequence[str]) -> None:
    global _WARNED
    if not _WARNED:
        LOGGER.warning(
            "TEXT EMBEDDINGS ARE HASH STAND-INS (no npz table entry found for "
            f"{list(texts)[:4]}...). The text branch is semantically void: "
            "detection still trains, but open-vocabulary behavior and mAP parity "
            "with the reference require real CLIP ViT-B/32 embeddings. Generate "
            "them offline with tools/encode_texts_torch.py and pass text_embeddings=<file.npz>."
        )
        _WARNED = True


def _hash_embedding(text: str, dim: int = EMBED_DIM) -> np.ndarray:
    seed = int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little")
    v = np.random.default_rng(seed).standard_normal(dim).astype(np.float32)
    return v / np.linalg.norm(v)


def _load_npz_table(npz_path: str | Path) -> Optional[Dict[str, np.ndarray]]:
    """{text: (512,) embedding} from an encode_texts.py npz."""
    p = Path(npz_path)
    if not p.exists():
        return None
    z = np.load(p, allow_pickle=True)  # "texts" is an object array (tools/encode_texts.py)
    emb = np.asarray(z["embeddings"], np.float32)
    emb = emb / np.clip(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12, None)
    if "texts" in z:
        texts = [str(t) for t in z["texts"]]
        return dict(zip(texts, emb))
    return {f"__pos{i}__": e for i, e in enumerate(emb)}


def clip_text_tower(clip_model: Union[str, Path], device=None):
    """(tokenizer, tower) of a transformers CLIP directory on `device` (the
    card when None), loaded once a (path, device)."""
    from tamtr_torch.data.clip_tokenizer import CLIPTokenizer
    from tamtr_torch.nn.clip_text import CLIPTextTower, resolve_device

    dev = resolve_device(device)
    key = (str(Path(clip_model).resolve()), str(dev))
    if key not in _TOWERS:
        if not Path(clip_model).is_dir():
            raise FileNotFoundError(f"clip_model {clip_model}: not a directory (a transformers CLIP checkpoint)")
        try:
            _TOWERS[key] = (CLIPTokenizer.from_pretrained(clip_model), CLIPTextTower.from_pretrained(clip_model, dev))
        except Exception as e:
            raise RuntimeError(f"clip_model {clip_model}: cannot read the CLIP checkpoint "
                               f"({type(e).__name__}: {e})") from e
    return _TOWERS[key]


@torch.no_grad()
def encode_with_clip(texts: Sequence[str], clip_model: Union[str, Path], device=None) -> np.ndarray:
    """(K, projection) L2-normalised CLIP text embeddings: the texts
    tokenized padded to the longest, as the JAX package's
    `_encode_with_transformers` calls `CLIPTokenizer`."""
    tok, tower = clip_text_tower(clip_model, device)
    enc = tok(list(texts), padding=True)
    positions = tower.config.max_position_embeddings
    if enc["input_ids"].shape[1] > positions:
        n = enc["attention_mask"].sum(1)
        i = int(n.argmax())
        raise ValueError(f"{clip_model}: text {texts[i]!r} is {int(n[i])} tokens; the CLIP text tower takes "
                         f"at most {positions}")
    dev = tower.text_projection.weight.device
    out = tower(enc["input_ids"].to(dev), enc["attention_mask"].to(dev)).float().cpu().numpy()
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


def encode_texts(texts: Sequence[str], npz_path: Optional[str | Path] = None, dim: int = EMBED_DIM,
                 clip_model: Optional[str | Path] = None, device=None) -> np.ndarray:
    """(K, dim) L2-normalized embeddings for arbitrary text strings: the npz
    table (by text, or by position for embeddings-only files), then the
    CLIP checkpoint `clip_model` on `device` (the card when None), then hash
    stand-ins (with a loud warning)."""
    out = np.zeros((len(texts), dim), np.float32)
    missing: List[int] = []
    table = _load_npz_table(npz_path) if npz_path is not None else None
    if table is not None:
        width = len(next(iter(table.values())))
        if width != dim:
            raise ValueError(f"{npz_path} holds {width}-d embeddings; the model takes {dim}")
        positional = "__pos0__" in table
        for i, t in enumerate(texts):
            key = f"__pos{i}__" if positional else t
            if key in table:
                out[i] = table[key]
            else:
                missing.append(i)
        if not missing:
            return out
    else:
        missing = list(range(len(texts)))
    if clip_model is not None and missing:
        emb = encode_with_clip([texts[i] for i in missing], clip_model, device)
        if emb.shape[1] != dim:
            raise ValueError(f"{clip_model} gives {emb.shape[1]}-d embeddings; the model takes {dim}")
        out[np.asarray(missing)] = emb
        return out
    _warn_hash_fallback([texts[i] for i in missing])
    for i in missing:
        out[i] = _hash_embedding(texts[i], dim)
    return out


def class_text_embeddings(names: Sequence[str], npz_path: Optional[str | Path] = None, dim: int = EMBED_DIM,
                          clip_model: Optional[str | Path] = None, device=None) -> np.ndarray:
    """(K, dim) L2-normalized text embeddings for the class names;
    multi-synonym names ("person/pedestrian") use the first synonym."""
    return encode_texts([str(n).split("/")[0] for n in names], npz_path=npz_path, dim=dim,
                        clip_model=clip_model, device=device)


class TextEmbedder:
    """Text -> embedding lookup with a cache, for per-batch RandomLoadText:
    unseen texts are embedded on first use (npz, CLIP or hash) and kept."""

    def __init__(self, npz_path: Optional[str | Path] = None, dim: int = EMBED_DIM,
                 clip_model: Optional[str | Path] = None, device=None) -> None:
        self.npz_path, self.dim, self.clip_model, self.device = npz_path, dim, clip_model, device
        self._cache: Dict[str, np.ndarray] = {}

    def __call__(self, batch_texts: Sequence[Sequence[str]]) -> np.ndarray:
        """(B, K) strings -> (B, K, dim) embeddings."""
        new = sorted({t for row in batch_texts for t in row} - self._cache.keys())
        if new:
            emb = encode_texts(new, npz_path=self.npz_path, dim=self.dim, clip_model=self.clip_model,
                               device=self.device)
            self._cache.update(zip(new, emb))
        return np.stack(
            [np.stack([self._cache[t] for t in row]) for row in batch_texts]
        ).astype(np.float32)
