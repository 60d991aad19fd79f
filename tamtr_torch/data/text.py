"""Frozen text embeddings for the open-vocabulary branch (a port of the JAX
package's `tamtr_tpu/data/text.py`).

Sources, in order: an `.npz` table made offline by `tools/encode_texts.py`
with a real CLIP ViT-B/32 (keys "texts" (K,) and "embeddings" (K, 512);
files with only "embeddings" are matched by position), then deterministic
hash stand-ins: unit vectors seeded by the text's sha256, bitwise the JAX
package's at the CLIP width of 512. The stand-ins keep the pipeline
trainable (classes stay distinct) but carry no CLIP semantics, so using
them logs a loud warning. `dim` asks for another width: the text width of
a model is its head's hidden width (512 for `tamtr.yaml`, 128 for
`tamtr-nano.yaml`), and an npz table must hold that width.
The JAX package's third source, a local `transformers` CLIP checkpoint, is
not ported.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from tamtr_torch.utils.log import LOGGER

EMBED_DIM = 512
_WARNED = False


def _warn_hash_fallback(texts: Sequence[str]) -> None:
    global _WARNED
    if not _WARNED:
        LOGGER.warning(
            "TEXT EMBEDDINGS ARE HASH STAND-INS (no npz table entry found for "
            f"{list(texts)[:4]}...). The text branch is semantically void: "
            "detection still trains, but open-vocabulary behavior and mAP parity "
            "with the reference require real CLIP ViT-B/32 embeddings. Generate "
            "them offline with tools/encode_texts.py and pass text_embeddings=<file.npz>."
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


def encode_texts(texts: Sequence[str], npz_path: Optional[str | Path] = None,
                 dim: int = EMBED_DIM) -> np.ndarray:
    """(K, dim) L2-normalized embeddings for arbitrary text strings: the npz
    table (by text, or by position for embeddings-only files), then hash
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
    _warn_hash_fallback([texts[i] for i in missing])
    for i in missing:
        out[i] = _hash_embedding(texts[i], dim)
    return out


def class_text_embeddings(names: Sequence[str], npz_path: Optional[str | Path] = None,
                          dim: int = EMBED_DIM) -> np.ndarray:
    """(K, dim) L2-normalized text embeddings for the class names;
    multi-synonym names ("person/pedestrian") use the first synonym."""
    return encode_texts([str(n).split("/")[0] for n in names], npz_path=npz_path, dim=dim)


class TextEmbedder:
    """Text -> embedding lookup with a cache, for per-batch RandomLoadText:
    unseen texts are embedded on first use (npz or hash) and kept."""

    def __init__(self, npz_path: Optional[str | Path] = None, dim: int = EMBED_DIM) -> None:
        self.npz_path, self.dim = npz_path, dim
        self._cache: Dict[str, np.ndarray] = {}

    def __call__(self, batch_texts: Sequence[Sequence[str]]) -> np.ndarray:
        """(B, K) strings -> (B, K, dim) embeddings."""
        new = sorted({t for row in batch_texts for t in row} - self._cache.keys())
        if new:
            emb = encode_texts(new, npz_path=self.npz_path, dim=self.dim)
            self._cache.update(zip(new, emb))
        return np.stack(
            [np.stack([self._cache[t] for t in row]) for row in batch_texts]
        ).astype(np.float32)
