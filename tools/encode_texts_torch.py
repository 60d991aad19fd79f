#!/usr/bin/env python
"""Offline CLIP text-embedding table generator of the PyTorch port (the
counterpart of `tools/encode_texts.py`), without `transformers`: the port's
own CLIP tokenizer and text tower, on the card unless `--device` says
otherwise.

Usage:
  # classes from a dataset yaml (synonyms split on "/", all encoded):
  python tools/encode_texts_torch.py --data dataset/visdrone.yaml --model <clip dir> --out visdrone_clip.npz

  # or explicit texts:
  python tools/encode_texts_torch.py --texts pedestrian people car "" --model <clip dir> --out t.npz

  # checkpoint sources, tried in order:
  #   --torch-pt <ViT-B-32.pt>   OpenAI-format torchscript CLIP archive (its
  #                              weights read, its code not run); the
  #                              tokenizer is read from --model
  #   --model <dir>              a transformers CLIP directory (config.json,
  #                              model.safetensors or pytorch_model.bin,
  #                              vocab.json, merges.txt), e.g. a downloaded
  #                              openai/clip-vit-base-patch32
  # Neither machine has network access: copy a checkpoint in first.

The output npz has keys "texts" (K,) (an object array) and "embeddings"
(K, 512) L2-normalized, read by `tamtr_torch.data.text` (cfg key
`text_embeddings=<file>`). The padding text "" is always included
(RandomLoadText pads with it). A source that fails is reported on stderr
before the next is tried.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CONTEXT = 77  # the OpenAI tower's context: ids padded with the end token to 77


def collect_texts(data: Optional[str] = None, texts: Optional[Sequence[str]] = None) -> List[str]:
    """The explicit texts, then each synonym of the dataset's names not yet
    listed, then "" (the padding text) if absent."""
    out = list(texts or [])
    if data:
        from tamtr_torch.config import load_data_yaml

        # check=False: encoding only needs the names table, not split paths
        for n in load_data_yaml(data, check=False)["names"]:
            for syn in str(n).split("/"):
                if syn not in out:
                    out.append(syn)
    if "" not in out:
        out.append("")
    return out


@torch.no_grad()
def encode_transformers(texts: Sequence[str], model_dir: str, device=None) -> np.ndarray:
    """A transformers CLIP directory's `text_embeds` (not normalised), the
    texts padded to the longest, as `tools/encode_texts.py` calls it."""
    from tamtr_torch.data.clip_tokenizer import CLIPTokenizer
    from tamtr_torch.nn.clip_text import CLIPTextTower

    tower = CLIPTextTower.from_pretrained(model_dir, device)
    enc = CLIPTokenizer.from_pretrained(model_dir)(list(texts), padding=True)
    dev = tower.text_projection.weight.device
    return tower(enc["input_ids"].to(dev), enc["attention_mask"].to(dev)).float().cpu().numpy()


@torch.no_grad()
def encode_openai_pt(texts: Sequence[str], pt_path: str, tokenizer_dir: str, device=None) -> np.ndarray:
    """An OpenAI torchscript archive's `encode_text` (not normalised): the
    ids padded with the end token to 77 and truncated, pooled at their
    largest id, with no padding mask, as the archive computes it."""
    from tamtr_torch.data.clip_tokenizer import CLIPTokenizer
    from tamtr_torch.nn.clip_text import CLIPTextTower

    tower = CLIPTextTower.from_openai(pt_path, device)
    ids = CLIPTokenizer.from_pretrained(tokenizer_dir)(list(texts), padding="max_length", max_length=CONTEXT,
                                                       truncation=True)["input_ids"]
    return tower(ids.to(tower.text_projection.weight.device)).float().cpu().numpy()


def encode_table(texts: Sequence[str], model: Optional[str], torch_pt: Optional[str] = None, device=None,
                 allow_hash: bool = False) -> np.ndarray:
    """(K, 512) L2-normalised rows by the first source that works: the
    OpenAI archive (when it exists), the transformers directory, then hash
    stand-ins if `allow_hash`. Raises RuntimeError listing each source's
    error when none works."""
    emb, errors = None, []
    if torch_pt and Path(torch_pt).expanduser().exists():
        try:
            emb = encode_openai_pt(texts, str(Path(torch_pt).expanduser()), model, device)
        except Exception as e:  # noqa: BLE001 - reported, then the next source
            errors.append(f"torch-pt({torch_pt}): {e}")
            print(f"encode_texts_torch: {errors[-1]}", file=sys.stderr)
    if emb is None and model:
        try:
            emb = encode_transformers(texts, model, device)
        except Exception as e:  # noqa: BLE001
            errors.append(f"model({model}): {e}")
            print(f"encode_texts_torch: {errors[-1]}", file=sys.stderr)
    if emb is None:
        if not allow_hash:
            raise RuntimeError("no CLIP checkpoint available: " + "; ".join(errors or ["no source given"]))
        from tamtr_torch.data.text import _hash_embedding

        emb = np.stack([_hash_embedding(t) for t in texts])
    emb = np.asarray(emb, np.float32)
    return emb / np.clip(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12, None)


def write_table(out: str, texts: Sequence[str], emb: np.ndarray) -> None:
    np.savez(out, texts=np.array(list(texts), dtype=object), embeddings=np.asarray(emb, np.float32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", help="dataset yaml with a names: table")
    ap.add_argument("--texts", nargs="*", help="explicit texts to encode")
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument("--model", default="openai/clip-vit-base-patch32",
                    help="transformers CLIP checkpoint directory (also the tokenizer of --torch-pt)")
    ap.add_argument("--torch-pt", default=None,
                    help="OpenAI-format CLIP .pt archive (e.g. ~/.cache/clip/ViT-B-32.pt)")
    ap.add_argument("--allow-hash", action="store_true",
                    help="fall back to hash stand-ins if no checkpoint is "
                         "available (NOT suitable for parity runs)")
    ap.add_argument("--device", default=None, help="torch device of the tower (default: cuda)")
    args = ap.parse_args(argv)

    texts = collect_texts(args.data, args.texts)
    try:
        emb = encode_table(texts, args.model, args.torch_pt, args.device, args.allow_hash)
    except RuntimeError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        print("Copy openai/clip-vit-base-patch32 (or ViT-B-32.pt with --model naming a directory that holds "
              "its vocab.json and merges.txt) here from a machine with network access, and re-run. "
              "Use --allow-hash only for smoke tests.", file=sys.stderr)
        return 1
    write_table(args.out, texts, emb)
    print(f"wrote {args.out}: {len(texts)} texts, dim {emb.shape[1]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
