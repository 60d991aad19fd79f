"""Checkpoint files of other libraries, read without them.

safetensors: an 8-byte little-endian header size, a JSON header mapping
each name to {"dtype", "shape", "data_offsets"} (offsets into the data
after the header; the key "__metadata__" holds strings), then the raw
little-endian data. F32, F16 and BF16 are read; another dtype raises naming
it, unless `select` leaves its tensor out (a buffer such as an int64
`position_ids` is never read). A sharded checkpoint's
`model.safetensors.index.json` ("weight_map": name -> file) is followed.
`pytorch_model.bin` (and its `.index.json`) goes through
`torch.load(weights_only=True)`, which runs no pickled code.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}
_NAMES = {v: k for k, v in _DTYPES.items()}
PathLike = Union[str, Path]


def read_safetensors(path: PathLike, select: Optional[Callable[[str], bool]] = None) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of one `.safetensors` file, the names `select`
    keeps (all when None)."""
    p = Path(path)
    with open(p, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{p}: not a safetensors file (shorter than its header size)")
        (n,) = struct.unpack("<Q", head)
        try:
            header = json.loads(f.read(n))
        except ValueError as e:
            raise ValueError(f"{p}: not a safetensors file (its header is not JSON: {e})") from None
        data = f.read()
    out = {}
    for name, entry in header.items():
        if name == "__metadata__" or (select is not None and not select(name)):
            continue
        dtype = _DTYPES.get(entry["dtype"])
        if dtype is None:
            raise ValueError(f"{p}: tensor {name!r} is {entry['dtype']}; this reader takes F32, F16 and BF16")
        start, end = entry["data_offsets"]
        if end > len(data) or end - start != int(np.prod(entry["shape"])) * dtype.itemsize:
            raise ValueError(f"{p}: tensor {name!r}'s offsets {start}-{end} do not fit its shape or the file")
        raw = bytearray(data[start:end])  # a copy of its own: aligned, writable
        t = torch.frombuffer(raw, dtype=dtype) if raw else torch.empty(0, dtype=dtype)
        out[name] = t.reshape(entry["shape"])
    return out


def write_safetensors(tensors: Dict[str, torch.Tensor], path: PathLike,
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """The inverse of `read_safetensors` for F32, F16 and BF16 tensors, in
    name order, the header padded with spaces to 8 bytes."""
    header, blobs, offset = {}, [], 0
    if metadata:
        header["__metadata__"] = dict(metadata)
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r} is {t.dtype}; write F32, F16 or BF16")
        raw = t.view(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)) + text)
        for b in blobs:
            f.write(b)


def _read_bin(path: Path, select) -> Dict[str, torch.Tensor]:
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in state.items() if select is None or select(k)}


def read_state(path: PathLike, select: Optional[Callable[[str], bool]] = None) -> Dict[str, torch.Tensor]:
    """A transformers checkpoint's tensors: `path` is a `.safetensors` or
    `.bin` file, or a directory holding (in this order of preference)
    `model.safetensors`, `model.safetensors.index.json`,
    `pytorch_model.bin` or `pytorch_model.bin.index.json`."""
    p = Path(path)
    if p.is_file():
        return read_safetensors(p, select) if p.suffix == ".safetensors" else _read_bin(p, select)
    for name, reader in (("model.safetensors", read_safetensors), ("pytorch_model.bin", _read_bin)):
        if (p / name).is_file():
            return reader(p / name, select)
        index = p / f"{name}.index.json"
        if index.is_file():
            shards = sorted(set(json.loads(index.read_text())["weight_map"].values()))
            out: Dict[str, torch.Tensor] = {}
            for shard in shards:
                out.update(reader(p / shard, select))
            return out
    raise FileNotFoundError(f"{p}: no model.safetensors, pytorch_model.bin or their .index.json")
