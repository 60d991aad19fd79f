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

A reference checkpoint (ultralytics 8.0.201's `last.pt` / `best.pt`, the
released `TAM_TR.pt`) is a `torch.save` zip archive whose pickle holds the
whole `RTDETRDetectionWorldModel` module under `ema` (training's layout) or
`model` (`strip_optimizer`'s), in half precision. `read_reference_checkpoint`
unpickles it through `torch.load` with an unpickler that resolves only
torch's tensor rebuilders, its dtypes, `Size` and `device`,
`collections.OrderedDict`, `copyreg._reconstructor` and the builtins `set`,
`frozenset` and `object` (under protocol 2's names `__builtin__` and
`copy_reg` too); every other global (the reference's classes, torch's
module classes, `functools.partial`, `getattr`, `pathlib`, `os.system`)
becomes an inert `PickledObject` subclass that records the name it stands
for, accepts any arguments and state, and is never imported or run.
Nothing is imported and nothing is added to `sys.modules`. The state dict
is then read off the module tree (`_parameters`, `_buffers` less
`_non_persistent_buffers_set`, `_modules`) as `nn.Module.state_dict` names
it, less `num_batches_tracked`, with fp16 and bf16 cast to fp32.
"""

from __future__ import annotations

import collections
import copyreg
import json
import pickle
import struct
import types
import zipfile
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

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


class PickledObject:
    """An object of a global the reference reader does not resolve: the
    class itself stands for the global (`qualname`), and calling it, or
    building an instance from the pickle's NEWOBJ, BUILD, SETITEMS or
    APPENDS, only records what it was given."""

    qualname = "?"

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.__dict__["pickled_args"] = args
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, tuple) and len(state) == 2 and all(s is None or isinstance(s, dict) for s in state):
            for part in state:  # (__dict__, slots)
                self.__dict__.update(part or {})
        elif isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["pickled_state"] = state

    def __setitem__(self, key, value):
        self.__dict__.setdefault("pickled_items", {})[key] = value

    def append(self, value):
        self.__dict__.setdefault("pickled_list", []).append(value)

    def extend(self, values):
        for v in values:
            self.append(v)


def _real_globals() -> Dict[Tuple[str, str], Any]:
    real: Dict[Tuple[str, str], Any] = {("collections", "OrderedDict"): collections.OrderedDict,
                                         ("torch", "Size"): torch.Size, ("torch", "device"): torch.device}
    for mod in ("copyreg", "copy_reg"):
        real[(mod, "_reconstructor")] = copyreg._reconstructor
    for mod in ("builtins", "__builtin__"):
        real.update({(mod, "set"): set, (mod, "frozenset"): frozenset, (mod, "object"): object})
    for name in ("_rebuild_tensor", "_rebuild_tensor_v2", "_rebuild_tensor_v3", "_rebuild_parameter",
                 "_rebuild_parameter_with_state"):
        if hasattr(torch._utils, name):
            real[("torch._utils", name)] = getattr(torch._utils, name)
    real[("torch._tensor", "_rebuild_from_type_v2")] = torch._tensor._rebuild_from_type_v2
    real.update({("torch", k): v for k, v in vars(torch).items() if isinstance(v, torch.dtype)})
    return real


_REAL = _real_globals()


class _ReferenceUnpickler(pickle.Unpickler):
    """Resolves `_REAL`; any other global becomes one `PickledObject`
    subclass per name, for this load."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.stubs: Dict[Tuple[str, str], type] = {}

    def find_class(self, module, name):
        real = _REAL.get((module, name))
        if real is not None:
            return real
        if (module, name) not in self.stubs:
            self.stubs[(module, name)] = type(name.rpartition(".")[2] or "PickledObject", (PickledObject,),
                                              {"qualname": f"{module}.{name}", "__module__": __name__})
        return self.stubs[(module, name)]


# torch.load's `pickle_module`: torch subclasses its Unpickler, where storage
# types resolve before `find_class`; the legacy format, which would call the
# module's `load`, is refused before torch.load is reached
_PICKLE_MODULE = types.ModuleType("tamtr_reference_pickle")
_PICKLE_MODULE.Unpickler = _ReferenceUnpickler


def _unsafe_globals(path: Path) -> List[str]:
    """The pickle's globals outside torch's weights-only set."""
    try:
        return torch.serialization.get_unsafe_globals_in_checkpoint(str(path))
    except ValueError as e:  # a TorchScript archive
        raise ValueError(f"{path}: {e}") from None


def _require_archive(path: Path) -> None:
    if not path.is_file():
        raise FileNotFoundError(f"{path}: no such checkpoint")
    if not zipfile.is_zipfile(path):
        raise ValueError(f"{path}: not a torch zip archive (torch.save's format since torch 1.6); the legacy "
                         "format and other files are not read")


def is_reference_checkpoint(path: PathLike) -> bool:
    """True for a torch zip archive whose pickle names a global outside
    torch's weights-only set (the reference's pickled module tree); False
    for the port's own checkpoints. Any other file raises, naming it."""
    p = Path(path)
    _require_archive(p)
    return bool(_unsafe_globals(p))


def _pickled_state(obj) -> Dict[str, Any]:
    return obj.__dict__ if isinstance(obj, PickledObject) else {}


def _walk_modules(obj, prefix: str, out: Dict[str, torch.Tensor], seen: set) -> None:
    if id(obj) in seen:
        raise ValueError(f"module {prefix or '<root>'} holds itself")
    seen.add(id(obj))
    d = _pickled_state(obj)
    groups = {g: d.get(g) or {} for g in ("_parameters", "_buffers", "_modules")}
    skip = d.get("_non_persistent_buffers_set") or set()
    if not all(isinstance(v, Mapping) for v in groups.values()) or not isinstance(skip, (set, frozenset)):
        raise ValueError(f"module {prefix or '<root>'} is not a pickled nn.Module")
    for group, dropped in (("_parameters", ()), ("_buffers", skip)):
        for name, t in groups[group].items():
            if t is None or name in dropped or name == "num_batches_tracked":
                continue
            if not isinstance(t, torch.Tensor):
                raise ValueError(f"{prefix}{name} is a {type(t).__name__}, not a tensor")
            t = t.detach()
            out[prefix + name] = t.float() if t.dtype in (torch.float16, torch.bfloat16) else t
    for name, child in groups["_modules"].items():
        if child is not None:
            _walk_modules(child, f"{prefix}{name}.", out, seen)


def read_reference_checkpoint(path: PathLike) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """(state dict, meta) of a reference checkpoint, on the CPU: the EMA
    module when the file holds one, else `model`; meta {"nc": the root's
    `yaml["nc"]` or None, "names": its `names` as a list or None, "imgsz":
    the file's `train_args["imgsz"]` or None}. Runs no
    pickled code (module docstring); raises naming the file for anything
    but a torch zip archive, or a root that is not a module tree."""
    p = Path(path)
    _require_archive(p)
    ckpt = torch.load(p, map_location="cpu", weights_only=False, pickle_module=_PICKLE_MODULE)
    root = None
    if isinstance(ckpt, Mapping):
        root = ckpt.get("ema") if ckpt.get("ema") is not None else ckpt.get("model")
    if "_modules" not in _pickled_state(root):
        kind = type(root).__name__ if not isinstance(root, PickledObject) else root.qualname
        raise ValueError(f"{p}: its ema / model entry is {kind}, not a pickled module tree")
    state: Dict[str, torch.Tensor] = {}
    try:
        _walk_modules(root, "", state, set())
    except ValueError as e:
        raise ValueError(f"{p}: {e}") from None
    d = _pickled_state(root)
    yaml = d.get("yaml")
    nc = yaml.get("nc") if isinstance(yaml, dict) else None
    names = d.get("names")
    if isinstance(names, dict):
        names = [str(names[k]) for k in sorted(names)]
    elif isinstance(names, (list, tuple)):
        names = [str(n) for n in names]
    else:
        names = None
    args = ckpt.get("train_args")
    imgsz = args.get("imgsz") if isinstance(args, dict) else None
    return state, {"nc": int(nc) if nc is not None else None, "names": names,
                   "imgsz": imgsz if isinstance(imgsz, int) else None}


def check_reference_state(path: PathLike, state: Mapping[str, torch.Tensor], expected: Mapping[str, torch.Tensor],
                          what: str) -> None:
    """Raise, naming the file and the first five keys of each list, unless
    `state` (a reference checkpoint's) holds exactly the keys and shapes of
    `expected` (the port model's state dict, `num_batches_tracked` aside):
    the JAX converter's report, `unmapped_torch` (keys `what` lacks) and
    `missing_params` (keys the file lacks), and the shape mismatches."""
    want = {k: tuple(v.shape) for k, v in expected.items() if not k.endswith("num_batches_tracked")}
    unmapped = [k for k in state if k not in want]
    missing = [k for k in want if k not in state]
    problems = []
    if unmapped:
        problems.append(f"unmapped_torch: {len(unmapped)} keys {what} does not have, first {unmapped[:5]}")
    if missing:
        problems.append(f"missing_params: {len(missing)} keys of {what} the file lacks, first {missing[:5]}")
    shapes = [f"{k}: file {tuple(state[k].shape)} vs {want[k]}" for k in want
              if k in state and tuple(state[k].shape) != want[k]]
    if shapes:
        problems.append(f"shape_mismatch: {len(shapes)} keys, first {shapes[:5]}")
    if problems:
        raise ValueError(f"{Path(path)}: not a checkpoint of {what}: " + "; ".join(problems))
