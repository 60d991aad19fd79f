#!/usr/bin/env python
"""Convert a reference (ultralytics 8.0.201) checkpoint into the port's own
"torch" layout, without the reference's classes: the counterpart of
`tools/port_torch_weights.py`'s port direction, which writes an orbax
directory for the JAX package.

Usage:
  python tools/port_torch_weights_torch.py TAM_TR.pt tamtr_port.pt [--model tamtr.yaml]

The reference file is read by `tamtr_torch/weight_files.py:read_reference_checkpoint`
(its EMA, else its stripped model; no pickled code runs) and held to
`--model`'s state dict at the file's nc (keys and shapes, as
`Engine.load`); the output is `{"trainer": {"ema": state dict}, "meta": {nc,
names, model_cfg, imgsz (the file's `train_args["imgsz"]`), max_gt}}`, the
layout of `engine/exporter.py`'s "torch" format, which `AutoBackend`,
`serve`, `val` and `Engine.load` read with `torch.load(weights_only=True)`.
The weights are the file's, cast to fp32. `Engine.load` reads the reference file itself; the conversion is for
the readers that take only the port's layout.

`--export` (the other direction: the port's weights as a module
ultralytics' `attempt_load_weights` reads) raises: it needs the
reference's own classes, which the port does not use.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

import torch

EXPORT_NEEDS = ("writing a checkpoint that ultralytics' attempt_load_weights reads needs the reference's own "
                "classes (ultralytics.nn.tasks.RTDETRDetectionWorldModel and the modules of its config) to pickle "
                "the model as a module; tamtr_torch does not use them: run tools/port_torch_weights.py --export "
                "beside the reference tree")


def port(ref_path, out_path, model_cfg: str = "tamtr.yaml") -> Path:
    """Convert `ref_path` into the port's "torch" layout at `out_path`."""
    from tamtr_torch.nn.graph import TAMTRModel
    from tamtr_torch.weight_files import check_reference_state, is_reference_checkpoint, read_reference_checkpoint

    if not is_reference_checkpoint(ref_path):
        raise ValueError(f"{ref_path}: not a reference checkpoint (its pickle names only torch's weights-only "
                         "globals: the port's own layout already)")
    state, meta = read_reference_checkpoint(ref_path)
    nc = meta["nc"]
    if not nc:
        raise ValueError(f"{ref_path}: the checkpoint's model has no yaml nc")
    own = TAMTRModel.from_cfg(model_cfg, nc=nc).state_dict()
    check_reference_state(ref_path, state, own, f"{model_cfg} at nc={nc}")
    meta = {"nc": nc, "names": meta["names"] or [str(i) for i in range(nc)], "model_cfg": str(model_cfg),
            "imgsz": meta["imgsz"] or 640, "max_gt": 128}
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"trainer": {"ema": {**own, **state}}, "meta": meta}, out)  # the file's weights, the port's counters
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ref", nargs="?", help="the reference checkpoint (.pt)")
    ap.add_argument("out", nargs="?", help="the port-layout checkpoint to write (.pt)")
    ap.add_argument("--model", default="tamtr.yaml", help="the port's model config the file holds")
    ap.add_argument("--export", action="store_true", help="the other direction (not available: see the docstring)")
    a = ap.parse_args(argv)
    if a.export:
        raise NotImplementedError(EXPORT_NEEDS)
    if a.ref is None or a.out is None:
        ap.error("give the reference checkpoint and the file to write")
    out = port(a.ref, a.out, a.model)
    print(f"ported {a.ref} -> {out} ({out.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    sys.exit(main())
