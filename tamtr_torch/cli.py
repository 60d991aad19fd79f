"""CLI: `python -m tamtr_torch <task> <mode> k=v ...` (a port of the JAX
package's `tamtr_tpu/cli.py`, the reference's `yolo` entry point,
`cfg/__init__.py:entrypoint`).

    python -m tamtr_torch detect train model=tamtr.yaml data=visdrone.yaml epochs=300 batch=6
    python -m tamtr_torch detect val model=runs/detect/train/weights/best.pt data=visdrone.yaml
    python -m tamtr_torch detect predict model=runs/detect/train/weights/best.pt source=images/ save=True
    python -m tamtr_torch detect track model=runs/detect/train/weights/best.pt source=frames/ tracker=bytetrack
    python -m tamtr_torch segment train data=coco-seg.yaml epochs=100
    python -m tamtr_torch pose val model=runs/detect/train/weights/best.pt data=coco-pose.yaml
    python -m tamtr_torch classify train data=imagefolder/ epochs=10 imgsz=224
    python -m tamtr_torch serve model=runs/detect/train/weights/best.pt port=8000
    python -m tamtr_torch export model=runs/detect/train/weights/best.pt format=torch_export
    python -m tamtr_torch benchmark model=runs/detect/train/weights/best.pt
    python -m tamtr_torch tune model=tamtr.yaml data=visdrone.yaml iterations=10 epochs=10
    python -m tamtr_torch settings [reset] [key=value ...]

A positional task and mode, and `key=value` overrides. The model is a model
config (weights from `seed`) or a checkpoint written by `train`. Everything
runs on the card unless `device=cpu` is given. `predict` prints one line
per image; with save=True it writes each plot under `project/predict`
(default `runs/predict`) with the image's name and format. `track` prints
one line per frame of an image sequence (a directory, a glob or images):
its track count and ids; `tracker=botsort` takes `gmc_method=` (sparseOptFlow
by default, orb, sift, ecc or none).
`serve` serves a checkpoint over HTTP (`tamtr_torch.serve`). `settings`
prints the user settings (`utils/settings.py`), after setting the given
keys or, with `reset`, the defaults. `fuse=True` runs val, predict and
track on the fused model and `half=True` in bf16 (both may be set);
`bf16=True` trains in bf16 with fp32 weights; `batch=-1` fits train's
batch to the card. `segment` and `pose` run a segment or pose model
(`yolo-seg-gelan.yaml`, `yolo-pose-gelan.yaml` by default): val prints the
mask or keypoint mAP beside the box metrics. `classify` runs a classifier
(`classify-gelan.yaml`) on an ImageFolder root (`data=` holding `train/`
and `val/` or `test/`): val prints top-1 and top-5, predict one line an
image with its top class and probability. `export format=<torch | npz |
torch_export>` prints the artifact's path (format=savedmodel by default, as
the JAX CLI's, which needs tensorflow and raises; keys out_dir, imgsz,
half); `benchmark` prints one row per format (`utils/benchmarks.py`);
`tune iterations=N data=...` prints the best hyperparameters
(`Engine.tune`; isolate=True, use_ray=True). A video file (MP4, MOV, M4V,
AVI) is a source of `predict` and `track`; with save=true its annotated
frames go into one `.mp4` under project/name. Webcam and stream sources and
other video containers exit with a message naming their ROADMAP entry.

`device=0,1` (a list of card indices, as the reference takes it) shows the
process those cards alone (CUDA_VISIBLE_DEVICES) and trains on all of them:
one rank a card, started by `Engine.train(n_devices=...)`. Under
`python -m torch.distributed.run --nproc_per_node N -m tamtr_torch train
...` each rank joins the launcher's group instead; `fsdp=2` shards the
optimizer state and `sp=2` the SS2D token axes (`tamtr_torch/parallel/`).

`main` first installs the crash-report hook (`utils/crash.py`), which
writes a report of an unhandled exception when the settings' `sync` is on.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Any, Dict, List

TASKS = ("detect", "segment", "pose", "classify")
MODES = ("train", "val", "predict", "track", "export", "benchmark", "tune", "serve")

# default model config per task (detect is the flagship TAM-TR)
TASK_MODELS = {
    "detect": "tamtr.yaml",
    "segment": "yolo-seg-gelan.yaml",
    "pose": "yolo-pose-gelan.yaml",
    "classify": "classify-gelan.yaml",
}


def _parse_value(v: str) -> Any:
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    if v.lower() in ("none", "null"):
        return None
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


def parse_args(argv: List[str]):
    task, mode = "detect", None
    overrides: Dict[str, Any] = {}
    for a in argv:
        if "=" in a:
            k, v = a.split("=", 1)
            overrides[k] = _parse_value(v)
        elif a in TASKS:
            task = a
        elif a in MODES:
            mode = a
        elif a in ("-h", "--help", "help"):
            print(__doc__)
            raise SystemExit(0)
        elif a == "version":
            from tamtr_torch import __version__

            print(__version__)
            raise SystemExit(0)
        else:
            close = [m for m in MODES + TASKS if a in m]
            raise SystemExit(f"unknown argument {a!r}" + (f" (did you mean {close[0]!r}?)" if close else ""))
    if mode is None:
        raise SystemExit(f"specify a mode: {MODES}")
    return task, mode, overrides


def select_devices(device: Any) -> tuple:
    """(device, card indices) of a `device=` value: a list of card indices
    ("0,1") becomes "cuda" over those cards, made the only ones the process
    sees (CUDA_VISIBLE_DEVICES, before CUDA starts); anything else is kept
    as it is, with no indices."""
    if not (isinstance(device, str) and "," in device):
        return device, []
    ids = [int(x) for x in device.split(",") if x.strip()]
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(map(str, ids))
    return "cuda", ids


def settings_command(args: List[str]) -> None:
    """`settings [reset] [key=value ...]` (the JAX CLI's, the reference's
    `handle_yolo_settings`): reset, or set and save the keys, then print
    the settings as YAML."""
    from tamtr_torch.config import dump_flat_yaml
    from tamtr_torch.utils.settings import SettingsManager

    settings = SettingsManager()
    if args and args[0] == "reset":
        settings.reset()
        print("settings reset to defaults")
    elif args:
        settings.update({k: _parse_value(v) for k, v in (a.split("=", 1) for a in args)})
        settings.save()
    print(dump_flat_yaml(dict(settings)))


def main(argv: List[str] | None = None) -> None:
    from tamtr_torch.utils.crash import set_crash_reporting

    set_crash_reporting()
    argv = argv if argv is not None else sys.argv[1:]
    if argv and argv[0] == "settings":
        settings_command(argv[1:])
        return
    task, mode, ov = parse_args(argv)
    source = ov.get("source")
    if mode in ("predict", "track") and source is not None:
        from tamtr_torch.data.loaders import unsupported_source

        why = unsupported_source(str(source))
        if why:
            raise SystemExit(f"{why} (ROADMAP.md queue A, item 2)")
    device, cards = select_devices(ov.pop("device", None))
    if mode == "train" and len(cards) > 1:
        ov.setdefault("n_devices", len(cards))
    if mode == "serve":
        from tamtr_torch.serve import serve_checkpoint

        if "model" not in ov:
            raise SystemExit("serve requires model=<checkpoint>, e.g. "
                             "`python -m tamtr_torch serve model=runs/detect/train/weights/best.pt port=8000`")
        srv = serve_checkpoint(str(ov.pop("model")), endpoint=str(ov.pop("endpoint", "tamtr")),
                               host=str(ov.pop("host", "127.0.0.1")), port=int(ov.pop("port", 8000)),
                               nc=ov.pop("nc", None), imgsz=ov.pop("imgsz", None), device=device)
        print(f"serving at {srv.url}", flush=True)
        srv.serve_forever()
        return
    from tamtr_torch import TAMTR

    model_arg = str(ov.pop("model", TASK_MODELS[task]))
    is_cfg = model_arg.endswith((".yaml", ".yml", ".json"))
    kw = {"imgsz": ov["imgsz"]} if "imgsz" in ov else {}
    model = TAMTR(model_arg if is_cfg else TASK_MODELS[task], device=device, seed=ov.get("seed", 0), **kw)
    if not is_cfg:
        # nc= / names= help load checkpoints without that metadata
        names = ov.pop("names", None)
        model.load(model_arg, nc=ov.pop("nc", None), names=names.split(",") if isinstance(names, str) else names)
    if mode == "train":
        print(model.train(**ov))
    elif mode == "val":
        print(model.val(**ov))
    elif mode == "predict":
        source = ov.pop("source", None)
        if source is None:
            raise SystemExit("predict requires source=<image, directory, glob or video>")
        save = ov.pop("save", False)
        out = Path(ov.get("project") or "runs") / "predict"
        from tamtr_torch.data.loaders import is_video

        video = is_video(str(source))
        if video:  # the annotated frames go into one .mp4 under project/name
            ov["save"] = save
        for r in model.predict(source, **ov):
            if isinstance(r, dict):  # a classifier's probabilities
                print(f"{r['path']}: {r['names'][0]} {r['top5_conf'][0]:.4f}", flush=True)
                continue
            print(f"{r.path}: {len(r)} detections", flush=True)
            if save and not video:
                r.save(out / Path(r.path).name)
    elif mode == "track":
        source = ov.pop("source", None)
        if source is None:
            raise SystemExit("track requires source=<directory, glob, images or video>")
        for r in model.track(source, tracker=ov.pop("tracker", "bytetrack"), **ov):
            print(f"{r.path}: {len(r.track_ids)} tracks {sorted(set(r.track_ids.tolist()))}", flush=True)
    elif mode == "export":
        ov.pop("seed", None)
        print(model.export(ov.pop("format", "savedmodel"), **ov))
    elif mode == "benchmark":
        from tamtr_torch.utils.benchmarks import benchmark

        ov.pop("seed", None)
        model.model  # noqa: B018  (the seeded model of a config)
        for row in benchmark(model._lazy_engine(), **ov):
            print(row, flush=True)
    elif mode == "tune":
        print(model.tune(int(ov.pop("iterations", 10)), **ov))


if __name__ == "__main__":
    main()
