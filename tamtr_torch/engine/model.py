"""Engine: train, val and predict of the TAM-TR detector (a port of the
JAX package's `tamtr_tpu/engine/model.py`: `Engine.train`, `val`,
`_validate`, `predict`, `load` and `set_classes`, for the DETR heads and
the YOLO `Detect` head; a DualRTDETRDecoder, whose eval gives two
predictions, only through the model and `Trainer.step`: `refuse_dual`).

    train(data=...): DetectionDataset + Loader -> Trainer.step per batch
      -> every val_interval epochs _validate with the EMA weights
      -> a results.csv row, checkpoints `last` and `best`, resume
    val(data=...): the same _validate on loaded weights
    predict(source): image files -> the eval forward (with TTA when
      augment=True) -> NMS -> `Results` in the images' pixels
    track(source): a sequence of frames -> the eval forward -> a tracker

val, predict and track run the fused twin of the model under fuse=True
(`nn/fuse.py`), and a twin computing in bf16 under half=True (fused first
when both are set); train(bf16=True) trains a model computing in bf16
with fp32 parameters (`nn/graph.py:TAMTRModel.dtype`), so its EMA and
checkpoint weights are fp32 too. train(batch=-1) fits the batch to the
card's memory (`utils/autobatch.py`). With plots=True (the default) train writes
`train_batch0-2.jpg`, `results.png` and, from val, `confusion_matrix.png`
into its run directory, and logs to TensorBoard under `tb/` when it is
installed; the other logger integrations attach as the settings allow
(`utils/callbacks.py`, `utils/settings.py`).

Several GPUs (the JAX package's mesh, `parallel/dist.py`): under a
launcher (`python -m torch.distributed.run --nproc_per_node N -m
tamtr_torch train ...`) train joins the process group it finds, one rank a
card; `train(n_devices=N)` in a plain process starts the N ranks itself
(`parallel/launch.py`) and then holds the trained model. The global batch
is split over the data ranks, and each loader takes its shard of the
images; `fsdp>1` shards the optimizer state (ZeRO-1) and `sp>1` cuts the
SS2D token axes over groups of sp ranks (`parallel/seq_scan.py`). Rank 0
alone writes checkpoints, results.csv and plots and fires the callbacks.
Val is data-parallel: each rank runs every world-size-th batch and rank 0
gathers the per-image statistics, so the metrics are the one-process
run's.

A Detect model (`yolo-gelan.yaml`) trains with the v8 loss (TAL, BCE,
CIoU, DFL; `train/trainer.py:loss_config_for`, the JAX engine's
`_loss_callable_for`) on batches without sampled texts (the loader draws
them only for a head that `uses_text`); its pixel boxes are scaled by the
input size before the postprocess, and rect val letterboxes for it alone.
A Segment model (`yolo-seg-gelan.yaml`) is the segment task and a Pose
model (`yolo-pose-gelan.yaml`) the pose task, as the JAX engine picks them
by head (`TASKS`): the dataset reads polygon or keypoint labels, the batch
carries gt masks or keypoints into the v8 segmentation or pose loss, and
val adds mask_mAP50 / mask_mAP50-95 (masks of the kept rows, sigmoid of
coefficients x protos > 0.5, against each gt polygon filled at the image's
size and resized to the protos' size) or pose_mAP50 / pose_mAP50-95
(keypoints matched by OKS) beside the box metrics. Predict gives a segment
model's `Results` its masks (not with TTA), as the JAX engine does; a pose
model's carry boxes only (the JAX engine hands its keypoints to `Results`
as masks, a fault the port does not copy).

A Classify model (`classify-gelan.yaml`) is the classify task, as the JAX
engine's `_train_classify`, `_validate_classify` and `_predict_classify`
(`tamtr_tpu/engine/model.py:424-625`): an ImageFolder directory
(`train/`, and `val/` or `test/`), imgsz 640 meaning 224, the softmax
cross-entropy step, top-1 / top-5 val (fitness top-1), and predict giving
one dict a image: path, probs, top5, top5_conf, names.

`export` writes the model in one of the exporter's formats
(`engine/exporter.py`); `tune` evolves the training hyperparameters over
short trainings (`engine/tuner.py`), in this process or one subprocess a
trial.

The engine runs on the card unless `device="cpu"` is given (then the ranks
meet over gloo). Not ported: video and stream sources.
"""

from __future__ import annotations

import csv
import signal
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from tamtr_torch.config import Config, get_cfg, load_data_yaml
from tamtr_torch.data.dataset import (AugConfig, ClassificationDataset, ClassificationLoader, DetectionDataset,
                                      Loader, center_crop_resized)
from tamtr_torch.data.image_io import imread
from tamtr_torch.data.imgproc import fill_poly, resize_linear, resize_linear_f32
from tamtr_torch.data.loaders import is_video, load_inference_source, unsupported_source
from tamtr_torch.data.video_io import video_fps
from tamtr_torch.data.text import TextEmbedder, class_text_embeddings
from tamtr_torch.engine.checkpoint import load_checkpoint, load_checkpoint_raw, save_checkpoint
from tamtr_torch.losses.v8_pose_loss import keypoint_sigmas
from tamtr_torch.nn.graph import TEXT_WIDTH, YOLO_HEADS, TAMTRModel, head_type_of
from tamtr_torch.engine.results import AnnotatedVideoWriter, Results
from tamtr_torch.nn.fuse import fuse_model
from tamtr_torch.ops.nms import multiclass_nms, postprocess_predictions
from tamtr_torch.parallel.dist import broadcast_from_rank0, gather_to_rank0, init_distributed, make_groups
from tamtr_torch.train.trainer import REPORTED, Trainer, TrainConfig, loss_config_for
from tamtr_torch.utils.callbacks import Callbacks, add_tensorboard, attach_integrations
from tamtr_torch.utils.checks import check_imgsz
from tamtr_torch.utils.coco import predictions_to_coco
from tamtr_torch.utils.files import increment_path
from tamtr_torch.utils.log import LOGGER
from tamtr_torch.utils.metrics import ConfusionMatrix, DetMetrics, mask_iou_np, match_predictions, oks_np
from tamtr_torch.utils.plotting import plot_images, plot_results
from tamtr_torch.utils.settings import SettingsManager
from tamtr_torch.weights import init_parameters


class EarlyStopping:
    """Stop after `patience` epochs without fitness improvement; patience
    <= 0 disables it."""

    def __init__(self, patience: int = 0):
        self.patience = patience or float("inf")
        self.best_fitness = 0.0
        self.best_epoch = 0

    def __call__(self, epoch: int, fitness: float) -> bool:
        if fitness >= self.best_fitness:
            self.best_fitness = fitness
            self.best_epoch = epoch
        return (epoch - self.best_epoch) >= self.patience


def to_image_pixels(boxes: np.ndarray, input_hw, orig_hw, lb=None) -> np.ndarray:
    """Normalized xyxy boxes of an (h, w) network input in the (oh, ow)
    image's own pixels: the square stretch undone, or with `lb` = (ratio,
    left, top) of a rect val batch the letterbox undone and the boxes
    clipped to the image."""
    oh, ow = orig_hw
    if lb is None:
        return boxes * np.array([ow, oh, ow, oh], np.float32)
    ratio, left, top = lb
    bh, bw = input_hw
    pb = boxes * np.array([bw, bh, bw, bh], np.float32)
    pb = (pb - np.array([left, top, left, top], np.float32)) / ratio
    return pb.clip(0, [ow, oh, ow, oh])


# the task of each head that is not the detect task (`tamtr_tpu/engine/model.py:173, 777`)
TASKS = {"Segment": "segment", "Pose": "pose"}


def task_of(model: TAMTRModel) -> str:
    """"segment", "pose" or "detect", by the model's head."""
    return TASKS.get(model.head_type, "detect")


def classify_imgsz(imgsz: int) -> int:
    """A classifier's input size: imgsz, with the detectors' default 640
    meaning 224 (`tamtr_tpu/engine/model.py:433`)."""
    return imgsz if imgsz != 640 else 224


def classify_split(root: Path, fallback: Optional[Path] = None) -> Optional[Path]:
    """The val split of an ImageFolder root: `val/`, else `test/`, else
    `fallback`."""
    return next((root / s for s in ("val", "test") if (root / s).is_dir()), fallback)


def normalized_pred(model: TAMTRModel, pred: torch.Tensor, input_hw) -> torch.Tensor:
    """The eval "pred" with its boxes normalized: a pixel head's (Detect,
    Segment, Pose) divided by the (h, w) input size, as the JAX engine's
    eval step scales them (`tamtr_tpu/engine/model.py:741-752`); a DETR
    head's as they are."""
    if model.head_type not in YOLO_HEADS:
        return pred
    h, w = input_hw
    scale = pred.new_ones(pred.shape[-1])
    scale[:4] = torch.tensor([1.0 / w, 1.0 / h, 1.0 / w, 1.0 / h], dtype=pred.dtype)
    return pred * scale


def kept_extras(model: TAMTRModel, out: Dict[str, torch.Tensor], kept: torch.Tensor) -> Optional[torch.Tensor]:
    """What the JAX engine's eval step adds for the postprocess's kept rows
    `kept` (B, max_det) (`tamtr_tpu/engine/model.py:757-768`): a Segment
    model's mask probabilities (B, max_det, Hm, Wm), the sigmoid of the
    rows' coefficients times the protos in fp32; a Pose model's keypoints
    (B, max_det, nk, kdim) in input pixels; else None."""
    idx = kept.long()
    if model.head_type == "Segment":
        coefs = out["mask_coefs"].float().gather(1, idx[..., None].expand(-1, -1, out["mask_coefs"].shape[-1]))
        return torch.sigmoid(torch.einsum("bkn,bnhw->bkhw", coefs, out["protos"].float()))
    if model.head_type == "Pose":
        k = out["keypoints"]
        return k.gather(1, idx[:, :, None, None].expand(-1, -1, *k.shape[2:]))
    return None


def gt_mask_tp(pm: np.ndarray, raw, pb: np.ndarray, pc: np.ndarray) -> np.ndarray:
    """The mask TP table of one image: predicted masks `pm` (n, Hm, Wm)
    bool against each gt polygon of `raw` filled at the image's size
    (`imgproc.fill_poly`), resized to (Hm, Wm) as float32 and thresholded at
    0.5 (`tamtr_tpu/engine/model.py:891-909`)."""
    hm, wm = pm.shape[-2:] if len(pm) else (2, 2)
    gm = np.stack([resize_linear_f32(fill_poly(np.zeros(raw.img.shape[:2], np.float32),
                                                   np.asarray(seg).astype(np.int32), 1.0), (wm, hm)) > 0.5
                   for seg in raw.segments]) if raw.segments else np.zeros((0, hm, wm), bool)
    if not (len(gm) and len(pm)):
        return np.zeros((len(pc), 10), bool)
    return match_predictions(pb, pc, raw.boxes, raw.cls.astype(np.float32), iou=mask_iou_np(gm, pm))


def gt_pose_tp(pk: np.ndarray, raw, pb: np.ndarray, pc: np.ndarray, orig_hw, imgsz: int) -> np.ndarray:
    """The keypoint TP table of one image: predicted keypoints `pk` (n, nk,
    3) at imgsz scale, stretched to the image's (h, w), matched by OKS
    (`OKS_SIGMA`, the gt boxes' areas at least 1) against its gt keypoints
    (`tamtr_tpu/engine/model.py:870-890`)."""
    oh, ow = orig_hw
    pk = pk.copy()
    pk[..., 0] *= ow / imgsz
    pk[..., 1] *= oh / imgsz
    gk = raw.keypoints if raw.keypoints is not None else np.zeros((0, 17, 3), np.float32)
    areas = np.clip((raw.boxes[:, 2] - raw.boxes[:, 0]) * (raw.boxes[:, 3] - raw.boxes[:, 1]), 1, None)
    if not (len(gk) and len(pk)):
        return np.zeros((len(pc), 10), bool)
    oks = oks_np(gk, pk, areas, keypoint_sigmas(gk.shape[1]))
    return match_predictions(pb, pc, raw.boxes, raw.cls.astype(np.float32), iou=oks)


def refuse_dual(model: TAMTRModel) -> None:
    """The engine takes one prediction per image; a DualRTDETRDecoder gives
    two (its eval "pred" is a list). The JAX engine reads it as one array
    and fails (`tamtr_tpu/engine/model.py:599, 743`), so the port runs a
    Dual model through its forward and `Trainer.step` only."""
    if model.head_type == "DualRTDETRDecoder":
        raise NotImplementedError("a DualRTDETRDecoder model gives two predictions per image: the engine's train, "
                                  "val, predict and track take one (as the JAX engine's); call the model or "
                                  "Trainer.step")


def weights_key(model: torch.nn.Module) -> tuple:
    """What changes when `model`'s weights do: the model, and each parameter
    and buffer's storage and version counter (which every in-place write,
    an optimizer or EMA step or `load_state_dict`, advances). Tensors made
    under inference mode carry no counter and count by storage alone."""
    return (id(model),) + tuple((t.data_ptr(), -1 if t.is_inference() else t._version)
                                for m in model.modules() for d in (m._parameters, m._buffers)
                                for t in d.values() if t is not None)


class _TrainTask(NamedTuple):
    """What `Engine._train`'s epoch loop takes from one task."""

    train_ds: Any  # its `close_mosaic`, where it has one, runs for the last close_mosaic epochs
    loader: Any
    to_step: Callable[[Dict[str, Any]], Dict[str, Any]]  # a loader batch -> `Trainer.step`'s batch
    validate: Optional[Callable[[TAMTRModel], Dict[str, float]]]  # the EMA's val metrics; None: no val split
    fitness: str  # the val metric that picks best.pt and stops early
    reported: Tuple[str, ...]  # the step's metrics in the results.csv row
    project: str  # the runs' directory when no project= is given
    plot_batches: bool  # plots=True draws the first three batches with their boxes


class Engine:
    """Trains and validates one model config on datasets.

    After `train`, `model` is the EMA model (eval mode) and `trainer` the
    last run's `Trainer`; after `load`, `model` holds a checkpoint's EMA
    weights; a caller may also set `model` itself (`TAMTR` does). `txt_feats` (K, hd) are the class text embeddings val scores
    against; `set_classes` replaces them."""

    def __init__(self, model_cfg: str = "tamtr.yaml",
                 device: Optional[Union[str, torch.device]] = None) -> None:
        if device is None and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        self.device = torch.device("cuda" if device is None else device)
        self.model_cfg = model_cfg
        self.model: Optional[TAMTRModel] = None
        self.trainer: Optional[Trainer] = None
        self.names: List[str] = []
        self.txt_feats: Optional[np.ndarray] = None
        self.cfg: Optional[Config] = None
        self.callbacks = Callbacks()
        self.timing: Dict[str, List[float]] = {}
        self._tracker = None  # `track`'s, kept across calls with persist=True
        self._fused = None  # (weights_key, fused twin) of the last fuse=True call
        self._last_run_dir: Optional[Path] = None  # val's plots go here after a train

    # ------------------------------------------------------------------ train
    def train(self, **overrides: Any) -> Dict[str, float]:
        cfg = get_cfg(overrides=overrides)
        self.cfg = cfg
        if not cfg.data:
            raise ValueError("train requires data=...")
        if cfg.batch < 1 and cfg.batch != -1:
            raise ValueError(f"batch={cfg.batch}: give a batch size, or -1 to fit it to the card's memory")
        dev = init_distributed(self.device)
        if dev is None and (cfg.n_devices or 1) > 1:
            return self._spawn(cfg, overrides)
        if dev is not None:
            self.device = dev
        world = dist.get_world_size() if dev is not None else 1
        sp = max(int(cfg.sp or 1), 1)
        if cfg.n_devices and cfg.n_devices != world:
            raise ValueError(f"n_devices={cfg.n_devices}, but {world} ranks run: start n_devices ranks")
        if world % sp:
            raise ValueError(f"{world} devices not divisible by sp={sp}")
        groups = make_groups(sp) if dev is not None else None
        n_data = world // sp
        if cfg.batch != -1 and cfg.batch % n_data:
            raise ValueError(f"batch {cfg.batch} must divide over {n_data} data-parallel devices")
        # SIGTERM / SIGINT set a flag; the epoch loop saves `last` and stops,
        # so resume=True continues from the interrupted epoch
        preempted = {"flag": False}

        def _on_signal(signum, frame):
            preempted["flag"] = True
            LOGGER.warning(f"signal {signum}: will checkpoint and stop at the next epoch boundary")

        old_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, _on_signal)
            except ValueError:  # not the main thread
                pass
        try:
            return self._train(cfg, preempted, groups)
        finally:
            for sig, h in old_handlers.items():
                signal.signal(sig, h)

    def _spawn(self, cfg: Config, overrides: Dict[str, Any]) -> Dict[str, float]:
        """`train` on cfg.n_devices ranks started here with
        `torch.distributed.run` (as the reference's `utils/dist.py` starts
        its DDP run), each running `parallel/launch.py`; then the trained
        EMA weights of the run's `last.pt` (when it saved one) are this
        engine's model. Returns rank 0's metrics."""
        import json
        import os
        import subprocess
        import sys
        import tempfile

        from tamtr_torch.parallel.dist import free_port

        with tempfile.TemporaryDirectory() as tmp:
            spec, out = Path(tmp) / "spec.json", Path(tmp) / "out.json"
            spec.write_text(json.dumps({"model_cfg": str(self.model_cfg), "device": self.device.type,
                                        "overrides": overrides, "out": str(out)}, default=str))
            root = str(Path(__file__).resolve().parents[2])
            env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")]))}
            cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(cfg.n_devices),
                   "--master_addr", "127.0.0.1", "--master_port", str(free_port()),
                   "-m", "tamtr_torch.parallel.launch", str(spec)]
            rc = subprocess.run(cmd, env=env).returncode
            if rc != 0:
                raise RuntimeError(f"training on {cfg.n_devices} ranks failed (exit code {rc}): {' '.join(cmd)}")
            result = json.loads(out.read_text())
        self._last_run_dir = Path(result["run_dir"])
        last = self._last_run_dir / "weights" / "last.pt"
        if last.exists():
            self.load(last)
            self.txt_feats = class_text_embeddings(self.names, npz_path=cfg.text_embeddings,
                                                   dim=self.model.text_width)
        return result["metrics"]

    def _train(self, cfg: Config, preempted: Dict[str, bool], groups=None) -> Dict[str, float]:
        """The epoch loop of every task on the parts of `_detect_task` or
        `_classify_task`: `Trainer.step` on each loader batch, every
        val_interval epochs val of the EMA, a results.csv row, `last.pt`
        every save_interval epochs and `best.pt` by the task's fitness,
        early stopping, the preemption save; resume=True goes on from
        `last.pt`."""
        dev = self.device
        rank0 = groups is None or dist.get_rank() == 0
        n_data = groups.data_size if groups is not None else 1
        fire = self.callbacks.fire if rank0 else (lambda *a, **k: None)
        make = self._classify_task if head_type_of(self.model_cfg) == "Classify" else self._detect_task
        model, task = make(cfg, groups, n_data)
        nc, loader = model.nc, task.loader
        tc = TrainConfig(
            lr0=cfg.lr0, lrf=cfg.lrf, momentum=cfg.momentum, weight_decay=cfg.weight_decay,
            warmup_iters=int(cfg.warmup_epochs), warmup_bias_lr=cfg.warmup_bias_lr, epochs=cfg.epochs,
            warmup_momentum=cfg.warmup_momentum, batch_size=cfg.batch, nbs=cfg.nbs,
            match_method=cfg.match_method,
        )
        loss_cfg = loss_config_for(model, nc, imgsz=cfg.imgsz, box=cfg.box, cls=cfg.cls, dfl=cfg.dfl,
                                   match_method=cfg.match_method, pose=cfg.pose, kobj=cfg.kobj)
        trainer = Trainer(model, tc, loss_cfg=loss_cfg, steps_per_epoch=max(len(loader), 1), device=dev,
                          seed=cfg.seed + 1, groups=groups, zero=int(cfg.fsdp or 1) > 1)
        self.trainer = trainer
        self.model = trainer.ema

        run_dir = Path(cfg.project or task.project) / (cfg.name or "train")
        if rank0:
            if not cfg.resume and not cfg.exist_ok:
                run_dir = increment_path(run_dir)
            run_dir.mkdir(parents=True, exist_ok=True)
        if groups is not None:
            run_dir = broadcast_from_rank0(run_dir)
        self._last_run_dir = run_dir
        if rank0:
            if cfg.plots:
                add_tensorboard(self.callbacks, str(run_dir / "tb"))
            # the settings gate the other integrations; TensorBoard goes with plots above
            attach_integrations(self.callbacks, run_dir, settings={**SettingsManager(), "tensorboard": False})
        csv_path = run_dir / "results.csv"
        start_epoch = 0
        last = run_dir / "weights" / "last.pt"
        if cfg.resume and last.exists():
            meta = load_checkpoint(last, trainer)
            start_epoch = int(meta.get("epoch", -1)) + 1
            LOGGER.info(f"resumed from epoch {start_epoch}")
        stopper = EarlyStopping(cfg.patience)
        best_fitness = 0.0
        meta = {"nc": nc, "names": self.names, "model_cfg": str(self.model_cfg), "imgsz": cfg.imgsz,
                "max_gt": cfg.max_gt}
        self.timing = {"step_ms": [], "wait_ms": []}

        if rank0:
            LOGGER.info(f"training {self.model_cfg}: nc={nc} imgsz={cfg.imgsz} batch={cfg.batch} "
                        f"device={dev} ranks={dist.get_world_size() if groups else 1} steps/epoch={len(loader)}")
        fire("on_train_start", self)
        metrics_out: Dict[str, float] = {}
        m: Dict[str, float] = {}
        for epoch in range(start_epoch, cfg.epochs):
            self._cur_epoch = epoch
            fire("on_train_epoch_start", self, epoch)
            if cfg.close_mosaic and epoch == cfg.epochs - cfg.close_mosaic and hasattr(task.train_ds, "close_mosaic"):
                task.train_ds.close_mosaic()
            loader.set_epoch(epoch)
            t0 = time.time()
            n_steps = 0
            batches = iter(loader)
            while True:
                tw = time.perf_counter()
                batch = next(batches, None)  # the host waits on the loader here
                ts = time.perf_counter()
                if batch is None:
                    break
                if cfg.plots and task.plot_batches and rank0 and epoch == start_epoch and n_steps < 3:
                    self._plot_batch(batch, run_dir / f"train_batch{n_steps}.jpg")
                m = trainer.step(task.to_step(batch))  # ends in host reads of the metrics: the device has finished
                self.timing["wait_ms"].append((ts - tw) * 1e3)
                self.timing["step_ms"].append((time.perf_counter() - ts) * 1e3)
                n_steps += 1
                fire("on_train_batch_end", self, n_steps)
            ips = n_steps * cfg.batch / max(time.time() - t0, 1e-9)
            comp = {k: m[k] for k in task.reported if k in m}
            if rank0:
                LOGGER.info(f"epoch {epoch + 1}/{cfg.epochs}: loss={m.get('loss', float('nan')):.3f} "
                            + " ".join(f"{k}={v:.3f}" for k, v in comp.items()) + f" {ips:.1f} img/s")
            row = {"epoch": epoch + 1, "loss": m.get("loss", float("nan")), **comp, "img_per_sec": ips}
            run_val = (epoch + 1) % max(cfg.val_interval, 1) == 0 or epoch == cfg.epochs - 1
            fitness = None
            if cfg.val and task.validate is not None and run_val:
                metrics_out = task.validate(trainer.ema)
                row.update(metrics_out)
                fitness = metrics_out.get(task.fitness, 0.0)
            if cfg.save:
                run_save = (epoch + 1) % max(cfg.save_interval, 1) == 0 or epoch == cfg.epochs - 1
                if run_save:
                    save_checkpoint(last, trainer, {"epoch": epoch, **meta})
                is_best = fitness is not None and fitness >= best_fitness
                if is_best:
                    best_fitness = fitness
                    save_checkpoint(run_dir / "weights" / "best.pt", trainer, {"epoch": epoch, **meta})
                if run_save or is_best:
                    fire("on_model_save", self, epoch, last, is_best)
            if fitness is not None and stopper(epoch, fitness):
                LOGGER.info(f"early stopping at epoch {epoch + 1}")
                if rank0:
                    self._append_csv(csv_path, row)
                break
            if rank0:
                self._append_csv(csv_path, row)
            fire("on_fit_epoch_end", self, epoch, row)
            if groups is not None:  # a signal stops every rank at the same epoch
                flag = torch.tensor([float(preempted["flag"])], device=dev)
                dist.all_reduce(flag, op=dist.ReduceOp.MAX)
                preempted["flag"] = bool(flag.item())
            if preempted["flag"]:
                if cfg.save:
                    save_checkpoint(last, trainer, {"epoch": epoch, **meta})
                    LOGGER.info("preemption checkpoint saved; resume with resume=True")
                break
        if cfg.plots and rank0:
            plot_results(csv_path)
        fire("on_train_end", self, metrics_out, run_dir)
        fire("teardown", self)
        return metrics_out

    def _fit_batch(self, cfg: Config, nc: int, groups, n_data: int) -> None:
        """batch=-1: the batch fitted to the card by two probe training
        steps (`autobatch_train`), the card's batch on every data rank."""
        if cfg.batch == -1:
            from tamtr_torch.utils.autobatch import autobatch_train

            cfg.batch = autobatch_train(self.model_cfg, nc, cfg.imgsz, cfg.max_gt, device=self.device, default=4)
            if groups is not None:
                cfg.batch = broadcast_from_rank0(cfg.batch) * n_data

    def _detect_task(self, cfg: Config, groups, n_data: int):
        """The seeded model and the `_TrainTask` of a detection, segment or
        pose run on a dataset file."""
        data = load_data_yaml(cfg.data)
        nc = data["nc"]
        self.names = data["names"]
        cfg.imgsz = check_imgsz(cfg.imgsz, stride=32)
        self._fit_batch(cfg, nc, groups, n_data)
        model = TAMTRModel.from_cfg(self.model_cfg, nc=nc, max_gt=cfg.max_gt,
                                    dtype=torch.bfloat16 if cfg.bf16 else None)
        refuse_dual(model)
        init_parameters(model, cfg.seed)
        width = model.text_width
        self.txt_feats = class_text_embeddings(self.names, npz_path=cfg.text_embeddings, dim=width)

        aug = AugConfig(
            mosaic=cfg.mosaic, mixup=cfg.mixup, copy_paste=cfg.copy_paste, degrees=cfg.degrees,
            translate=cfg.translate, scale=cfg.scale, shear=cfg.shear, perspective=cfg.perspective,
            hsv_h=cfg.hsv_h, hsv_s=cfg.hsv_s, hsv_v=cfg.hsv_v, fliplr=cfg.fliplr, flipud=cfg.flipud,
        )
        # RandomLoadText: per-image positive/negative text sampling and class remap;
        # the task's labels (kpt_shape stays the dataset's default, as the JAX engine's)
        train_ds = DetectionDataset(
            data["train"], imgsz=cfg.imgsz, augment=True, aug=aug, seed=cfg.seed, task=task_of(model),
            class_texts=[str(n).split("/") for n in self.names], random_text=model.uses_text,
            cache=cfg.cache, classes=cfg.classes, single_cls=cfg.single_cls,
        )
        loader = Loader(train_ds, cfg.batch // n_data, max_gt=cfg.max_gt, seed=cfg.seed, workers=cfg.workers,
                        pin_memory=self.device.type == "cuda", process_index=groups.data_rank if groups else 0,
                        process_count=n_data)
        txt = np.tile(self.txt_feats[None], (cfg.batch // n_data, 1, 1)).astype(np.float32)
        text_embedder = TextEmbedder(npz_path=cfg.text_embeddings, dim=width)

        def to_step(batch):
            return {
                "img": batch["img"],
                # per-image sampled texts (RandomLoadText) when present, else the class table
                "txt_feats": text_embedder(batch["texts"]) if "texts" in batch else txt,
                "cls": batch["cls"], "bboxes": batch["bboxes"], "mask": batch["mask"],
                **{k: batch[k] for k in ("masks", "keypoints") if k in batch},
            }

        validate = (lambda ema: self._validate(ema, data, cfg)) if data.get("val") else None
        return model, _TrainTask(train_ds, loader, to_step, validate, fitness="fitness", reported=REPORTED,
                                 project="runs/detect", plot_batches=True)

    def _classify_task(self, cfg: Config, groups, n_data: int):
        """The seeded model and the `_TrainTask` of a classification run
        (the JAX engine's `_train_classify`): `ClassificationDataset(data/
        train)` at `classify_imgsz`, nc and names from its class folders,
        max_gt 1, no text; the `ClassificationLoader`'s batches through the
        cross-entropy step, the row without the step's metrics (as JAX's),
        top-1 / top-5 val of `val/` (or `test/`) with fitness top-1, the
        runs under runs/classify. On several ranks each takes its shard of
        the images and every rank validates the whole split."""
        root = Path(cfg.data)
        cfg.imgsz, cfg.max_gt = classify_imgsz(cfg.imgsz), 1
        train_ds = ClassificationDataset(root / "train", imgsz=cfg.imgsz, augment=True, seed=cfg.seed)
        val_dir = classify_split(root)
        nc = len(train_ds.names)
        self.names = train_ds.names
        self.txt_feats = np.zeros((1, TEXT_WIDTH), np.float32)
        self._fit_batch(cfg, nc, groups, n_data)
        model = TAMTRModel.from_cfg(self.model_cfg, nc=nc, max_gt=1, dtype=torch.bfloat16 if cfg.bf16 else None)
        init_parameters(model, cfg.seed)
        loader = ClassificationLoader(train_ds, cfg.batch // n_data, seed=cfg.seed,
                                      process_index=groups.data_rank if groups else 0, process_count=n_data)
        txt = np.zeros((1, 1, TEXT_WIDTH), np.float32)

        def to_step(batch):
            b = len(batch["cls"])
            return {"img": batch["img"], "txt_feats": txt, "cls": batch["cls"],
                    "bboxes": np.zeros((b, 1, 4), np.float32), "mask": np.zeros((b, 1), bool)}

        validate = (lambda ema: self._validate_classify(ema, val_dir, cfg, cfg.imgsz)) if val_dir else None
        return model, _TrainTask(train_ds, loader, to_step, validate, fitness="top1", reported=(),
                                 project="runs/classify", plot_batches=False)

    def _plot_batch(self, batch: Dict[str, Any], path: Path) -> None:
        """The training batch's mosaic with its labels (`plot_images`); a
        failure is logged and training goes on."""
        cls, mask = np.asarray(batch["cls"]), np.asarray(batch["mask"]).reshape(-1)
        bi = np.repeat(np.arange(len(cls)), cls.shape[1])
        try:
            plot_images(np.asarray(batch["img"]), bi[mask], cls.reshape(-1)[mask],
                        np.asarray(batch["bboxes"]).reshape(-1, 4)[mask], names=self.names, save_path=path)
        except (OSError, ValueError) as e:
            LOGGER.warning(f"{path.name} not written: {e}")

    # --------------------------------------------------------------- classify
    @torch.inference_mode()
    def _validate_classify(self, model: TAMTRModel, val_dir: Path, cfg: Config, imgsz: int) -> Dict[str, float]:
        """Top-1 and top-5 accuracy of `model` on an ImageFolder split (the
        JAX engine's `_validate_classify`): the eval transform, batches of
        cfg.batch (the last one as it is: padding it, as the JAX engine's
        static shapes need, changes no prediction), a hit when the label is
        first, or among the first min(5, nc), of `argsort(-logits)`."""
        ds = ClassificationDataset(val_dir, imgsz=imgsz, augment=False)
        model = self._eval_model(model, cfg)
        dev = next(model.parameters()).device
        txt = torch.zeros(1, 1, TEXT_WIDTH, device=dev)
        bs = max(cfg.batch, 1)
        top1 = top5 = total = 0
        for s in range(0, len(ds), bs):
            imgs, labels = zip(*(ds.get(i) for i in range(s, min(s + bs, len(ds)))))
            logits = model(torch.from_numpy(np.stack(imgs)).to(dev), txt)["logits"].float().cpu().numpy()
            k = min(5, logits.shape[-1])
            for row, lab in zip(logits, labels):
                order = np.argsort(-row)
                top1 += int(order[0] == lab)
                top5 += int(lab in order[:k])
                total += 1
        res = {"top1": top1 / max(total, 1), "top5": top5 / max(total, 1)}
        LOGGER.info(f"classify val: top1={res['top1']:.4f} top5={res['top5']:.4f} ({total} imgs)")
        return res

    @torch.inference_mode()
    def _predict_classify(self, source: Any, cfg: Config) -> List[Dict[str, Any]]:
        """Class probabilities of each image of `source` (arrays, files, a
        directory or a glob; the JAX engine's `_predict_classify`): the BGR
        image's short side resized to `classify_imgsz` and centre-cropped
        (`center_crop_resized`), RGB in [0, 1], the eval forward's softmax.
        One dict an image: path, probs (nc,), top5 (the first five of
        argsort(-probs)), top5_conf and their names."""
        imgsz = classify_imgsz(cfg.imgsz)
        model = self._eval_model(self.model, cfg)
        dev = next(model.parameters()).device
        txt = torch.zeros(1, 1, TEXT_WIDTH, device=dev)
        out = []
        for name, frame in load_inference_source(source):
            img = center_crop_resized(frame, imgsz)[..., ::-1].astype(np.float32) / 255.0
            probs = model(torch.from_numpy(np.ascontiguousarray(img)[None]).to(dev), txt)["pred"][0]
            probs = probs.float().cpu().numpy()
            top5 = np.argsort(-probs)[:5]
            out.append({"path": name, "probs": probs, "top5": top5, "top5_conf": probs[top5],
                        "names": [self.names[i] if i < len(self.names) else str(i) for i in top5]})
        return out

    # -------------------------------------------------------------------- val
    def val(self, **overrides: Any) -> Dict[str, float]:
        """Detection metrics of the engine's model on `data=` (a dataset
        file); a Classify model's top-1 and top-5 on an ImageFolder root's
        val/ (or test/, or the root itself)."""
        cfg = get_cfg(self.cfg, overrides=overrides)
        if not cfg.data:
            raise ValueError("val requires data=...")
        if self.model is None:
            raise RuntimeError("no weights loaded; train first or load a checkpoint")
        if self.model.head_type == "Classify":
            return self._validate_classify(self.model, classify_split(Path(cfg.data), Path(cfg.data)), cfg,
                                           classify_imgsz(cfg.imgsz))
        data = load_data_yaml(cfg.data)
        if self.txt_feats is None:  # weights given without classes: the dataset's
            self.names = data["names"]
            self.txt_feats = class_text_embeddings(self.names, npz_path=cfg.text_embeddings,
                                                   dim=self.model.text_width)
        dev = init_distributed(self.device)  # under a launcher: data-parallel val
        if dev is not None and dev != self.device:
            self.device = dev
            self.model.to(dev)
        return self._validate(self.model, data, cfg)

    @torch.inference_mode()
    def _validate(self, model: TAMTRModel, data: Dict[str, Any], cfg: Config) -> Dict[str, float]:
        """mAP of `model` on the val split, under the reference val protocol:
        conf 0.4 unless set, the conf mask applied after the score sort
        (`legacy_val_mask`), predictions mapped to each image's own pixels;
        a Segment model's mask mAP and a Pose model's keypoint mAP beside
        the box metrics (`gt_mask_tp`, `gt_pose_tp`).

        In a process group every rank holds `model` and runs every
        world-size-th batch; rank 0 takes the per-image statistics in the
        one-process order, computes the metrics, writes the files, fires
        the callbacks, and every rank returns its metrics."""
        world = dist.get_world_size() if dist.is_initialized() else 1
        rank0 = world == 1 or dist.get_rank() == 0
        if rank0:
            self.callbacks.fire("on_val_start", self)
        split_dir = data.get(cfg.split) or data.get("val")
        task = task_of(model)
        ds = DetectionDataset(split_dir, imgsz=cfg.imgsz, augment=False, task=task,
                              classes=cfg.classes, single_cls=cfg.single_cls)
        conf = cfg.conf if cfg.conf is not None else 0.4
        model = self._eval_model(model, cfg)
        dev = next(model.parameters()).device
        metrics = DetMetrics()
        extra_metrics = DetMetrics() if task != "detect" else None  # mask or keypoint matches
        confusion = ConfusionMatrix(len(self.names) or model.nc, conf=conf) if cfg.plots else None
        bs = max(cfg.batch, 1)
        txt_all = torch.as_tensor(self.txt_feats[None], dtype=torch.float32, device=dev)
        n = len(ds)
        coco_records = [] if cfg.save_json else None
        t0 = time.time()
        # rect val letterboxes aspect-ratio-binned batches for a YOLO Detect
        # head only; the TAM-TR protocol stretches square (the reference's
        # `rtdetrworld/val.py`, rect=False), as the JAX engine does
        if cfg.rect and model.head_type == "Detect":
            ds.set_rectangle(bs)  # reorders by aspect ratio; chunks align
        batches = [list(range(s, min(s + bs, n))) for s in range(0, n, bs)]
        mine = batches[dist.get_rank()::world] if world > 1 else batches

        def fetch(idxs):
            return [ds.get_val(i) for i in idxs]

        # per image, in image order: (index, boxes, scores, labels, gt boxes, gt classes, the mask or
        # keypoint TP table or None, the native-size masks for save_json or None)
        per_image = []
        with ThreadPoolExecutor(max_workers=max(cfg.workers, 1)) as pool:  # 4 batches ahead
            futures = {bi: pool.submit(fetch, mine[bi]) for bi in range(min(4, len(mine)))}
            for bi, idxs in enumerate(mine):
                if bi + 4 < len(mine):
                    futures[bi + 4] = pool.submit(fetch, mine[bi + 4])
                items = futures.pop(bi).result()
                imgs = [it[0] for it in items]
                img = torch.from_numpy(np.stack(imgs)).to(dev)
                out = model(img, txt_all.expand(len(imgs), *txt_all.shape[1:]))
                pred = normalized_pred(model, out["pred"], img.shape[1:3])
                post = postprocess_predictions(pred, conf, cfg.iou, cfg.max_det, legacy_val_mask=True,
                                               classes=cfg.classes, single_cls=cfg.single_cls)
                extra = kept_extras(model, out, post[4])
                boxes, scores, labels, valid, _ = (t.cpu().numpy() for t in post)
                for k, i in enumerate(idxs):
                    _, raw, (oh, ow), lb = items[k]
                    sel = valid[k] & (scores[k] > 0)
                    pb = to_image_pixels(boxes[k][sel], imgs[k].shape[:2], (oh, ow), lb)
                    pc = labels[k][sel].astype(np.float32)
                    tp_x = rle = None
                    if extra is not None:  # the kept rows' masks or keypoints, those selected alone to the host
                        ext = extra[k][torch.from_numpy(sel).to(extra.device)].cpu().numpy()
                    if task == "segment":
                        pm = ext > 0.5
                        tp_x = gt_mask_tp(pm, raw, pb, pc)
                        if coco_records is not None:  # masks at the image's size
                            rle = np.stack([resize_linear(m.astype(np.uint8), (ow, oh)) > 0.5 for m in pm]) \
                                if len(pm) else np.zeros((0, oh, ow), bool)
                    elif task == "pose":
                        tp_x = gt_pose_tp(ext, raw, pb, pc, (oh, ow), cfg.imgsz)
                    per_image.append((i, pb, scores[k][sel], labels[k][sel], raw.boxes, raw.cls, tp_x, rle))
        if world > 1:  # every rank's images, on rank 0, in the one-process order
            gathered = gather_to_rank0(per_image)
            per_image = sorted((r for part in gathered for r in part), key=lambda r: r[0]) if rank0 else []
        for i, pb, ps, lab, gt_boxes, gt_cls, tp_x, rle in per_image:
            pc = lab.astype(np.float32)
            tp = match_predictions(pb, pc, gt_boxes, gt_cls.astype(np.float32))
            metrics.update(tp, ps, pc, gt_cls.astype(np.float32))
            if extra_metrics is not None:
                extra_metrics.update(tp_x, ps, pc, gt_cls.astype(np.float32))
            if confusion is not None:
                confusion.process_batch(pb, ps, pc.astype(np.int64), gt_boxes, gt_cls)
            if coco_records is not None:
                stem = Path(ds.im_files[i]).stem
                rec = {"image_id": int(stem) if stem.isnumeric() else i, "boxes": pb, "scores": ps, "labels": lab}
                if rle is not None:
                    rec["masks"] = rle
                coco_records.append(rec)
        if not rank0:
            return broadcast_from_rank0(None)
        if coco_records is not None:
            predictions_to_coco(coco_records, Path(cfg.project or "runs") / "predictions.json")
        res = metrics.compute()
        if extra_metrics is not None:
            xres, name = extra_metrics.compute(), "mask" if task == "segment" else "pose"
            res[f"{name}_mAP50"] = xres["mAP50"]
            res[f"{name}_mAP50-95"] = xres["mAP50-95"]
        if confusion is not None:
            out_dir = self._last_run_dir or Path(cfg.project or "runs")
            out_dir.mkdir(parents=True, exist_ok=True)
            confusion.plot(out_dir / "confusion_matrix.png", names=self.names)
        res["images_per_sec"] = n / max(time.time() - t0, 1e-9)
        LOGGER.info(f"val: mAP50={res['mAP50']:.4f} mAP50-95={res['mAP50-95']:.4f} "
                    f"P={res['precision']:.4f} R={res['recall']:.4f} ({res['images_per_sec']:.1f} img/s)")
        self.callbacks.fire("on_val_end", self, res)
        return broadcast_from_rank0(res) if world > 1 else res

    # ---------------------------------------------------------------- predict
    @torch.inference_mode()
    def predict(self, source: Any, **overrides: Any) -> List[Results]:
        """Detections of the engine's classes (`names`, `txt_feats`) in
        image files: a path, a directory (its .jpg, .jpeg, .png, .bmp and
        .webp files at any depth, sorted) or a list of paths.

        Each image is read (BGR), resized to (imgsz, imgsz) as cv2.resize
        does (`data/imgproc.py:resize_linear`), turned to RGB in [0, 1] and
        run through the eval forward; `postprocess_predictions` keeps the
        boxes above `conf` (default 0.25) after class-offset NMS at `iou`,
        up to `max_det`, of `classes`. With augment=True three passes run
        (imgsz; imgsz x 0.83, flipped; imgsz x 0.67, both snapped to 32) and
        a class-offset NMS over the `max_det` x 3 padded rows merges them.
        Boxes are in the image's own pixels. Writes nothing unless
        save=True: then each plot goes under `project/name` with the
        source's own name and format. A video file runs frame by frame
        (`_predict_frames`; with save=True an annotated `.mp4`). A Classify
        model gives one dict an image instead (`_predict_classify`), of
        arrays too."""
        cfg = get_cfg(self.cfg, overrides=overrides)
        cfg.save = bool(overrides.get("save", False))
        if self.model is not None and self.model.head_type == "Classify":
            return self._predict_classify(source, cfg)
        if self.model is None or self.txt_feats is None:
            raise RuntimeError("no weights or classes: train, load or set a model and set_classes first")
        why = unsupported_source(source)
        if why:
            raise NotImplementedError(why)
        if is_video(source):
            return self._predict_frames(source, cfg)
        if isinstance(source, (str, Path)):
            p = Path(source)
            paths = (sorted(str(f) for f in p.rglob("*") if f.suffix.lower() in
                            {".jpg", ".jpeg", ".png", ".bmp", ".webp"})
                     if p.is_dir() else [str(p)])
        else:
            paths = [str(x) for x in source]
        model = self._eval_model(self.model, cfg)
        conf = cfg.conf if cfg.conf is not None else 0.25
        txt = torch.as_tensor(self.txt_feats[None], dtype=torch.float32, device=next(model.parameters()).device)
        # TTA (the reference's `_predict_augment`, `tasks.py:272-307`): scales
        # 1 / 0.83 / 0.67 snapped to the stride grid, the middle one flipped
        passes = [(cfg.imgsz, False)]
        if cfg.augment:
            passes += [(max(round(cfg.imgsz * 0.83 / 32) * 32, 32), True),
                       (max(round(cfg.imgsz * 0.67 / 32) * 32, 32), False)]
        results = []
        for path in paths:
            im0 = imread(path)
            if im0 is None:
                raise FileNotFoundError(f"cannot read image {path}")
            oh, ow = im0.shape[:2]
            all_b, all_s, all_l = [], [], []
            for sz, flip in passes:
                b, s, lab, extra = self._detect(model, im0, sz, txt, conf, cfg.iou, cfg.max_det, flip=flip,
                                                classes=cfg.classes, single_cls=cfg.single_cls)
                if flip:  # un-flip normalized xyxy
                    b = np.stack([1 - b[:, 2], b[:, 1], 1 - b[:, 0], b[:, 3]], -1)
                all_b.append(b)
                all_s.append(s)
                all_l.append(lab)
            b, s, lab = np.concatenate(all_b), np.concatenate(all_s), np.concatenate(all_l)
            if len(passes) > 1 and len(b):
                pad = cfg.max_det * len(passes) - len(b)
                keep, valid_k = (t.numpy() for t in multiclass_nms(
                    torch.from_numpy(np.pad(b, ((0, pad), (0, 0)))), torch.from_numpy(np.pad(s, (0, pad))),
                    torch.from_numpy(np.pad(lab, (0, pad))), cfg.iou, cfg.max_det))
                idx = keep[valid_k]
                b, s, lab = b[idx[idx < len(b)]], s[idx[idx < len(s)]], lab[idx[idx < len(lab)]]
            # a segment model's masks (not merged across TTA passes, as the JAX engine's)
            masks = extra if model.head_type == "Segment" and not cfg.augment else None
            r = Results(path, b * np.array([ow, oh, ow, oh], np.float32), s, lab, self.names,
                        orig_shape=(oh, ow), masks=masks)
            if cfg.save:  # annotated image output (reference save=True)
                r.save(Path(cfg.project or "runs/detect") / (cfg.name or "predict") / Path(path).name)
            results.append(r)
        return results

    @torch.inference_mode()
    def _predict_frames(self, source: Any, cfg: Config) -> List[Results]:
        """Predict over a video file frame by frame (the JAX engine's
        `_predict_frames`): every `vid_stride`-th frame, named "path#i",
        through `_detect` at imgsz; each `Results` keeps its frame as
        `orig_img`. With save=True the plots go to
        `<project or runs/detect>/<name or predict>/<stem>.mp4` at the
        file's fps / vid_stride."""
        model = self._eval_model(self.model, cfg)
        conf = cfg.conf if cfg.conf is not None else 0.25
        txt = torch.as_tensor(self.txt_feats[None], dtype=torch.float32, device=next(model.parameters()).device)
        writer = self._video_writer(source, cfg, "runs/detect")
        results = []
        try:
            for name, frame in load_inference_source(source, cfg.vid_stride, cfg.stream_buffer):
                oh, ow = frame.shape[:2]
                b, s, lab, _ = self._detect(model, frame, cfg.imgsz, txt, conf, cfg.iou, cfg.max_det,
                                            classes=cfg.classes, single_cls=cfg.single_cls)
                r = Results(name, b * np.array([ow, oh, ow, oh], np.float32), s, lab, self.names,
                            orig_shape=(oh, ow), orig_img=frame)
                if writer is not None:
                    writer.write(r)
                results.append(r)
        finally:
            if writer is not None:
                writer.close()
        return results

    @staticmethod
    def _video_writer(source: Any, cfg: Config, project: str) -> Optional[AnnotatedVideoWriter]:
        """The annotated-video writer of a video `source` when cfg.save is
        set (`<project>/<name or predict>/<stem>.mp4` at fps / vid_stride),
        else None."""
        if not cfg.save or not is_video(source):
            return None
        src = Path(str(source))
        out = (Path(cfg.project or project) / (cfg.name or "predict") / src.stem).with_suffix(".mp4")
        return AnnotatedVideoWriter(out, video_fps(src) / max(cfg.vid_stride, 1))

    @staticmethod
    def _detect(model: TAMTRModel, im0: np.ndarray, sz: int, txt: torch.Tensor, conf: float, iou: float,
                max_det: int, flip: bool = False, classes=None, single_cls: bool = False):
        """One BGR image stretched to (sz, sz) as cv2.resize does, turned to
        RGB in [0, 1] (and mirrored with `flip`), through the eval forward
        and `postprocess_predictions`: normalized xyxy boxes, scores and
        labels of the kept detections, and their `kept_extras` (a Segment
        model's mask probabilities, a Pose model's keypoints) or None."""
        img = resize_linear(im0, (sz, sz))[..., ::-1].astype(np.float32) / 255.0
        if flip:
            img = img[:, ::-1]
        out = model(torch.from_numpy(np.ascontiguousarray(img)[None]).to(txt.device), txt)
        post = postprocess_predictions(normalized_pred(model, out["pred"], (sz, sz)), conf, iou, max_det,
                                       classes=classes, single_cls=single_cls)
        extra = kept_extras(model, out, post[4])
        boxes, scores, labels, valid, _ = (t.cpu().numpy() for t in post)
        sel = valid[0] & (scores[0] > 0)
        if extra is not None:  # the selected rows alone to the host
            extra = extra[0][torch.from_numpy(sel).to(extra.device)].cpu().numpy()
        return boxes[0][sel], scores[0][sel], labels[0][sel], extra

    # ------------------------------------------------------------------ track
    @torch.inference_mode()
    def track(self, source: Any, tracker: str = "bytetrack", persist: bool = False,
              **overrides: Any) -> List[Results]:
        """Multi-object tracking over a sequence of frames (the JAX package's
        `Engine.track`, the reference's `Model.track`): an array, a list, a
        directory (its images at any depth, sorted), a glob or an image file
        (`data/loaders.py:load_inference_source`), a video file (every
        `vid_stride`-th frame; webcam and stream sources raise). Each frame
        is stretched to (imgsz, imgsz) as cv2.resize does, turned to RGB in
        [0, 1] and run through the eval forward at `conf`
        (0.25 by default); its detections, in the frame's pixels, go through
        the tracker ("bytetrack", or "botsort", whose motion compensation
        runs on the engine's device), and
        each `Results` holds the tracked boxes and their `track_ids`. The
        tracker's own keys (gmc_method, with_reid, proximity_thresh,
        appearance_thresh, track_buffer, match_thresh) ride `overrides`.
        With persist=True the tracker of the previous call goes on. With
        save=True a video source's plots go to
        `<project or runs/track>/<name or predict>/<stem>.mp4` at the file's
        fps / vid_stride. `timing` gets the read, model and tracker ms of each
        frame."""
        from tamtr_torch.trackers.track import make_tracker, update_result_with_tracks

        tracker_args = {k: overrides.pop(k) for k in ("gmc_method", "with_reid", "proximity_thresh",
                                                      "appearance_thresh", "track_buffer", "match_thresh")
                        if k in overrides}
        cfg = get_cfg(self.cfg, overrides=overrides)
        cfg.save = bool(overrides.get("save", False))
        if self.model is None or self.txt_feats is None:
            raise RuntimeError("no weights or classes: train, load or set a model and set_classes first")
        if not persist or self._tracker is None:
            self._tracker = make_tracker(tracker, device=self.device, **tracker_args)
        model = self._eval_model(self.model, cfg)
        conf = cfg.conf if cfg.conf is not None else 0.25
        txt = torch.as_tensor(self.txt_feats[None], dtype=torch.float32, device=next(model.parameters()).device)
        self.timing = {"read_ms": [], "model_ms": [], "tracker_ms": []}
        results = []
        writer = self._video_writer(source, cfg, "runs/track")
        frames = load_inference_source(source, cfg.vid_stride, cfg.stream_buffer)
        t0 = time.perf_counter()
        try:
            for name, frame in frames:
                t1 = time.perf_counter()
                oh, ow = frame.shape[:2]
                b, s, lab, _ = self._detect(model, frame, cfg.imgsz, txt, conf, cfg.iou, cfg.max_det)
                r = Results(name, b * np.array([ow, oh, ow, oh], np.float32), s, lab, self.names,
                            orig_shape=(oh, ow), orig_img=frame)
                t2 = time.perf_counter()
                update_result_with_tracks(r, self._tracker, frame=frame)
                results.append(r)
                t3 = time.perf_counter()
                for k, a, b in (("read_ms", t0, t1), ("model_ms", t1, t2), ("tracker_ms", t2, t3)):
                    self.timing[k].append((b - a) * 1e3)
                if writer is not None:
                    writer.write(r)
                t0 = time.perf_counter()
        finally:
            if writer is not None:
                writer.close()
        return results

    def _eval_model(self, model: TAMTRModel, cfg: Config) -> TAMTRModel:
        """The model val, predict and track run (the JAX package's
        `_resolve_eval_model`), in eval mode: `model`; with cfg.fuse its
        fused twin (`nn/fuse.fuse_model`); with cfg.half a twin computing in
        bf16 (`TAMTRModel.with_dtype`, the JAX `model.clone(dtype=bf16)`),
        after the fuse when both are set (folded in fp32, computed at bf16).
        A model that already computes in bf16 keeps it. The fused twin is
        cached and built again whenever `model` or any of its weights changed
        since (`weights_key`); the bf16 twin shares the weights of the model
        it is made from. `model`'s weights and dtype are never changed."""
        refuse_dual(model)
        dtype = torch.bfloat16 if cfg.half else model.dtype
        if cfg.fuse:
            key = weights_key(model)
            if self._fused is None or self._fused[0] != key:
                self._fused = (key, fuse_model(model))
            model = self._fused[1]
        return (model if model.dtype == dtype else model.with_dtype(dtype)).eval()

    # ------------------------------------------------------------- export
    def export(self, fmt: str = "torch", out_dir: str = "runs/export", imgsz: int = 640, half: bool = False,
               int8: bool = False) -> Path:
        """Export the engine's model (after `train` the EMA, after `load` the
        checkpoint's) with its meta (`engine/exporter.py`; the JAX
        `Engine.export`): n_text = len(names) or nc. The JAX `calib` of
        tflite int8 has no format here to go to."""
        from tamtr_torch.engine.exporter import export_model

        if self.model is None:
            raise RuntimeError("no weights loaded; train first or load a checkpoint")
        head = self.model.model[-1]
        meta = {"nc": self.model.nc, "names": self.names, "model_cfg": str(self.model_cfg), "imgsz": imgsz,
                "max_gt": getattr(head, "max_gt", 128)}
        return export_model(self.model, imgsz, len(self.names) or self.model.nc, out_dir, fmt, half=half, int8=int8,
                            meta=meta)

    # ------------------------------------------------------------------ tune
    def tune(self, iterations: int = 10, isolate: bool = False, use_ray: bool = False,
             **overrides: Any) -> Dict[str, float]:
        """Hyperparameter evolution (the JAX `Engine.tune`, the reference's
        `Model.tune`): `engine/tuner.py:Tuner` mutates the hyperparameters
        and runs a short `train` of this config on `overrides` per
        iteration, keeping the fitness-best; rows in
        `<project or runs>/tune/tune_results.csv`. isolate=True runs each
        trial in a Python subprocess (a trial that crashes hard, killed for
        memory or wedging the card, scores fitness 0 and the loop goes on);
        use_ray=True goes to Ray Tune with ASHA (`run_ray_tune`), which
        needs ray[tune]. Every trial trains on this engine's device."""
        from tamtr_torch.engine.tuner import SPACE, Tuner, run_ray_tune

        base_cfg = get_cfg(overrides=overrides)
        if use_ray:
            return run_ray_tune(
                lambda hyp: Engine(self.model_cfg, device=self.device).train(
                    **{**overrides, **hyp, "save": False, "plots": False}),
                max_samples=iterations, max_t=base_cfg.epochs,
                storage_path=str(Path(base_cfg.project or "runs") / "tune"))
        tuner = Tuner(save_dir=Path(base_cfg.project or "runs") / "tune", seed=base_cfg.seed)

        def train_fn(hyp: Dict[str, float]) -> Dict[str, float]:
            ov = {**overrides, **hyp, "save": False, "plots": False}
            if not isolate:
                return Engine(self.model_cfg, device=self.device).train(**ov)
            return self._isolated_trial(ov)

        base_hyp = {k: getattr(base_cfg, k) for k in SPACE}
        return tuner(train_fn, base_hyp=base_hyp, iterations=iterations)

    def _isolated_trial(self, overrides: Dict[str, Any]) -> Dict[str, float]:
        """One tune trial, `Engine(model_cfg).train(**overrides)` in a Python
        subprocess on this engine's device; its numeric metrics, or fitness
        0 when the process dies without writing them."""
        import json
        import os
        import subprocess
        import sys
        import tempfile

        code = ("import json, sys\nfrom pathlib import Path\n"
                "cfg = json.loads(sys.argv[1])\n"
                "from tamtr_torch.engine.model import Engine\n"
                "m = Engine(cfg['model_cfg'], device=cfg['device']).train(**cfg['overrides'])\n"
                "Path(cfg['out']).write_text(json.dumps({k: float(v) for k, v in m.items() "
                "if isinstance(v, (int, float))}))\n")
        root = str(Path(__file__).resolve().parents[2])
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")]))}
        with tempfile.TemporaryDirectory() as tmp:
            out = Path(tmp) / "metrics.json"
            payload = json.dumps({"model_cfg": str(self.model_cfg), "device": str(self.device),
                                  "overrides": overrides, "out": str(out)}, default=str)
            r = subprocess.run([sys.executable, "-c", code, payload], capture_output=True, text=True, env=env)
            if out.exists():
                return json.loads(out.read_text())
        LOGGER.warning(f"isolated tune trial crashed (rc={r.returncode}); fitness=0\n{r.stderr[-500:]}")
        return {"fitness": 0.0}

    # ------------------------------------------------------------- weights
    def load(self, ckpt_path: Union[str, Path], nc: Optional[int] = None,
             names: Optional[List[str]] = None) -> "Engine":
        """The EMA weights of a checkpoint: the port's own (`weights/last.pt`
        or `best.pt` of `train`, an exported `model.pt`), whose meta supplies
        nc, names and the model config, or the reference's (an ultralytics
        `last.pt` / `best.pt`, the released `TAM_TR.pt`: its EMA, else its
        stripped model, read by `weight_files.read_reference_checkpoint`
        without running its pickled code), whose module supplies nc and
        names and which must hold this engine's model config exactly. The
        file's contents, not its suffix, decide which. `nc` and `names`
        given here take precedence; names default to "0", "1", ...

        A bare known asset name that is not a file here ("TAM_TR.pt") is
        fetched from the project's release (`utils/downloads.py`) and then
        loaded; when it cannot be reached, HUBModelError."""
        from tamtr_torch.weight_files import check_reference_state, is_reference_checkpoint, read_reference_checkpoint

        p = Path(ckpt_path)
        if not p.exists() and p.name == str(ckpt_path):
            from tamtr_torch.utils.downloads import ASSETS_NAMES, attempt_download_asset
            from tamtr_torch.utils.errors import HUBModelError

            if p.name in ASSETS_NAMES:
                try:
                    p = Path(attempt_download_asset(p.name))
                except ConnectionError as e:
                    raise HUBModelError(f"could not fetch asset {p.name!r}: {e}") from e
        reference = is_reference_checkpoint(p)
        state, meta = read_reference_checkpoint(p) if reference else load_checkpoint_raw(p)
        nc = nc or meta.get("nc")
        if not nc:
            raise ValueError(f"{p}: the checkpoint has no nc metadata; pass nc=...")
        self.names = list(names or meta.get("names") or [str(i) for i in range(nc)])
        if meta.get("model_cfg"):
            self.model_cfg = meta["model_cfg"]
        model = TAMTRModel.from_cfg(self.model_cfg, nc=nc, max_gt=meta.get("max_gt", 128))
        if reference:  # JAX's converter report, then the port's own counters
            own = model.state_dict()
            check_reference_state(p, state, own, f"{self.model_cfg} at nc={nc}")
            state = {**{k: v for k, v in own.items() if k.endswith("num_batches_tracked")}, **state}
        model.load_state_dict(state, strict=True)
        self.model = model.to(self.device).eval()
        if self.txt_feats is None:  # a classifier takes no text: its table is zeros, as in its training
            self.txt_feats = np.zeros((1, TEXT_WIDTH), np.float32) if model.head_type == "Classify" else \
                class_text_embeddings(self.names, dim=model.text_width)
        return self

    def set_classes(self, classes: List[str], embeddings: Optional[np.ndarray] = None) -> None:
        """Open-vocabulary retarget: new class names, with their embeddings
        or the class-name ones."""
        self.names = list(classes)
        width = self.model.text_width if self.model is not None else TEXT_WIDTH
        self.txt_feats = (np.asarray(embeddings, np.float32) if embeddings is not None
                          else class_text_embeddings(self.names, dim=width))

    @staticmethod
    def _append_csv(path: Path, row: Dict[str, Any]) -> None:
        """Append a row, rewriting the file when new columns appear (val
        metrics exist only on val epochs)."""
        rows: List[Dict[str, Any]] = []
        fields: List[str] = []
        if path.exists():
            with open(path, newline="") as f:
                r = csv.DictReader(f)
                fields = list(r.fieldnames or [])
                rows = list(r)
        new_fields = fields + [k for k in row if k not in fields]
        if new_fields == fields and fields and list(row) == fields:
            with open(path, "a", newline="") as f:
                csv.DictWriter(f, fieldnames=fields).writerow(row)
            return
        rows.append({k: row.get(k, "") for k in new_fields})
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=new_fields, restval="")
            w.writeheader()
            for rr in rows:
                rr.pop(None, None)
                w.writerow(rr)
