"""Engine: train and val of the TAM-TR detector on a dataset (a port of the
JAX package's `tamtr_tpu/engine/model.py`, `Engine.train`, `val`,
`_validate`, `load` and `set_classes`, for the `ManbaWorldDecoder` head).

    train(data=...): DetectionDataset + Loader -> Trainer.step per batch
      -> every val_interval epochs _validate with the EMA weights
      -> a results.csv row, checkpoints `last` and `best`, resume
    val(data=...): the same _validate on loaded weights

The engine runs on the card unless `device="cpu"` is given. Not ported:
the mesh, sequence parallelism and ZeRO, autobatch, fuse and half,
classify/segment/pose, predict, track, tune and export; the plots (the
confusion matrix of `cfg.plots` is not computed: matplotlib is not on the
card's machine).
"""

from __future__ import annotations

import csv
import signal
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from tamtr_torch.config import Config, get_cfg, load_data_yaml
from tamtr_torch.data.dataset import AugConfig, DetectionDataset, Loader
from tamtr_torch.data.text import TextEmbedder, class_text_embeddings
from tamtr_torch.engine.checkpoint import load_checkpoint, load_checkpoint_raw, save_checkpoint
from tamtr_torch.nn.graph import TAMTRModel
from tamtr_torch.ops.nms import postprocess_predictions
from tamtr_torch.train.trainer import Trainer, TrainConfig
from tamtr_torch.utils.callbacks import Callbacks
from tamtr_torch.utils.checks import check_imgsz
from tamtr_torch.utils.coco import predictions_to_coco
from tamtr_torch.utils.files import increment_path
from tamtr_torch.utils.log import LOGGER
from tamtr_torch.utils.metrics import DetMetrics, match_predictions
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


def text_width(model: TAMTRModel) -> int:
    """The width of the text embeddings `model` takes: its head's hidden width."""
    return model.model[-1].hd


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

    # ------------------------------------------------------------------ train
    def train(self, **overrides: Any) -> Dict[str, float]:
        cfg = get_cfg(overrides=overrides)
        self.cfg = cfg
        if not cfg.data:
            raise ValueError("train requires data=...")
        if cfg.batch < 1:
            raise ValueError(f"batch={cfg.batch}: autobatch is not ported; give a batch size")
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
            return self._train(cfg, preempted)
        finally:
            for sig, h in old_handlers.items():
                signal.signal(sig, h)

    def _train(self, cfg: Config, preempted: Dict[str, bool]) -> Dict[str, float]:
        dev = self.device
        data = load_data_yaml(cfg.data)
        nc = data["nc"]
        self.names = data["names"]
        cfg.imgsz = check_imgsz(cfg.imgsz, stride=32)
        model = TAMTRModel.from_cfg(self.model_cfg, nc=nc, max_gt=cfg.max_gt)
        init_parameters(model, cfg.seed)
        width = text_width(model)
        self.txt_feats = class_text_embeddings(self.names, npz_path=cfg.text_embeddings, dim=width)

        aug = AugConfig(
            mosaic=cfg.mosaic, mixup=cfg.mixup, copy_paste=cfg.copy_paste, degrees=cfg.degrees,
            translate=cfg.translate, scale=cfg.scale, shear=cfg.shear, perspective=cfg.perspective,
            hsv_h=cfg.hsv_h, hsv_s=cfg.hsv_s, hsv_v=cfg.hsv_v, fliplr=cfg.fliplr, flipud=cfg.flipud,
        )
        # RandomLoadText: per-image positive/negative text sampling and class remap
        train_ds = DetectionDataset(
            data["train"], imgsz=cfg.imgsz, augment=True, aug=aug, seed=cfg.seed,
            class_texts=[str(n).split("/") for n in self.names], random_text=True,
            cache=cfg.cache, classes=cfg.classes, single_cls=cfg.single_cls,
        )
        loader = Loader(train_ds, cfg.batch, max_gt=cfg.max_gt, seed=cfg.seed, workers=cfg.workers,
                        pin_memory=dev.type == "cuda")
        tc = TrainConfig(
            lr0=cfg.lr0, lrf=cfg.lrf, momentum=cfg.momentum, weight_decay=cfg.weight_decay,
            warmup_iters=int(cfg.warmup_epochs), warmup_bias_lr=cfg.warmup_bias_lr, epochs=cfg.epochs,
            warmup_momentum=cfg.warmup_momentum, batch_size=cfg.batch, nbs=cfg.nbs,
            match_method=cfg.match_method,
        )
        trainer = Trainer(model, tc, steps_per_epoch=len(loader), device=dev, seed=cfg.seed + 1)
        self.trainer = trainer
        self.model = trainer.ema

        run_dir = Path(cfg.project or "runs/detect") / (cfg.name or "train")
        if not cfg.resume and not cfg.exist_ok:
            run_dir = increment_path(run_dir)
        run_dir.mkdir(parents=True, exist_ok=True)
        csv_path = run_dir / "results.csv"
        start_epoch = 0
        last = run_dir / "weights" / "last.pt"
        if cfg.resume and last.exists():
            meta = load_checkpoint(last, trainer)
            start_epoch = int(meta.get("epoch", -1)) + 1
            LOGGER.info(f"resumed from epoch {start_epoch}")
        stopper = EarlyStopping(cfg.patience)
        txt = np.tile(self.txt_feats[None], (cfg.batch, 1, 1)).astype(np.float32)
        text_embedder = TextEmbedder(npz_path=cfg.text_embeddings, dim=width)
        best_fitness = 0.0
        meta = {"nc": nc, "names": self.names, "model_cfg": str(self.model_cfg), "imgsz": cfg.imgsz,
                "max_gt": cfg.max_gt}
        self.timing = {"step_ms": [], "wait_ms": []}

        LOGGER.info(f"training {self.model_cfg}: nc={nc} imgsz={cfg.imgsz} batch={cfg.batch} "
                    f"device={dev} steps/epoch={len(loader)}")
        self.callbacks.fire("on_train_start", self)
        metrics_out: Dict[str, float] = {}
        m: Dict[str, float] = {}
        for epoch in range(start_epoch, cfg.epochs):
            self._cur_epoch = epoch
            self.callbacks.fire("on_train_epoch_start", self, epoch)
            if cfg.close_mosaic and epoch == cfg.epochs - cfg.close_mosaic:
                train_ds.close_mosaic()
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
                m = trainer.step({
                    "img": batch["img"],
                    # per-image sampled texts (RandomLoadText) when present, else the class table
                    "txt_feats": text_embedder(batch["texts"]) if "texts" in batch else txt,
                    "cls": batch["cls"], "bboxes": batch["bboxes"], "mask": batch["mask"],
                })  # ends in host reads of the metrics: the device has finished
                self.timing["wait_ms"].append((ts - tw) * 1e3)
                self.timing["step_ms"].append((time.perf_counter() - ts) * 1e3)
                n_steps += 1
                self.callbacks.fire("on_train_batch_end", self, n_steps)
            ips = n_steps * cfg.batch / max(time.time() - t0, 1e-9)
            comp = {k: m[k] for k in ("giou", "class", "bbox") if k in m}
            LOGGER.info(f"epoch {epoch + 1}/{cfg.epochs}: loss={m.get('loss', float('nan')):.3f} "
                        + " ".join(f"{k}={v:.3f}" for k, v in comp.items()) + f" {ips:.1f} img/s")
            row = {"epoch": epoch + 1, "loss": m.get("loss", float("nan")), **comp, "img_per_sec": ips}
            run_val = (epoch + 1) % max(cfg.val_interval, 1) == 0 or epoch == cfg.epochs - 1
            fitness = None
            if cfg.val and data.get("val") and run_val:
                metrics_out = self._validate(trainer.ema, data, cfg)
                row.update(metrics_out)
                fitness = metrics_out.get("fitness", 0.0)
            if cfg.save:
                run_save = (epoch + 1) % max(cfg.save_interval, 1) == 0 or epoch == cfg.epochs - 1
                if run_save:
                    save_checkpoint(last, trainer, {"epoch": epoch, **meta})
                is_best = fitness is not None and fitness >= best_fitness
                if is_best:
                    best_fitness = fitness
                    save_checkpoint(run_dir / "weights" / "best.pt", trainer, {"epoch": epoch, **meta})
                if run_save or is_best:
                    self.callbacks.fire("on_model_save", self, epoch, last, is_best)
            if fitness is not None and stopper(epoch, fitness):
                LOGGER.info(f"early stopping at epoch {epoch + 1}")
                self._append_csv(csv_path, row)
                break
            self._append_csv(csv_path, row)
            self.callbacks.fire("on_fit_epoch_end", self, epoch, row)
            if preempted["flag"]:
                if cfg.save:
                    save_checkpoint(last, trainer, {"epoch": epoch, **meta})
                    LOGGER.info("preemption checkpoint saved; resume with resume=True")
                break
        self.callbacks.fire("on_train_end", self, metrics_out, run_dir)
        self.callbacks.fire("teardown", self)
        return metrics_out

    # -------------------------------------------------------------------- val
    def val(self, **overrides: Any) -> Dict[str, float]:
        cfg = get_cfg(self.cfg, overrides=overrides)
        if not cfg.data:
            raise ValueError("val requires data=...")
        data = load_data_yaml(cfg.data)
        if self.model is None:
            raise RuntimeError("no weights loaded; train first or load a checkpoint")
        if self.txt_feats is None:  # weights given without classes: the dataset's
            self.names = data["names"]
            self.txt_feats = class_text_embeddings(self.names, npz_path=cfg.text_embeddings,
                                                   dim=text_width(self.model))
        return self._validate(self.model, data, cfg)

    @torch.inference_mode()
    def _validate(self, model: TAMTRModel, data: Dict[str, Any], cfg: Config) -> Dict[str, float]:
        """mAP of `model` on the val split, under the reference val protocol:
        conf 0.4 unless set, the conf mask applied after the score sort
        (`legacy_val_mask`), predictions mapped to each image's own pixels."""
        self.callbacks.fire("on_val_start", self)
        split_dir = data.get(cfg.split) or data.get("val")
        ds = DetectionDataset(split_dir, imgsz=cfg.imgsz, augment=False,
                              classes=cfg.classes, single_cls=cfg.single_cls)
        conf = cfg.conf if cfg.conf is not None else 0.4
        model.eval()
        dev = next(model.parameters()).device
        metrics = DetMetrics()
        bs = max(cfg.batch, 1)
        txt_all = torch.as_tensor(self.txt_feats[None], dtype=torch.float32, device=dev)
        n = len(ds)
        coco_records = [] if cfg.save_json else None
        t0 = time.time()
        if cfg.rect:
            ds.set_rectangle(bs)  # reorders by aspect ratio; chunks align
        batches = [list(range(s, min(s + bs, n))) for s in range(0, n, bs)]

        def fetch(idxs):
            return [ds.get_val(i) for i in idxs]

        with ThreadPoolExecutor(max_workers=max(cfg.workers, 1)) as pool:  # 4 batches ahead
            futures = {bi: pool.submit(fetch, batches[bi]) for bi in range(min(4, len(batches)))}
            for bi, idxs in enumerate(batches):
                if bi + 4 < len(batches):
                    futures[bi + 4] = pool.submit(fetch, batches[bi + 4])
                items = futures.pop(bi).result()
                imgs = [it[0] for it in items]
                img = torch.from_numpy(np.stack(imgs)).to(dev)
                pred = model(img, txt_all.expand(len(imgs), *txt_all.shape[1:]))["pred"]
                boxes, scores, labels, valid, _ = (t.cpu().numpy() for t in postprocess_predictions(
                    pred, conf, cfg.iou, cfg.max_det, legacy_val_mask=True, classes=cfg.classes,
                    single_cls=cfg.single_cls))
                for k, i in enumerate(idxs):
                    _, raw, (oh, ow), lb = items[k]
                    sel = valid[k] & (scores[k] > 0)
                    if lb is not None:  # rect: undo the letterbox (ratio, pads)
                        ratio, left, top = lb
                        bh, bw = imgs[k].shape[:2]
                        pb = boxes[k][sel] * np.array([bw, bh, bw, bh], np.float32)
                        pb = (pb - np.array([left, top, left, top], np.float32)) / ratio
                        pb = pb.clip(0, [ow, oh, ow, oh])
                    else:
                        pb = boxes[k][sel] * np.array([ow, oh, ow, oh], np.float32)
                    pc = labels[k][sel].astype(np.float32)
                    ps = scores[k][sel]
                    tp = match_predictions(pb, pc, raw.boxes, raw.cls.astype(np.float32))
                    metrics.update(tp, ps, pc, raw.cls.astype(np.float32))
                    if coco_records is not None:
                        stem = Path(ds.im_files[i]).stem
                        coco_records.append({"image_id": int(stem) if stem.isnumeric() else i, "boxes": pb,
                                             "scores": ps, "labels": labels[k][sel]})
        if coco_records is not None:
            predictions_to_coco(coco_records, Path(cfg.project or "runs") / "predictions.json")
        res = metrics.compute()
        res["images_per_sec"] = n / max(time.time() - t0, 1e-9)
        LOGGER.info(f"val: mAP50={res['mAP50']:.4f} mAP50-95={res['mAP50-95']:.4f} "
                    f"P={res['precision']:.4f} R={res['recall']:.4f} ({res['images_per_sec']:.1f} img/s)")
        self.callbacks.fire("on_val_end", self, res)
        return res

    # ------------------------------------------------------------- weights
    def load(self, ckpt_path: Union[str, Path], nc: Optional[int] = None,
             names: Optional[List[str]] = None) -> "Engine":
        """The EMA weights of a checkpoint (`weights/last.pt` or `best.pt`);
        its meta supplies nc, names and the model config."""
        ema, meta = load_checkpoint_raw(ckpt_path)
        nc = nc or meta.get("nc")
        if not nc:
            raise ValueError("checkpoint has no nc metadata; pass nc=...")
        self.names = names or meta.get("names") or [str(i) for i in range(nc)]
        if meta.get("model_cfg"):
            self.model_cfg = meta["model_cfg"]
        model = TAMTRModel.from_cfg(self.model_cfg, nc=nc, max_gt=meta.get("max_gt", 128))
        model.load_state_dict(ema)
        self.model = model.to(self.device).eval()
        if self.txt_feats is None:
            self.txt_feats = class_text_embeddings(self.names, dim=text_width(model))
        return self

    def set_classes(self, classes: List[str], embeddings: Optional[np.ndarray] = None) -> None:
        """Open-vocabulary retarget: new class names, with their embeddings
        or the class-name ones."""
        self.names = list(classes)
        width = text_width(self.model) if self.model is not None else 512
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
