"""User entry points: `TAMTR(...).predict(source)` or `.predict(images,
text)`, `TAMTR(...).trainer()`, and `TAMTR(...).train(data=...)` /
`.val(data=...)`; the facades the JAX package exports beside it
(`tamtr_tpu/api.py`): `RTDETRWorld` (= TAMTR), `YOLO` (the task from the
config's name), `RTDETR`, `NAS` (predict and val of a trained
checkpoint), `SAM` (promptable and automatic segmentation,
`models/sam/`) and `FastSAM` (a YOLO segment model with `prompt`,
`models/fastsam.py`).

A Classify config (`YOLO("classify-gelan.yaml")`) trains on an ImageFolder
root (`train(data=root)`), validates top-1 / top-5 and predicts one dict
an image (path, probs, top5, top5_conf, names) from files or arrays.

`info()` gives the model's summary: layers, parameters and, once a model
is held, GFLOPs. `fuse=True` to `predict`, `track` or `val` runs the fused
twin of the model (`nn/fuse.py`); `train(batch=-1)` fits the batch to the
card's memory. `export(fmt)` writes the model as "torch", "npz" or
"torch_export" (`engine/exporter.py`), and `tune(iterations, data=...)`
evolves the training hyperparameters (`engine/tuner.py`).

`track(source)` runs `Engine.track` over a sequence of frames (arrays,
image files, a directory or a glob): the file predict's forward on each
frame, then a tracker ("bytetrack", or "botsort" with camera-motion compensation),
one `Results` with `track_ids` per frame.

A YOLO config (`TAMTR("yolo-gelan.yaml")`) builds the Detect model: it
trains with the v8 loss, takes no text (predict's `text` is a table of its
classes' rows, which it ignores), and its pixel boxes come back in the
image's pixels like TAM-TR's.

`predict(source)` with a path, a directory or a list of paths runs
`Engine.predict` (the JAX package's `tamtr_tpu/engine/model.py:predict`):
each file read, resized as cv2 resizes, the eval forward (three passes with
augment=True), NMS, and `Results` in the image's pixels, for the classes of
`set_classes` (or of a loaded or trained model). `predict(images, text)`
takes arrays already in memory: each image resized to `imgsz` on the device
(bilinear), run through the eval forward with the given class embeddings,
postprocessed (conf filter, class-offset NMS), and its boxes scaled back
to the image's own pixels. `trainer` returns a
`tamtr_torch.train.trainer.Trainer` over the model, whose `step(batch)` is
one training step. `train`, `val`, `load`, `set_classes` and file predict
go through one `tamtr_torch.engine.model.Engine` on the same device, built
on first use, as the JAX package's `TAMTR` sends every call through its
engine. The engine holds the detector's one model: `predict`, `trainer`,
`val` and `load_jax_variables` all use it, and after `train` it is the
trained EMA model.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from tamtr_torch.config import get_cfg, load_data_yaml
from tamtr_torch.engine.model import Engine, normalized_pred
from tamtr_torch.engine.results import Results
from tamtr_torch.nn.graph import TAMTRModel
from tamtr_torch.ops.nms import postprocess_predictions
from tamtr_torch.train.trainer import Trainer, TrainConfig, loss_config_for
from tamtr_torch.weights import from_jax_variables, init_parameters

ImageLike = Union[np.ndarray, torch.Tensor]


def variable_count(model: torch.nn.Module) -> int:
    """The numbers a model holds as the JAX package counts its variables:
    parameters and BatchNorm statistics, without `num_batches_tracked`."""
    return sum(t.numel() for name, t in model.state_dict().items() if not name.endswith("num_batches_tracked"))


class TAMTR:
    """A TAM-TR detector in eval mode.

    Args:
      model: config name or path ("tamtr.yaml" resolves to the bundled JSON),
        or a checkpoint (`.pt`: the port's own, or the reference's, such as
        the released "TAM_TR.pt", as `RTDETRWorld("TAM_TR.pt")` opens it),
        loaded at once by `load` on a model of the checkpoint's config
        (`tamtr.yaml` for the reference's).
      nc: number of classes of the model that `predict` and `trainer` build
        before any train or load (10 when not given); `train` takes the
        dataset's, and raises if it differs from an `nc` given here.
      device: "cuda" by default; "cpu" only when asked for.
      seed: seed of the generator that initialises the weights, here and
        in `train` unless it is given `seed=`.
      imgsz: square input size of the network; `train` and `val` use it
        unless given `imgsz=`, and after `train` it is the size trained at.
      max_gt: ground-truth slots per training image (the CDN layout); 300 as
        the JAX package's training config; `train` uses it unless given
        `max_gt=`.
    """

    def __init__(self, model: Union[str, Path] = "tamtr.yaml", nc: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = None, seed: int = 0, imgsz: int = 640,
                 max_gt: int = 300):
        if device is None and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        self.device = torch.device("cuda" if device is None else device)
        weights = model if Path(model).suffix == ".pt" else None
        self.model_cfg = "tamtr.yaml" if weights else model
        self.nc, self.seed, self.imgsz, self.max_gt = nc, seed, imgsz, max_gt
        self._engine: Optional[Engine] = None
        if weights:
            self.load(weights, nc=nc)

    def _lazy_engine(self) -> Engine:
        if self._engine is None:
            self._engine = Engine(self.model_cfg, device=self.device)
        return self._engine

    @property
    def model(self) -> TAMTRModel:
        """The detector's one model, the engine's: initialised from `seed` on
        first use unless `train` or `load` gave the engine one."""
        eng = self._lazy_engine()
        if eng.model is None:
            net = TAMTRModel.from_cfg(self.model_cfg, nc=self.nc or 10, max_gt=self.max_gt)
            init_parameters(net, self.seed)
            eng.model = net.to(self.device).eval()
        return eng.model

    def info(self, imgsz: int = 640, nc: int = 80) -> str:
        """The model's summary, logged and returned, as the JAX package's
        `TAMTR.info` gives it: "TAMTR(<cfg>): <n> layers, <x>M params", with
        ", <g> GFLOPs @ <imgsz>px" once the engine holds a model (trained,
        loaded, set, or made by a predict). Layers are the graph's rows and
        the head; params count every variable the JAX package holds: the
        parameters and the BatchNorm statistics (not `num_batches_tracked`).
        A config with no model yet is counted at `nc` classes. GFLOPs are one
        eval forward at batch 1 (`utils/profiler.py:flops_of`)."""
        from tamtr_torch.utils.log import LOGGER
        from tamtr_torch.utils.profiler import flops_of

        held = self._engine.model if self._engine is not None else None
        model = held if held is not None else TAMTRModel.from_cfg(self.model_cfg, nc=nc)
        n_params = variable_count(model)
        gflops = ""
        if held is not None:
            dev = next(model.parameters()).device
            img = torch.zeros(1, imgsz, imgsz, 3, device=dev)
            txt = torch.zeros(1, model.nc, model.text_width, device=dev)
            gflops = f", {flops_of(model.eval(), img, txt)['gflops']:.1f} GFLOPs @ {imgsz}px"
        summary = (f"{type(self).__name__}({self.model_cfg}): {len(model.specs) + 1} layers, "
                   f"{n_params / 1e6:.1f}M params{gflops}")
        LOGGER.info(summary)
        return summary

    def load_jax_variables(self, params: Dict, batch_stats: Dict) -> "TAMTR":
        """Load the JAX package's flax variables (nested dicts of arrays)."""
        sd, report = from_jax_variables(params, batch_stats, self.model)
        problems = {k: v for k, v in report.items() if v}
        if problems:
            raise ValueError(f"incomplete weight bridge: {problems}")
        self.model.load_state_dict(sd, strict=True)
        return self

    def trainer(self, cfg: TrainConfig = TrainConfig(), seed: int = 0) -> Trainer:
        """A `Trainer` over this detector's model and device, with its
        head's loss at `imgsz` (`loss_config_for`); `step(batch)` is one
        training step (see `Trainer.step`). Predict puts the model back in
        eval mode itself."""
        model = self.model
        loss_cfg = loss_config_for(model, imgsz=self.imgsz, match_method=cfg.match_method)
        return Trainer(model, cfg, loss_cfg=loss_cfg, device=self.device, seed=seed)

    def train(self, **overrides) -> Dict[str, float]:
        """Train a model of this config, initialised from the seed, on a
        dataset (`data=` a dataset .json/.yaml file) with the keys of
        `tamtr_torch.config.Config`; returns the last val metrics. The
        trained EMA model becomes this detector's model."""
        args = {"seed": self.seed, "imgsz": self.imgsz, "max_gt": self.max_gt, **overrides}
        if self.nc is not None and args.get("data") and load_data_yaml(args["data"])["nc"] != self.nc:
            raise ValueError(f"the dataset's nc differs from this detector's nc={self.nc}")
        eng = self._lazy_engine()
        res = eng.train(**args)
        self.nc, self.imgsz = eng.model.nc, eng.cfg.imgsz
        return res

    def val(self, **overrides) -> Dict[str, float]:
        """mAP of this detector's model (trained, loaded or bridged) on `data=`."""
        return self._lazy_engine().val(**{"imgsz": self.imgsz, **overrides})

    def load(self, ckpt_path: Union[str, Path], nc: Optional[int] = None,
             names: Optional[List[str]] = None) -> "TAMTR":
        """The EMA weights of a checkpoint written by `train` (`weights/last.pt`
        or `best.pt`), with its classes and model config, or of a reference
        (ultralytics) checkpoint such as "TAM_TR.pt", with its classes, on
        this detector's config (`Engine.load`; `nc` and `names` for a
        checkpoint without them)."""
        self._lazy_engine().load(ckpt_path, nc=nc, names=names)
        self.nc, self.model_cfg = self._engine.model.nc, self._engine.model_cfg
        return self

    def export(self, fmt: str = "torch", **kwargs) -> Path:
        """Export this detector's model (trained, loaded, or seeded from the
        config): `Engine.export` in the formats of `engine/exporter.py`
        ("torch", "npz", "torch_export"), on this detector's device."""
        self.model  # noqa: B018  (the seeded model of a config, made on first use)
        return self._lazy_engine().export(fmt, **kwargs)

    def tune(self, iterations: int = 10, use_ray: bool = False, **kwargs) -> Dict[str, float]:
        """Hyperparameter search over short trainings of this config
        (`Engine.tune`): mutation evolution by default (isolate=True, a
        subprocess a trial), Ray Tune with ASHA with use_ray=True; `train`'s
        defaults of this detector (seed, imgsz, max_gt) unless given."""
        args = {"seed": self.seed, "imgsz": self.imgsz, "max_gt": self.max_gt, **kwargs}
        return self._lazy_engine().tune(iterations, use_ray=use_ray, **args)

    def set_classes(self, classes: List[str], embeddings: Optional[np.ndarray] = None) -> None:
        """Open-vocabulary retarget for `val`: new class names, with their
        (K, hd) text embeddings or the class-name ones."""
        self._lazy_engine().set_classes(classes, embeddings)

    def track(self, source, tracker: str = "bytetrack", persist: bool = False, conf: float = 0.25,
              iou: float = 0.7, max_det: int = 300, **overrides) -> List[Results]:
        """Multi-object tracking over a sequence of frames: an (H, W, 3) BGR
        uint8 array, a list of sources, a directory, a glob, an image file or
        a video file (`Engine.track`; save=True writes a video's annotated
        `.mp4`), for this detector's classes, at `imgsz`. `tracker`
        is "bytetrack" (the default) or "botsort" (camera-motion
        compensation by gmc_method: "sparseOptFlow", the default, "orb",
        "sift", "ecc" or "none"); the tracker's keys (gmc_method,
        with_reid, track_buffer, match_thresh,
        proximity_thresh, appearance_thresh) go in `overrides`. persist=True
        goes on with the tracker of the previous call. One `Results` per
        frame, its boxes the tracked ones and `track_ids` their ids."""
        eng = self._lazy_engine()
        eng.model = self.model  # the seeded model when none was trained, loaded or set
        return eng.track(source, tracker=tracker, persist=persist,
                         **{"imgsz": self.imgsz, "conf": conf, "iou": iou, "max_det": max_det, **overrides})

    def _to_batch(self, images: Union[ImageLike, Sequence[ImageLike]]):
        """(B, imgsz, imgsz, 3) float in [0, 1] on the device, and each image's (h, w)."""
        if isinstance(images, (np.ndarray, torch.Tensor)) and images.ndim == 4:
            images = list(images)
        elif isinstance(images, (np.ndarray, torch.Tensor)):
            images = [images]
        batch, sizes = [], []
        for im in images:
            t = torch.as_tensor(np.asarray(im) if isinstance(im, np.ndarray) else im)
            if t.ndim != 3 or t.shape[-1] != 3:
                raise ValueError(f"an image must be (H, W, 3), got {tuple(t.shape)}")
            is_uint8 = t.dtype == torch.uint8
            t = t.to(self.device, torch.float32)
            if is_uint8:
                t = t / 255.0
            sizes.append((t.shape[0], t.shape[1]))
            if t.shape[:2] != (self.imgsz, self.imgsz):
                t = F.interpolate(
                    t.permute(2, 0, 1)[None], size=(self.imgsz, self.imgsz),
                    mode="bilinear", align_corners=False,
                )[0].permute(1, 2, 0)
            batch.append(t)
        return torch.stack(batch), sizes

    @torch.inference_mode()
    def predict(self, images, text=None, conf: float = 0.25, iou: float = 0.7,
                max_det: int = 300, **overrides) -> Union[List[Results], List[Dict[str, np.ndarray]]]:
        """Detect objects in image files, or in images in memory.

        Args:
          images: a path (an image or a video file), a directory or a list
            of paths (with `text` None): `Engine.predict` over the files,
            for this detector's classes, at `imgsz`, with the engine's
            options in `overrides` (augment, classes, save, project, name,
            vid_stride, ...); one `Results` per image or video frame. Or (B, H, W, 3) or (H, W, 3) uint8 or float in [0, 1], or
            a list of (H, W, 3) images of any sizes, with `text`.
          text: (K, hd) or (1|B, K, hd) class embeddings of the images in
            memory.
          fuse=True (in `overrides`) runs the fused twin of the model
            (`nn/fuse.py`) on either path, half=True a twin computing in
            bf16 (fused first when both are set).
        Returns:
          one `Results` per file; or one dict per image in memory: "boxes"
          (n, 4) xyxy in the image's pixels, "scores" (n,), "labels" (n,)
          int32.
        """
        if text is None and self.model.head_type == "Classify":  # class probabilities, of arrays too
            eng = self._lazy_engine()
            eng.model = self.model
            return eng.predict(images, **{"imgsz": self.imgsz, **overrides})
        if text is None:
            if not isinstance(images, (str, Path, list, tuple)) or (
                    isinstance(images, (list, tuple)) and not all(isinstance(x, (str, Path)) for x in images)):
                raise ValueError("predict takes a path, a directory or a list of paths, or images with text")
            eng = self._lazy_engine()
            eng.model = self.model  # the seeded model when none was trained, loaded or set
            return eng.predict(images, **{"imgsz": self.imgsz, "conf": conf, "iou": iou, "max_det": max_det,
                                          **overrides})
        model = self._lazy_engine()._eval_model(self.model, get_cfg(overrides=overrides))
        img, sizes = self._to_batch(images)
        txt = torch.as_tensor(np.asarray(text) if isinstance(text, np.ndarray) else text)
        txt = txt.to(self.device, torch.float32)
        if txt.ndim == 2:
            txt = txt[None]
        pred = normalized_pred(model, model(img, txt)["pred"], img.shape[1:3])
        boxes, scores, labels, valid, _ = postprocess_predictions(pred, conf, iou, max_det)
        results = []
        for i, (h, w) in enumerate(sizes):
            sel = valid[i] & (scores[i] > 0)
            scale = torch.tensor([w, h, w, h], dtype=torch.float32, device=boxes.device)
            results.append({
                "boxes": (boxes[i][sel] * scale).cpu().numpy(),
                "scores": scores[i][sel].cpu().numpy(),
                "labels": labels[i][sel].cpu().numpy(),
            })
        return results


class RTDETR(TAMTR):
    """The text-free RT-DETR detector (`tamtr_tpu/api.py:129-133`):
    `TAMTR("rtdetr.yaml")`, AIFI on the deepest level and the RTDETRDecoder
    head, with TAMTR's entry points. It scores with Linear heads and takes
    no text: predict's `text` is a (K, 512) table of its classes' rows,
    which it ignores."""

    def __init__(self, model: Union[str, Path] = "rtdetr.yaml", **kw):
        super().__init__(model, **kw)


class YOLO(TAMTR):
    """The YOLO facade (`tamtr_tpu/api.py:107-126`): a `TAMTR` whose task
    comes from the config's name unless given: "seg" -> segment, "pose" ->
    pose, "classify" or "cls" -> classify, else detect (`yolo-gelan.yaml`,
    `yolo-seg-gelan.yaml`, `yolo-pose-gelan.yaml`, `classify-gelan.yaml`).
    The engine picks the head's task from the model itself; `task` is
    informative."""

    def __init__(self, model: Union[str, Path] = "yolo-gelan.yaml", task: Optional[str] = None, **kw):
        stem = str(model).lower()
        if task is None:
            task = ("segment" if "seg" in stem else "pose" if "pose" in stem
                    else "classify" if "classify" in stem or "cls" in stem else "detect")
        self.task = task
        super().__init__(model, **kw)


# the reference's import name for the text-guided detector
RTDETRWorld = TAMTR


class FastSAM(YOLO):
    """FastSAM (`tamtr_tpu/api.py:180-201`): a YOLO segment model
    (`yolo-seg-gelan.yaml`) whose predict gives every instance's mask, and
    `prompt(result, ...)` to select masks by box, point or text
    (`models/fastsam.py:FastSAMPrompt`)."""

    def __init__(self, model: Union[str, Path] = "yolo-seg-gelan.yaml", **kw):
        super().__init__(model, task="segment", **kw)

    @staticmethod
    def prompt(result: Results, bboxes=None, points=None, labels=None, texts=None, embed_fn=None) -> np.ndarray:
        """The mask of a box prompt, of point prompts, of a text prompt (in
        that order of precedence), or every mask, at the image's size."""
        from tamtr_torch.models.fastsam import FastSAMPrompt

        p = FastSAMPrompt(result)
        if bboxes is not None:
            return p.box_prompt(bboxes)
        if points is not None:
            return p.point_prompt(points, labels)
        if texts is not None:
            return p.text_prompt(texts, embed_fn=embed_fn)
        return p.everything()


class NAS:
    """Predict and val of a trained detection checkpoint
    (`tamtr_tpu/api.py:204-245`; the reference wraps YOLO-NAS weights
    this way): no config, and no training."""

    def __init__(self, model: Union[str, Path] = "yolo_nas.pt", device: Optional[Union[str, torch.device]] = None):
        if Path(model).suffix in (".yaml", ".yml", ".json"):
            raise ValueError("NAS models only support pre-trained weights, not model configs")
        self.weights, self.device = str(model), device
        self._engine: Optional[Engine] = None

    def _lazy_engine(self) -> Engine:
        if self._engine is None:
            self._engine = Engine("yolo-gelan.yaml", device=self.device).load(self.weights)
        return self._engine

    def predict(self, source=None, **kwargs):
        return self._lazy_engine().predict(source, **kwargs)

    def __call__(self, source=None, **kwargs):
        return self.predict(source, **kwargs)

    def val(self, **kwargs):
        return self._lazy_engine().val(**kwargs)

    def train(self, **kwargs):
        raise NotImplementedError("NAS models only support predict/val (reference parity).")

    def info(self) -> str:
        return f"NAS({self.weights}): nc={len(self._lazy_engine().names)}"


class SAM:
    """Segment Anything (`tamtr_tpu/api.py:137-177`): "mobile_sam" (the
    default), "sam_b", "sam_l" or "sam_h" with seeded weights, a path to
    an `.npz` of the JAX package's SAM variables whose name ends in one of
    them (`build_sam`), or a `SamModel`.

        sam = SAM("mobile_sam")
        sam("img.jpg", bboxes=[x1, y1, x2, y2])   # a mask per box
        sam("img.jpg", points=[[x, y]], labels=[1])
        sam("img.jpg")                            # segment everything

    Runs on the card unless device="cpu"."""

    def __init__(self, model="mobile_sam", device: Optional[Union[str, torch.device]] = None):
        self.model_name, self.device = model, device
        self._predictor = None

    @property
    def predictor(self):
        if self._predictor is None:
            from tamtr_torch.models.sam.predict import SAMPredictor

            self._predictor = SAMPredictor(self.model_name, device=self.device)
        return self._predictor

    def __call__(self, source=None, **kwargs) -> List[Results]:
        return self.predict(source, **kwargs)

    def predict(self, source=None, bboxes=None, points=None, labels=None, **kwargs) -> List[Results]:
        """Promptable segmentation with prompts, else automatic."""
        return self.predictor(source, bboxes=bboxes, points=points, labels=labels, **kwargs)

    def info(self) -> str:
        """"SAM(<name>): <x>M params, imgsz=<s>", every variable counted
        (`variable_count`: the TinyViT's BatchNorm statistics too, as JAX
        counts them)."""
        p = self.predictor
        return f"SAM({self.model_name}): {variable_count(p.sam) / 1e6:.1f}M params, imgsz={p.imgsz}"

    @property
    def task_map(self):
        from tamtr_torch.models.sam.predict import SAMPredictor

        return {"segment": {"predictor": SAMPredictor}}
