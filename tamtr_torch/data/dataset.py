"""YOLO-format detection dataset and fixed-shape batch loader (a port of
the JAX package's `tamtr_tpu/data/dataset.py`: the detect, segment and pose
tasks).

- YOLO label txts next to the images (`images/` -> `labels/`), parsed once
  and cached in an npz keyed by a hash of the file list: `cls cx cy w h`
  rows; in a segment dataset also polygon rows `cls x1 y1 ... xn yn`
  (the box is the polygon's extent; a box row's polygon is its corners);
  in a pose dataset rows of 5 + nk * kdim values (`kpt_shape`).
- The TAM-TR train path stretches every image square and applies
  mosaic(p), perspective, HSV and flips; val stretches (or letterboxes, in
  rect mode).
- `collate` pads the ground truth to `max_gt` slots with a validity mask,
  the batch dict `Trainer.step` takes; a segment batch adds each kept gt's
  mask filled at imgsz / mask_ratio (`imgproc.fill_poly`, cv2's
  `fillPoly`), a pose batch its keypoints.
- `Loader` runs `torch.utils.data.DataLoader` over a map-style set of batch
  keys: batch `bi` of epoch `e` draws from `np.random.default_rng((seed, e,
  bi))`, so the batches are the JAX package's and do not depend on the
  worker count.

Classification (`ClassificationDataset`, `ClassificationLoader`; the JAX
package's `tamtr_tpu/data/dataset.py:593-720`): an ImageFolder
`root/<class>/*`, a random-resized crop and a flip in training, a
short-side resize and a centre crop in eval, both resized as cv2 resizes
(`imgproc.resize_linear`), and batches in this process.

Images are read by `data/image_io.py` (PNG, JPEG, BMP, TIFF, WebP, `.npy`)
as cv2 reads them.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tamtr_torch.data import augment as A
from tamtr_torch.data import imgproc
from tamtr_torch.data.image_io import imread as _imread
from tamtr_torch.data.image_io import image_shape
from tamtr_torch.utils.log import LOGGER

IMG_EXTS = {".bmp", ".jpg", ".jpeg", ".png", ".tif", ".tiff", ".webp"}


@dataclass
class AugConfig:
    """The reference hyp keys of the augmentations."""

    mosaic: float = 0.0  # TAM-TR ships mosaic off
    mosaic_n: int = 4  # 4 or 9 tiles
    mixup: float = 0.0
    copy_paste: float = 0.3
    degrees: float = 0.0
    translate: float = 0.1
    scale: float = 0.9
    shear: float = 0.0
    perspective: float = 0.0
    hsv_h: float = 0.015
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    fliplr: float = 0.5
    flipud: float = 0.0


def _img2label_path(img_path: str) -> str:
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    p = Path(img_path)
    return str(p.parent.parent / "labels" / (p.stem + ".txt")) if sa in str(p) else str(
        p.with_suffix(".txt")
    ).replace(sa, sb)


class DetectionDataset:
    """Images + YOLO labels with normalized-xywh -> pixel-xyxy conversion."""

    def __init__(
        self,
        img_dir: str | Path | Sequence[str],
        imgsz: int = 640,
        augment: bool = False,
        aug: Optional[AugConfig] = None,
        cache_labels: bool = True,
        seed: int = 0,
        task: str = "detect",
        kpt_shape: Tuple[int, int] = (17, 3),
        class_texts: Optional[Sequence[Sequence[str]]] = None,
        random_text: bool = False,
        cache: "bool | str" = False,
        classes: Optional[Sequence[int]] = None,
        single_cls: bool = False,
    ) -> None:
        self.imgsz = imgsz
        self.augment = augment
        self.aug = aug or AugConfig()
        self.task = task  # "detect" | "segment" | "pose"
        self.kpt_shape = tuple(kpt_shape)
        # per-class synonym lists (names split on "/"); RandomLoadText in training
        self.class_texts = [list(t) for t in class_texts] if class_texts else None
        self.random_text = random_text and self.class_texts is not None
        self.im_files = self._glob_images(img_dir)
        if not self.im_files:
            raise FileNotFoundError(f"no images found under {img_dir}")
        self.label_files = [_img2label_path(f) for f in self.im_files]
        self.labels = self._load_labels(cache_labels)
        self._update_labels(classes, single_cls)
        self._rng = np.random.default_rng(seed)
        self._mosaic_on = self.aug.mosaic > 0
        self._albu = A._get_albumentations() if augment else None
        # decoded-image cache: "ram" keeps the arrays, "disk" a .npy beside each image
        self.cache = {True: "ram", False: ""}.get(cache, str(cache or "").lower())
        self._im_cache: Dict[int, np.ndarray] = {}
        if self.cache == "ram" and not self._check_cache_ram():
            LOGGER.warning("cache=ram needs more free memory than available; caching disabled")
            self.cache = ""

    def _update_labels(self, classes: Optional[Sequence[int]], single_cls: bool) -> None:
        """With `classes`, keep only the gt rows of those classes (no remap),
        with their polygons and keypoints; with `single_cls`, every gt is
        class 0. Applied after the label cache loads, so the cache stays
        unfiltered."""
        if classes is None and not single_cls:
            return
        include = np.asarray(list(classes), np.int32) if classes is not None else None
        for lab in self.labels:
            if include is not None:
                j = np.isin(lab["cls"], include)
                lab["cls"] = lab["cls"][j]
                lab["xywhn"] = lab["xywhn"][j]
                if "segments" in lab:
                    lab["segments"] = [seg for seg, keep in zip(lab["segments"], j) if keep]
                if "kpts" in lab:
                    lab["kpts"] = lab["kpts"][j]
            if single_cls:
                lab["cls"] = np.zeros_like(lab["cls"])

    def _check_cache_ram(self, safety: float = 1.3) -> bool:
        """The decoded set must fit in 70% of the free memory."""
        sample = _imread(self.im_files[0])
        if sample is None:
            return False
        need = sample.nbytes * len(self.im_files) * safety
        try:
            avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
        except (ValueError, OSError):
            return False
        return need < 0.7 * avail

    @staticmethod
    def _glob_images(src) -> List[str]:
        files: List[str] = []
        for p in [src] if isinstance(src, (str, Path)) else list(src):
            p = Path(p)
            if p.is_dir():
                files += sorted(str(f) for f in p.rglob("*") if f.suffix.lower() in IMG_EXTS)
            elif p.is_file() and p.suffix == ".txt":
                base = p.parent
                for line in p.read_text().splitlines():
                    line = line.strip()
                    if line:
                        f = Path(line)
                        files.append(str(f if f.is_absolute() else base / f))
            elif p.is_file():
                files.append(str(p))
        return files

    def _cache_path(self) -> Path:
        h = hashlib.sha1("".join(self.im_files).encode()).hexdigest()[:16]
        return Path(self.label_files[0]).parent / f".tamtr_labels_{h}.npz"

    def _load_labels(self, use_cache: bool) -> List[Dict[str, np.ndarray]]:
        cp = self._cache_path()
        if use_cache and cp.exists():
            try:
                labels = list(np.load(cp, allow_pickle=True)["labels"])  # written below
                if len(labels) == len(self.im_files):
                    return labels
            except (OSError, ValueError, KeyError):
                pass
        labels = [self._parse_label_file(lf) for lf in self.label_files]
        if use_cache:
            try:
                np.savez_compressed(cp, labels=np.array(labels, dtype=object))
            except OSError:
                pass
        return labels

    def _parse_label_file(self, lf: str) -> Dict[str, np.ndarray]:
        """One YOLO label txt, all values normalized: detect `cls cx cy w h`;
        segment `cls x1 y1 ... xn yn` (the box is the polygon's extent; a
        box row's polygon is the box's corners); pose `cls cx cy w h (px py
        v) * nk`, a box row's keypoints zeros."""
        rows = []
        try:
            text = Path(lf).read_text()
        except OSError:
            text = ""
        for line in text.splitlines():
            vals = line.split()
            if vals:
                rows.append(np.array(vals, np.float32))
        cls, xywhn, segments, kpts = [], [], [], []
        nk, kdim = self.kpt_shape
        for r in rows:
            if self.task == "segment" and len(r) > 5 and (len(r) - 1) % 2 == 0:
                poly = r[1:].reshape(-1, 2)
                x1, y1 = poly.min(0)
                x2, y2 = poly.max(0)
                xywhn.append([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1])
                segments.append(poly)
                cls.append(r[0])
            elif self.task == "pose" and len(r) == 5 + nk * kdim:
                xywhn.append(r[1:5])
                kpts.append(r[5:].reshape(nk, kdim))
                cls.append(r[0])
            elif len(r) >= 5:
                xywhn.append(r[1:5])
                cls.append(r[0])
                if self.task == "segment":  # a box row in a segment dataset: its corners
                    cx, cy, w, h = r[1:5]
                    segments.append(np.array(
                        [[cx - w / 2, cy - h / 2], [cx + w / 2, cy - h / 2],
                         [cx + w / 2, cy + h / 2], [cx - w / 2, cy + h / 2]], np.float32))
                elif self.task == "pose":
                    kpts.append(np.zeros((nk, kdim), np.float32))
        out = {
            "cls": np.asarray(cls, np.int32).reshape(-1),
            "xywhn": np.asarray(xywhn, np.float32).reshape(-1, 4).clip(0, 1),
        }
        if self.task == "segment":
            out["segments"] = segments
        if self.task == "pose":
            out["kpts"] = np.stack(kpts) if kpts else np.zeros((0, nk, kdim), np.float32)
        return out

    def __len__(self) -> int:
        return len(self.im_files)

    def _decode(self, i: int) -> Optional[np.ndarray]:
        """Decoded BGR uint8 image, through the ram/disk cache if enabled;
        the cached array is shared, and no augmentation writes in place."""
        if self.cache == "ram":
            img = self._im_cache.get(i)
            if img is None:
                img = _imread(self.im_files[i])
                if img is not None:
                    self._im_cache[i] = img
            return img
        if self.cache == "disk":
            npy = Path(self.im_files[i]).with_suffix(".npy")
            if npy.exists():
                try:
                    return np.load(npy, mmap_mode="r")
                except (OSError, ValueError):
                    pass
            img = _imread(self.im_files[i])
            if img is not None:
                try:
                    np.save(npy, img)
                except OSError:
                    pass
            return img
        return _imread(self.im_files[i])

    def _read(self, i: int) -> A.Sample:
        img = self._decode(i)
        if img is None:
            raise FileNotFoundError(self.im_files[i])
        h, w = img.shape[:2]
        lab = self.labels[i]
        xywhn = lab["xywhn"]
        boxes = np.empty((len(xywhn), 4), np.float32)
        if len(xywhn):
            cx, cy, bw, bh = (xywhn * np.array([w, h, w, h], np.float32)).T
            boxes[:, 0] = cx - bw / 2
            boxes[:, 1] = cy - bh / 2
            boxes[:, 2] = cx + bw / 2
            boxes[:, 3] = cy + bh / 2
        segs = None
        if "segments" in lab:
            segs = [p * np.array([w, h], np.float32) for p in lab["segments"]]
        kpts = None
        if "kpts" in lab:
            kpts = lab["kpts"].copy()
            kpts[..., 0] *= w
            kpts[..., 1] *= h
        return A.Sample(img, boxes, lab["cls"].copy(), segs, kpts)

    def close_mosaic(self) -> None:
        """Disable mosaic for the final epochs."""
        self._mosaic_on = False

    def _image_shape(self, i: int) -> Tuple[int, int]:
        """(h, w) of image i; a PNG's or a JPEG's from its headers, without
        decoding."""
        if Path(self.im_files[i]).suffix.lower() in (".png", ".jpg", ".jpeg"):
            return image_shape(self.im_files[i])
        return self._read(i).img.shape[:2]

    def set_rectangle(self, batch_size: int, stride: int = 32, pad: float = 0.5) -> None:
        """Aspect-ratio-binned val batch shapes: sort the images by aspect
        ratio, then give each batch the least stride-multiple shape that
        letterboxes its images."""
        ni = len(self.im_files)
        shapes = np.array([self._image_shape(i) for i in range(ni)], np.float64)
        bi = np.floor(np.arange(ni) / batch_size).astype(int)
        nb = int(bi[-1]) + 1
        ar = shapes[:, 0] / shapes[:, 1]  # h / w
        irect = ar.argsort()
        self.im_files = [self.im_files[i] for i in irect]
        self.label_files = [self.label_files[i] for i in irect]
        self.labels = [self.labels[i] for i in irect]
        self._im_cache.clear()
        ar = ar[irect]
        out = [[1.0, 1.0]] * nb
        for b in range(nb):
            ari = ar[bi == b]
            mini, maxi = ari.min(), ari.max()
            if maxi < 1:
                out[b] = [maxi, 1.0]
            elif mini > 1:
                out[b] = [1.0, 1.0 / mini]
        self.batch_shapes = np.ceil(np.array(out) * self.imgsz / stride + pad).astype(int) * stride
        self.batch_index = bi
        self.rect = True

    def get_val(self, i: int):
        """Eval sample: (RGB float image, native-space labels, (h, w), lb).

        Square mode (default): stretch to (imgsz, imgsz), lb = None. Rect
        mode (after `set_rectangle`): letterbox (no upscaling) to the image's
        batch shape; lb = (ratio, left, top) maps predictions back."""
        raw = self._read(i)
        h, w = raw.img.shape[:2]
        if getattr(self, "rect", False):
            bh, bw = (int(v) for v in self.batch_shapes[self.batch_index[i]])
            r = min(bh / h, bw / w, 1.0)
            nh, nw = max(round(h * r), 1), max(round(w * r), 1)
            resized = imgproc.resize_linear(raw.img, (nw, nh))
            canvas = np.full((bh, bw, 3), 114, np.uint8)
            top, left = (bh - nh) // 2, (bw - nw) // 2
            canvas[top:top + nh, left:left + nw] = resized
            img = canvas[..., ::-1].astype(np.float32) / 255.0
            return img, raw, (h, w), (r, left, top)
        img = imgproc.resize_linear(raw.img, (self.imgsz, self.imgsz))
        img = img[..., ::-1].astype(np.float32) / 255.0
        return img, raw, (h, w), None

    def get(self, i: int, rng: Optional[np.random.Generator] = None) -> A.Sample:
        """Load + augment one sample at imgsz (the stretch path)."""
        rng = rng or self._rng
        s = self.imgsz
        if self.augment:
            if self._mosaic_on and rng.random() < self.aug.mosaic:
                n = 9 if self.aug.mosaic_n == 9 else 4
                idxs = [i] + list(rng.integers(0, len(self), n - 1))
                parts = [A.stretch_resize(self._read(j), s) for j in idxs]
                smp = (A.mosaic9 if n == 9 else A.mosaic4)(parts, s, rng)
                border = (-s // 2, -s // 2)
            else:
                smp = A.stretch_resize(self._read(i), s)
                border = (0, 0)
            # the reference order: Mosaic -> CopyPaste -> RandomPerspective
            smp = A.copy_paste(smp, rng, self.aug.copy_paste)
            smp = A.random_perspective(
                smp, rng, degrees=self.aug.degrees, translate=self.aug.translate,
                scale=self.aug.scale, shear=self.aug.shear, perspective=self.aug.perspective,
                border=border,
            )
            if self.aug.mixup and rng.random() < self.aug.mixup:
                j = int(rng.integers(0, len(self)))
                other = A.random_perspective(
                    A.stretch_resize(self._read(j), s), rng, scale=self.aug.scale,
                    translate=self.aug.translate,
                )
                smp = A.mixup(smp, other, rng)
            # then MixUp -> Albumentations -> RandomHSV -> flips
            smp = A.albumentations_transform(smp, rng, compose=self._albu)
            smp = A.random_hsv(smp, rng, self.aug.hsv_h, self.aug.hsv_s, self.aug.hsv_v)
            smp = A.random_flip(smp, rng, self.aug.fliplr, self.aug.flipud)
            smp = self._load_text(smp, rng)
        else:
            smp = A.stretch_resize(self._read(i), s)
        return smp

    def _load_text(self, smp: A.Sample, rng: np.random.Generator) -> A.Sample:
        """RandomLoadText: per-image text sampling and class-id remap."""
        if not self.random_text:
            return smp
        max_s = min(len(self.class_texts), 80)
        new_cls, keep, texts = A.random_load_text(
            smp.cls, self.class_texts, rng, max_samples=max_s, padding=True
        )
        segs = None
        if smp.segments is not None:
            segs = [p for p, k in zip(smp.segments, keep) if k]
        kpts = smp.keypoints[keep] if smp.keypoints is not None else None
        return A.Sample(smp.img, smp.boxes[keep], new_cls, segs, kpts, texts)


def collate(samples: Sequence[A.Sample], max_gt: int, imgsz: int, task: str = "detect",
            kpt_shape: Tuple[int, int] = (17, 3), mask_ratio: int = 4) -> Dict[str, np.ndarray]:
    """Fixed-shape batch dict: img (B, H, W, 3) uint8 RGB, cls (B, max_gt),
    bboxes (B, max_gt, 4) normalized cxcywh, mask (B, max_gt), and texts
    (B lists of strings) when the samples carry them. With more gts than
    slots, the largest boxes are kept. The segment task adds "masks" (B,
    max_gt, imgsz // mask_ratio, imgsz // mask_ratio) float32, each kept
    gt's polygon / mask_ratio (truncated to int) filled with 1 as
    cv2.fillPoly fills it; the pose task adds "keypoints" (B, max_gt, nk,
    kdim) in pixels."""
    B = len(samples)
    img = np.empty((B,) + samples[0].img.shape, np.uint8)
    for b, s in enumerate(samples):
        img[b] = s.img[..., ::-1]  # BGR -> RGB
    cls = np.zeros((B, max_gt), np.int32)
    boxes = np.zeros((B, max_gt, 4), np.float32)
    mask = np.zeros((B, max_gt), bool)
    hm = imgsz // mask_ratio
    if task == "segment":
        seg_masks = np.zeros((B, max_gt, hm, hm), np.float32)
    if task == "pose":
        keypoints = np.zeros((B, max_gt) + tuple(kpt_shape), np.float32)
    for b, s in enumerate(samples):
        n = min(len(s.cls), max_gt)
        if n:
            if len(s.cls) > max_gt:
                areas = (s.boxes[:, 2] - s.boxes[:, 0]) * (s.boxes[:, 3] - s.boxes[:, 1])
                order = np.argsort(-areas)[:max_gt]
            else:
                order = np.arange(n)
            b_xyxy = s.boxes[order]
            cx = (b_xyxy[:, 0] + b_xyxy[:, 2]) / 2 / imgsz
            cy = (b_xyxy[:, 1] + b_xyxy[:, 3]) / 2 / imgsz
            bw = (b_xyxy[:, 2] - b_xyxy[:, 0]) / imgsz
            bh = (b_xyxy[:, 3] - b_xyxy[:, 1]) / imgsz
            boxes[b, :n] = np.stack([cx, cy, bw, bh], -1)
            cls[b, :n] = s.cls[order]
            mask[b, :n] = True
            if task == "segment" and s.segments is not None:
                for j, oi in enumerate(order):
                    imgproc.fill_poly(seg_masks[b, j], (s.segments[int(oi)] / mask_ratio).astype(np.int32), 1.0)
            if task == "pose" and s.keypoints is not None:
                keypoints[b, :n] = s.keypoints[order]
    out = {"img": img, "cls": cls, "bboxes": boxes, "mask": mask}
    if task == "segment":
        out["masks"] = seg_masks
    if task == "pose":
        out["keypoints"] = keypoints
    if any(s.texts is not None for s in samples):
        out["texts"] = [s.texts or [] for s in samples]
    return out


class _Batches(torch.utils.data.Dataset):
    """Map-style set of batches, keyed (epoch, bi, image indices, mosaic on)
    by `_EpochKeys`: the key carries what a persistent worker's copy of the
    dataset cannot see change (the epoch, `close_mosaic`)."""

    def __init__(self, dataset: DetectionDataset, max_gt: int, seed: int) -> None:
        self.ds, self.max_gt, self.seed = dataset, max_gt, seed

    def __getitem__(self, key) -> Dict[str, np.ndarray]:
        epoch, bi, idxs, mosaic_on = key
        self.ds._mosaic_on = mosaic_on
        rng = np.random.default_rng((self.seed, epoch, bi))
        return collate([self.ds.get(int(i), rng) for i in idxs], self.max_gt, self.ds.imgsz, task=self.ds.task,
                       kpt_shape=self.ds.kpt_shape)


class _EpochKeys(torch.utils.data.Sampler):
    """The batch keys of the loader's current epoch, shuffled by
    `np.random.default_rng(seed + epoch)`."""

    def __init__(self, loader: "Loader") -> None:
        self.loader = loader

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        ld = self.loader
        idxs = np.arange(len(ld.ds))
        np.random.default_rng(ld.seed + ld.epoch).shuffle(idxs)
        idxs = idxs[ld.process_index::ld.process_count]  # this process's shard
        for bi in range(len(ld)):
            yield ld.epoch, bi, tuple(int(i) for i in idxs[bi * ld.bs:(bi + 1) * ld.bs]), ld.ds._mosaic_on


class Loader:
    """Shuffled full batches of a `DetectionDataset` per epoch (the last
    partial batch dropped), built by `workers` processes (spawned, kept
    across epochs; 0 builds them in this process), as tensors, in pinned
    memory with `pin_memory`. Process `process_index` of `process_count`
    (a data rank) takes every process_count-th image of the epoch's
    shuffled order, from its index on, as the JAX package's loader shards
    by host."""

    def __init__(self, dataset: DetectionDataset, batch_size: int, max_gt: int = 128, seed: int = 0,
                 workers: int = 8, pin_memory: bool = False, process_index: int = 0,
                 process_count: int = 1) -> None:
        self.ds, self.bs, self.max_gt, self.seed = dataset, batch_size, max_gt, seed
        self.process_index, self.process_count = process_index, process_count
        self.epoch = 0
        self._dl = torch.utils.data.DataLoader(
            _Batches(dataset, max_gt, seed), batch_size=None, sampler=_EpochKeys(self),
            num_workers=workers, pin_memory=pin_memory, persistent_workers=workers > 0,
            multiprocessing_context="spawn" if workers > 0 else None,
        )

    def __len__(self) -> int:
        return len(self.ds) // self.process_count // self.bs

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        return iter(self._dl)



class ClassificationDataset:
    """Folder-per-class image classification dataset: `root/<class>/*`,
    the classes sorted by name, each class's images sorted (at any depth).

    `get(i, rng)` returns (img (S, S, 3) float32 RGB in [0, 1], class
    index). With augment=True and a generator: a random-resized crop (area
    scale in `scale`, aspect ratio in [3/4, 4/3], drawn from `rng` as
    uniform, uniform, integers, integers) resized to S, then a left-right
    flip with probability `fliplr` (`rng.random()`). Otherwise the short
    side resized to S (rounded), then the centre crop."""

    IMG_EXTS = IMG_EXTS

    def __init__(self, root: str | Path, imgsz: int = 224, augment: bool = False,
                 scale: Tuple[float, float] = (0.5, 1.0), fliplr: float = 0.5, seed: int = 0) -> None:
        self.root = Path(root)
        self.imgsz, self.augment, self.scale, self.fliplr, self.seed = imgsz, augment, scale, fliplr, seed
        self.names = sorted(d.name for d in self.root.iterdir() if d.is_dir())
        if not self.names:
            raise FileNotFoundError(f"no class folders under {root}")
        self.samples: List[Tuple[str, int]] = [
            (str(f), ci) for ci, c in enumerate(self.names) for f in sorted((self.root / c).rglob("*"))
            if f.suffix.lower() in self.IMG_EXTS]

    def __len__(self) -> int:
        return len(self.samples)

    def get(self, i: int, rng: Optional[np.random.Generator] = None) -> Tuple[np.ndarray, int]:
        path, label = self.samples[i]
        img = _imread(path)
        if img is None:
            raise FileNotFoundError(path)
        h, w = img.shape[:2]
        s = self.imgsz
        if self.augment and rng is not None:
            area = rng.uniform(*self.scale) * h * w
            ar = rng.uniform(3 / 4, 4 / 3)
            cw = min(int(round(np.sqrt(area * ar))), w)
            ch = min(int(round(np.sqrt(area / ar))), h)
            x0 = rng.integers(0, w - cw + 1)
            y0 = rng.integers(0, h - ch + 1)
            img = imgproc.resize_linear(img[y0:y0 + ch, x0:x0 + cw], (s, s))
            if rng.random() < self.fliplr:
                img = img[:, ::-1]
        else:
            img = center_crop_resized(img, s)
        return np.ascontiguousarray(img[..., ::-1], np.float32) / 255.0, label


def center_crop_resized(img: np.ndarray, s: int) -> np.ndarray:
    """The short side of a uint8 image resized to s (the long side rounded,
    at least s) as cv2 resizes, then its centre (s, s) crop: the eval and
    predict transform of a classifier."""
    h, w = img.shape[:2]
    r = s / min(h, w)
    img = imgproc.resize_linear(img, (max(s, round(w * r)), max(s, round(h * r))))
    hh, ww = img.shape[:2]
    y0, x0 = (hh - s) // 2, (ww - s) // 2
    return img[y0:y0 + s, x0:x0 + s]


class ClassificationLoader:
    """Batches of a `ClassificationDataset` built in this process: each
    epoch's order shuffled by `default_rng(seed + epoch)`, process
    `process_index` of `process_count` taking every process_count-th
    image of it from its index on, the augmentations drawn from
    `default_rng(seed * 9973 + epoch)`, the last partial batch dropped
    (with drop_last). Every process yields `len(self)` batches, so a
    training step's collectives pair up when the shards are uneven (the
    JAX loader counts its own shard, and its first shards then take one
    batch more). A batch is {"img" (B, S, S, 3) float32, "cls" (B, 1)
    int32}."""

    def __init__(self, dataset: ClassificationDataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True, process_index: int = 0, process_count: int = 1) -> None:
        self.ds, self.bs, self.shuffle, self.seed, self.drop_last = dataset, batch_size, shuffle, seed, drop_last
        self.pi, self.pc = process_index, process_count
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.ds) // self.pc
        return n // self.bs if self.drop_last else (n + self.bs - 1) // self.bs

    def __iter__(self):
        idxs = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idxs)
        idxs = idxs[self.pi::self.pc]
        rng = np.random.default_rng(self.seed * 9973 + self._epoch)
        for s in range(0, len(self) * self.bs, self.bs):
            chunk = idxs[s:s + self.bs]
            imgs, labels = zip(*(self.ds.get(int(i), rng) for i in chunk))
            yield {"img": np.stack(imgs), "cls": np.asarray(labels, np.int32)[:, None]}
