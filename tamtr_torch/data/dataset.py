"""YOLO-format detection dataset and fixed-shape batch loader (a port of
the JAX package's `tamtr_tpu/data/dataset.py`, detect task).

- YOLO label txts (cls cx cy w h, normalized) next to the images
  (`images/` -> `labels/`), parsed once and cached in an npz keyed by a hash
  of the file list.
- The TAM-TR train path stretches every image square and applies
  mosaic(p), perspective, HSV and flips; val stretches (or letterboxes, in
  rect mode).
- `collate` pads the ground truth to `max_gt` slots with a validity mask,
  the batch dict `Trainer.step` takes.
- `Loader` runs `torch.utils.data.DataLoader` over a map-style set of batch
  keys: batch `bi` of epoch `e` draws from `np.random.default_rng((seed, e,
  bi))`, so the batches are the JAX package's and do not depend on the
  worker count.

Images are read by `data/image_io.py` (PNG and `.npy`; no JPEG yet).
`ClassificationDataset` is not ported.
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
from tamtr_torch.data.image_io import png_shape
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
        class_texts: Optional[Sequence[Sequence[str]]] = None,
        random_text: bool = False,
        cache: "bool | str" = False,
        classes: Optional[Sequence[int]] = None,
        single_cls: bool = False,
    ) -> None:
        self.imgsz = imgsz
        self.augment = augment
        self.aug = aug or AugConfig()
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
        """With `classes`, keep only the gt rows of those classes (no remap);
        with `single_cls`, every gt is class 0. Applied after the label cache
        loads, so the cache stays unfiltered."""
        if classes is None and not single_cls:
            return
        include = np.asarray(list(classes), np.int32) if classes is not None else None
        for lab in self.labels:
            if include is not None:
                j = np.isin(lab["cls"], include)
                lab["cls"] = lab["cls"][j]
                lab["xywhn"] = lab["xywhn"][j]
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

    @staticmethod
    def _parse_label_file(lf: str) -> Dict[str, np.ndarray]:
        """One YOLO label txt, `cls cx cy w h` rows, normalized."""
        try:
            text = Path(lf).read_text()
        except OSError:
            text = ""
        cls, xywhn = [], []
        for line in text.splitlines():
            r = np.array(line.split(), np.float32)
            if len(r) >= 5:
                xywhn.append(r[1:5])
                cls.append(r[0])
        return {
            "cls": np.asarray(cls, np.int32).reshape(-1),
            "xywhn": np.asarray(xywhn, np.float32).reshape(-1, 4).clip(0, 1),
        }

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
        return A.Sample(img, boxes, lab["cls"].copy())

    def close_mosaic(self) -> None:
        """Disable mosaic for the final epochs."""
        self._mosaic_on = False

    def _image_shape(self, i: int) -> Tuple[int, int]:
        """(h, w) of image i; a PNG's from its header, without decoding."""
        if Path(self.im_files[i]).suffix.lower() == ".png":
            return png_shape(self.im_files[i])
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
        return A.Sample(smp.img, smp.boxes[keep], new_cls, texts)


def collate(samples: Sequence[A.Sample], max_gt: int, imgsz: int) -> Dict[str, np.ndarray]:
    """Fixed-shape batch dict: img (B, H, W, 3) uint8 RGB, cls (B, max_gt),
    bboxes (B, max_gt, 4) normalized cxcywh, mask (B, max_gt), and texts
    (B lists of strings) when the samples carry them. With more gts than
    slots, the largest boxes are kept."""
    B = len(samples)
    img = np.empty((B,) + samples[0].img.shape, np.uint8)
    for b, s in enumerate(samples):
        img[b] = s.img[..., ::-1]  # BGR -> RGB
    cls = np.zeros((B, max_gt), np.int32)
    boxes = np.zeros((B, max_gt, 4), np.float32)
    mask = np.zeros((B, max_gt), bool)
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
    out = {"img": img, "cls": cls, "bboxes": boxes, "mask": mask}
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
        return collate([self.ds.get(int(i), rng) for i in idxs], self.max_gt, self.ds.imgsz)


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
        for bi in range(len(ld)):
            yield ld.epoch, bi, tuple(int(i) for i in idxs[bi * ld.bs:(bi + 1) * ld.bs]), ld.ds._mosaic_on


class Loader:
    """Shuffled full batches of a `DetectionDataset` per epoch (the last
    partial batch dropped), built by `workers` processes (spawned, kept
    across epochs; 0 builds them in this process), as tensors, in pinned
    memory with `pin_memory`."""

    def __init__(self, dataset: DetectionDataset, batch_size: int, max_gt: int = 128, seed: int = 0,
                 workers: int = 8, pin_memory: bool = False) -> None:
        self.ds, self.bs, self.max_gt, self.seed = dataset, batch_size, max_gt, seed
        self.epoch = 0
        self._dl = torch.utils.data.DataLoader(
            _Batches(dataset, max_gt, seed), batch_size=None, sampler=_EpochKeys(self),
            num_workers=workers, pin_memory=pin_memory, persistent_workers=workers > 0,
            multiprocessing_context="spawn" if workers > 0 else None,
        )

    def __len__(self) -> int:
        return len(self.ds) // self.bs

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        return iter(self._dl)

