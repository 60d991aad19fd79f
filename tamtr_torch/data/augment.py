"""Host-side augmentations in numpy, without cv2 (a port of the JAX
package's `tamtr_tpu/data/augment.py`, detect task).

The numpy code is a line-for-line copy of the JAX package's, and every
random draw comes in the same order from the same `np.random.Generator`, so
one seed gives the same geometry and equal labels. The cv2 calls are the
numpy versions of `tamtr_torch/data/imgproc.py`: resize and HSV give cv2's
bytes, the affine warp lies within one level of cv2's. Images are (H, W, 3)
uint8 BGR, as cv2 reads them; `collate` turns them to RGB.

Segments and keypoints (the segment and pose heads) are not carried, so
`copy_paste`, a no-op for box-only labels in the JAX package too, returns
its sample. `albumentations_transform` is a no-op when the package is not
installed, as in the JAX package; the card's machine does not have it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from tamtr_torch.data import imgproc


@dataclass
class Sample:
    """One image + labels in pixel space; `texts` are the per-sample class
    texts of RandomLoadText."""

    img: np.ndarray  # (H, W, 3) uint8, BGR
    boxes: np.ndarray  # (N, 4) xyxy pixels
    cls: np.ndarray  # (N,) int32
    texts: Optional[List[str]] = None


def stretch_resize(sample: Sample, size: int) -> Sample:
    """scaleFill stretch to (size, size): the TAM-TR load path."""
    h, w = sample.img.shape[:2]
    if (h, w) != (size, size):
        img = imgproc.resize_linear(sample.img, (size, size))
        sx, sy = size / w, size / h
        boxes = sample.boxes * np.array([sx, sy, sx, sy], dtype=np.float32)
    else:
        img, boxes = sample.img, sample.boxes
    return Sample(img, boxes.astype(np.float32), sample.cls)


def letterbox(
    sample: Sample, size: int, center: bool = True, color: int = 114
) -> Tuple[Sample, Tuple[float, float], Tuple[float, float]]:
    """Aspect-preserving resize + pad; returns (sample, ratio, pad)."""
    h, w = sample.img.shape[:2]
    r = min(size / h, size / w)
    nh, nw = round(h * r), round(w * r)
    img = imgproc.resize_linear(sample.img, (nw, nh))
    dh, dw = size - nh, size - nw
    if center:
        top, left = dh // 2, dw // 2
    else:
        top, left = 0, 0
    out = np.full((size, size, 3), color, dtype=np.uint8)
    out[top : top + nh, left : left + nw] = img
    boxes = sample.boxes * r + np.array([left, top, left, top], dtype=np.float32)
    return Sample(out, boxes.astype(np.float32), sample.cls), (r, r), (left, top)


def _mosaic_labels(all_boxes, all_cls, s: int) -> Tuple[np.ndarray, np.ndarray]:
    if all_boxes:
        boxes = np.concatenate(all_boxes, 0).clip(0, 2 * s)
        cls = np.concatenate(all_cls, 0)
        keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
        return boxes[keep], cls[keep]
    return np.zeros((0, 4), np.float32), np.zeros((0,), np.int32)


def mosaic4(
    samples: Sequence[Sample], size: int, rng: np.random.Generator, color: int = 114
) -> Sample:
    """4-image mosaic on a 2s x 2s canvas."""
    s = size
    yc = int(rng.uniform(s * 0.5, s * 1.5))
    xc = int(rng.uniform(s * 0.5, s * 1.5))
    canvas = np.full((2 * s, 2 * s, 3), color, dtype=np.uint8)
    all_boxes, all_cls = [], []
    for i, smp in enumerate(samples[:4]):
        img = smp.img
        h, w = img.shape[:2]
        if i == 0:  # top-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
        elif i == 1:  # top-right
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, 2 * s), yc
            x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
        elif i == 2:  # bottom-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(2 * s, yc + h)
            x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
        else:  # bottom-right
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, 2 * s), min(2 * s, yc + h)
            x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
        canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        padw, padh = x1a - x1b, y1a - y1b
        if len(smp.boxes):
            all_boxes.append(smp.boxes + np.array([padw, padh, padw, padh], dtype=np.float32))
            all_cls.append(smp.cls)
    boxes, cls = _mosaic_labels(all_boxes, all_cls, s)
    return Sample(canvas, boxes, cls)


def mosaic9(
    samples: Sequence[Sample], size: int, rng: np.random.Generator, color: int = 114
) -> Sample:
    """9-image (3x3) mosaic: tiles placed around the centre on a 3s x 3s
    canvas, each aligned to the previous tile's size, then the central
    2s x 2s crop (the output contract of `mosaic4`)."""
    s = size
    canvas = np.full((3 * s, 3 * s, 3), color, dtype=np.uint8)
    all_boxes, all_cls = [], []
    hp = wp = h0 = w0 = 0
    off = -(-s // 2)  # central-crop offset (reference border = -s//2)
    for i, smp in enumerate(samples[:9]):
        img = smp.img
        h, w = img.shape[:2]
        if i == 0:  # center
            h0, w0 = h, w
            c = s, s, s + w, s + h
        elif i == 1:  # top
            c = s, s - h, s + w, s
        elif i == 2:  # top right
            c = s + wp, s - h, s + wp + w, s
        elif i == 3:  # right
            c = s + w0, s, s + w0 + w, s + h
        elif i == 4:  # bottom right
            c = s + w0, s + hp, s + w0 + w, s + hp + h
        elif i == 5:  # bottom
            c = s + w0 - w, s + h0, s + w0, s + h0 + h
        elif i == 6:  # bottom left
            c = s + w0 - wp - w, s + h0, s + w0 - wp, s + h0 + h
        elif i == 7:  # left
            c = s - w, s + h0 - h, s, s + h0
        else:  # top left
            c = s - w, s + h0 - hp - h, s, s + h0 - hp
        padw, padh = c[:2]
        x1, y1, x2, y2 = (min(max(x, 0), 3 * s) for x in c)
        canvas[y1:y2, x1:x2] = img[y1 - padh : y2 - padh, x1 - padw : x2 - padw]
        hp, wp = h, w
        shift = np.array([padw - off, padh - off], dtype=np.float32)
        if len(smp.boxes):
            all_boxes.append(smp.boxes + np.concatenate([shift, shift]))
            all_cls.append(smp.cls)
    canvas = canvas[off : off + 2 * s, off : off + 2 * s]
    boxes, cls = _mosaic_labels(all_boxes, all_cls, s)
    return Sample(canvas, boxes.astype(np.float32), cls)


def random_perspective(
    sample: Sample,
    rng: np.random.Generator,
    degrees: float = 0.0,
    translate: float = 0.1,
    scale: float = 0.5,
    shear: float = 0.0,
    perspective: float = 0.0,
    border: Tuple[int, int] = (0, 0),
) -> Sample:
    """Affine/perspective warp + box transform + candidate filter (matrix
    chain M = T @ S @ R @ P @ C)."""
    img = sample.img
    h0, w0 = img.shape[:2]
    width = w0 + border[1] * 2
    height = h0 + border[0] * 2

    C = np.eye(3)
    C[0, 2] = -w0 / 2
    C[1, 2] = -h0 / 2
    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)
    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R[:2] = imgproc.rotation_matrix(a, (0, 0), s)
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * width
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * height
    M = T @ S @ R @ P @ C

    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        if perspective:
            img = imgproc.warp_perspective(img, M, (width, height), border=114)
        else:
            img = imgproc.warp_affine(img, M[:2], (width, height), border=114)

    boxes, cls = sample.boxes, sample.cls
    n = len(boxes)
    if n:
        xy = np.ones((n * 4, 3))
        xy[:, :2] = boxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
        xy = xy @ M.T
        xy = (xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]).reshape(n, 8)
        x = xy[:, [0, 2, 4, 6]]
        y = xy[:, [1, 3, 5, 7]]
        new = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], 1).astype(np.float32)
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
        keep = _box_candidates(boxes.T * s, new.T, area_thr=0.1)
        boxes, cls = new[keep], cls[keep]
    return Sample(img, boxes, cls, sample.texts)


def _box_candidates(box1, box2, wh_thr=2, ar_thr=100, area_thr=0.1, eps=1e-16):
    """Keep boxes with w, h > 2 px, area ratio > area_thr, aspect < 100."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


def bbox_ioa(box1: np.ndarray, box2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Intersection over box2 area: box1 (N, 4), box2 (M, 4) xyxy -> (N, M)."""
    b1x1, b1y1, b1x2, b1y2 = box1.T
    b2x1, b2y1, b2x2, b2y2 = box2.T
    iw = (np.minimum(b1x2[:, None], b2x2) - np.maximum(b1x1[:, None], b2x1)).clip(0)
    ih = (np.minimum(b1y2[:, None], b2y2) - np.maximum(b1y1[:, None], b2y1)).clip(0)
    area2 = (b2x2 - b2x1) * (b2y2 - b2y1)
    return iw * ih / (area2 + eps)


def copy_paste(sample: Sample, rng: np.random.Generator, p: float = 0.5) -> Sample:
    """Copy-Paste (arXiv:2012.07177) pastes mirrored instances by their
    polygon segments; box-only labels have none, so this returns the sample
    and draws nothing, as the JAX package's does for them."""
    return sample


def random_load_text(
    cls: np.ndarray,
    class_texts: Sequence[Sequence[str]],
    rng: np.random.Generator,
    max_samples: int = 80,
    neg_samples: Tuple[int, int] = (80, 80),
    padding: bool = True,
    padding_value: str = "",
    prompt_format: str = "{}",
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Sample positive + negative class texts and remap class ids.

    Args:
      cls: (N,) int class ids of the instances.
      class_texts: per-class synonym lists (names split on "/").
    Returns:
      (new_cls (N',), keep (N,) bool, texts list of <= max_samples strings,
       padded to max_samples when `padding`).
    """
    num_classes = len(class_texts)
    pos_labels = np.unique(cls).tolist()
    if len(pos_labels) > max_samples:
        pos_labels = list(rng.choice(pos_labels, size=max_samples, replace=False))
    n_neg = min(
        min(num_classes, max_samples) - len(pos_labels),
        int(rng.integers(neg_samples[0], neg_samples[1] + 1)),
    )
    neg_pool = [i for i in range(num_classes) if i not in set(pos_labels)]
    neg_labels = list(rng.choice(neg_pool, size=max(n_neg, 0), replace=False)) if n_neg > 0 else []
    sampled = [int(x) for x in (list(pos_labels) + neg_labels)]
    rng.shuffle(sampled)
    label2id = {label: i for i, label in enumerate(sampled)}
    keep = np.array([int(c) in label2id for c in cls], bool)
    new_cls = np.array([label2id[int(c)] for c in cls[keep]], np.int32)
    texts = []
    for label in sampled:
        prompts = class_texts[label]
        texts.append(prompt_format.format(prompts[int(rng.integers(len(prompts)))]))
    if padding and len(texts) < max_samples:
        texts += [padding_value] * (max_samples - len(texts))
    return new_cls, keep, texts


def random_hsv(
    sample: Sample,
    rng: np.random.Generator,
    hgain: float = 0.015,
    sgain: float = 0.7,
    vgain: float = 0.4,
) -> Sample:
    """HSV jitter through per-channel lookup tables."""
    if hgain or sgain or vgain:
        r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
        x = np.arange(0, 256, dtype=r.dtype)
        lut = np.empty((3, 256), np.uint8)
        lut[0] = (x * r[0]) % 180
        lut[1] = np.clip(x * r[1], 0, 255)
        lut[2] = np.clip(x * r[2], 0, 255)
        hsv = imgproc.bgr2hsv(sample.img)
        hsv = np.stack([lut[k][hsv[..., k]] for k in range(3)], -1)
        img = imgproc.hsv2bgr(hsv)
        return Sample(img, sample.boxes, sample.cls, sample.texts)
    return sample


def _get_albumentations():
    """The reference's albumentations list, or None when the package is
    missing or fails to build it."""
    try:
        import albumentations as A_

        return A_.Compose(
            [
                A_.Blur(p=0.01),
                A_.MedianBlur(p=0.01),
                A_.ToGray(p=0.01),
                A_.CLAHE(p=0.01),
                A_.RandomBrightnessContrast(p=0.0),
                A_.RandomGamma(p=0.0),
                A_.ImageCompression(quality_lower=75, p=0.0),
            ],
            bbox_params=A_.BboxParams(format="yolo", label_fields=["class_labels"]),
        )
    except Exception:  # absent or incompatible: the transform is a no-op
        return None


def albumentations_transform(
    sample: Sample, rng: np.random.Generator, p: float = 1.0, compose=None
) -> Sample:
    """Optional albumentations pixel augmentations (Blur, MedianBlur, ToGray,
    CLAHE at p = 0.01). `compose` is `_get_albumentations()`; without it,
    or with no boxes, the sample is returned and nothing is drawn."""
    if compose is None or len(sample.cls) == 0 or rng.random() >= p:
        return sample
    h, w = sample.img.shape[:2]
    b = sample.boxes.astype(np.float32)
    xywh = np.stack(
        [(b[:, 0] + b[:, 2]) / 2 / w, (b[:, 1] + b[:, 3]) / 2 / h,
         (b[:, 2] - b[:, 0]) / w, (b[:, 3] - b[:, 1]) / h],
        1,
    )
    new = compose(image=sample.img, bboxes=np.clip(xywh, 0.0, 1.0), class_labels=sample.cls)
    if len(new["class_labels"]) == 0:
        return sample
    nb = np.asarray(new["bboxes"], np.float32).reshape(-1, 4)
    nh, nw = new["image"].shape[:2]
    xyxy = np.stack(
        [(nb[:, 0] - nb[:, 2] / 2) * nw, (nb[:, 1] - nb[:, 3] / 2) * nh,
         (nb[:, 0] + nb[:, 2] / 2) * nw, (nb[:, 1] + nb[:, 3] / 2) * nh],
        1,
    )
    return Sample(np.ascontiguousarray(new["image"]), xyxy,
                  np.asarray(new["class_labels"], sample.cls.dtype), sample.texts)


def random_flip(
    sample: Sample, rng: np.random.Generator, fliplr: float = 0.5, flipud: float = 0.0
) -> Sample:
    """Horizontal / vertical flips."""
    img, boxes = sample.img, sample.boxes.copy()
    h, w = img.shape[:2]
    if flipud and rng.random() < flipud:
        img = img[::-1]
        boxes[:, [1, 3]] = h - boxes[:, [3, 1]]
    if fliplr and rng.random() < fliplr:
        img = img[:, ::-1]
        boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    return Sample(np.ascontiguousarray(img), boxes, sample.cls, sample.texts)


def mixup(sample1: Sample, sample2: Sample, rng: np.random.Generator) -> Sample:
    """Beta(32, 32) image blend, labels concatenated."""
    r = rng.beta(32.0, 32.0)
    img = (sample1.img.astype(np.float32) * r + sample2.img.astype(np.float32) * (1 - r)).astype(
        np.uint8
    )
    return Sample(
        img,
        np.concatenate([sample1.boxes, sample2.boxes], 0),
        np.concatenate([sample1.cls, sample2.cls], 0),
        sample1.texts,
    )
