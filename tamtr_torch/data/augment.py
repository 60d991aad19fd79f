"""Host-side augmentations in numpy, without cv2 (a port of the JAX
package's `tamtr_tpu/data/augment.py`).

The numpy code is a line-for-line copy of the JAX package's, and every
random draw comes in the same order from the same `np.random.Generator`, so
one seed gives the same geometry and equal labels. The cv2 calls are the
numpy versions of `tamtr_torch/data/imgproc.py`: resize and HSV give cv2's
bytes, the affine warp lies within one level of cv2's. Images are (H, W, 3)
uint8 BGR, as cv2 reads them; `collate` turns them to RGB.

Polygon segments (a list of (n, 2) pixel polygons, one per box) and
keypoints ((N, nk, 3) pixels) ride through every geometric transform with
the boxes, as in the JAX package: `copy_paste` pastes mirrored instances
by their polygons (`imgproc.fill_poly` for cv2's filled contour), a no-op
for box-only labels; `random_perspective` warps polygon points (the box is
the warped polygon's extent) and keypoints (invisible outside the canvas);
`random_flip` mirrors keypoint x and keeps each keypoint's index, as the
JAX package does (the reference reorders them with `flip_idx`).
`albumentations_transform` is a no-op when the package is not installed,
as in the JAX package; the card's machine does not have it; it skips
samples with segments or keypoints, as the JAX package's does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from tamtr_torch.data import imgproc


@dataclass
class Sample:
    """One image + labels in pixel space.

    `segments` (optional): list of (n, 2) pixel polygons, one per box.
    `keypoints` (optional): (N, nk, 3) pixel keypoints (x, y, visibility).
    `texts` (optional): the per-sample class texts of RandomLoadText.
    """

    img: np.ndarray  # (H, W, 3) uint8, BGR
    boxes: np.ndarray  # (N, 4) xyxy pixels
    cls: np.ndarray  # (N,) int32
    segments: Optional[list] = None
    keypoints: Optional[np.ndarray] = None
    texts: Optional[List[str]] = None


def stretch_resize(sample: Sample, size: int) -> Sample:
    """scaleFill stretch to (size, size): the TAM-TR load path."""
    h, w = sample.img.shape[:2]
    segs, kpts = sample.segments, sample.keypoints
    if (h, w) != (size, size):
        img = imgproc.resize_linear(sample.img, (size, size))
        sx, sy = size / w, size / h
        boxes = sample.boxes * np.array([sx, sy, sx, sy], dtype=np.float32)
        if segs is not None:
            segs = [p * np.array([sx, sy], np.float32) for p in segs]
        if kpts is not None:
            kpts = kpts.copy()
            kpts[..., 0] *= sx
            kpts[..., 1] *= sy
    else:
        img, boxes = sample.img, sample.boxes
    return Sample(img, boxes.astype(np.float32), sample.cls, segs, kpts)


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


def _mosaic_labels(all_boxes, all_cls, all_segs, all_kpts, any_segs: bool, any_kpts: bool, s: int):
    """The tiles' labels clipped to the 2s x 2s canvas, the empty boxes
    dropped with their polygons and keypoints: (boxes, cls, segments,
    keypoints)."""
    if all_boxes:
        boxes = np.concatenate(all_boxes, 0).clip(0, 2 * s)
        cls = np.concatenate(all_cls, 0)
        keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
        segs = [p for p, k in zip(all_segs, keep) if k] if any_segs else None
        kpts = (np.concatenate(all_kpts, 0)[keep] if all_kpts else None) if any_kpts else None
        return boxes[keep], cls[keep], segs, kpts
    return (np.zeros((0, 4), np.float32), np.zeros((0,), np.int32), [] if any_segs else None,
            np.zeros((0, 17, 3), np.float32) if any_kpts else None)


def _tile_labels(smp: Sample, shift: np.ndarray, any_segs: bool, any_kpts: bool, all_boxes, all_cls, all_segs,
                 all_kpts) -> None:
    """One tile's labels moved by shift = (padw, padh); a tile without
    polygons in a mosaic with some gives each box an empty one."""
    if len(smp.boxes):
        all_boxes.append(smp.boxes + np.concatenate([shift, shift]))
        all_cls.append(smp.cls)
        if any_segs:
            segs = smp.segments or [np.zeros((0, 2), np.float32) for _ in range(len(smp.boxes))]
            all_segs += [p + shift for p in segs]
        if any_kpts and smp.keypoints is not None:
            k = smp.keypoints.copy()
            k[..., :2] += shift
            all_kpts.append(k)


def mosaic4(
    samples: Sequence[Sample], size: int, rng: np.random.Generator, color: int = 114
) -> Sample:
    """4-image mosaic on a 2s x 2s canvas; segments and keypoints ride along
    with the same (padw, padh) shift."""
    s = size
    yc = int(rng.uniform(s * 0.5, s * 1.5))
    xc = int(rng.uniform(s * 0.5, s * 1.5))
    canvas = np.full((2 * s, 2 * s, 3), color, dtype=np.uint8)
    any_segs = any(smp.segments is not None for smp in samples[:4])
    any_kpts = any(smp.keypoints is not None for smp in samples[:4])
    all_boxes, all_cls, all_segs, all_kpts = [], [], [], []
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
        _tile_labels(smp, np.array([padw, padh], dtype=np.float32), any_segs, any_kpts, all_boxes, all_cls,
                     all_segs, all_kpts)
    boxes, cls, segs, kpts = _mosaic_labels(all_boxes, all_cls, all_segs, all_kpts, any_segs, any_kpts, s)
    return Sample(canvas, boxes, cls, segs, kpts)


def mosaic9(
    samples: Sequence[Sample], size: int, rng: np.random.Generator, color: int = 114
) -> Sample:
    """9-image (3x3) mosaic: tiles placed around the centre on a 3s x 3s
    canvas, each aligned to the previous tile's size, then the central
    2s x 2s crop (the output contract of `mosaic4`)."""
    s = size
    canvas = np.full((3 * s, 3 * s, 3), color, dtype=np.uint8)
    any_segs = any(smp.segments is not None for smp in samples[:9])
    any_kpts = any(smp.keypoints is not None for smp in samples[:9])
    all_boxes, all_cls, all_segs, all_kpts = [], [], [], []
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
        _tile_labels(smp, np.array([padw - off, padh - off], dtype=np.float32), any_segs, any_kpts, all_boxes,
                     all_cls, all_segs, all_kpts)
    canvas = canvas[off : off + 2 * s, off : off + 2 * s]
    boxes, cls, segs, kpts = _mosaic_labels(all_boxes, all_cls, all_segs, all_kpts, any_segs, any_kpts, s)
    return Sample(canvas, boxes.astype(np.float32), cls, segs, kpts)


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
    segs, kpts = sample.segments, sample.keypoints
    n = len(boxes)
    if n:
        def warp_pts(pts):  # (k, 2) -> (k, 2)
            z = np.ones((len(pts), 3))
            z[:, :2] = pts
            z = z @ M.T
            return (z[:, :2] / z[:, 2:3] if perspective else z[:, :2]).astype(np.float32)

        if segs is not None and len(segs) == n and any(len(p) for p in segs):
            # warp the polygons' points; a box is its warped polygon's extent
            segs = [warp_pts(p) if len(p) else p for p in segs]
            new = np.zeros((n, 4), np.float32)
            for i, p in enumerate(segs):
                if len(p):
                    new[i] = [p[:, 0].min(), p[:, 1].min(), p[:, 0].max(), p[:, 1].max()]
        else:
            xy = np.ones((n * 4, 3))
            xy[:, :2] = boxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
            xy = xy @ M.T
            xy = (xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]).reshape(n, 8)
            x = xy[:, [0, 2, 4, 6]]
            y = xy[:, [1, 3, 5, 7]]
            new = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], 1).astype(np.float32)
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
        if kpts is not None and len(kpts) == n:
            # warp (x, y); a keypoint outside the output canvas turns invisible
            flat = kpts[..., :2].reshape(-1, 2)
            warped = warp_pts(flat).reshape(kpts.shape[0], kpts.shape[1], 2)
            vis = kpts[..., 2:].copy() if kpts.shape[-1] > 2 else np.ones(kpts.shape[:2] + (1,), np.float32)
            out = (
                (warped[..., 0] < 0) | (warped[..., 0] > width)
                | (warped[..., 1] < 0) | (warped[..., 1] > height)
            )
            vis[out[..., None].repeat(vis.shape[-1], -1)] = 0.0
            kpts = np.concatenate([warped, vis], -1).astype(np.float32)
        # candidate filter: area_thr 0.01 with segments
        keep = _box_candidates(boxes.T * s, new.T, area_thr=0.01 if segs is not None else 0.1)
        boxes, cls = new[keep], cls[keep]
        if segs is not None and len(segs) == n:
            segs = [p for p, k in zip(segs, keep) if k]
        if kpts is not None:
            kpts = kpts[keep]
    return Sample(img, boxes, cls, segs, kpts, sample.texts)


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
    """Copy-Paste (arXiv:2012.07177): paste horizontally mirrored copies of
    instances at their mirrored places when the mirrored box overlaps every
    existing box by < 30% IoA. It needs polygon segments: for box-only
    labels it returns the sample and draws nothing, as the JAX package's
    does. The k = round(p * candidates) instances come from one
    `rng.choice` draw, the JAX package's; each is drawn filled into a mask
    (`imgproc.fill_poly`, cv2's one filled contour) whose mirror selects
    the pixels of the mirrored image."""
    if not p or sample.segments is None or len(sample.segments) == 0:
        return sample
    img = sample.img.copy()
    h, w = img.shape[:2]
    boxes = sample.boxes
    flip_boxes = boxes.copy()
    flip_boxes[:, 0] = w - boxes[:, 2]
    flip_boxes[:, 2] = w - boxes[:, 0]
    ioa = bbox_ioa(flip_boxes, boxes)  # (N, N)
    indexes = np.nonzero((ioa < 0.30).all(1))[0]
    k = round(p * len(indexes))
    if k == 0:
        return sample
    sel = rng.choice(indexes, size=k, replace=False)
    im_new = np.zeros((h, w), np.uint8)
    for j in sel:
        imgproc.fill_poly(im_new, sample.segments[int(j)].astype(np.int32), 1)
    result = img[:, ::-1]  # mirrored image
    i = im_new[:, ::-1].astype(bool)  # original-position masks -> mirrored
    img[i] = result[i]
    new_boxes = np.concatenate([boxes, flip_boxes[sel]], 0)
    new_cls = np.concatenate([sample.cls, sample.cls[sel]], 0)
    flip_segs = [
        np.stack([w - sample.segments[int(j)][:, 0], sample.segments[int(j)][:, 1]], -1)
        for j in sel
    ]
    new_segs = list(sample.segments) + flip_segs
    kpts = sample.keypoints
    if kpts is not None:
        kpts = np.concatenate([kpts, kpts[sel]], 0)
    return Sample(img, new_boxes.astype(np.float32), new_cls, new_segs, kpts, sample.texts)


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
        return Sample(img, sample.boxes, sample.cls, sample.segments, sample.keypoints, sample.texts)
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
    with no boxes, or with segments or keypoints (which the transform would
    not move, as the JAX package skips them), the sample is returned and
    nothing is drawn."""
    if compose is None or len(sample.cls) == 0 or sample.segments is not None or sample.keypoints is not None \
            or rng.random() >= p:
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
                  np.asarray(new["class_labels"], sample.cls.dtype), None, None, sample.texts)


def random_flip(
    sample: Sample, rng: np.random.Generator, fliplr: float = 0.5, flipud: float = 0.0
) -> Sample:
    """Horizontal / vertical flips of the image, boxes, polygons and
    keypoints; a keypoint keeps its index (the JAX package's behaviour)."""
    img, boxes = sample.img, sample.boxes.copy()
    segs = None if sample.segments is None else [p.copy() for p in sample.segments]
    kpts = None if sample.keypoints is None else sample.keypoints.copy()
    h, w = img.shape[:2]
    if flipud and rng.random() < flipud:
        img = img[::-1]
        boxes[:, [1, 3]] = h - boxes[:, [3, 1]]
        if segs is not None:
            segs = [np.stack([p[:, 0], h - p[:, 1]], -1) for p in segs]
        if kpts is not None:
            kpts[..., 1] = h - kpts[..., 1]
    if fliplr and rng.random() < fliplr:
        img = img[:, ::-1]
        boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
        if segs is not None:
            segs = [np.stack([w - p[:, 0], p[:, 1]], -1) for p in segs]
        if kpts is not None:
            kpts[..., 0] = w - kpts[..., 0]
    return Sample(np.ascontiguousarray(img), boxes, sample.cls, segs, kpts, sample.texts)


def mixup(sample1: Sample, sample2: Sample, rng: np.random.Generator) -> Sample:
    """Beta(32, 32) image blend, labels concatenated (a sample without
    polygons gives its boxes empty ones when the other has some)."""
    r = rng.beta(32.0, 32.0)
    img = (sample1.img.astype(np.float32) * r + sample2.img.astype(np.float32) * (1 - r)).astype(
        np.uint8
    )
    segs = None
    if sample1.segments is not None or sample2.segments is not None:
        s1 = sample1.segments or [np.zeros((0, 2), np.float32) for _ in sample1.cls]
        s2 = sample2.segments or [np.zeros((0, 2), np.float32) for _ in sample2.cls]
        segs = list(s1) + list(s2)
    kpts = None
    if sample1.keypoints is not None and sample2.keypoints is not None:
        kpts = np.concatenate([sample1.keypoints, sample2.keypoints], 0)
    return Sample(
        img,
        np.concatenate([sample1.boxes, sample2.boxes], 0),
        np.concatenate([sample1.cls, sample2.cls], 0),
        segs,
        kpts,
        sample1.texts,
    )
