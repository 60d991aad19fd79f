"""Automatic mask generation utilities for SAM, in numpy (a port of the JAX
package's `tamtr_tpu/models/sam/amg.py`, the reference's
`ultralytics/models/sam/amg.py`): point grids, crop boxes, the stability
score, mask -> box, the uncrop helpers, and `remove_small_regions`.

`remove_small_regions` labels 8-connected components with
`scipy.ndimage.label` where the JAX package calls
`cv2.connectedComponentsWithStats(working, 8)`, and numbers them as cv2
does: cv2 labels 2x2 blocks of pixels (Spaghetti / BBDT), so a component's
label follows its first block in raster order of the blocks, not its first
pixel (`connected_components`); the islands fallback's `argmax` over the
areas breaks ties by that label.
"""

from __future__ import annotations

import math
from itertools import product
from typing import Generator, List, Sequence, Tuple

import numpy as np
from scipy import ndimage


def batch_iterator(batch_size: int, *args) -> Generator[List, None, None]:
    """Equal batches across the input arrays."""
    assert args and all(len(a) == len(args[0]) for a in args)
    n = len(args[0]) // batch_size + int(len(args[0]) % batch_size != 0)
    for b in range(n):
        yield [a[b * batch_size:(b + 1) * batch_size] for a in args]


def calculate_stability_score(masks: np.ndarray, mask_threshold: float, threshold_offset: float) -> np.ndarray:
    """IoU of the masks binarized at threshold +- offset: (..., H, W) logits
    -> (...,) float32 (the counts divided in float32, as JAX's int32
    true division)."""
    inter = (masks > (mask_threshold + threshold_offset)).sum(axis=(-1, -2))
    union = (masks > (mask_threshold - threshold_offset)).sum(axis=(-1, -2))
    return inter.astype(np.float32) / np.maximum(union, 1).astype(np.float32)


def build_point_grid(n_per_side: int) -> np.ndarray:
    """Evenly spaced (n^2, 2) points in [0, 1]^2."""
    offset = 1 / (2 * n_per_side)
    side = np.linspace(offset, 1 - offset, n_per_side)
    xs = np.tile(side[None, :], (n_per_side, 1))
    ys = np.tile(side[:, None], (1, n_per_side))
    return np.stack([xs, ys], axis=-1).reshape(-1, 2)


def build_all_layer_point_grids(n_per_side: int, n_layers: int, scale_per_layer: int) -> List[np.ndarray]:
    """A point grid for every crop layer."""
    return [build_point_grid(int(n_per_side / (scale_per_layer ** i))) for i in range(n_layers + 1)]


def generate_crop_boxes(im_size: Tuple[int, int], n_layers: int,
                        overlap_ratio: float) -> Tuple[List[List[int]], List[int]]:
    """The xyxy crop boxes of each layer ((2^i)^2 in layer i) and their layers."""
    crop_boxes, layer_idxs = [[0, 0, im_size[1], im_size[0]]], [0]
    im_h, im_w = im_size
    short_side = min(im_h, im_w)

    def crop_len(orig_len, n_crops, overlap):
        return int(math.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_side))
        crop_w, crop_h = crop_len(im_w, n_side, overlap), crop_len(im_h, n_side, overlap)
        x0s = [int((crop_w - overlap) * i) for i in range(n_side)]
        y0s = [int((crop_h - overlap) * i) for i in range(n_side)]
        for x0, y0 in product(x0s, y0s):
            crop_boxes.append([x0, y0, min(x0 + crop_w, im_w), min(y0 + crop_h, im_h)])
            layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs


def uncrop_boxes_xyxy(boxes: np.ndarray, crop_box: Sequence[int]) -> np.ndarray:
    """Crop-local boxes in image coordinates."""
    x0, y0 = crop_box[0], crop_box[1]
    return boxes + np.asarray([[x0, y0, x0, y0]], boxes.dtype)


def uncrop_points(points: np.ndarray, crop_box: Sequence[int]) -> np.ndarray:
    """Crop-local points in image coordinates."""
    return points + np.asarray([[crop_box[0], crop_box[1]]], points.dtype)


def uncrop_masks(masks: np.ndarray, crop_box: Sequence[int], orig_h: int, orig_w: int) -> np.ndarray:
    """Crop-local masks padded back to the image's size."""
    x0, y0, x1, y1 = crop_box
    if x0 == 0 and y0 == 0 and x1 == orig_w and y1 == orig_h:
        return masks
    pad = [(0, 0)] * (masks.ndim - 2) + [(y0, orig_h - y1), (x0, orig_w - x1)]
    return np.pad(masks, pad)


def is_box_near_crop_edge(boxes: np.ndarray, crop_box: Sequence[int], orig_box: Sequence[int],
                          atol: float = 20.0) -> np.ndarray:
    """Boxes within atol of the crop's edge but not of the image's."""
    crop = np.asarray(crop_box, np.float32)
    orig = np.asarray(orig_box, np.float32)
    b = uncrop_boxes_xyxy(boxes, crop_box).astype(np.float32)
    near_crop = np.isclose(b, crop[None], atol=atol, rtol=0)
    near_image = np.isclose(b, orig[None], atol=atol, rtol=0)
    return np.any(near_crop & ~near_image, axis=1)


def batched_mask_to_box(masks: np.ndarray) -> np.ndarray:
    """xyxy int32 boxes around binary masks (..., H, W) -> (..., 4); [0, 0,
    0, 0] for an empty mask."""
    h, w = masks.shape[-2:]
    in_h, in_w = masks.any(axis=-1), masks.any(axis=-2)
    ys, xs = np.arange(h, dtype=np.int32), np.arange(w, dtype=np.int32)
    bottom = np.max(np.where(in_h, ys, 0), axis=-1)
    top = np.min(np.where(in_h, ys, h), axis=-1)
    right = np.max(np.where(in_w, xs, 0), axis=-1)
    left = np.min(np.where(in_w, xs, w), axis=-1)
    empty = (right < left) | (bottom < top)
    out = np.stack([left, top, right, bottom], axis=-1).astype(np.int32)
    return np.where(empty[..., None], 0, out).astype(np.int32)


def connected_components(working: np.ndarray) -> Tuple[int, np.ndarray, np.ndarray]:
    """(n_labels, labels, areas) of the 8-connected components of a binary
    map, as `cv2.connectedComponentsWithStats(working, 8)` gives them:
    label 0 the background (every zero pixel), areas[0] its size; the
    components numbered in raster order of the first 2x2 pixel block each
    touches, the blocks of cv2's block-based labelling (every foreground
    pixel of a 2x2 block is 8-connected to the others, so a block holds one
    component)."""
    lab, n = ndimage.label(working, structure=np.ones((3, 3), np.int8))
    if n == 0:
        return 1, np.zeros(working.shape, np.int32), np.asarray([working.size], np.int64)
    h, w = lab.shape
    ys, xs = np.nonzero(lab)
    block = (ys // 2) * ((w + 1) // 2) + xs // 2  # the 2x2 block of each pixel, in block raster order
    first = np.full(n + 1, np.iinfo(np.int64).max)
    np.minimum.at(first, lab[ys, xs], block)
    order = np.argsort(first[1:], kind="stable") + 1  # scipy labels in cv2's order
    remap = np.zeros(n + 1, np.int32)
    remap[order] = np.arange(1, n + 1, dtype=np.int32)
    out = remap[lab]
    return n + 1, out, np.bincount(out.ravel(), minlength=n + 1).astype(np.int64)


def remove_small_regions(mask: np.ndarray, area_thresh: float, mode: str) -> Tuple[np.ndarray, bool]:
    """Fill holes ("holes") or drop islands ("islands") smaller than
    area_thresh; (mask, changed). With no island of area_thresh or more
    the largest one stays."""
    assert mode in {"holes", "islands"}
    correct_holes = mode == "holes"
    working = (correct_holes ^ mask.astype(bool)).astype(np.uint8)
    n_labels, regions, areas = connected_components(working)
    sizes = areas[1:]
    small = [i + 1 for i, s in enumerate(sizes) if s < area_thresh]
    if not small:
        return mask, False
    fill = [0] + small
    if not correct_holes:
        fill = [i for i in range(n_labels) if i not in fill] or [int(np.argmax(sizes)) + 1]
    return np.isin(regions, fill), True
