"""Box and instance containers (numpy; a copy of the JAX package's
`tamtr_tpu/utils/instance.py`, the reference's `utils/instance.py`).

`Bboxes` is a format-aware box array (xyxy / xywh / ltwh); `Instances`
bundles boxes with optional segments and keypoints and applies geometric
ops to all of them consistently. Host-side tooling: the augmentations of
`data/augment.py` carry plain arrays, as the JAX package's do, and device
code uses tensors (`tamtr_torch/ops/boxes.py`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

_FORMATS = ("xyxy", "xywh", "ltwh")


def _convert(boxes: np.ndarray, src: str, dst: str) -> np.ndarray:
    if src == dst or len(boxes) == 0:
        return boxes.copy()
    b = boxes.astype(np.float32)
    if src == "xywh":  # center-xy
        cx, cy, w, h = b.T
        x1, y1 = cx - w / 2, cy - h / 2
    elif src == "ltwh":
        x1, y1, w, h = b.T
    else:
        x1, y1, x2, y2 = b.T
        w, h = x2 - x1, y2 - y1
    if dst == "xyxy":
        out = np.stack([x1, y1, x1 + w, y1 + h], 1)
    elif dst == "xywh":
        out = np.stack([x1 + w / 2, y1 + h / 2, w, h], 1)
    else:
        out = np.stack([x1, y1, w, h], 1)
    return out


class Bboxes:
    """Format-aware box container (reference `instance.py:34-174`)."""

    def __init__(self, bboxes: np.ndarray, format: str = "xyxy") -> None:
        assert format in _FORMATS, f"format must be one of {_FORMATS}"
        bboxes = np.asarray(bboxes, np.float32)
        if bboxes.ndim == 1:
            bboxes = bboxes[None]
        assert bboxes.ndim == 2 and bboxes.shape[1] == 4
        self.bboxes = bboxes
        self.format = format

    def convert(self, format: str) -> None:
        assert format in _FORMATS
        self.bboxes = _convert(self.bboxes, self.format, format)
        self.format = format

    def areas(self) -> np.ndarray:
        b = _convert(self.bboxes, self.format, "xyxy")
        return (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])

    def mul(self, scale) -> None:
        """Scale per coordinate: scalar or (4,) (reference `:107-125`)."""
        s = np.asarray(scale, np.float32)
        self.bboxes = self.bboxes * (s if s.ndim else s[None])

    def add(self, offset) -> None:
        o = np.asarray(offset, np.float32)
        self.bboxes = self.bboxes + (o if o.ndim else o[None])

    def __len__(self) -> int:
        return len(self.bboxes)

    def __getitem__(self, index) -> "Bboxes":
        b = self.bboxes[index]
        return Bboxes(b if b.ndim == 2 else b[None], self.format)

    @classmethod
    def concatenate(cls, boxes_list: Sequence["Bboxes"], axis: int = 0) -> "Bboxes":
        assert boxes_list
        fmt = boxes_list[0].format
        assert all(b.format == fmt for b in boxes_list)
        return cls(np.concatenate([b.bboxes for b in boxes_list], axis), fmt)


class Instances:
    """Boxes + segments + keypoints with joint geometry ops
    (reference `instance.py:176-417`)."""

    def __init__(
        self,
        bboxes: np.ndarray,
        segments: Optional[List[np.ndarray]] = None,
        keypoints: Optional[np.ndarray] = None,
        bbox_format: str = "xywh",
        normalized: bool = True,
    ) -> None:
        self._bboxes = Bboxes(bboxes, bbox_format)
        self.segments = segments if segments is not None else []
        self.keypoints = keypoints  # (N, nk, 2|3) or None
        self.normalized = normalized

    # ------------------------------------------------------------ accessors
    @property
    def bboxes(self) -> np.ndarray:
        return self._bboxes.bboxes

    @property
    def bbox_areas(self) -> np.ndarray:
        return self._bboxes.areas()

    def convert_bbox(self, format: str) -> None:
        self._bboxes.convert(format)

    def __len__(self) -> int:
        return len(self._bboxes)

    def __getitem__(self, index) -> "Instances":
        segs = None
        if self.segments:
            sel = np.arange(len(self._bboxes))[index]
            segs = [self.segments[i] for i in np.atleast_1d(sel)]
        kpts = self.keypoints[index] if self.keypoints is not None else None
        b = self.bboxes[index]
        return Instances(
            b if b.ndim == 2 else b[None], segs, kpts, self._bboxes.format, self.normalized
        )

    # ------------------------------------------------------------- geometry
    def scale(self, scale_w: float, scale_h: float, bbox_only: bool = False) -> None:
        self._bboxes.mul((scale_w, scale_h, scale_w, scale_h))
        if bbox_only:
            return
        self.segments = [s * np.array([scale_w, scale_h], np.float32) for s in self.segments]
        if self.keypoints is not None:
            self.keypoints[..., 0] *= scale_w
            self.keypoints[..., 1] *= scale_h

    def denormalize(self, w: int, h: int) -> None:
        if not self.normalized:
            return
        self.scale(w, h)
        self.normalized = False

    def normalize(self, w: int, h: int) -> None:
        if self.normalized:
            return
        self.scale(1 / w, 1 / h)
        self.normalized = True

    def add_padding(self, padw: int, padh: int) -> None:
        assert not self.normalized, "add_padding expects absolute coords"
        self._bboxes.add((padw, padh, padw, padh))
        self.segments = [s + np.array([padw, padh], np.float32) for s in self.segments]
        if self.keypoints is not None:
            self.keypoints[..., 0] += padw
            self.keypoints[..., 1] += padh

    def flipud(self, h: int) -> None:
        if self._bboxes.format == "xyxy":
            y1 = self.bboxes[:, 1].copy()
            y2 = self.bboxes[:, 3].copy()
            self.bboxes[:, 1] = h - y2
            self.bboxes[:, 3] = h - y1
        else:
            self.bboxes[:, 1] = h - self.bboxes[:, 1]
        self.segments = [np.stack([s[:, 0], h - s[:, 1]], 1) for s in self.segments]
        if self.keypoints is not None:
            self.keypoints[..., 1] = h - self.keypoints[..., 1]

    def fliplr(self, w: int) -> None:
        if self._bboxes.format == "xyxy":
            x1 = self.bboxes[:, 0].copy()
            x2 = self.bboxes[:, 2].copy()
            self.bboxes[:, 0] = w - x2
            self.bboxes[:, 2] = w - x1
        else:
            self.bboxes[:, 0] = w - self.bboxes[:, 0]
        self.segments = [np.stack([w - s[:, 0], s[:, 1]], 1) for s in self.segments]
        if self.keypoints is not None:
            self.keypoints[..., 0] = w - self.keypoints[..., 0]

    def clip(self, w: int, h: int) -> None:
        fmt = self._bboxes.format
        self.convert_bbox("xyxy")
        self.bboxes[:, [0, 2]] = self.bboxes[:, [0, 2]].clip(0, w)
        self.bboxes[:, [1, 3]] = self.bboxes[:, [1, 3]].clip(0, h)
        if fmt != "xyxy":
            self.convert_bbox(fmt)
        self.segments = [
            np.stack([s[:, 0].clip(0, w), s[:, 1].clip(0, h)], 1) for s in self.segments
        ]
        if self.keypoints is not None:
            self.keypoints[..., 0] = self.keypoints[..., 0].clip(0, w)
            self.keypoints[..., 1] = self.keypoints[..., 1].clip(0, h)

    def remove_zero_area_boxes(self) -> np.ndarray:
        """Drop degenerate boxes; returns the keep mask (reference `:344-360`)."""
        good = self.bbox_areas > 0
        if not good.all():
            self._bboxes = self._bboxes[good]
            if self.segments:
                self.segments = [s for s, g in zip(self.segments, good) if g]
            if self.keypoints is not None:
                self.keypoints = self.keypoints[good]
        return good

    def update(self, bboxes, segments=None, keypoints=None) -> None:
        self._bboxes = Bboxes(bboxes, self._bboxes.format)
        if segments is not None:
            self.segments = segments
        if keypoints is not None:
            self.keypoints = keypoints

    @classmethod
    def concatenate(cls, il: Sequence["Instances"], axis: int = 0) -> "Instances":
        assert il
        fmt, norm = il[0]._bboxes.format, il[0].normalized
        assert all(i._bboxes.format == fmt and i.normalized == norm for i in il)
        boxes = np.concatenate([i.bboxes for i in il], axis)
        segs: List[np.ndarray] = sum((i.segments for i in il), [])
        kpts = (
            np.concatenate([i.keypoints for i in il], axis)
            if il[0].keypoints is not None
            else None
        )
        return cls(boxes, segs, kpts, fmt, norm)
