"""Prediction results (a port of the JAX package's
`tamtr_tpu/engine/results.py`: `Boxes` and `Results`, detect task).

`Results` wraps one image's detections: `.boxes` (xyxy pixels, conf, cls),
`.plot()`, `.save()`, `.save_txt()` and `.tojson()`, and dict-style access
("path", "boxes", "scores", "labels", "names") for callers that treat a
result as a mapping; `Engine.track` sets `track_ids`. The text outputs are
byte-equal to the JAX package's for the same detections. `save` writes the
plot at the path it is given, in the format its suffix names
(`data/image_io.py:imwrite`: JPEG and BMP byte-equal to `cv2.imencode`,
PNG), as the JAX package's writes through cv2. A segment model's `masks`
(N, Hm, Wm) sigmoid probabilities at the protos' size are laid over the
plot. `AnnotatedVideoWriter` writes the plots of a video source's frames
as an MPEG-4 Part 2 `.mp4` (`data/video_io.py:VideoWriter`), as the JAX
package's writes through cv2.VideoWriter with fourcc "mp4v".
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np


class Boxes:
    """Detection boxes accessor: xyxy pixels + conf + cls."""

    def __init__(self, xyxy: np.ndarray, conf: np.ndarray, cls: np.ndarray):
        self.xyxy = np.asarray(xyxy, np.float32).reshape(-1, 4)
        self.conf = np.asarray(conf, np.float32).reshape(-1)
        self.cls = np.asarray(cls).reshape(-1)

    def __len__(self) -> int:
        return len(self.conf)

    @property
    def xywh(self) -> np.ndarray:
        b = self.xyxy
        return np.stack(
            [(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2, b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], -1)


class Results:
    """One image's detections; `plot` draws on `orig_img` (the BGR frame of
    a source that is not a file) or reads the image again from `path`.
    `masks`: a segment model's (N, Hm, Wm) mask probabilities, or None."""

    def __init__(self, path: str, boxes: np.ndarray, scores: np.ndarray, labels: np.ndarray,
                 names: Sequence[str], orig_shape: Optional[tuple] = None, masks: Optional[np.ndarray] = None,
                 orig_img: Optional[np.ndarray] = None):
        self.path = path
        self.names = list(names)
        self.boxes = Boxes(boxes, scores, labels)
        self.orig_shape = orig_shape
        self.masks = masks
        self.orig_img = orig_img
        self.track_ids: Optional[np.ndarray] = None  # one id per box, set by `Engine.track`

    def __len__(self) -> int:
        return len(self.boxes)

    def __getitem__(self, key: str):
        return {
            "path": self.path,
            "boxes": self.boxes.xyxy,
            "scores": self.boxes.conf,
            "labels": self.boxes.cls,
            "names": self.names,
        }[key]

    def __contains__(self, key: str) -> bool:
        return key in ("path", "boxes", "scores", "labels", "names")

    def plot(self, line_width: Optional[int] = None, mask_alpha: float = 0.4) -> np.ndarray:
        """The BGR image with the detections drawn (`utils/plotting.py`),
        over each mask resized to the image (float32 bilinear, as cv2) and
        thresholded at 0.5, blended in its class's palette colour at
        `mask_alpha`."""
        from tamtr_torch.data.image_io import imread
        from tamtr_torch.data.imgproc import resize_linear_f32
        from tamtr_torch.utils.plotting import _palette, annotate_image

        b = self.boxes
        img = self.orig_img.copy() if self.orig_img is not None else imread(self.path)
        if self.masks is not None and len(self.masks):
            colors = _palette(max(len(self.names), 1))
            overlay = img.astype(np.float32)
            for m, lab in zip(self.masks, b.cls):
                mm = resize_linear_f32(m.astype(np.float32), (img.shape[1], img.shape[0])) > 0.5
                c = np.array(colors[int(lab) % len(colors)], np.float32)
                overlay[mm] = overlay[mm] * (1 - mask_alpha) + c * mask_alpha
            img = overlay.astype(np.uint8)
        return annotate_image(img, b.xyxy, b.conf, b.cls, self.names, line_width)

    def save(self, path: str | Path) -> Path:
        """Write the plot at `path`, in the format of its suffix (.jpg,
        .jpeg, .jpe, .png, .bmp, .tif, .tiff or lossless .webp; another
        raises NotImplementedError); returns the path written."""
        from tamtr_torch.data.image_io import imwrite

        out = Path(path)
        out.parent.mkdir(parents=True, exist_ok=True)
        imwrite(out, self.plot())
        return out

    def save_txt(self, path: str | Path, save_conf: bool = False) -> None:
        """YOLO-format lines: cls cx cy w h [conf] normalized to orig_shape."""
        oh, ow = self.orig_shape or (1, 1)
        lines = []
        for b, c, l in zip(self.boxes.xywh, self.boxes.conf, self.boxes.cls):
            vals = [int(l), b[0] / ow, b[1] / oh, b[2] / ow, b[3] / oh]
            if save_conf:
                vals.append(float(c))
            lines.append(" ".join(f"{v:.6g}" for v in vals))
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text("\n".join(lines))

    def tojson(self) -> str:
        out = []
        for b, c, l in zip(self.boxes.xyxy, self.boxes.conf, self.boxes.cls):
            name = self.names[int(l)] if int(l) < len(self.names) else str(int(l))
            out.append({
                "name": name,
                "class": int(l),
                "confidence": round(float(c), 5),
                "box": {"x1": float(b[0]), "y1": float(b[1]), "x2": float(b[2]), "y2": float(b[3])},
            })
        return json.dumps(out)


class AnnotatedVideoWriter:
    """Annotated video for predict and track on video sources (the JAX
    package's `AnnotatedVideoWriter`): each `write(result)` adds
    `result.plot()` to an `.mp4` at `out_path`, opened at the first frame
    and sized to it; `fps` 30.0 when it is not positive."""

    def __init__(self, out_path, fps: float = 30.0):
        self.out_path = Path(out_path)
        self.fps = float(fps) if fps and fps > 0 else 30.0
        self._writer = None

    def write(self, result: "Results") -> None:
        from tamtr_torch.data.video_io import VideoWriter

        frame = result.plot()
        if self._writer is None:
            h, w = frame.shape[:2]
            self._writer = VideoWriter(self.out_path, self.fps, (w, h))
        self._writer.write(frame)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
