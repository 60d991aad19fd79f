"""Auto-annotation: detector boxes -> SAM masks -> polygon labels (a port
of the JAX package's `tamtr_tpu/data/annotator.py`, the reference's
`data/annotator.py`).

`auto_annotate` runs a detector over a folder, prompts SAM with each
image's boxes, and writes `<stem>.txt` segment labels: `cls x1 y1 x2 y2 ...`
normalized, one polygon a detection: the mask's largest outer contour
(`data/imgproc.py:find_external_contours` and `contour_area`, bitwise
`cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)` and
`cv2.contourArea`), strided down to 64 points.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Optional

import numpy as np

from tamtr_torch.data.imgproc import contour_area, find_external_contours


def _mask_to_polygon(mask: np.ndarray, max_points: int = 64) -> Optional[np.ndarray]:
    """The largest outer contour of a bool mask (the first of equal areas,
    in cv2's contour order), every len // max_points-th point up to
    max_points: (N, 2) float32 pixels, or None below 3 points."""
    contours = find_external_contours(mask.astype(np.uint8))
    if not contours:
        return None
    c = max(contours, key=contour_area)
    if len(c) < 3:
        return None
    if len(c) > max_points:
        c = c[:: len(c) // max_points][:max_points]
    return c.astype(np.float32)


def auto_annotate(data: str | Path, det_model: Any, sam_model: Any = "mobile_sam", conf: float = 0.25,
                  output_dir: str | Path | None = None) -> Path:
    """Label every image under `data` with `det_model`'s detections as SAM
    segments. det_model: a `TAMTR` / `YOLO` (or an `Engine`) with trained,
    loaded or seeded weights; sam_model: a `SAM`, a `SAMPredictor`, or a
    builder name (a predictor on the card). Writes `<stem>.txt` for each
    image with at least one polygon into `output_dir` (default
    `<data>_auto_annotate_labels` beside `data`) and returns it."""
    from tamtr_torch.api import SAM

    data = Path(data)
    output_dir = Path(output_dir or data.parent / f"{data.stem}_auto_annotate_labels")
    output_dir.mkdir(parents=True, exist_ok=True)
    sam_pred = SAM(sam_model).predictor if isinstance(sam_model, str) else \
        sam_model.predictor if isinstance(sam_model, SAM) else sam_model
    for r in det_model.predict(str(data), conf=conf):
        boxes = r.boxes.xyxy
        if len(boxes) == 0:
            continue
        sam_res = sam_pred(r.path, bboxes=boxes)[0]
        oh, ow = sam_res.orig_shape
        lines = []
        for cls, mask in zip(r.boxes.cls, sam_res.masks):
            poly = _mask_to_polygon(np.asarray(mask) > 0.5)
            if poly is None:
                continue
            lines.append(f"{int(cls)} " + " ".join(f"{x / ow:.6f} {y / oh:.6f}" for x, y in poly))
        if lines:
            (output_dir / f"{Path(r.path).stem}.txt").write_text("\n".join(lines) + "\n")
    return output_dir
