"""COCO-format prediction dump for `save_json` (the JAX package's
`utils/coco.py:predictions_to_coco`, box records only)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np


def predictions_to_coco(
    per_image: List[Dict],
    save_path: str | Path,
    class_map: Optional[Sequence[int]] = None,
) -> Path:
    """per_image: [{image_id, boxes (N, 4) xyxy, scores (N,), labels (N,)}];
    writes [{image_id, category_id, bbox (ltwh), score}]."""
    out = []
    for rec in per_image:
        boxes = np.asarray(rec["boxes"], np.float64)
        ltwh = boxes.copy()
        ltwh[:, 2:] = boxes[:, 2:] - boxes[:, :2]
        for b, s, lab in zip(ltwh, rec["scores"], rec["labels"]):
            cid = int(class_map[int(lab)]) if class_map is not None else int(lab)
            out.append({
                "image_id": rec["image_id"],
                "category_id": cid,
                "bbox": [round(float(x), 3) for x in b],
                "score": round(float(s), 5),
            })
    save_path = Path(save_path)
    save_path.parent.mkdir(parents=True, exist_ok=True)
    save_path.write_text(json.dumps(out))
    return save_path
