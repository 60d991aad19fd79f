"""COCO-format prediction dump for `save_json`, with RLE masks for a
segment model (numpy; a copy of the JAX package's `tamtr_tpu/utils/coco.py`
without its pycocotools evaluation)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np


def mask_to_rle(mask: np.ndarray) -> Dict:
    """Binary mask (H, W) -> COCO compressed RLE, pycocotools-compatible:
    pycocotools' `rleToString` byte format (the reference's segment json
    path, `models/yolo/segment/val.py:195-219`): column-major run lengths
    starting with a zero-run, delta-encoded from the 3rd count on, emitted
    as 5-bit groups with a continuation bit, offset by 48 into printable
    ASCII."""
    mask = np.asarray(mask, bool)
    h, w = mask.shape
    flat = mask.ravel(order="F")
    if flat.size == 0:
        cnts: List[int] = []
    else:
        change = np.flatnonzero(np.diff(flat)) + 1
        idx = np.concatenate([[0], change, [flat.size]])
        cnts = np.diff(idx).tolist()
        if flat[0]:
            cnts = [0] + cnts
    chars = []
    for i in range(len(cnts)):
        x = cnts[i] - (cnts[i - 2] if i > 2 else 0)
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            chars.append(chr(c + 48))
    return {"size": [int(h), int(w)], "counts": "".join(chars)}


def rle_to_mask(rle: Dict) -> np.ndarray:
    """Inverse of `mask_to_rle` (pycocotools `rleFrString` + decode)."""
    h, w = rle["size"]
    s = rle["counts"]
    cnts: List[int] = []
    p = 0
    while p < len(s):
        x, k, more = 0, 0, True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    out = np.zeros(h * w, bool)
    pos, val = 0, False
    for c in cnts:
        out[pos : pos + c] = val
        pos += c
        val = not val
    return out.reshape((h, w), order="F")


def predictions_to_coco(
    per_image: List[Dict],
    save_path: str | Path,
    class_map: Optional[Sequence[int]] = None,
) -> Path:
    """per_image: [{image_id, boxes (N,4) xyxy, scores (N,), labels (N,),
    masks (optional, (N, H, W) bool at native resolution)}]."""
    out = []
    for rec in per_image:
        boxes = np.asarray(rec["boxes"], np.float64)
        ltwh = boxes.copy()
        ltwh[:, 2:] = boxes[:, 2:] - boxes[:, :2]
        masks = rec.get("masks")
        for j, (b, s, l) in enumerate(zip(ltwh, rec["scores"], rec["labels"])):
            cid = int(class_map[int(l)]) if class_map is not None else int(l)
            row = {
                "image_id": rec["image_id"],
                "category_id": cid,
                "bbox": [round(float(x), 3) for x in b],
                "score": round(float(s), 5),
            }
            if masks is not None:
                row["segmentation"] = mask_to_rle(masks[j])
            out.append(row)
    save_path = Path(save_path)
    save_path.parent.mkdir(parents=True, exist_ok=True)
    save_path.write_text(json.dumps(out))
    return save_path
