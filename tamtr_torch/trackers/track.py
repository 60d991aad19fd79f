"""Trackers by name, and one frame's detections through a tracker (a port
of the JAX package's `tamtr_tpu/trackers/track.py`; the reference's
`trackers/track.py:56-65` does this in an `on_predict_postprocess_end`
callback, `Engine.track` does it in its loop).
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from tamtr_torch.trackers.bot_sort import BOTSORT
from tamtr_torch.trackers.byte_tracker import BYTETracker

TRACKER_MAP = {"bytetrack": BYTETracker, "botsort": BOTSORT}


def make_tracker(name: str = "bytetrack", device: Union[str, torch.device, None] = None, **kwargs: Any):
    """A tracker by name ("bytetrack" or "botsort"; the reference's
    "bytetrack.yaml" also). `device` is where BOTSORT's motion compensation
    runs (the card when None); BYTETracker has no device work."""
    stem = str(name).replace(".yaml", "").replace(".yml", "").lower()
    if stem not in TRACKER_MAP:
        raise ValueError(f"unknown tracker {name}; available: {list(TRACKER_MAP)}")
    if stem == "botsort":
        kwargs["device"] = device
    return TRACKER_MAP[stem](**kwargs)


def update_result_with_tracks(result, tracker, frame: Optional[np.ndarray] = None) -> None:
    """Feed one frame's detections to the tracker and put the tracks in
    `result`: `result.boxes` becomes the tracked boxes, `result.track_ids`
    one id per box (the tracker's order). `frame` (BGR) feeds BOTSORT's
    motion compensation and appearance; BYTETracker ignores it."""
    from tamtr_torch.engine.results import Boxes

    b = result.boxes
    kwargs = {"frame_bgr": frame} if frame is not None and isinstance(tracker, BOTSORT) else {}
    out = tracker.update(np.asarray(b.xyxy, np.float32), np.asarray(b.conf, np.float32),
                         np.asarray(b.cls, np.float32), **kwargs)
    if len(out) == 0:
        result.track_ids = np.zeros((0,), np.int64)
        return
    result.boxes = Boxes(out[:, :4], out[:, 5], out[:, 6])
    result.track_ids = out[:, 4].astype(np.int64)
