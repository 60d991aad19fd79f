"""BoT-SORT: BYTETracker with camera-motion compensation (GMC) and
appearance (ReID), a port of the JAX package's
`tamtr_tpu/trackers/bot_sort.py` (numpy).

Before association, a global affine map between consecutive frames
(`trackers/gmc.py:GMC`: 'sparseOptFlow', the default, 'orb', 'sift',
'ecc' or 'none') moves the tracks' boxes, and with `with_reid=True`
appearance embeddings gate and augment the first association: the stage-1
cost becomes ``min(fused IoU distance, embedding distance / 2)`` after the
reference's proximity and appearance gates (`bot_sort.py:178-192`). The
embedder is `encoder(frame, boxes) -> (N, D)`, by default
`patch_appearance_encoder`, a colour layout of each box. GMC's dense work
runs on `device` (the card unless device='cpu' is given).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Union

import numpy as np
import torch

from tamtr_torch.data.imgproc import resize_linear
from tamtr_torch.trackers.byte_tracker import BYTETracker, Track, iou_distance, xyxy2xyah
from tamtr_torch.trackers.gmc import GMC


def patch_appearance_encoder(frame_bgr: np.ndarray, boxes: np.ndarray, grid: int = 8) -> np.ndarray:
    """The default ReID embedder: each box's crop resized to (grid, grid)
    as cv2.resize does (`data/imgproc.py:resize_linear`), centred by a fixed
    0.5 (not the patch mean, which would zero a solid-colour patch) and
    L2-normalised; a zero row for a box outside the frame."""
    Hf, Wf = frame_bgr.shape[:2]
    out = np.zeros((len(boxes), grid * grid * 3), np.float32)
    for i, b in enumerate(np.asarray(boxes)):
        x1, y1, x2, y2 = int(max(0, b[0])), int(max(0, b[1])), int(min(Wf, b[2])), int(min(Hf, b[3]))
        if x2 <= x1 or y2 <= y1:
            continue
        patch = resize_linear(frame_bgr[y1:y2, x1:x2], (grid, grid)).astype(np.float32)
        v = (patch / 255.0 - 0.5).ravel()
        out[i] = v / max(float(np.linalg.norm(v)), 1e-12)
    return out


def embedding_distance(tracks: List[Track], feats: np.ndarray) -> np.ndarray:
    """Cosine distance between the tracks' smoothed features and the
    detections' (the reference's `matching.py:embedding_distance`)."""
    if not tracks or len(feats) == 0:
        return np.zeros((len(tracks), len(feats)), np.float32)
    tf = np.stack([
        t.smooth_feat if t.smooth_feat is not None else np.zeros(feats.shape[1])
        for t in tracks
    ]).astype(np.float32)
    sim = tf @ feats.T  # rows and columns are L2-normalised
    return np.maximum(0.0, 1.0 - sim)


class BOTSORT(BYTETracker):
    """BYTETracker with GMC (`gmc_method`, shrinking frames by
    `gmc_downscale`, on `device`) and, with `with_reid=True`, appearance
    from `encoder` in the first association."""

    def __init__(self, *args, gmc_method: str = "sparseOptFlow", gmc_downscale: int = 2, with_reid: bool = False,
                 proximity_thresh: float = 0.5, appearance_thresh: float = 0.25, encoder: Optional[Callable] = None,
                 device: Union[str, torch.device, None] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.gmc = GMC(gmc_method, gmc_downscale, device=device)
        self.with_reid = bool(with_reid)
        self.proximity_thresh = proximity_thresh
        self.appearance_thresh = appearance_thresh
        self.encoder = encoder or patch_appearance_encoder
        self._frame_feats: Optional[np.ndarray] = None

    @staticmethod
    def _apply_affine(track: Track, H: np.ndarray) -> None:
        b = track.xyxy
        pts = np.array([[b[0], b[1]], [b[2], b[3]]], np.float32)
        warped = pts @ H[:, :2].T + H[:, 2]
        track.mean[:4] = xyxy2xyah(np.array([warped[0, 0], warped[0, 1], warped[1, 0], warped[1, 1]]))

    def _feat_of(self, i: int):
        if self._frame_feats is None or i >= len(self._frame_feats):
            return None
        return self._frame_feats[i]

    def _stage1_cost(self, pool, boxes_hi, scores_hi, hi_idx):
        """The reference's `BOTSORT.get_dists` (`bot_sort.py:178-192`): the
        score-fused IoU distance, with the ReID cosine distance taken
        elementwise-min after the proximity and appearance gates."""
        iou_d = iou_distance(pool, boxes_hi)
        cost = iou_d
        if self.fuse_score and cost.size:
            cost = 1.0 - (1.0 - cost) * scores_hi[None, :]
        if self.with_reid and cost.size and self._frame_feats is not None:
            emb = embedding_distance(pool, self._frame_feats[hi_idx]) / 2.0
            emb[emb > self.appearance_thresh] = 1.0
            emb[iou_d > self.proximity_thresh] = 1.0
            cost = np.minimum(cost, emb)
        return cost

    def update(self, boxes, scores, classes, frame_bgr: Optional[np.ndarray] = None):
        if frame_bgr is not None:
            H = self.gmc.apply(frame_bgr)
            for t in self.tracked + self.lost:
                self._apply_affine(t, H)
            self._frame_feats = self.encoder(frame_bgr, boxes) if self.with_reid and len(boxes) else None
        else:
            self._frame_feats = None
        return super().update(boxes, scores, classes)
