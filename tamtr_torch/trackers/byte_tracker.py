"""BYTETracker: two-stage association of detections with tracks (a port of
the JAX package's `tamtr_tpu/trackers/byte_tracker.py`, numpy and scipy,
host code as there).

High-confidence detections associate first, by IoU with the Kalman-predicted
tracks (the reference's `trackers/byte_tracker.py:197-420`); low-confidence
detections rescue the tracked tracks left unmatched; unconfirmed tracks get
a last pass; the remaining confident detections start tracks. Track ids come
from `Track`'s own counter (`Track.reset_id` starts it again at 1).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from tamtr_torch.trackers.kalman import KalmanFilterXYAH
from tamtr_torch.utils.metrics import box_iou_np

NEW = 0
TRACKED = 1
LOST = 2
REMOVED = 3


def xyxy2xyah(b: np.ndarray) -> np.ndarray:
    w = b[2] - b[0]
    h = b[3] - b[1]
    return np.array([(b[0] + b[2]) / 2, (b[1] + b[3]) / 2, w / max(h, 1e-6), h])


def xyah2xyxy(m: np.ndarray) -> np.ndarray:
    a, h = m[2], m[3]
    w = a * h
    return np.array([m[0] - w / 2, m[1] - h / 2, m[0] + w / 2, m[1] + h / 2])


class Track:
    _count = 0

    def __init__(self, box_xyxy: np.ndarray, score: float, cls: int, feat: Optional[np.ndarray] = None):
        self.kf = KalmanFilterXYAH()
        self.mean, self.cov = self.kf.initiate(xyxy2xyah(box_xyxy))
        self.score = float(score)
        self.cls = int(cls)
        self.state = NEW
        self.is_activated = False
        self.track_id = 0
        self.frame_id = 0
        self.start_frame = 0
        # appearance (the reference's BOTrack.update_features,
        # `trackers/bot_sort.py:56-66`): an EMA of L2-normalised features
        self.curr_feat: Optional[np.ndarray] = None
        self.smooth_feat: Optional[np.ndarray] = None
        self.feat_alpha = 0.9
        if feat is not None:
            self.update_features(feat)

    def update_features(self, feat: np.ndarray) -> None:
        feat = np.asarray(feat, np.float32)
        feat = feat / max(float(np.linalg.norm(feat)), 1e-12)
        self.curr_feat = feat
        if self.smooth_feat is None:
            self.smooth_feat = feat
        else:
            sf = self.feat_alpha * self.smooth_feat + (1 - self.feat_alpha) * feat
            self.smooth_feat = sf / max(float(np.linalg.norm(sf)), 1e-12)

    @staticmethod
    def next_id() -> int:
        Track._count += 1
        return Track._count

    @staticmethod
    def reset_id() -> None:
        """The next new track gets id 1."""
        Track._count = 0

    @property
    def xyxy(self) -> np.ndarray:
        return xyah2xyxy(self.mean[:4])

    def predict(self) -> None:
        if self.state != TRACKED:
            self.mean[7] = 0.0  # lost tracks: freeze height velocity
        self.mean, self.cov = self.kf.predict(self.mean, self.cov)

    def activate(self, frame_id: int) -> None:
        self.track_id = Track.next_id()
        self.state = TRACKED
        self.is_activated = frame_id == 1
        self.frame_id = frame_id
        self.start_frame = frame_id

    def update(self, box_xyxy: np.ndarray, score: float, cls: int, frame_id: int,
               feat: Optional[np.ndarray] = None) -> None:
        self.mean, self.cov = self.kf.update(self.mean, self.cov, xyxy2xyah(box_xyxy))
        self.state = TRACKED
        self.is_activated = True
        self.score = float(score)
        self.cls = int(cls)
        self.frame_id = frame_id
        if feat is not None:
            self.update_features(feat)

    def re_activate(self, box_xyxy: np.ndarray, score: float, cls: int, frame_id: int,
                    feat: Optional[np.ndarray] = None) -> None:
        self.update(box_xyxy, score, cls, frame_id, feat=feat)
        self.track_id = self.track_id or Track.next_id()

    def mark_lost(self) -> None:
        self.state = LOST

    def mark_removed(self) -> None:
        self.state = REMOVED


def linear_assignment(cost: np.ndarray, thresh: float):
    """Hungarian association with gating (the reference's `matching.py:20-55`):
    (matches, unmatched rows, unmatched columns)."""
    if cost.size == 0:
        return [], list(range(cost.shape[0])), list(range(cost.shape[1]))
    from scipy.optimize import linear_sum_assignment

    rows, cols = linear_sum_assignment(cost)
    matches = [(r, c) for r, c in zip(rows, cols) if cost[r, c] <= thresh]
    mr = {m[0] for m in matches}
    mc = {m[1] for m in matches}
    return (
        matches,
        [r for r in range(cost.shape[0]) if r not in mr],
        [c for c in range(cost.shape[1]) if c not in mc],
    )


def iou_distance(tracks: List[Track], boxes: np.ndarray) -> np.ndarray:
    if not tracks or len(boxes) == 0:
        return np.zeros((len(tracks), len(boxes)))
    tb = np.stack([t.xyxy for t in tracks])
    return 1.0 - box_iou_np(tb, boxes)


class BYTETracker:
    def __init__(
        self,
        track_high_thresh: float = 0.5,
        track_low_thresh: float = 0.1,
        new_track_thresh: float = 0.6,
        match_thresh: float = 0.8,
        track_buffer: int = 30,
        fuse_score: bool = True,
    ):
        self.tracked: List[Track] = []
        self.lost: List[Track] = []
        self.frame_id = 0
        self.high = track_high_thresh
        self.low = track_low_thresh
        self.new_thresh = new_track_thresh
        self.match_thresh = match_thresh
        self.max_lost = track_buffer
        self.fuse_score = fuse_score

    def _feat_of(self, i: int) -> Optional[np.ndarray]:
        """Appearance feature of detection i this frame (BOTSORT overrides)."""
        return None

    def _stage1_cost(self, pool: List[Track], boxes_hi: np.ndarray, scores_hi: np.ndarray,
                     hi_idx: np.ndarray) -> np.ndarray:
        """First-association cost matrix (BOTSORT fuses ReID distances here)."""
        cost = iou_distance(pool, boxes_hi)
        if self.fuse_score and cost.size:
            cost = 1.0 - (1.0 - cost) * scores_hi[None, :]
        return cost

    def update(self, boxes: np.ndarray, scores: np.ndarray, classes: np.ndarray) -> np.ndarray:
        """One frame. boxes (N, 4) xyxy. Returns (M, 7): x1, y1, x2, y2, id, score, cls."""
        self.frame_id += 1
        hi = scores >= self.high
        lo = (scores >= self.low) & ~hi

        pool = [t for t in self.tracked if t.is_activated] + self.lost
        unconfirmed = [t for t in self.tracked if not t.is_activated]
        for t in pool + unconfirmed:
            t.predict()

        # stage 1: high-confidence detections
        hi_idx = np.nonzero(hi)[0]
        cost = self._stage1_cost(pool, boxes[hi], scores[hi], hi_idx)
        m1, ut, ud = linear_assignment(cost, self.match_thresh)
        for r, c in m1:
            i = hi_idx[c]
            if pool[r].state == TRACKED:
                pool[r].update(boxes[i], scores[i], classes[i], self.frame_id, feat=self._feat_of(i))
            else:
                pool[r].re_activate(boxes[i], scores[i], classes[i], self.frame_id, feat=self._feat_of(i))
                self.lost = [t for t in self.lost if t is not pool[r]]
                self.tracked.append(pool[r])

        # stage 2: rescue unmatched *tracked* tracks with low-confidence detections
        remain = [pool[r] for r in ut if pool[r].state == TRACKED]
        cost2 = iou_distance(remain, boxes[lo])
        m2, ut2, _ = linear_assignment(cost2, 0.5)
        lo_idx = np.nonzero(lo)[0]
        for r, c in m2:
            i = lo_idx[c]
            remain[r].update(boxes[i], scores[i], classes[i], self.frame_id)
        for r in ut2:
            remain[r].mark_lost()
            if remain[r] not in self.lost:
                self.lost.append(remain[r])
        # unmatched lost tracks from stage 1 stay lost
        for r in ut:
            t = pool[r]
            if t.state == LOST and t not in self.lost:
                self.lost.append(t)

        # stage 3: unconfirmed tracks vs the remaining high-confidence detections
        left = [hi_idx[c] for c in ud]
        cost3 = iou_distance(unconfirmed, boxes[left] if left else np.zeros((0, 4)))
        m3, ut3, ud3 = linear_assignment(cost3, 0.7)
        for r, c in m3:
            i = left[c]
            unconfirmed[r].update(boxes[i], scores[i], classes[i], self.frame_id)
        for r in ut3:
            unconfirmed[r].mark_removed()

        # new tracks from the remaining detections
        for c in ud3:
            i = left[c]
            if scores[i] >= self.new_thresh:
                t = Track(boxes[i], scores[i], classes[i], feat=self._feat_of(i))
                t.activate(self.frame_id)
                self.tracked.append(t)

        # prune
        self.lost = [t for t in self.lost if t.state == LOST and self.frame_id - t.frame_id <= self.max_lost]
        self.tracked = [t for t in self.tracked if t.state == TRACKED]

        out = [
            np.concatenate([t.xyxy, [t.track_id, t.score, t.cls]])
            for t in self.tracked
            if t.is_activated and t.frame_id == self.frame_id
        ]
        return np.stack(out) if out else np.zeros((0, 7))
