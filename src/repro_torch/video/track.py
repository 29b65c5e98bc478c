"""Greedy-IoU multi-object track association (P2M-DeTrack workload).

Copy of `repro.video.track` (numpy).

Host-side, per-stream state: the detector's per-frame (boxes, scores)
feed a greedy bipartite match against the live tracks — highest-IoU
pair first, matches below ``iou_thresh`` rejected — matched tracks
update in place, unmatched detections open new tracks, and tracks
unseen for ``max_age`` frames retire.  Track ids are allocated
per-tracker, so a recycled engine slot with a fresh ``Tracker`` restarts
at id 0 — the slot-state-isolation invariant `StreamEngine` pins in its
tests (DESIGN.md §9).
"""
from __future__ import annotations

import dataclasses

import numpy as np


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of (N, 4) × (M, 4) normalized x0y0x1y1 boxes."""
    a = np.asarray(a, np.float32).reshape(-1, 4)
    b = np.asarray(b, np.float32).reshape(-1, 4)
    x0 = np.maximum(a[:, None, 0], b[None, :, 0])
    y0 = np.maximum(a[:, None, 1], b[None, :, 1])
    x1 = np.minimum(a[:, None, 2], b[None, :, 2])
    y1 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x1 - x0, 0, None) * np.clip(y1 - y0, 0, None)
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(
        a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(
        b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


@dataclasses.dataclass
class Track:
    tid: int
    box: np.ndarray  # (4,) normalized x0y0x1y1
    score: float
    age: int = 0  # frames since last matched detection
    hits: int = 1  # matched detections over the track's life


class Tracker:
    """Per-stream greedy-IoU association state; see module docstring."""

    def __init__(self, iou_thresh: float = 0.3, max_age: int = 3):
        self.iou_thresh = iou_thresh
        self.max_age = max_age
        self.tracks: list[Track] = []
        self._next_id = 0

    def update(self, boxes: np.ndarray, scores: np.ndarray) -> list[Track]:
        """Associate one frame's detections; returns the live tracks
        (matched + newborn) after ageing out stale ones."""
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        scores = np.asarray(scores, np.float32).reshape(-1)
        matched_t: set[int] = set()
        matched_d: set[int] = set()
        if self.tracks and len(boxes):
            ious = iou_matrix(np.stack([t.box for t in self.tracks]), boxes)
            while True:
                ti, di = np.unravel_index(np.argmax(ious), ious.shape)
                if ious[ti, di] < self.iou_thresh:
                    break
                trk = self.tracks[ti]
                trk.box = boxes[di].copy()
                trk.score = float(scores[di])
                trk.age = 0
                trk.hits += 1
                matched_t.add(int(ti))
                matched_d.add(int(di))
                ious[ti, :] = -1.0
                ious[:, di] = -1.0
        for ti, trk in enumerate(self.tracks):
            if ti not in matched_t:
                trk.age += 1
        for di in range(len(boxes)):
            if di not in matched_d:
                self.tracks.append(Track(tid=self._next_id,
                                         box=boxes[di].copy(),
                                         score=float(scores[di])))
                self._next_id += 1
        self.tracks = [t for t in self.tracks if t.age <= self.max_age]
        return [t for t in self.tracks if t.age == 0]
