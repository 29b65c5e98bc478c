"""Synthetic moving-object video source (the streaming counterpart of
`data/vww_synthetic.py`); copy of `repro.video.synthetic` (numpy).

Each stream is a static textured background plus ``n_objects`` soft
figure-shaped blobs following parametric linear trajectories that
reflect off the frame edges.  Ground-truth boxes (normalized
``x0, y0, x1, y1``) and stable object ids come with every frame, so the
tracking workload has something to score against.

Temporal redundancy is a *parameter*, not an accident: object positions
advance every ``hold`` frames (quantized time), the background is frozen
per stream, and there is no per-frame noise by default — so within a
hold group consecutive frames are **bit-identical**.  That is the
redundancy the delta gate (`video/delta.py`) exploits, and it makes the
threshold-0 gate lossless by construction (DESIGN.md §9).

Deterministic in (seed, frame index); every frame is addressable without
materializing the stream (``frame_at``), and shapes are stable: always
``(H, W, 3)`` frames and ``(n_objects, 4)`` boxes.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.data.vww_synthetic import _background


@functools.lru_cache(maxsize=64)
def _stream_layout(image_size: int, n_objects: int, seed: int):
    """Per-stream randomized layout: background + object parameters."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x51DE0]))
    h = w = image_size
    bg = _background(h, w, rng)
    background = np.stack(
        [np.clip(bg * rng.uniform(0.7, 1.3), 0.0, 1.0) for _ in range(3)], -1
    ).astype(np.float32)
    objs = []
    for _ in range(n_objects):
        objs.append({
            # normalized center start + velocity (fraction of frame/frame)
            "p0": rng.uniform(0.25, 0.75, 2),
            "v": rng.uniform(0.01, 0.04, 2) * rng.choice([-1.0, 1.0], 2),
            # normalized half-extents (rx, ry) and a distinct color
            "r": rng.uniform(0.08, 0.16, 2),
            "color": rng.uniform(0.3, 1.0, 3).astype(np.float32),
        })
    return background, objs


def _reflect(p: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """Reflect an unbounded coordinate into [lo, hi] (triangle wave)."""
    span = hi - lo
    q = np.mod(p - lo, 2 * span)
    return lo + np.where(q > span, 2 * span - q, q)


@dataclasses.dataclass(frozen=True)
class SyntheticVideo:
    """Parametric moving-object stream; see module docstring."""

    image_size: int = 40
    n_frames: int = 16
    n_objects: int = 2
    seed: int = 0
    hold: int = 2  # positions advance every `hold` frames (temporal redundancy)
    noise: float = 0.0  # per-frame noise; > 0 breaks bit-identical holds

    def _centers_at(self, t: int) -> list[tuple[np.ndarray, dict]]:
        _, objs = _stream_layout(self.image_size, self.n_objects, self.seed)
        tq = (t // max(1, self.hold)) * max(1, self.hold)
        out = []
        for o in objs:
            # keep the whole box inside the frame: reflect the center
            # within margins of the half-extents
            c = np.array([
                _reflect(o["p0"][i] + o["v"][i] * tq, o["r"][i],
                         1.0 - o["r"][i])
                for i in range(2)
            ])
            out.append((c, o))
        return out

    def boxes_at(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        """Ground truth at frame ``t``: (n_objects, 4) normalized
        ``x0, y0, x1, y1`` boxes and (n_objects,) stable ids."""
        boxes = np.empty((self.n_objects, 4), np.float32)
        for i, (c, o) in enumerate(self._centers_at(t)):
            boxes[i] = [c[0] - o["r"][0], c[1] - o["r"][1],
                        c[0] + o["r"][0], c[1] + o["r"][1]]
        return boxes, np.arange(self.n_objects, dtype=np.int32)

    def frame_at(self, t: int) -> dict[str, np.ndarray]:
        """``{"image": (H, W, 3) f32 in [0,1], "boxes": (N, 4), "ids": (N,)}``."""
        background, _ = _stream_layout(self.image_size, self.n_objects,
                                       self.seed)
        h = w = self.image_size
        img = background.copy()
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        for c, o in self._centers_at(t):
            cx, cy = c[0] * w, c[1] * h
            rx, ry = o["r"][0] * w, o["r"][1] * h
            d = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2
            m = np.exp(-np.maximum(d - 0.6, 0.0) * 5.0)[..., None]
            img = img * (1 - 0.85 * m) + 0.85 * m * o["color"]
        if self.noise > 0.0:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, 1 + t]))
            img = img + rng.normal(0.0, self.noise, img.shape)
        boxes, ids = self.boxes_at(t)
        return {"image": np.clip(img, 0.0, 1.0).astype(np.float32),
                "boxes": boxes, "ids": ids}

    def frames(self) -> np.ndarray:
        """Materialize the whole stream: (n_frames, H, W, 3)."""
        return np.stack([self.frame_at(t)["image"]
                         for t in range(self.n_frames)])

    def gt_boxes(self) -> np.ndarray:
        """(n_frames, n_objects, 4) ground-truth track boxes."""
        return np.stack([self.boxes_at(t)[0] for t in range(self.n_frames)])
