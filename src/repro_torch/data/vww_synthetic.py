"""Synthetic Visual-Wake-Words proxy (the real VWW is unavailable offline).

Copy of `repro.data.vww_synthetic` (pure numpy).

Binary "person present" classification with a learnable but non-trivial
visual signal: positives composite a soft vertical "figure" (head +
torso ellipses, randomly placed/scaled/lit); negatives get background
texture only (gradients + stripes + blob distractors).  Both classes
share global illumination and noise statistics so the task is not
solvable from image mean alone.  Deterministic in (seed, step).
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _figure_mask(h, w, rng):
    """Soft person-ish silhouette: head circle + torso ellipse."""
    cy = rng.uniform(0.35, 0.65) * h
    cx = rng.uniform(0.25, 0.75) * w
    scale = rng.uniform(0.15, 0.35) * min(h, w)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    head = ((yy - (cy - 1.1 * scale)) ** 2 + (xx - cx) ** 2) / (0.45 * scale) ** 2
    torso = ((yy - cy) ** 2 / (1.4 * scale) ** 2
             + (xx - cx) ** 2 / (0.7 * scale) ** 2)
    mask = np.minimum(head, torso)
    return np.exp(-np.maximum(mask - 1.0, 0.0) * 4.0)  # soft edge


def _background(h, w, rng):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    g = (rng.uniform(-1, 1) * yy / h + rng.uniform(-1, 1) * xx / w)
    stripes = 0.15 * np.sin(2 * np.pi * (xx * rng.uniform(0.02, 0.1)
                                         + rng.uniform(0, 1)))
    blob = np.zeros((h, w), np.float32)
    for _ in range(rng.integers(0, 4)):
        by, bx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(0.05, 0.2) * min(h, w)
        blob += 0.3 * np.exp(-(((yy - by) ** 2 + (xx - bx) ** 2) / r**2))
    return 0.4 + 0.2 * g + stripes + blob


@dataclasses.dataclass(frozen=True)
class SyntheticVWW:
    image_size: int = 80
    batch: int = 32
    seed: int = 0

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        h = w = self.image_size
        images = np.empty((self.batch, h, w, 3), np.float32)
        labels = rng.integers(0, 2, self.batch).astype(np.int32)
        for i in range(self.batch):
            bg = _background(h, w, rng)
            img = np.stack([bg * rng.uniform(0.7, 1.3) for _ in range(3)], -1)
            if labels[i]:
                m = _figure_mask(h, w, rng)
                color = rng.uniform(0.3, 1.0, 3).astype(np.float32)
                img = img * (1 - 0.8 * m[..., None]) + m[..., None] * color
            img += rng.normal(0, 0.03, img.shape)
            images[i] = np.clip(img, 0.0, 1.0)
        return {"images": images, "labels": labels}
