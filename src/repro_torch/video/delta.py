"""Temporal delta gating: skip the P²M stem on redundant frames.

Copy of `repro.video.delta` (numpy).

Frame-delta (event-style) readout after Neuromorphic-P2M
(arXiv:2301.09111): an always-on sensor watching a mostly static scene
re-transmits a mostly identical activation map every frame.  The gate
compares each incoming frame against the **reference frame** — the one
whose stem activations are cached — and only re-runs (and re-transmits)
the stem when the mean absolute pixel delta crosses ``threshold``.
Comparing against the reference rather than the previous frame means
slow drift accumulates until it crosses the threshold instead of
slipping under it one frame at a time.

``threshold=0.0`` is *lossless* gating: only bit-identical frames skip,
so gated output is exactly the dense output (pinned by test).
``threshold=None`` disables gating (the dense baseline).  Either way
every tick lands in a `core.bandwidth.StreamBandwidthLedger`, so the
bandwidth reduction the bench reports is measured on the live stream,
not the Eq. 2 closed form (DESIGN.md §9).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.bandwidth import FirstLayerGeom, StreamBandwidthLedger


@dataclasses.dataclass(frozen=True)
class DeltaGateConfig:
    """``threshold``: mean |Δ| (pixels in [0, 1]) above which the stem
    re-runs; 0.0 skips only bit-identical frames (lossless); None
    disables gating entirely — every frame re-runs (dense baseline)."""

    threshold: float | None = 0.0

    @property
    def enabled(self) -> bool:
        return self.threshold is not None


def frame_delta(ref: np.ndarray, cur: np.ndarray) -> float:
    """Mean absolute pixel difference between two (H, W, 3) frames."""
    return float(np.mean(np.abs(np.asarray(cur, np.float32)
                                - np.asarray(ref, np.float32))))


class DeltaGate:
    """Per-stream gate state: the reference frame whose stem activations
    are cached, plus the stream's measured-bandwidth ledger."""

    def __init__(self, cfg: DeltaGateConfig, geom: FirstLayerGeom):
        self.cfg = cfg
        self.ledger = StreamBandwidthLedger(geom)
        self._ref: np.ndarray | None = None
        self.disabled = False

    def disable(self) -> None:
        """Drop to dense for the rest of the stream (DESIGN.md §10,
        degradation ladder rung 2): every remaining frame re-runs.  The
        engine calls this when the cached stem fails on-device
        validation — trusting the gate further would keep serving stale
        or corrupted activations."""
        self.disabled = True
        self._ref = None

    def should_rerun(self, frame: np.ndarray) -> bool:
        """Decide this tick: True ⇒ the stem re-runs on ``frame``."""
        if self.disabled:
            return True
        if self._ref is not None and self._ref.shape != np.shape(frame):
            # a reference that no longer matches the stream's frames is
            # corrupted gate state — fail safe to dense, don't compare
            self.disable()
            return True
        if self._ref is None or not self.cfg.enabled:
            return True
        if not np.isfinite(self._ref).all():
            self.disable()
            return True
        return frame_delta(self._ref, frame) > self.cfg.threshold

    def observe(self, frame: np.ndarray, reran: bool) -> int:
        """Record the decision's outcome; returns bits transmitted.

        On a re-run the frame becomes the new reference (its stem
        activations are what the engine cached)."""
        if reran:
            self._ref = np.array(frame, np.float32, copy=True)
        return self.ledger.record(reran)
