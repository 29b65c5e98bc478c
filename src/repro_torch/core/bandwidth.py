"""Bandwidth-reduction model (paper §4.3, Eq. 2-3).

Copy of `repro.core.bandwidth` (pure Python).

``BR = (I/O) · (4/3) · (12/N_b)``

* ``I = i² · 3`` RGB input elements, ``O = ((i−k+2p)/s + 1)² · c_o`` output
  elements (Eq. 3),
* ``4/3`` — Bayer RGGB → RGB compression credit,
* ``12/N_b`` — 12-bit native pixel depth vs the quantized ADC output.

Note on the paper's arithmetic: Eq. 2 as printed uses ``O/I`` (a
*compression ratio* < 1); the reduction *factor* quoted in the text
(~21×) is its reciprocal form implemented here.  With Table 1 values
(i=560, k=s=5, p=0, c_o=8, N_b=8) this evaluates to **18.75×**, which the
paper rounds up to "∼21×"; the benchmark records both (see
EXPERIMENTS.md).
"""
from __future__ import annotations

import dataclasses

BAYER_FACTOR = 4.0 / 3.0
SENSOR_BIT_DEPTH = 12


@dataclasses.dataclass(frozen=True)
class FirstLayerGeom:
    """First-layer hyperparameters (paper Table 1 defaults).

    Validated on construction: ``out_spatial`` uses floor division, so a
    kernel larger than the padded image would silently produce a
    nonpositive output grid (and a nonsense bandwidth figure) — reject
    those geometries instead.
    """

    image_size: int = 560
    kernel: int = 5
    padding: int = 0
    stride: int = 5
    out_channels: int = 8
    out_bits: int = 8

    def __post_init__(self):
        if self.image_size < 1 or self.kernel < 1:
            raise ValueError(
                f"image_size and kernel must be >= 1, got "
                f"image_size={self.image_size} kernel={self.kernel}")
        if self.padding < 0:
            raise ValueError(f"padding must be >= 0, got {self.padding}")
        if self.kernel > self.image_size + 2 * self.padding:
            raise ValueError(
                f"kernel {self.kernel} exceeds padded image "
                f"{self.image_size} + 2*{self.padding} — out_spatial would "
                "be nonpositive")
        if self.stride < 1:
            raise ValueError(f"stride must be >= 1, got {self.stride}")
        if self.out_channels < 1:
            raise ValueError(
                f"out_channels must be >= 1, got {self.out_channels}")
        if self.out_bits < 1:
            raise ValueError(f"out_bits must be >= 1, got {self.out_bits}")

    @property
    def out_spatial(self) -> int:
        return (self.image_size - self.kernel + 2 * self.padding) // self.stride + 1

    @property
    def input_elems(self) -> int:
        return self.image_size**2 * 3

    @property
    def output_elems(self) -> int:
        return self.out_spatial**2 * self.out_channels


def bandwidth_reduction(geom: FirstLayerGeom) -> float:
    """Reduction factor: input sensor bits / output P²M bits (Eq. 2 recip)."""
    elem_ratio = geom.input_elems / geom.output_elems
    return elem_ratio * BAYER_FACTOR * (SENSOR_BIT_DEPTH / geom.out_bits)


def compression_ratio(geom: FirstLayerGeom) -> float:
    """Eq. 2 exactly as printed (O/I form): the < 1 compression ratio."""
    return 1.0 / bandwidth_reduction(geom)


def paper_table1_geom() -> FirstLayerGeom:
    return FirstLayerGeom()


# ------------------------------------------------------------ event readout
#
# Frame-delta (event-style) extension for video streams, after
# Neuromorphic-P2M (arXiv:2301.09111): on a temporally redundant stream
# the sensor only reads out the P²M activation map on frames whose pixel
# delta crossed a threshold; a skipped frame transmits a single
# "no event" flag.  `video/delta.py` drives the measured accounting on a
# live stream (DESIGN.md §9); the closed form below is the static
# counterpart the bench compares it against.  See EXPERIMENTS.md
# §Bandwidth.

SKIP_FLAG_BITS = 1  # the per-frame "no event" token a skipped frame costs


def frame_output_bits(geom: FirstLayerGeom) -> int:
    """Dense per-frame readout: every P²M output element at ADC width."""
    return geom.output_elems * geom.out_bits


def event_readout_bits(geom: FirstLayerGeom, rerun_fraction: float) -> float:
    """Closed-form mean bits/frame when a fraction of frames re-run the
    stem and the rest transmit only the skip flag."""
    if not 0.0 <= rerun_fraction <= 1.0:
        raise ValueError(f"rerun_fraction must be in [0, 1], "
                         f"got {rerun_fraction}")
    return rerun_fraction * frame_output_bits(geom) + SKIP_FLAG_BITS


@dataclasses.dataclass
class StreamBandwidthLedger:
    """Measured per-stream readout accounting: one `record` per tick.

    ``bits`` is what actually crossed the sensor boundary — a skipped
    frame costs :data:`SKIP_FLAG_BITS`, a re-run frame adds the full
    dense readout — so ``reduction_vs_dense`` is a *measured* bandwidth
    reduction on the stream, not the Eq. 2 closed form.
    """

    geom: FirstLayerGeom
    frames: int = 0
    rerun_frames: int = 0
    bits: int = 0

    def record(self, reran: bool) -> int:
        """Account one frame; returns the bits it transmitted."""
        cost = SKIP_FLAG_BITS + (frame_output_bits(self.geom) if reran else 0)
        self.frames += 1
        self.rerun_frames += int(reran)
        self.bits += cost
        return cost

    @property
    def skip_rate(self) -> float:
        return 1.0 - self.rerun_frames / self.frames if self.frames else 0.0

    @property
    def bits_per_frame(self) -> float:
        return self.bits / self.frames if self.frames else 0.0

    @property
    def dense_bits_per_frame(self) -> int:
        return frame_output_bits(self.geom)

    @property
    def reduction_vs_dense(self) -> float:
        """Measured dense/actual bits ratio (> 1 once any frame skips)."""
        bpf = self.bits_per_frame
        return self.dense_bits_per_frame / bpf if bpf else 0.0

    def summary(self) -> dict:
        """The ledger as one dict — the view shape the metrics registry
        snapshots (`StreamEngine` publishes one per live gate,
        DESIGN.md §13.2)."""
        return {
            "frames": self.frames,
            "rerun_frames": self.rerun_frames,
            "bits": self.bits,
            "skip_rate": self.skip_rate,
            "bits_per_frame": self.bits_per_frame,
            "dense_bits_per_frame": self.dense_bits_per_frame,
            "reduction_vs_dense": self.reduction_vs_dense,
        }
