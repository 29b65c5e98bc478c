"""StreamEngine: multi-tick streaming-video detection over the scheduler
core; port of `repro.video.engine` (single device).

A request here is a whole video **stream**: it occupies one slot of the
scheduler's fixed table for as many ticks as it has frames, advancing
one frame per engine tick.  Per-slot state, recycled by ``_on_admit``:

* a `DeltaGate` — reference frame + measured-bandwidth ledger;
* the cached stem activations — the P²M output of the reference frame,
  one ``(n_slots, Ho, Wo, N)`` float32 tensor that stays on the engine's
  device across ticks;
* a `Tracker` — live tracks and the per-stream id counter.

Every tick is one forward over the whole slot table: the deploy-folded,
8-bit P²M stem on the padded image batch, a per-slot ``rerun`` mask that
selects fresh stem activations or the cached ones, then the backbone,
the CenterNet-lite heads and the top-k decode.  Two stem paths
(``stem_path``):

* ``"where"`` — the stem conv (B1 on the card) over every slot, then
  ``torch.where`` with the cache: every skipped slot still pays the stem.
* ``"gated"`` — the delta-gated stem kernel
  (`kernels/p2m_conv/gated.py`): the mask and the cache go into the
  kernel, skipped slots copy the cache, one launch.  It runs at the
  blocks the tuner gives the where path's stem for the same signature
  (`core.p2m_conv.deploy_conv_blocks`), so both paths run the same body,
  B1's or B2's ring.  Bitwise equal to the where path.  ``"auto"`` picks it on a
  CUDA engine, ``"where"`` on the CPU (where the gated wrapper would only
  run its plain twin).

The cached stem is validated on the device: a slot whose cache holds a
non-finite value is forced to re-run, the **effective** mask comes back
to the host with the boxes and scores, and that slot's gate drops to
dense.  With ``threshold=0`` the gate skips only bit-identical frames,
so gated detections equal the dense engine's exactly.

There is no degradation ladder: the reference swaps the stem for the
patches conv and the where path after repeated launch faults, which on
the card would be a quiet fall back from the kernel to a plain version.
``_on_launch_fault`` only counts; a failing launch goes through the
scheduler's containment and surfaces as failed requests.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.p2m_vww import (
    SERVE_QUANT_BITS,
    STREAM_MAX_QUEUE,
    STREAM_MAX_SLOTS,
)
from repro_torch.core.bandwidth import (
    FirstLayerGeom,
    StreamBandwidthLedger,
    frame_output_bits,
)
from repro_torch.core.bn_fold import deploy_params
from repro_torch.core.p2m_conv import deploy_conv_blocks, premix_deploy
from repro_torch.core.quant import QuantSpec, quantize_deploy
from repro_torch.device import resolve_device
from repro_torch.kernels.p2m_conv.gated import p2m_conv_fused_gated
from repro_torch.models.mobilenetv2 import (
    MNV2Config,
    apply_mnv2_backbone,
    apply_mnv2_stem,
)
from repro_torch.obs.metrics import counted_lru_cache
from repro_torch.serving.scheduler import ScheduledRequest, SlotEngine
from repro_torch.serving.vision import _tree_to
from repro_torch.video.delta import DeltaGate, DeltaGateConfig
from repro_torch.video.detect import (
    DetectConfig,
    apply_detect_head,
    decode_detections,
    det_grid,
)
from repro_torch.video.track import Tracker


@dataclasses.dataclass
class StreamRequest(ScheduledRequest):
    """One video stream = one multi-tick slot occupancy.

    Bandwidth numbers all read through ``ledger`` — the stream's
    `StreamBandwidthLedger`, owned by its slot's `DeltaGate` and attached
    on admit — so there is exactly one copy of the readout accounting."""

    uid: int
    frames: np.ndarray  # (T, H, W, 3) float32 in [0, 1]
    gt_boxes: np.ndarray | None = None  # optional (T, N, 4) ground truth

    # Filled by the engine, one entry per served frame:
    frame_outputs: list = dataclasses.field(default_factory=list)  # (boxes, scores)
    tracks: list = dataclasses.field(default_factory=list)  # [(tid, box, score)]
    frames_done: int = 0
    ledger: StreamBandwidthLedger | None = None  # attached on admit

    @property
    def n_frames(self) -> int:
        return len(self.frames)

    @property
    def skip_count(self) -> int:
        """Frames that reused the cached stem (transmitted nothing)."""
        return self.ledger.frames - self.ledger.rerun_frames if self.ledger else 0

    @property
    def bits(self) -> int:
        """Measured transmitted bits over the stream so far."""
        return self.ledger.bits if self.ledger else 0

    @property
    def skip_rate(self) -> float:
        return self.ledger.skip_rate if self.ledger else 0.0

    @property
    def bits_per_frame(self) -> float:
        return self.ledger.bits_per_frame if self.ledger else 0.0

    @property
    def dense_frame_bits(self) -> int:
        return self.ledger.dense_bits_per_frame if self.ledger else 0

    @property
    def reduction_vs_dense(self) -> float:
        """Measured bandwidth reduction vs re-transmitting every frame."""
        return self.ledger.reduction_vs_dense if self.ledger else 0.0

    @property
    def frame_latency_us(self) -> float:
        """Mean per-frame launch wall-clock over the stream so far."""
        return self.launch_wall_us / self.frames_done if self.frames_done else 0.0


@counted_lru_cache("stream_forward")
def _stream_forward_for(cfg: MNV2Config, dcfg: DetectConfig,
                        stem_path: str = "where"):
    """The per-tick forward: stem (gated or where-select) → backbone →
    heads → top-k decode, as a plain function of the engine's trees and
    this tick's tensors.  Built once per (cfg, dcfg, stem_path) and shared
    by every engine on them.

    Returns ``forward(params, bn, dep, det, images, cached, rerun) →
    (stem, boxes, scores, rerun_eff)``; ``dep`` is a premixed deploy tree
    (`premix_deploy`), ``rerun`` a (B,) bool tensor on the images'
    device.  ``rerun_eff`` adds every slot whose cache is not finite; when
    every cache row is finite it equals ``rerun``.
    """
    if stem_path not in ("gated", "where"):
        raise ValueError(f"unknown stem_path {stem_path!r}")
    grid = det_grid(cfg.p2m.out_spatial(cfg.image_size))
    p2m = cfg.p2m
    adc = p2m.adc

    def forward(params, bn, dep, det, images, cached, rerun):
        cache_ok = torch.isfinite(cached).flatten(1).all(dim=1)
        rerun = rerun | ~cache_ok
        if stem_path == "gated":
            # the deploy-form stem (conv → quantizing ADC epilogue, as
            # apply_p2m_conv_deploy) with the select inside the kernel, at
            # the blocks the tuner gives apply_p2m_conv_deploy
            block_h, block_n, depth = deploy_conv_blocks(images, p2m)
            stem = p2m_conv_fused_gated(
                images, dep["wrows"], dep["shift"], cached, rerun,
                kernel=p2m.kernel, stride=p2m.stride, mode="quant",
                v_lsb=adc.v_lsb, max_count=adc.max_count, block_h=block_h,
                block_n=block_n, pipeline_depth=depth)
        else:
            stem, _ = apply_mnv2_stem(params, bn, images, cfg,
                                      p2m_deploy=dep)
            stem = torch.where(rerun[:, None, None, None], stem, cached)
        feats, _ = apply_mnv2_backbone(params, bn, stem, cfg)
        boxes, scores = decode_detections(
            apply_detect_head(det, feats, grid), dcfg.max_dets)
        return stem, boxes, scores, rerun

    return forward


class StreamEngine(SlotEngine):
    """Multi-tick streaming detection engine; see module docstring."""

    request_type = StreamRequest

    def __init__(self, params, bn_state, cfg: MNV2Config, det_params, *,
                 det_cfg: DetectConfig = DetectConfig(),
                 gate: DeltaGateConfig = DeltaGateConfig(),
                 max_streams: int = STREAM_MAX_SLOTS,
                 max_queue: int | None = STREAM_MAX_QUEUE,
                 deploy_quant_bits: int | None = SERVE_QUANT_BITS,
                 iou_thresh: float = 0.3,
                 evict: str = "drop-newest",
                 stem_path: str = "auto",
                 device=None, **core):
        """``params``/``bn_state``/``det_params``: the port's trees
        (`init_mnv2` and `init_detect_head`, or reference trees through
        `compat.tree_from_reference`).  ``evict`` defaults to drop-newest:
        an admitted stream is a promise held for its whole lifetime.
        ``stem_path``: ``"gated"``, ``"where"`` or ``"auto"`` (gated on a
        CUDA engine, where on the CPU).  ``device``: None ⇒ the GPU
        (raises when there is none).  ``core`` forwards the scheduler's
        fault-tolerance knobs to `SlotEngine`."""
        if cfg.variant != "p2m":
            raise ValueError("StreamEngine requires the p2m variant: stem "
                             "caching and readout accounting are defined by "
                             "the in-pixel layer")
        self.device = resolve_device(device)
        super().__init__(max_streams, max_queue=max_queue, evict=evict,
                         **core)
        self.cfg = cfg
        self._kernel_faults = 0
        self._gate_faults = 0
        self.det_cfg = det_cfg
        self.gate_cfg = gate
        self._params = _tree_to(params, self.device)
        self._bn = _tree_to(bn_state, self.device)
        self._det = _tree_to(det_params, self.device)
        dep = deploy_params(self._params["stem"], self._bn["stem"], cfg.p2m)
        if deploy_quant_bits is not None:
            dep = quantize_deploy(
                dep, QuantSpec(deploy_quant_bits, deploy_quant_bits))
        dep = premix_deploy(dep, cfg.p2m)
        dep["shift"] = dep["shift"].to(torch.float32).contiguous()
        self._deploy = dep
        self.geom = FirstLayerGeom(
            image_size=cfg.image_size, kernel=cfg.p2m.kernel, padding=0,
            stride=cfg.p2m.stride, out_channels=cfg.p2m.out_channels,
            out_bits=cfg.p2m.n_bits)
        self._iou_thresh = iou_thresh

        if stem_path == "auto":
            stem_path = "gated" if self.device.type == "cuda" else "where"
        self._fwd = _stream_forward_for(cfg, det_cfg, stem_path)  # checks it
        self.stem_path = stem_path
        # skip accounting over *active* slots (gated path only: the where
        # path computes every slot regardless)
        self._stem_total = 0
        self._stem_skipped = 0

        ho = cfg.p2m.out_spatial(cfg.image_size)
        co = cfg.p2m.out_channels
        # on the device across ticks: _launch feeds the previous tick's
        # stem output straight back in
        self._cached_stem = torch.zeros((self.n_slots, ho, ho, co),
                                        device=self.device)
        self._gates: list[DeltaGate | None] = [None] * self.n_slots
        self._trackers: list[Tracker | None] = [None] * self.n_slots
        self.registry.register_view(self.metrics_scope, "stream",
                                    self.stream_summary)
        self.registry.register_view(self.metrics_scope, "gates",
                                    self._gate_ledgers)

    # ------------------------------------------------- adapter hooks

    def submit(self, req: StreamRequest) -> str:
        """Reject degenerate streams at the door: an empty stream would
        otherwise occupy a slot whose launch has no frame to read."""
        if req.n_frames == 0:
            raise ValueError(f"stream {req.uid} has no frames")
        return super().submit(req)

    def _on_admit(self, i: int, req: StreamRequest) -> None:
        """Recycle slot ``i`` for a new stream: fresh gate (no reference
        frame), fresh tracker (ids restart at 0), zeroed stem cache —
        nothing of the previous occupant may leak."""
        self._gates[i] = DeltaGate(self.gate_cfg, self.geom)
        self._trackers[i] = Tracker(iou_thresh=self._iou_thresh)
        self._cached_stem[i] = 0.0
        req.ledger = self._gates[i].ledger

    def _on_launch_fault(self, exc: Exception) -> None:
        """Count the fault; the stem stays on its path (no fallback)."""
        self._kernel_faults += 1

    @torch.no_grad()
    def forward(self, images: torch.Tensor, cached: torch.Tensor,
                rerun: torch.Tensor):
        """One tick's forward on the engine's device through the engine's
        trees: (stem, boxes, scores, effective rerun mask)."""
        return self._fwd(self._params, self._bn, self._deploy, self._det,
                         images, cached, rerun)

    def _launch(self, active):
        h = w = self.cfg.image_size
        images = np.zeros((self.n_slots, h, w, 3), np.float32)
        rerun = np.zeros((self.n_slots,), bool)
        frames: dict[int, np.ndarray] = {}
        for i, req in active:
            frame = req.frames[req.frames_done]
            frames[i] = frame
            images[i] = frame
            gate = self._gates[i]
            was_disabled = gate.disabled
            rerun[i] = gate.should_rerun(frame)
            if gate.disabled and not was_disabled:
                self._gate_faults += 1  # reference failed validation
        stem, boxes, scores, rerun_eff = self.forward(
            torch.from_numpy(images).to(self.device), self._cached_stem,
            torch.from_numpy(rerun).to(self.device))
        boxes, scores = boxes.cpu().numpy(), scores.cpu().numpy()
        rerun_eff = rerun_eff.cpu().numpy()
        self._cached_stem = stem  # stays on the device
        if self.stem_path == "gated":
            # every active slot whose effective mask is False had its stem
            # copied from the cache in-kernel
            self._stem_total += len(active)
            self._stem_skipped += sum(
                1 for i, _ in active if not rerun_eff[i])
        for i, req in active:  # the per-stream ledger meters the tick
            if rerun_eff[i] and not rerun[i]:
                # the on-device check caught a corrupted stem cache: this
                # stream's gate drops to dense (the ledger meters the
                # *effective* mask)
                self._gates[i].disable()
                self._gate_faults += 1
            self._gates[i].observe(frames[i], bool(rerun_eff[i]))
        return boxes, scores

    def _absorb(self, i: int, req: StreamRequest, result) -> bool:
        boxes, scores = result
        req.frame_outputs.append((boxes[i].copy(), scores[i].copy()))
        keep = scores[i] >= self.det_cfg.score_thresh
        live = self._trackers[i].update(boxes[i][keep], scores[i][keep])
        req.tracks.append([(t.tid, t.box.copy(), t.score) for t in live])
        req.frames_done += 1
        return req.frames_done >= req.n_frames

    # ------------------------------------------------------ reporting

    def _gate_ledgers(self) -> list:
        """Per-slot delta-gate ledger summaries (None = free slot)."""
        return [None if g is None else g.ledger.summary()
                for g in self._gates]

    def health(self) -> dict:
        """Core health report plus the stream-specific counters: gates
        dropped to dense (corrupted cache or reference) and launch
        faults."""
        h = super().health()
        h["gate_faults"] = self._gate_faults
        h["kernel_faults"] = self._kernel_faults
        return h

    def stream_summary(self) -> dict:
        """Aggregate stream metrics over completed requests: mean stem
        skip rate, measured bits/frame vs dense, and the measured
        bandwidth reduction on the served traffic (summed over the
        per-stream ledgers)."""
        done: list[StreamRequest] = self.completed
        frames = sum(r.frames_done for r in done)
        skips = sum(r.skip_count for r in done)
        bits = sum(r.bits for r in done)
        dense = frame_output_bits(self.geom)
        bpf = bits / frames if frames else 0.0
        return {
            "streams": len(done),
            "frames": frames,
            "stem_skip_rate": skips / frames if frames else 0.0,
            "bits_per_frame": bpf,
            "dense_bits_per_frame": dense,
            "measured_reduction_vs_dense": dense / bpf if bpf else 0.0,
            "stem_path": self.stem_path,
            # gated path only: fraction of active-slot stem computations
            # the kernel replaced by a cache copy (0.0 on the where path,
            # which computes every slot)
            "stem_flops_skipped_ratio": (
                self._stem_skipped / self._stem_total
                if self._stem_total else 0.0),
        }
