"""Streaming-video P²M detection; port of `repro.video` (single device).

Synthetic moving-object streams (`synthetic`), a CenterNet-lite
detection head on the deploy-folded P²M-MobileNetV2 backbone (`detect`),
greedy-IoU tracking (`track`), temporal delta gating with measured
readout-bandwidth accounting (`delta`), and the multi-tick
`StreamEngine` over the scheduler core (`engine`).
"""
from repro_torch.video.delta import DeltaGate, DeltaGateConfig, frame_delta
from repro_torch.video.detect import (
    DetectConfig,
    apply_detect_head,
    decode_detections,
    detect_loss,
    init_detect_head,
    render_targets,
)
from repro_torch.video.engine import StreamEngine, StreamRequest
from repro_torch.video.synthetic import SyntheticVideo
from repro_torch.video.track import Track, Tracker, iou_matrix

__all__ = [
    "DeltaGate", "DeltaGateConfig", "frame_delta",
    "DetectConfig", "apply_detect_head", "decode_detections",
    "detect_loss", "init_detect_head", "render_targets",
    "StreamEngine", "StreamRequest", "SyntheticVideo",
    "Track", "Tracker", "iou_matrix",
]
