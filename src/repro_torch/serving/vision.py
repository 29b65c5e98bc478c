"""Batched vision serving: microbatched single-shot inference through the
deploy-folded P²M stem + MobileNetV2 backbone; port of
`repro.serving.vision` (single device).

``VisionEngine`` is a thin adapter over the scheduler core
(`serving/scheduler.py`): a slot is a position in a fixed-shape
microbatch that a request occupies for exactly one tick.  Free slots
carry a zero image and their outputs are discarded.

The forward is the *deployed* model: for the P²M variant the stem runs
with BN folded into the pixel weights and PTQ-quantized, through the CUDA
kernel on the card.  The folded, quantized deploy tree and its premixed
weights are computed once, at construction; a launch runs only the stem
kernel and the backbone.

There is no degradation ladder: the reference swaps the fused conv for
the patches path after repeated launch faults, which here would be a
quiet fall back from the kernel to a plain version.  A failing launch
goes through the scheduler's containment (retry, then quarantine) and
surfaces as failed requests.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.p2m_vww import (
    SERVE_MAX_BATCH,
    SERVE_MAX_QUEUE,
    SERVE_QUANT_BITS,
)
from repro_torch.core.bn_fold import deploy_params
from repro_torch.core.p2m_conv import premix_deploy
from repro_torch.core.pixel_model import PixelModel, default_pixel_model
from repro_torch.core.quant import QuantSpec, quantize_deploy
from repro_torch.device import resolve_device
from repro_torch.models.mobilenetv2 import MNV2Config, apply_mnv2
from repro_torch.serving.scheduler import ScheduledRequest, SlotEngine


@dataclasses.dataclass
class VisionRequest(ScheduledRequest):
    uid: int
    image: np.ndarray  # (H, W, 3) float32 in [0, 1]

    # Filled by the engine:
    label: int | None = None
    probs: np.ndarray | None = None

    @property
    def batch_wall_us(self) -> float:
        """Wall-clock of the (single) launch that served this request."""
        return self.launch_wall_us


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


class VisionEngine(SlotEngine):
    request_type = VisionRequest

    def __init__(self, params, bn_state, cfg: MNV2Config, *,
                 pixel_model: PixelModel | None = None,
                 max_batch: int = SERVE_MAX_BATCH,
                 max_queue: int = SERVE_MAX_QUEUE,
                 deploy_quant_bits: int | None = SERVE_QUANT_BITS,
                 evict: str = "drop-oldest",
                 device=None, **core):
        """``params``/``bn_state``: the port's trees (`init_mnv2`, or a
        reference tree through `compat.tree_from_reference`).
        ``deploy_quant_bits``: PTQ bit-width for the folded P²M stem
        (None ⇒ fold only; ignored for the baseline variant).
        ``device``: None ⇒ the GPU (raises when there is none).
        ``core`` forwards the scheduler's fault-tolerance and cadence
        knobs to `SlotEngine`."""
        self.device = resolve_device(device)
        super().__init__(max_batch, max_queue=max_queue, evict=evict, **core)
        self.cfg = cfg
        self._params = _tree_to(params, self.device)
        self._bn = _tree_to(bn_state, self.device)
        self._pixel_model = pixel_model or default_pixel_model()

        dep = None
        if cfg.variant == "p2m":
            dep = deploy_params(self._params["stem"], self._bn["stem"],
                                cfg.p2m)
            if deploy_quant_bits is not None:
                dep = quantize_deploy(
                    dep, QuantSpec(deploy_quant_bits, deploy_quant_bits))
            dep = premix_deploy(dep, cfg.p2m, self._pixel_model)
        self._deploy = dep

    # ------------------------------------------------- adapter hooks

    @torch.inference_mode()
    def forward(self, images: torch.Tensor,
                p2m_impl: str | None = None) -> torch.Tensor:
        """Class probabilities of a (B, H, W, 3) batch on the engine's
        device, through the engine's deploy tree.  ``p2m_impl`` names
        another stem conv than the device's own (for comparisons)."""
        logits, _ = apply_mnv2(self._params, self._bn, images, self.cfg,
                               self._pixel_model, p2m_deploy=self._deploy,
                               p2m_impl=p2m_impl)
        return torch.softmax(logits, dim=-1)

    def _launch(self, active):
        h = w = self.cfg.image_size
        images = np.zeros((self.n_slots, h, w, 3), np.float32)
        for i, req in active:
            images[i] = req.image
        probs = self.forward(torch.from_numpy(images).to(self.device))
        return probs.cpu().numpy()

    def _absorb(self, i, req: VisionRequest, probs) -> bool:
        req.probs = probs[i]
        req.label = int(probs[i].argmax())
        return True  # a vision slot lives exactly one tick
