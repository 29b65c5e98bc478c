"""P²M as a drop-in modality frontend (beyond-paper integration); port of
`repro.core.frontend`.

The paper embeds the first CNN layers in the sensor.  For the multimodal
architectures (llama-3.2-vision, whisper) the same idea slots in as the
*patch/frame embedder*: the sensor ships N_b-bit compressed feature maps
instead of raw 12-bit pixels, and a linear projection lifts them to the
backbone width.  At the default config a 560² frame gives 112² P²M
outputs, pooled 4×4 into 28² = 784 tokens of 8·4·4 = 128 features,
projected to Llama-3.2-Vision-11B's ``d_model`` of 4096.

The conv is the P²M stem (`core/p2m_conv.py`): in the deploy form the
folded, 8-bit quantized kernel the tuner picks (B1 or B2's ring) for a
CUDA tensor; in the train form B1/B2 forward and the closed-form B3/B4
backward through `ops.P2MConvFunction`.  ``proj`` is a plain product,
as the reference computes it outside any kernel.

Under the VLM's plan (`parallel.plan_for`) the frontend runs as it is on
each rank's images: the frames split over the batch axes like the
tokens and are replicated over ``"model"``, each rank's stem runs B1 or
B2 on its own frames, and ``proj`` stays whole on every rank (its 128 ×
4096 floats replicated, not column-split), so the tokens it gives are
the rank's rows of ``image_embeds``, which the VLM's cross blocks take
replicated over the model axis.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.p2m_conv import (
    P2MConvConfig,
    apply_p2m_conv_deploy,
    apply_p2m_conv_train,
    init_p2m_conv,
    init_p2m_state,
)
from repro_torch.core.pixel_model import PixelModel, default_pixel_model
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class P2MFrontendConfig:
    """In-pixel compressive patch embedder.

    ``pool`` merges a ``pool×pool`` block of P²M outputs into one token, so
    token count = (i/(stride·pool))².
    """

    image_size: int = 560
    conv: P2MConvConfig = dataclasses.field(default_factory=P2MConvConfig)
    d_model: int = 4096
    pool: int = 4

    @property
    def tokens(self) -> int:
        side = self.conv.out_spatial(self.image_size) // self.pool
        return side * side

    @property
    def token_feature_dim(self) -> int:
        return self.conv.out_channels * self.pool * self.pool


def init_p2m_frontend(generator: torch.Generator, cfg: P2MFrontendConfig, *,
                      device=None) -> dict[str, Any]:
    """The conv's train-form params and ``proj`` (token_feature_dim,
    d_model), fan-in normal, drawn from ``generator`` (a CPU generator:
    the same seed gives the same weights on any device) and placed on
    ``device`` (the GPU unless named)."""
    device = resolve_device(device)
    fan_in = cfg.token_feature_dim
    conv = init_p2m_conv(generator, cfg.conv, device=device)
    proj = torch.randn((fan_in, cfg.d_model), generator=generator) \
        * (1.0 / fan_in) ** 0.5
    return {"conv": conv, "proj": proj.to(device)}


def init_p2m_frontend_state(cfg: P2MFrontendConfig, *,
                            device=None) -> dict[str, Any]:
    return {"conv": init_p2m_state(cfg.conv, device=resolve_device(device))}


def pool_tokens(fmap: torch.Tensor, pool: int) -> torch.Tensor:
    """(B, H, W, C) feature map → (B, (H/p)·(W/p), p·p·C) tokens: the map
    cropped to whole ``pool`` blocks, blocks in raster order, a token's
    features running (row in block, column in block, channel), as the
    reference lays them out."""
    b, h, w, c = fmap.shape
    p = pool
    x = fmap[:, : (h // p) * p, : (w // p) * p, :]
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def apply_p2m_frontend(
    params: dict,
    state: dict,
    images: torch.Tensor,
    cfg: P2MFrontendConfig,
    model: PixelModel | None = None,
    *,
    train: bool = False,
    deploy: dict | None = None,
    impl: str | None = None,
):
    """(B, H, W, 3) → (B, tokens, d_model) embeddings, plus new state.

    When ``deploy`` is given (`bn_fold.deploy_params`, optionally with
    `p2m_conv.premix_deploy`'s ``wrows``), the folded, quantized in-pixel
    path is used (what the manufactured sensor would emit) and the state
    is returned as it is.  Otherwise the train form runs, BN on batch
    statistics with ``train`` (the new state its running update), on the
    running statistics without.  ``impl`` takes the port's conv names
    (`core.p2m_conv._resolve_impl`): ``"cuda"``, ``"plain"`` or
    ``"patches"``, by the tensor's device when None; the reference's
    ``"pallas"`` and ``"fused"`` are its own kernels and not names here.
    """
    model = model or default_pixel_model()
    if deploy is not None:
        fmap = apply_p2m_conv_deploy(deploy, images, cfg.conv, model,
                                     impl=impl)
        new_state = state
    else:
        fmap, conv_state = apply_p2m_conv_train(
            params["conv"], state["conv"], images, cfg.conv, model,
            train=train, impl=impl)
        new_state = {"conv": conv_state}
    return pool_tokens(fmap, cfg.pool) @ params["proj"], new_state
