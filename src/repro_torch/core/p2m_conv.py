"""The P²M in-pixel convolutional layer (paper §3.2, §4.1-4.2); port of
`repro.core.p2m_conv` (deploy form; the train form comes with the
training slice).

Every multiply is the pixel function ``g(w, x)``, weights live in
[−1, 1], and the output passes through the SS-ADC: shifted ReLU with
full-scale saturation, optionally integer-quantized.  The deploy form has
BN folded (scale into the weights, shift into the ADC counter pre-load;
`bn_fold.deploy_params`).

Conv implementations (``impl``):

* ``"cuda"`` — the hand-written CUDA kernel; the default for a CUDA
  tensor, and an error for a CPU tensor.
* ``"plain"`` — the kernel's plain PyTorch twin; the default for a CPU
  tensor.
* ``"patches"`` — `extract_patches` + `p2m_matmul_plain`, the
  patch-materializing reference.

``"plain"`` and ``"patches"`` run on a CUDA tensor only when asked for.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.adc import ADCConfig
from repro_torch.core.pixel_model import PixelModel, default_pixel_model
from repro_torch.kernels.p2m_conv.conv import (
    p2m_conv_fused,
    p2m_conv_premixed_plain,
    premix_rows,
)
from repro_torch.kernels.p2m_conv.ops import _coeff_tuple, p2m_matmul_plain

IMPLS = ("cuda", "plain", "patches")


@dataclasses.dataclass(frozen=True)
class P2MConvConfig:
    """Paper Table 1 defaults: k=5, s=5 (non-overlapping), p=0, c_o=8, N_b=8."""

    kernel: int = 5
    stride: int = 5
    in_channels: int = 3
    out_channels: int = 8
    n_bits: int = 8
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5

    @property
    def adc(self) -> ADCConfig:
        return ADCConfig(n_bits=self.n_bits, v_lsb=1.0 / (2**self.n_bits - 1))

    def out_spatial(self, i: int) -> int:
        return (i - self.kernel) // self.stride + 1


def extract_patches(images: torch.Tensor, kernel: int,
                    stride: int) -> torch.Tensor:
    """(B, H, W, C) → (B, P, k·k·C) patches, (kh, kw, C) fastest-varying."""
    b, h, w, c = images.shape
    k, s = kernel, stride
    if s == k and h % k == 0 and w % k == 0:
        x = images.reshape(b, h // k, k, w // k, k, c)
        x = x.permute(0, 1, 3, 2, 4, 5)  # (B, ph, pw, k, k, C)
        return x.reshape(b, (h // k) * (w // k), k * k * c)
    # (B, ph, W, C, kh) → (B, ph, pw, C, kh, kw) → (B, ph, pw, kh, kw, C)
    x = images.unfold(1, k, s).unfold(2, k, s)
    ph, pw = x.shape[1], x.shape[2]
    return x.permute(0, 1, 2, 4, 5, 3).reshape(b, ph * pw, k * k * c)


def init_p2m_conv(generator: torch.Generator, cfg: P2MConvConfig, *,
                  device) -> dict[str, Any]:
    """Trainable params of the train form, drawn from ``generator`` (a CPU
    generator: the same seed gives the same weights on any device)."""
    k = cfg.kernel
    fan_in = k * k * cfg.in_channels
    theta = (torch.rand((k, k, cfg.in_channels, cfg.out_channels),
                        generator=generator) * 2.0 - 1.0) * (3.0 / fan_in) ** 0.5
    return {
        "theta": theta.to(device),
        "bn_gamma": torch.ones(cfg.out_channels, device=device),
        "bn_beta": torch.zeros(cfg.out_channels, device=device),
    }


def init_p2m_state(cfg: P2MConvConfig, *, device) -> dict[str, Any]:
    return {
        "bn_mean": torch.zeros(cfg.out_channels, device=device),
        "bn_var": torch.ones(cfg.out_channels, device=device),
    }


def _flat_weights(theta: torch.Tensor, cfg: P2MConvConfig) -> torch.Tensor:
    """(k,k,C,Co) → (k·k·C, Co), clipped to the transistor range [−1, 1]."""
    k = cfg.kernel
    w = torch.clamp(theta, -1.0, 1.0)
    return w.reshape(k * k * cfg.in_channels, cfg.out_channels)


def _resolve_impl(impl: str | None, images: torch.Tensor) -> str:
    """Conv implementation: by the tensor's device unless asked for."""
    if impl is None:
        return "cuda" if images.is_cuda else "plain"
    if impl not in IMPLS:
        raise ValueError(f"unknown p2m conv impl {impl!r}")
    if impl == "cuda" and not images.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors, got images on "
                         f"{images.device}")
    return impl


def premix_deploy(deploy: dict, cfg: P2MConvConfig,
                  model: PixelModel | None = None) -> dict:
    """The deploy tree plus ``wrows``, its premixed weights (`premix_rows`),
    so that serving computes the premix once and not on every launch."""
    model = model or default_pixel_model()
    return {**deploy,
            "wrows": premix_rows(deploy["w"], _coeff_tuple(model), cfg.kernel)}


def apply_p2m_conv_deploy(
    deploy: dict,
    images: torch.Tensor,
    cfg: P2MConvConfig,
    model: PixelModel | None = None,
    *,
    quantize: bool = True,
    impl: str | None = None,
) -> torch.Tensor:
    """Deploy-form forward with folded BN: conv(g) → shifted-ReLU ADC.

    ``deploy`` holds ``w`` (k·k·C, Co) folded+clipped weights and ``shift``
    (Co,) counter pre-load in volts (see `bn_fold`), and may hold
    ``wrows`` from `premix_deploy`.  NHWC images in, (B, Ho, Wo, Co) out.
    """
    model = model or default_pixel_model()
    mode = "quant" if quantize else "relu"
    impl = _resolve_impl(impl, images)
    adc = cfg.adc
    shift = deploy["shift"].to(torch.float32)
    if impl == "patches":
        b = images.shape[0]
        ho = cfg.out_spatial(images.shape[1])
        wo = cfg.out_spatial(images.shape[2])
        patches = extract_patches(images, cfg.kernel, cfg.stride)
        xf = patches.reshape(b * patches.shape[1], -1)
        out = p2m_matmul_plain(xf, deploy["w"], shift, model, adc, mode=mode)
        return out.reshape(b, ho, wo, cfg.out_channels)
    wrows = deploy.get("wrows")
    if wrows is None:
        wrows = premix_rows(deploy["w"], _coeff_tuple(model), cfg.kernel)
    conv = p2m_conv_fused if impl == "cuda" else p2m_conv_premixed_plain
    return conv(images, wrows, shift, kernel=cfg.kernel, stride=cfg.stride,
                mode=mode, v_lsb=adc.v_lsb, max_count=adc.max_count)
