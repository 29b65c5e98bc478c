"""The P²M in-pixel convolutional layer (paper §3.2, §4.1-4.2); port of
`repro.core.p2m_conv`.

Every multiply is the pixel function ``g(w, x)``, weights live in
[−1, 1], and the output passes through the SS-ADC: shifted ReLU with
full-scale saturation, optionally integer-quantized.  Two forms:

* **train form** (`apply_p2m_conv_train`) — conv(g) → BatchNorm (batch
  statistics) → saturating ReLU; what the paper trains.
* **deploy form** (`apply_p2m_conv_deploy`) — BN folded (scale into the
  weights, shift into the ADC counter pre-load; `bn_fold.deploy_params`).

Conv implementations (``impl``):

* ``"cuda"`` — the hand-written CUDA kernels: the forward kernel the
  tuner picks (B1, or B2's ring; `kernels/p2m_conv/tune.py`), and in the
  train form the closed-form backward kernels through
  `ops.P2MConvFunction`; the default for a CUDA tensor, and an error for a
  CPU tensor.
* ``"plain"`` — the kernels' plain PyTorch twin (autograd through it in
  the train form); the default for a CPU tensor.
* ``"patches"`` — `extract_patches` + `p2m_matmul_plain`, the
  patch-materializing reference.

``"plain"`` and ``"patches"`` run on a CUDA tensor only when asked for.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.adc import ADCConfig, clip
from repro_torch.core.pixel_model import PixelModel, default_pixel_model
from repro_torch.kernels.p2m_conv import tune
from repro_torch.kernels.p2m_conv.conv import (
    p2m_conv_fused,
    p2m_conv_plain,
    p2m_conv_premixed_plain,
    premix_rows,
)
from repro_torch.kernels.p2m_conv.ops import (
    _coeff_tuple,
    p2m_conv,
    p2m_matmul_plain,
)

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
    w = clip(theta, -1.0, 1.0)
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


def _conv_raw(images: torch.Tensor, w: torch.Tensor, cfg: P2MConvConfig,
              model: PixelModel, impl: str) -> torch.Tensor:
    """Pre-epilogue conv accumulation (B, Ho, Wo, Co) via ``impl``,
    differentiable in ``images`` and ``w``."""
    zero = torch.zeros(cfg.out_channels, dtype=torch.float32,
                       device=images.device)
    if impl == "cuda":
        return p2m_conv(images, w, zero, model, cfg.adc, "raw", cfg.kernel,
                        cfg.stride)
    if impl == "plain":
        return p2m_conv_plain(images, w, zero, kernel=cfg.kernel,
                              stride=cfg.stride, coeffs=_coeff_tuple(model),
                              mode="raw")
    b = images.shape[0]
    ho = cfg.out_spatial(images.shape[1])
    wo = cfg.out_spatial(images.shape[2])
    patches = extract_patches(images, cfg.kernel, cfg.stride)  # (B,P,K)
    xf = patches.reshape(b * patches.shape[1], -1)
    raw = p2m_matmul_plain(xf, w, zero, model, cfg.adc, mode="raw")
    return raw.reshape(b, ho, wo, cfg.out_channels)


def apply_p2m_conv_train(
    params: dict,
    state: dict,
    images: torch.Tensor,
    cfg: P2MConvConfig,
    model: PixelModel | None = None,
    *,
    train: bool = True,
    generator: torch.Generator | None = None,
    impl: str | None = None,
) -> tuple[torch.Tensor, dict]:
    """Train-form forward: conv(g) → BN → saturating ReLU.

    With ``train`` BN normalizes by the batch's mean and population
    variance and the new state is ``0.9·old + 0.1·batch`` (momentum
    ``cfg.bn_momentum``); otherwise it uses the running statistics.  Read
    noise (``model.read_noise_std``) is drawn from ``generator`` when one
    is given.  ``impl`` selects the conv (`_resolve_impl`).

    Returns ``(out (B, Ho, Wo, Co), new_state)``.
    """
    model = model or default_pixel_model()
    b = images.shape[0]
    ho = cfg.out_spatial(images.shape[1])
    wo = cfg.out_spatial(images.shape[2])
    w = _flat_weights(params["theta"], cfg)

    raw = _conv_raw(images, w, cfg, model, _resolve_impl(impl, images))
    raw = raw.reshape(b * ho * wo, cfg.out_channels)
    if model.read_noise_std > 0.0 and generator is not None:
        noise = torch.randn(raw.shape, generator=generator,
                            device=generator.device, dtype=raw.dtype)
        raw = raw + model.read_noise_std * noise.to(raw.device)

    if train:
        mean = raw.mean(dim=0)
        var = raw.var(dim=0, correction=0)
        mom = cfg.bn_momentum
        new_state = {
            "bn_mean": mom * state["bn_mean"] + (1 - mom) * mean.detach(),
            "bn_var": mom * state["bn_var"] + (1 - mom) * var.detach(),
        }
    else:
        mean, var = state["bn_mean"], state["bn_var"]
        new_state = state
    xhat = (raw - mean) / torch.sqrt(var + cfg.bn_eps)
    y = params["bn_gamma"] * xhat + params["bn_beta"]
    y = clip(y, 0.0, cfg.adc.full_scale)  # saturating ReLU
    return y.reshape(b, ho, wo, cfg.out_channels), new_state


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
    coeffs = _coeff_tuple(model)
    wrows = deploy.get("wrows")
    if wrows is None:
        wrows = premix_rows(deploy["w"], coeffs, cfg.kernel)
    kw = dict(kernel=cfg.kernel, stride=cfg.stride, mode=mode,
              v_lsb=adc.v_lsb, max_count=adc.max_count)
    if impl == "plain":
        return p2m_conv_premixed_plain(images, wrows, shift, **kw)
    # The tuner's blocks and depth, as the reference's deploy path takes
    # them through `ops.p2m_conv` (B1, or B2's ring).
    b, h, w, c = images.shape
    bh, bn, depth = tune.get_conv_blocks(b, h, w, c, cfg.out_channels,
                                         cfg.kernel, cfg.stride, coeffs,
                                         mode, device=images.device)
    return p2m_conv_fused(images, wrows, shift, block_h=bh, block_n=bn,
                          pipeline_depth=depth, **kw)
