"""BN folding into the P²M layer (paper §4.2, Eq. 1); port of
`repro.core.bn_fold`.

At inference BN is affine, ``Y = A·X + B`` with ``A = γ/√(σ²+ε)`` and
``B = β − γμ/√(σ²+ε)``.  The paper folds A into the pixel weights and B
into the ADC counter pre-load.  The pixel transfer ``g`` is nonlinear in
w, so the fold is approximate; :func:`fold_error` measures it.
"""
from __future__ import annotations

import torch

from repro_torch.core.p2m_conv import P2MConvConfig, _flat_weights
from repro_torch.core.pixel_model import PixelModel
from repro_torch.kernels.p2m_conv.ops import p2m_matmul_plain


def bn_affine(gamma, beta, mean, var, eps: float = 1e-5):
    """Return (A, B) of the inference-time BN affine map."""
    inv = 1.0 / torch.sqrt(var + eps)
    a = gamma * inv
    b = beta - gamma * mean * inv
    return a, b


def deploy_params(params: dict, state: dict, cfg: P2MConvConfig) -> dict:
    """Fold train-form (θ, BN) into deploy-form (w, shift):
    ``w[k, c] = clip(A[c]·θ[k, c], −1, 1)``, ``shift[c] = B[c]``."""
    a, b = bn_affine(params["bn_gamma"], params["bn_beta"],
                     state["bn_mean"], state["bn_var"], cfg.bn_eps)
    w = _flat_weights(params["theta"], cfg)
    w_fold = torch.clamp(w * a[None, :], -1.0, 1.0)
    return {"w": w_fold, "shift": b, "bn_scale": a}


def fold_error(params: dict, state: dict, cfg: P2MConvConfig,
               model: PixelModel, sample_patches: torch.Tensor) -> float:
    """Max |BN(conv_g(θ)) − conv_g(A·θ) − B| over sample patches."""
    a, b = bn_affine(params["bn_gamma"], params["bn_beta"],
                     state["bn_mean"], state["bn_var"], cfg.bn_eps)
    w = _flat_weights(params["theta"], cfg)
    zero = torch.zeros(cfg.out_channels, dtype=torch.float32, device=w.device)
    raw = p2m_matmul_plain(sample_patches, w, zero, model, cfg.adc, mode="raw")
    exact = a[None, :] * raw + b[None, :]
    w_fold = torch.clamp(w * a[None, :], -1.0, 1.0)
    folded = p2m_matmul_plain(sample_patches, w_fold, b, model, cfg.adc,
                              mode="raw")
    return float(torch.max(torch.abs(exact - folded)))


def init_deploy_form(generator: torch.Generator, cfg: P2MConvConfig, *,
                     device) -> dict:
    """Beyond-paper: initialize directly in deploy parameterization
    (trainable w ∈ [−1,1] and shift), so no fold approximation exists.
    ``w`` is drawn from ``generator`` (a CPU generator: the same seed
    gives the same weights on any device)."""
    k = cfg.kernel
    fan_in = k * k * cfg.in_channels
    w = (torch.rand((fan_in, cfg.out_channels), generator=generator)
         * 2.0 - 1.0) * (3.0 / fan_in) ** 0.5
    return {"w": w.to(device),
            "shift": torch.zeros(cfg.out_channels, dtype=torch.float32,
                                 device=device)}
