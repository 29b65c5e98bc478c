"""The P²M inner product and the fused P²M conv as ops; port of
`repro.kernels.p2m_conv.ops` (forward only).

* :func:`p2m_matmul_plain` — basis-decomposed product (dw·dx matmuls) on
  pre-extracted im2col patches; the "patches" reference path.
* :func:`p2m_conv` — the fused implicit-im2col convolution: the CUDA
  kernel for a CUDA tensor, its plain twin for a CPU tensor.

The differentiable form (the reference's ``custom_vjp``) comes with the
training slice as a ``torch.autograd.Function``.
"""
from __future__ import annotations

import torch

from repro_torch.core.adc import ADCConfig
from repro_torch.core.pixel_model import PixelModel
from repro_torch.kernels.p2m_conv.conv import (
    _epilogue_values,
    p2m_conv_fused,
    premix_rows,
)

_DEFAULT_ADC = ADCConfig()


def _coeff_tuple(model: PixelModel) -> tuple:
    return tuple(tuple(float(v) for v in row) for row in model.coeffs)


def p2m_matmul_plain(x: torch.Tensor, w: torch.Tensor, shift,
                     model: PixelModel, adc: ADCConfig | None = None,
                     mode: str = "relu") -> torch.Tensor:
    """Basis-decomposed P²M product: x (M, K) in [0,1], w (K, N) signed,
    shift (N,) volts → (M, N) through the ``mode`` epilogue."""
    adc = adc or _DEFAULT_ADC
    coeffs = model.coeffs
    dw, dx = coeffs.shape
    x32 = x.to(torch.float32)
    sgn = torch.sign(w).to(torch.float32)
    aw = torch.abs(w).to(torch.float32)

    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    wp = aw
    for i in range(1, dw + 1):
        wsig = sgn * wp
        xp = x32
        for j in range(1, dx + 1):
            a_ij = float(coeffs[i - 1, j - 1])
            if a_ij != 0.0:
                acc = acc + a_ij * (xp @ wsig)
            if j < dx:
                xp = xp * x32
        if i < dw:
            wp = wp * aw
    shift = torch.as_tensor(shift, dtype=torch.float32, device=x.device)
    return _epilogue_values(acc, shift, mode=mode, v_lsb=adc.v_lsb,
                            max_count=adc.max_count)


def p2m_conv(images: torch.Tensor, w: torch.Tensor, shift: torch.Tensor,
             model: PixelModel, adc: ADCConfig | None = None,
             mode: str = "relu", kernel: int = 5, stride: int = 5, *,
             wrows: torch.Tensor | None = None, want_raw: bool = False):
    """Fused P²M convolution: (B, H, W, C) images → (B, Ho, Wo, N).

    ``w`` is the flat (k·k·C, N) weight; ``wrows`` may carry its premix
    (`premix_rows`) when the caller computed it once for many calls.
    """
    adc = adc or _DEFAULT_ADC
    if wrows is None:
        wrows = premix_rows(w, _coeff_tuple(model), kernel)
    return p2m_conv_fused(images, wrows, shift.to(torch.float32),
                          kernel=kernel, stride=stride, mode=mode,
                          v_lsb=adc.v_lsb, max_count=adc.max_count,
                          want_raw=want_raw)
