"""Post-training quantization for the P²M layer (paper §4.2, §5.2 Fig. 7a);
port of `repro.core.quant`.

Weights per-channel symmetric to ``w_bits``; output activations to
``N_b`` bits via the ADC; the BN shift to the counter pre-load grid.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.adc import ADCConfig


def quantize_symmetric(x: torch.Tensor, bits: int, axis=None):
    """Symmetric linear quantization.  Returns (int32 values, scale);
    ``axis`` selects per-channel scales (reduce over all other axes)."""
    qmax = float(2 ** (bits - 1) - 1)
    if axis is None:
        scale = torch.max(torch.abs(x)) / qmax
    else:
        reduce_dims = tuple(i for i in range(x.dim()) if i != axis)
        scale = torch.amax(torch.abs(x), dim=reduce_dims, keepdim=True) / qmax
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax)
    return q.to(torch.int32), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def fake_quant(x: torch.Tensor, bits: int, axis=None) -> torch.Tensor:
    """Quantize-dequantize with straight-through gradient; the value is
    formed as ``x + (q − x)`` like the reference's, to the last bit."""
    q, scale = quantize_symmetric(x, bits, axis)
    out = dequantize(q, scale)
    return x + (out - x).detach()


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Bit-widths for the deployable P²M layer."""

    w_bits: int = 8
    out_bits: int = 8
    shift_bits: int = 8


def quantize_deploy(deploy: dict, spec: QuantSpec) -> dict:
    """Quantize folded deploy params: weights per output channel, the
    shift to the ADC count grid (``out_bits`` sets that ADC)."""
    wq = fake_quant(deploy["w"], spec.w_bits, axis=1)
    adc = adc_for_bits(spec.out_bits)
    lsb = torch.tensor(adc.v_lsb, dtype=torch.float32,
                       device=deploy["shift"].device)
    sq = torch.round(deploy["shift"] / lsb) * adc.v_lsb
    return {**deploy, "w": wq, "shift": sq}


def adc_for_bits(out_bits: int) -> ADCConfig:
    return ADCConfig(n_bits=out_bits, v_lsb=1.0 / (2**out_bits - 1))
