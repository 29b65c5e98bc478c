"""SS-ADC + digital-CDS model (paper §3.3); port of `repro.core.adc`.

The counter gives signed accumulation, a quantized ReLU (clamp at ≥ 0)
and the BN shift term (counter pre-load to ``round(B/Δ)``) for free.
The straight-through ``ste_adc`` comes with the training slice.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ADCConfig:
    """N-bit SS-ADC; ``v_lsb`` volts per count; 2^n_bits − 1 full-scale counts."""

    n_bits: int = 8
    v_lsb: float = 1.0 / 255.0

    @property
    def max_count(self) -> int:
        return (1 << self.n_bits) - 1

    @property
    def full_scale(self) -> float:
        return self.max_count * self.v_lsb


def adc_counts(v: torch.Tensor, cfg: ADCConfig,
               preset_counts=0) -> torch.Tensor:
    """Integer counter output ``clip(round(v/Δ) + preset, 0, 2^n − 1)``
    (int32, round half to even)."""
    # Divide by a 0-dim tensor on v's device, not a Python float: CUDA
    # divides by a host scalar as a multiply by its reciprocal, which
    # moves round() at half counts.
    lsb = torch.tensor(cfg.v_lsb, dtype=torch.float32, device=v.device)
    counts = torch.round(v / lsb).to(torch.int32) + torch.as_tensor(
        preset_counts, dtype=torch.int32, device=v.device)
    return torch.clamp(counts, 0, cfg.max_count)


def adc_dequant(counts: torch.Tensor, cfg: ADCConfig) -> torch.Tensor:
    """Map counts back to normalized volts."""
    return counts.to(torch.float32) * cfg.v_lsb


def shifted_relu(v: torch.Tensor, shift, cfg: ADCConfig) -> torch.Tensor:
    """Float view of the ADC: ``clip(v + shift, 0, full_scale)``."""
    return torch.clamp(v + shift, 0.0, cfg.full_scale)
