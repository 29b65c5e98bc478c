"""SS-ADC + digital-CDS model (paper §3.3); port of `repro.core.adc`.

The counter gives signed accumulation, a quantized ReLU (clamp at ≥ 0)
and the BN shift term (counter pre-load to ``round(B/Δ)``) for free.
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


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``min(max(x, lo), hi)`` with the reference's gradient (`jnp.clip`):
    at an exact tie with a bound the gradient is split in half, where
    `torch.clamp` passes all of it.  A tie occurs where a value lands on
    a bound exactly, as a BN output of a channel that is constant over
    the batch does (it is ``beta``, 0 at init)."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def shifted_relu(v: torch.Tensor, shift, cfg: ADCConfig) -> torch.Tensor:
    """Float view of the ADC: ``clip(v + shift, 0, full_scale)``."""
    return clip(v + shift, 0.0, cfg.full_scale)


def ste_adc(v: torch.Tensor, shift: torch.Tensor,
            cfg: ADCConfig) -> torch.Tensor:
    """Quantization-aware ADC: forward integer-exact, backward identity
    through the clip's linear region (straight-through estimator)."""
    soft = shifted_relu(v, shift, cfg)
    shift = torch.as_tensor(shift, dtype=torch.float32, device=v.device)
    lsb = torch.tensor(cfg.v_lsb, dtype=torch.float32, device=v.device)
    preset = torch.round(shift / lsb).to(torch.int32)
    hard = adc_dequant(adc_counts(v, cfg, preset_counts=preset), cfg)
    return soft + (hard - soft).detach()
