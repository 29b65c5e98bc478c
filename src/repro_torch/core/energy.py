"""Energy-delay-product model (paper §5.3, Eq. 4-8, Tables 4-5); copy of
`repro.core.energy` (pure Python).

    E_tot ≈ (e_pix + e_adc)·N_pix  +  e_com·N_pix  +  e_mac·N_mac  [+ e_read·N_read ≈ 0]

    t_conv ≈ ceil(k²·c_i·c_o / ((B_IO/B_W)·N_bank))·t_read
           + ceil(k²·c_i·c_o / N_mult)·h_o·w_o·t_mult              (Eq. 7)

    T_delay ≈ T_sens + T_adc + Σ t_conv        (sequential, Eq. 8)
    T_delay ≈ max(T_sens + T_adc, Σ t_conv)    (conservative overlap)

All constants are the paper's 22 nm values (Tables 4-5).  The model is
deliberately parametric so a caller can sweep alternatives.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Sequence

# ---------------------------------------------------------------- Table 4/5


@dataclasses.dataclass(frozen=True)
class EnergyConstants:
    """Per-op energies in pJ (22 nm, paper Table 4)."""

    e_pix: float  # per-pixel sensing/readout
    e_adc: float  # per-pixel A/D conversion
    e_com: float = 900.0  # sensor→SoC communication per pixel
    e_mac: float = 1.568  # one MAC on the SoC (45→22 nm scaled)


@dataclasses.dataclass(frozen=True)
class DelayConstants:
    """Paper Table 5."""

    t_sens_s: float  # sensor read delay
    t_adc_s: float  # total ADC delay
    t_mult_s: float = 5.48e-9
    t_read_s: float = 5.48e-9
    b_io: int = 64
    b_w: int = 32
    n_bank: int = 4
    n_mult: int = 175


P2M_ENERGY = EnergyConstants(e_pix=148.0, e_adc=41.9)
BASELINE_C_ENERGY = EnergyConstants(e_pix=312.0, e_adc=86.14)
BASELINE_NC_ENERGY = EnergyConstants(e_pix=312.0, e_adc=80.14)

P2M_DELAY = DelayConstants(t_sens_s=35.84e-3, t_adc_s=0.229e-3)
BASELINE_DELAY = DelayConstants(t_sens_s=39.2e-3, t_adc_s=4.58e-3)

# Sensor-output pixel counts (Table 4, "Sensor output pixel" column).
N_PIX_P2M = 112 * 112 * 8
N_PIX_BASELINE_C = 560 * 560 * 3
N_PIX_BASELINE_NC = 300 * 300 * 3

# ---------------------------------------------------------------- layer census


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """One conv layer for MAdds/delay accounting.

    Depthwise convs are expressed with ``groups``; ``k=1`` covers pointwise
    and fully-connected (h_o = w_o = 1) layers.
    """

    k: int
    c_i: int
    c_o: int
    h_o: int
    w_o: int
    groups: int = 1

    @property
    def weights(self) -> int:
        return self.k * self.k * (self.c_i // self.groups) * self.c_o

    @property
    def macs(self) -> int:
        return self.weights * self.h_o * self.w_o


def total_macs(census: Iterable[ConvSpec]) -> int:
    return sum(l.macs for l in census)


def conv_delay_s(layer: ConvSpec, d: DelayConstants) -> float:
    """Eq. 7 for one layer."""
    wts = layer.weights
    read = math.ceil(wts / ((d.b_io / d.b_w) * d.n_bank)) * d.t_read_s
    mult = math.ceil(wts / d.n_mult) * layer.h_o * layer.w_o * d.t_mult_s
    return read + mult


def soc_delay_s(census: Iterable[ConvSpec], d: DelayConstants) -> float:
    return sum(conv_delay_s(l, d) for l in census)


# ---------------------------------------------------------------- E/D/EDP


@dataclasses.dataclass(frozen=True)
class EDPReport:
    energy_uj: float
    sens_energy_uj: float
    com_energy_uj: float
    soc_energy_uj: float
    delay_sequential_ms: float
    delay_conservative_ms: float
    edp_sequential: float  # µJ·ms
    edp_conservative: float


def evaluate_model(
    census: Sequence[ConvSpec],
    n_pix: int,
    e: EnergyConstants,
    d: DelayConstants,
) -> EDPReport:
    """Full Eq. 4-8 evaluation for one model/hardware pairing.

    ``census`` must list the *SoC-executed* conv layers only (for P²M the
    in-pixel first layer is excluded — its energy is inside e_pix/e_adc).
    """
    n_mac = total_macs(census)
    e_sens = (e.e_pix + e.e_adc) * n_pix * 1e-6  # pJ → µJ
    e_com = e.e_com * n_pix * 1e-6
    e_soc = e.e_mac * n_mac * 1e-6
    energy = e_sens + e_com + e_soc

    t_front = d.t_sens_s + d.t_adc_s
    t_soc = soc_delay_s(census, d)
    t_seq = (t_front + t_soc) * 1e3  # ms
    t_cons = max(t_front, t_soc) * 1e3

    return EDPReport(
        energy_uj=energy,
        sens_energy_uj=e_sens,
        com_energy_uj=e_com,
        soc_energy_uj=e_soc,
        delay_sequential_ms=t_seq,
        delay_conservative_ms=t_cons,
        edp_sequential=energy * t_seq,
        edp_conservative=energy * t_cons,
    )
