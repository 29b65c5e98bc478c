"""The paper's analytic numbers from the port (`repro_torch.core.energy`,
`repro_torch.models.mobilenetv2.layer_census` and
`peak_activation_bytes`, `repro_torch.core.bn_fold.init_deploy_form`):
a mirror of the energy, census and Table 2 tests of
`tests/test_paper_tables.py`, and every number held equal to the
reference's (pure Python on both sides, so exactly).  Eq. 2's 18.75× is
held in `tests/test_torch_video.py`."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import energy as j_energy
from repro.core.bn_fold import init_deploy_form as j_init_deploy_form
from repro.core.p2m_conv import P2MConvConfig as JP2MConvConfig
from repro.models.mobilenetv2 import MNV2Config as JMNV2Config
from repro.models.mobilenetv2 import layer_census as j_layer_census
from repro.models.mobilenetv2 import (
    peak_activation_bytes as j_peak_activation_bytes,
)
from repro_torch.core import energy
from repro_torch.core.bn_fold import init_deploy_form
from repro_torch.core.energy import (
    BASELINE_C_ENERGY,
    BASELINE_DELAY,
    N_PIX_BASELINE_C,
    N_PIX_P2M,
    P2M_DELAY,
    P2M_ENERGY,
    evaluate_model,
    total_macs,
)
from repro_torch.core.p2m_conv import P2MConvConfig
from repro_torch.models.mobilenetv2 import (
    MNV2Config,
    layer_census,
    peak_activation_bytes,
)

# paper Table 2 values: (MAdds G, peak MB); peak convention per column —
# see the reference's models/mobilenetv2.py docstring.
TABLE2 = {
    ("baseline", 560): (1.93, 7.53),
    ("p2m", 560): (0.27, 0.30),
    ("baseline", 225): (0.31, 1.2),
    ("p2m", 225): (0.05, 0.049),
    ("baseline", 115): (0.09, 0.311),
    ("p2m", 115): (0.01, 0.013),
}


@pytest.mark.parametrize("variant,res", list(TABLE2))
def test_table2_reproduction(variant, res):
    paper_madds, paper_peak = TABLE2[(variant, res)]
    cfg = MNV2Config(variant=variant, image_size=res)
    madds = total_macs(layer_census(cfg)) / 1e9
    peak = peak_activation_bytes(cfg, fused_blocks=(variant == "p2m")) / 1e6
    assert abs(madds - paper_madds) / paper_madds < 0.45
    assert abs(peak - paper_peak) / paper_peak < 0.06


@pytest.mark.parametrize("variant,res", list(TABLE2))
@pytest.mark.parametrize("width", [1.0, 0.25])
def test_census_and_peak_equal_the_reference(variant, res, width):
    cfg = MNV2Config(variant=variant, image_size=res, width=width)
    jcfg = JMNV2Config(variant=variant, image_size=res, width=width)
    for include in (False, True):
        got = [dataclasses.astuple(c)
               for c in layer_census(cfg, include_in_pixel=include)]
        want = [dataclasses.astuple(c)
                for c in j_layer_census(jcfg, include_in_pixel=include)]
        assert got == want
    for fused in (False, True):
        assert peak_activation_bytes(cfg, fused_blocks=fused) == \
            j_peak_activation_bytes(jcfg, fused_blocks=fused)


def test_table2_reduction_ratios():
    """The headline ratios: ~7.15× MAdds, ~25.1× peak memory at 560²."""
    base = MNV2Config(variant="baseline", image_size=560)
    p2m = MNV2Config(variant="p2m", image_size=560)
    madds_ratio = total_macs(layer_census(base)) / total_macs(layer_census(p2m))
    peak_ratio = (peak_activation_bytes(base, fused_blocks=False)
                  / peak_activation_bytes(p2m, fused_blocks=True))
    assert 6.0 < madds_ratio < 8.0
    assert 23.0 < peak_ratio < 27.0


def _reports(module, census_fn, cfg_cls):
    p2m = census_fn(cfg_cls(variant="p2m", image_size=560))
    base = census_fn(cfg_cls(variant="baseline", image_size=560))
    return (module.evaluate_model(p2m, module.N_PIX_P2M, module.P2M_ENERGY,
                                  module.P2M_DELAY),
            module.evaluate_model(base, module.N_PIX_BASELINE_C,
                                  module.BASELINE_C_ENERGY,
                                  module.BASELINE_DELAY))


def test_fig8_edp_ratios():
    """Energy ≤7.81×, delay ≤2.15×, EDP 16.76× / ~11× (paper §5.3)."""
    p2m_census = layer_census(MNV2Config(variant="p2m", image_size=560))
    base_census = layer_census(MNV2Config(variant="baseline", image_size=560))
    rp = evaluate_model(p2m_census, N_PIX_P2M, P2M_ENERGY, P2M_DELAY)
    rb = evaluate_model(base_census, N_PIX_BASELINE_C, BASELINE_C_ENERGY,
                        BASELINE_DELAY)
    energy_ratio = rb.energy_uj / rp.energy_uj
    delay_ratio = rb.delay_sequential_ms / rp.delay_sequential_ms
    edp_seq = rb.edp_sequential / rp.edp_sequential
    edp_cons = rb.edp_conservative / rp.edp_conservative
    assert abs(energy_ratio - 7.81) / 7.81 < 0.05
    assert abs(delay_ratio - 2.15) / 2.15 < 0.08
    assert abs(edp_seq - 16.76) / 16.76 < 0.05
    assert abs(edp_cons - 11.0) / 11.0 < 0.15


def test_sensing_energy_breakdown():
    """P²M moves energy out of sensing+com: its sensor-side energy must be
    ≪ baseline's (the point of Fig. 8a)."""
    rp, rb = _reports(energy, layer_census, MNV2Config)
    assert (rp.sens_energy_uj + rp.com_energy_uj) < 0.12 * (
        rb.sens_energy_uj + rb.com_energy_uj)


def test_edp_reports_equal_the_reference():
    """Every field of both Fig. 8 reports, and the constants, equal the
    reference's."""
    got = _reports(energy, layer_census, MNV2Config)
    want = _reports(j_energy, j_layer_census, JMNV2Config)
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]
    for name in ("P2M_ENERGY", "BASELINE_C_ENERGY", "BASELINE_NC_ENERGY",
                 "P2M_DELAY", "BASELINE_DELAY", "N_PIX_P2M",
                 "N_PIX_BASELINE_C", "N_PIX_BASELINE_NC"):
        a, b = getattr(energy, name), getattr(j_energy, name)
        assert (dataclasses.asdict(a) if dataclasses.is_dataclass(a)
                else a) == (dataclasses.asdict(b)
                            if dataclasses.is_dataclass(b) else b)


def test_conv_delay_matches_the_reference_per_layer():
    census = layer_census(MNV2Config(variant="baseline", image_size=225))
    jcensus = j_layer_census(JMNV2Config(variant="baseline", image_size=225))
    for c, jc in zip(census, jcensus):
        assert c.weights == jc.weights and c.macs == jc.macs
        assert energy.conv_delay_s(c, P2M_DELAY) == \
            j_energy.conv_delay_s(jc, j_energy.P2M_DELAY)
    assert energy.soc_delay_s(census, BASELINE_DELAY) == \
        j_energy.soc_delay_s(jcensus, j_energy.BASELINE_DELAY)


@pytest.mark.parametrize("kernel,channels,out", [(5, 3, 8), (3, 1, 16)])
def test_init_deploy_form_matches_the_reference_law(kernel, channels, out):
    """Deploy-form init: w uniform in ±√(3/fan_in) (the reference's law;
    the draws come from each framework's own generator), shift zero;
    the same seed gives the same weights."""
    cfg = P2MConvConfig(kernel=kernel, stride=kernel, in_channels=channels,
                        out_channels=out)
    jcfg = JP2MConvConfig(kernel=kernel, stride=kernel,
                          in_channels=channels, out_channels=out)
    ref = j_init_deploy_form(jax.random.PRNGKey(0), jcfg)
    dep = init_deploy_form(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    again = init_deploy_form(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    fan_in = kernel * kernel * channels
    lim = (3.0 / fan_in) ** 0.5
    assert dep["w"].shape == tuple(np.shape(ref["w"])) == (fan_in, out)
    assert dep["w"].dtype == torch.float32
    assert float(dep["w"].abs().max()) <= lim
    assert float(np.abs(ref["w"]).max()) <= lim
    assert torch.equal(dep["w"], again["w"])
    assert torch.equal(dep["shift"], torch.zeros(out))
    np.testing.assert_array_equal(np.asarray(ref["shift"]), np.zeros(out))
