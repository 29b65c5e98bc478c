"""The port's core numerics (`repro_torch.core`) against the JAX
reference — pixel model, ADC, BN fold, PTQ — and the rules the port
keeps: it imports neither `jax` nor `repro`.

Tolerances: fit coefficients bit-identical (the fit is the same numpy);
everything else within 1e-6 (fp32, same op order), integer counts equal.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.core import adc as jadc
from repro.core import bn_fold as jbn
from repro.core import p2m_conv as jp2m
from repro.core import pixel_model as jpm
from repro.core import quant as jquant
from repro_torch import compat
from repro_torch.core import adc, bn_fold, p2m_conv, pixel_model, quant

TOL = 1e-6
SRC = Path(__file__).resolve().parents[1] / "src"


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _params(seed=0):
    """A reference P²M stem with non-trivial BN, in both packages."""
    cfg = jp2m.P2MConvConfig()
    params = jp2m.init_p2m_conv(jax.random.PRNGKey(seed), cfg)
    state = jp2m.init_p2m_state(cfg)
    state = {"bn_mean": state["bn_mean"] + 0.1,
             "bn_var": state["bn_var"] * 0.5}
    params["bn_gamma"] = params["bn_gamma"] * 0.8
    params["bn_beta"] = params["bn_beta"] + 0.05
    tp = compat.tree_from_reference(_np_tree(params), device="cpu")
    ts = compat.tree_from_reference(_np_tree(state), device="cpu")
    return cfg, params, state, p2m_conv.P2MConvConfig(), tp, ts


# ------------------------------------------------------------ pixel model


@pytest.mark.parametrize("dw,dx", [(3, 3), (1, 3), (2, 4)])
def test_fit_coefficients_bit_identical(dw, dx):
    ref = jpm.fit_pixel_model(degree_w=dw, degree_x=dx)
    got = pixel_model.fit_pixel_model(degree_w=dw, degree_x=dx)
    np.testing.assert_array_equal(got.coeffs, ref.coeffs)
    assert got.fit_rmse == ref.fit_rmse


def test_fit_with_term_mask_bit_identical():
    mask = np.abs(jpm.default_pixel_model().coeffs) >= 0.06
    ref = jpm.fit_pixel_model(term_mask=mask)
    got = pixel_model.fit_pixel_model(term_mask=mask)
    np.testing.assert_array_equal(got.coeffs, ref.coeffs)


@settings(max_examples=10, deadline=None, derandomize=True)
@given(st.floats(0.0, 1.0), st.floats(0.0, 1.0))
def test_pixel_model_eval_matches_reference(w, x):
    ref_m = jpm.default_pixel_model()
    got_m = pixel_model.default_pixel_model()
    ws = np.linspace(0, w, 7, dtype=np.float32)[:, None]
    xs = np.linspace(x, 1, 5, dtype=np.float32)[None, :]
    ref = np.asarray(ref_m(jnp.asarray(ws), jnp.asarray(xs)))
    got = got_m(_t(ws), _t(xs)).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_pixel_model_zero_boundaries():
    m = pixel_model.default_pixel_model()
    xs = torch.linspace(0, 1, 11)
    assert torch.all(m(torch.zeros(11), xs) == 0)
    assert torch.all(m(xs, torch.zeros(11)) == 0)
    lin = pixel_model.linear_pixel_model()
    torch.testing.assert_close(lin(xs, xs.flip(0)), xs * xs.flip(0))


# -------------------------------------------------------------------- ADC


def test_adc_functions_match_reference():
    rng = np.random.default_rng(0)
    v = rng.uniform(-1, 2, 1000).astype(np.float32)
    cfg, jcfg = adc.ADCConfig(), jadc.ADCConfig()
    preset = round(0.1 / cfg.v_lsb)
    ref_c = np.asarray(jadc.adc_counts(jnp.asarray(v), jcfg, preset))
    got_c = adc.adc_counts(_t(v), cfg, preset)
    assert got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_c.numpy(), ref_c)
    np.testing.assert_allclose(adc.adc_dequant(got_c, cfg).numpy(),
                               np.asarray(jadc.adc_dequant(ref_c, jcfg)),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        adc.shifted_relu(_t(v), 0.1, cfg).numpy(),
        np.asarray(jadc.shifted_relu(jnp.asarray(v), 0.1, jcfg)),
        rtol=TOL, atol=TOL)
    # 0.5/Δ = 127.4999… in fp32 → 127 counts, +10 preset
    np.testing.assert_array_equal(
        adc.adc_counts(torch.tensor([-0.5, 0.0, 0.5, 2.0]), cfg, 10).numpy(),
        [0, 10, 137, 255])


# --------------------------------------------------------------- BN fold


def test_bn_affine_and_deploy_params_match_reference():
    cfg, params, state, tcfg, tp, ts = _params()
    ja, jb = jbn.bn_affine(params["bn_gamma"], params["bn_beta"],
                           state["bn_mean"], state["bn_var"])
    ta, tb = bn_fold.bn_affine(tp["bn_gamma"], tp["bn_beta"],
                               ts["bn_mean"], ts["bn_var"])
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=TOL, atol=TOL)
    ref = jbn.deploy_params(params, state, cfg)
    got = bn_fold.deploy_params(tp, ts, tcfg)
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("degree_w", [1, 3])
def test_fold_error_matches_reference(degree_w):
    cfg, params, state, tcfg, tp, ts = _params(seed=1)
    jm = jpm.fit_pixel_model(degree_w=degree_w, degree_x=3)
    tm = pixel_model.fit_pixel_model(degree_w=degree_w, degree_x=3)
    imgs = np.random.default_rng(1).random((2, 20, 20, 3)).astype(np.float32)
    jpatch = jp2m.extract_patches(jnp.asarray(imgs), 5, 5).reshape(-1, 75)
    tpatch = p2m_conv.extract_patches(_t(imgs), 5, 5).reshape(-1, 75)
    ref = jbn.fold_error(params, state, cfg, jm, jpatch)
    got = bn_fold.fold_error(tp, ts, tcfg, tm, tpatch)
    assert got == pytest.approx(ref, abs=TOL)
    if degree_w == 1:
        assert got < 1e-5  # linear-in-w ⇒ the paper's fold is exact


# ------------------------------------------------------------------ quant


@settings(max_examples=10, deadline=None, derandomize=True)
@given(st.integers(2, 8), st.integers(0, 2**31 - 1))
def test_quantize_symmetric_and_fake_quant_match_reference(bits, seed):
    x = np.random.default_rng(seed).uniform(-3, 3, (17, 5)).astype(np.float32)
    for axis in (None, 1):
        jq, js = jquant.quantize_symmetric(jnp.asarray(x), bits, axis)
        tq, ts = quant.quantize_symmetric(_t(x), bits, axis)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=TOL)
        np.testing.assert_allclose(
            quant.dequantize(tq, ts).numpy(),
            np.asarray(jquant.dequantize(jq, js)), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(
            quant.fake_quant(_t(x), bits, axis).numpy(),
            np.asarray(jquant.fake_quant(jnp.asarray(x), bits, axis)),
            rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_deploy_matches_reference(bits):
    cfg, params, state, tcfg, tp, ts = _params(seed=2)
    spec = (jquant.QuantSpec(bits, bits), quant.QuantSpec(bits, bits))
    ref = jquant.quantize_deploy(jbn.deploy_params(params, state, cfg),
                                 spec[0])
    got = quant.quantize_deploy(bn_fold.deploy_params(tp, ts, tcfg), spec[1])
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=TOL, atol=TOL)
    assert quant.adc_for_bits(bits) == adc.ADCConfig(
        n_bits=bits, v_lsb=jquant.adc_for_bits(bits).v_lsb)


# ----------------------------------------------------------------- rules


def test_port_imports_without_jax_or_reference():
    """`repro_torch` imports with `jax` and `repro` blocked, and pulls in
    neither."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None
        import repro_torch.compat
        import repro_torch.configs.p2m_vww
        import repro_torch.core.bn_fold
        import repro_torch.core.quant
        import repro_torch.data
        import repro_torch.kernels.p2m_conv
        import repro_torch.obs
        import repro_torch.serving
        bad = [m for m, v in sys.modules.items() if v is not None and (
            m.split(".")[0] in ("jax", "jaxlib", "repro"))]
        assert not bad, bad
        print("clean")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(SRC)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_port_sources_never_name_the_reference():
    for path in (SRC / "repro_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax",
                                     "import repro.", "from repro.",
                                     "from repro import")), (path, line)
