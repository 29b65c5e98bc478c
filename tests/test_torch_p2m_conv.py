"""The port's P²M conv (`repro_torch.kernels.p2m_conv`) against the JAX
reference: the plain conv against `p2m_conv_jnp` over s == k, s < k,
s > k and ragged geometries in all three modes with ``want_raw``, the
wrapper's CPU path against the Pallas kernel in interpret mode, and the
building blocks (premix, im2col, patches, the patch-level product).

Tolerances: raw and relu rtol 1e-5 / atol 1e-6 (fp32, sums in another
order).  Weights are drawn at the model's own scale, U(−1, 1)·√(3/fan_in)
as `init_p2m_conv` draws them: there the fp32 sums reassociate within
atol 1e-6, where unit-scale weights cancel from magnitudes near 10.  Quant may differ by one count in at most 1e-4 of the elements,
and only where the reference's raw / v_lsb lies within 1e-3 of a half
count, where a rounding boundary sits.  The CUDA kernel itself is held
to its plain twin in `tests/test_torch_cuda.py`, on a GPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.core.adc import ADCConfig as JADCConfig
from repro.core.p2m_conv import extract_patches as j_extract_patches
from repro.core.pixel_model import default_pixel_model as j_default_model
from repro.kernels.p2m_conv import conv as jconv
from repro.kernels.p2m_conv.ops import _coeff_tuple as j_coeff_tuple
from repro.kernels.p2m_conv.ops import p2m_matmul_jnp
from repro_torch.core.adc import ADCConfig
from repro_torch.core.p2m_conv import (
    P2MConvConfig,
    apply_p2m_conv_deploy,
    extract_patches,
)
from repro_torch.core.pixel_model import default_pixel_model
from repro_torch.kernels.p2m_conv import conv, ops
from repro_torch.kernels.p2m_conv.ops import _coeff_tuple

MODEL = default_pixel_model()
COEFFS = _coeff_tuple(MODEL)
ADC = ADCConfig()
RTOL, ATOL = 1e-5, 1e-6

# (B, H, W, C, k, s, N): paper fast path, remainder crop, overlapping
# stride, odd dims, stride > kernel, ragged N and rows.
GEOMETRIES = [
    (2, 20, 20, 3, 5, 5, 8),
    (1, 23, 19, 3, 5, 5, 8),
    (2, 14, 11, 2, 3, 2, 8),
    (2, 13, 13, 3, 5, 3, 5),
    (2, 10, 10, 3, 3, 6, 8),
    (1, 17, 12, 3, 4, 3, 16),
    (3, 9, 9, 1, 4, 4, 11),
]


def _data(b, h, w, c, k, n, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.random((b, h, w, c)).astype(np.float32)
    scale = (3.0 / (k * k * c)) ** 0.5
    wt = (rng.uniform(-1, 1, (k * k * c, n)) * scale).astype(np.float32)
    sh = rng.uniform(-0.2, 0.2, (n,)).astype(np.float32)
    return imgs, wt, sh


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_quant_close(out, ref_out, ref_raw, v_lsb=ADC.v_lsb):
    rep = conv.quant_disagreement(_t(out), _t(ref_out), _t(ref_raw), v_lsb)
    assert rep["max_count_diff"] <= 1, rep
    assert rep["n_diff"] <= 1e-4 * np.size(out), rep
    assert rep["all_near_half"], rep


@pytest.mark.parametrize("b,h,w,c,k,s,n", GEOMETRIES)
@pytest.mark.parametrize("mode", ["raw", "relu", "quant"])
def test_plain_conv_matches_reference(b, h, w, c, k, s, n, mode):
    imgs, wt, sh = _data(b, h, w, c, k, n)
    ref = np.asarray(jconv.p2m_conv_jnp(
        jnp.asarray(imgs), jnp.asarray(wt), jnp.asarray(sh), kernel=k,
        stride=s, coeffs=COEFFS, mode=mode))
    out = conv.p2m_conv_plain(_t(imgs), _t(wt), _t(sh), kernel=k, stride=s,
                              coeffs=COEFFS, mode=mode).numpy()
    assert out.shape == ref.shape
    if mode == "quant":
        ref_raw = np.asarray(jconv.p2m_conv_raw_jnp(
            jnp.asarray(imgs), jnp.asarray(wt), kernel=k, stride=s,
            coeffs=COEFFS)).reshape(ref.shape)
        _assert_quant_close(out, ref, ref_raw)
    else:
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,h,w,c,k,s,n", GEOMETRIES)
def test_want_raw_returns_reference_accumulation(b, h, w, c, k, s, n):
    imgs, wt, sh = _data(b, h, w, c, k, n, seed=1)
    ref_raw = np.asarray(jconv.p2m_conv_raw_jnp(
        jnp.asarray(imgs), jnp.asarray(wt), kernel=k, stride=s,
        coeffs=COEFFS))
    wrows = conv.premix_rows(_t(wt), COEFFS, k)
    out, raw = conv.p2m_conv_fused(_t(imgs), wrows, _t(sh), kernel=k,
                                   stride=s, mode="relu", want_raw=True)
    np.testing.assert_allclose(raw.numpy().reshape(ref_raw.shape), ref_raw,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        conv.p2m_conv_raw_plain(_t(imgs), _t(wt), kernel=k, stride=s,
                                coeffs=COEFFS).numpy(),
        ref_raw, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        out.numpy(),
        np.clip(raw.numpy() + sh, 0.0, ADC.full_scale), rtol=0, atol=0)


@pytest.mark.parametrize("k,s", [(5, 5), (3, 2)])
@pytest.mark.parametrize("mode", ["raw", "relu", "quant"])
def test_wrapper_cpu_path_matches_pallas_interpret(k, s, mode):
    """The wrapper's CPU path against the TPU kernel it replaces, run in
    interpret mode on one tiny shape, ``want_raw`` included."""
    imgs, wt, sh = _data(1, 10, 10, 3, k, 8, seed=2)
    ref_out, ref_raw = jconv.p2m_conv_pallas(
        jnp.asarray(imgs), jnp.asarray(wt), jnp.asarray(sh), kernel=k,
        stride=s, coeffs=COEFFS, mode=mode, want_raw=True, interpret=True)
    ref_out, ref_raw = np.asarray(ref_out), np.asarray(ref_raw)
    out, raw = conv.p2m_conv_fused(
        _t(imgs), conv.premix_rows(_t(wt), COEFFS, k), _t(sh), kernel=k,
        stride=s, mode=mode, want_raw=True)
    np.testing.assert_allclose(raw.numpy(), ref_raw, rtol=RTOL, atol=ATOL)
    if mode == "quant":
        _assert_quant_close(out.numpy(), ref_out, ref_raw)
    else:
        np.testing.assert_allclose(out.numpy(), ref_out, rtol=RTOL, atol=ATOL)


@settings(max_examples=5, deadline=None, derandomize=True)
@given(st.integers(1, 3), st.integers(0, 9), st.integers(2, 5),
       st.integers(1, 4), st.integers(1, 20))
def test_plain_conv_property_random_geometry(c, extra, k, s, n):
    """Random geometries, ragged everything: plain conv == reference."""
    h = k + extra
    imgs, wt, sh = _data(2, h, h + 1, c, k, n, seed=extra + 10 * k)
    ref = np.asarray(jconv.p2m_conv_jnp(
        jnp.asarray(imgs), jnp.asarray(wt), jnp.asarray(sh), kernel=k,
        stride=s, coeffs=COEFFS, mode="raw"))
    out = conv.p2m_conv_plain(_t(imgs), _t(wt), _t(sh), kernel=k, stride=s,
                              coeffs=COEFFS, mode="raw").numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_ops_conv_on_cpu_is_the_plain_conv():
    imgs, wt, sh = _data(2, 20, 20, 3, 5, 8, seed=3)
    before = conv.p2m_conv_fused.launches
    out = ops.p2m_conv(_t(imgs), _t(wt), _t(sh), MODEL, ADC, "quant", 5, 5)
    ref = conv.p2m_conv_plain(_t(imgs), _t(wt), _t(sh), kernel=5, stride=5,
                              coeffs=COEFFS, mode="quant")
    assert torch.equal(out, ref)
    assert conv.p2m_conv_fused.launches == before  # no kernel on the CPU


def test_premix_matches_reference():
    _, wt, _ = _data(1, 5, 5, 3, 5, 8, seed=4)
    ref = np.asarray(jconv.premix_weights(jnp.asarray(wt), COEFFS))
    np.testing.assert_allclose(conv.premix_weights(_t(wt), COEFFS).numpy(),
                               ref, rtol=1e-6, atol=1e-7)
    # the per-kernel-row layout the reference builds inline (conv.py:373)
    dx, k, kc = 3, 5, 15
    ref_rows = ref.reshape(dx, k, kc, 8).transpose(1, 0, 2, 3).reshape(
        k, dx * kc, 8)
    np.testing.assert_allclose(conv.premix_rows(_t(wt), COEFFS, 5).numpy(),
                               ref_rows, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("h,w,k,s", [(20, 20, 5, 5), (23, 19, 5, 5),
                                     (13, 13, 5, 3), (10, 10, 3, 6)])
def test_im2col_and_extract_patches_match_reference(h, w, k, s):
    imgs, _, _ = _data(2, h, w, 3, k, 1, seed=5)
    ref = np.asarray(jconv.im2col_matrix(jnp.asarray(imgs), k, s))
    np.testing.assert_array_equal(
        conv.im2col_matrix(_t(imgs), k, s).numpy(), ref)
    ref_p = np.asarray(j_extract_patches(jnp.asarray(imgs), k, s))
    got_p = extract_patches(_t(imgs), k, s).numpy()
    np.testing.assert_array_equal(got_p, ref_p)
    np.testing.assert_array_equal(got_p.reshape(ref.shape), ref)


@pytest.mark.parametrize("mode", ["raw", "relu", "quant"])
def test_matmul_plain_matches_reference(mode):
    rng = np.random.default_rng(6)
    x = rng.random((64, 75)).astype(np.float32)
    wt = (rng.uniform(-1, 1, (75, 8)) * 0.2).astype(np.float32)
    sh = rng.uniform(-0.2, 0.2, (8,)).astype(np.float32)
    jm = j_default_model()
    ref = np.asarray(p2m_matmul_jnp(jnp.asarray(x), jnp.asarray(wt),
                                    jnp.asarray(sh), jm, JADCConfig(), mode))
    out = ops.p2m_matmul_plain(_t(x), _t(wt), _t(sh), MODEL, ADC, mode)
    if mode == "quant":
        ref_raw = np.asarray(p2m_matmul_jnp(
            jnp.asarray(x), jnp.asarray(wt), jnp.zeros(8), jm, JADCConfig(),
            "raw"))
        _assert_quant_close(out.numpy(), ref, ref_raw)
    else:
        np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)
    assert j_coeff_tuple(jm) == COEFFS


@pytest.mark.parametrize("impl", ["plain", "patches"])
def test_deploy_impls_agree_on_cpu(impl):
    cfg = P2MConvConfig()
    imgs, wt, sh = _data(2, 20, 20, 3, 5, 8, seed=7)
    dep = {"w": _t(wt), "shift": _t(sh)}
    ref = apply_p2m_conv_deploy(dep, _t(imgs), cfg, quantize=False,
                                impl=None)
    out = apply_p2m_conv_deploy(dep, _t(imgs), cfg, quantize=False,
                                impl=impl)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_impl_cuda_on_cpu_tensor_raises():
    cfg = P2MConvConfig()
    imgs, wt, sh = _data(1, 10, 10, 3, 5, 8)
    dep = {"w": _t(wt), "shift": _t(sh)}
    with pytest.raises(ValueError, match="CUDA"):
        apply_p2m_conv_deploy(dep, _t(imgs), cfg, impl="cuda")
    with pytest.raises(ValueError, match="unknown"):
        apply_p2m_conv_deploy(dep, _t(imgs), cfg, impl="pallas")


def test_quant_disagreement_reports_boundary_flips():
    v = ADC.v_lsb
    ref_raw = torch.tensor([0.5 * v, 3.2 * v, 10.5 * v + 1e-9])
    ref_out = torch.round(ref_raw / v) * v
    out = ref_out.clone()
    rep = conv.quant_disagreement(out, ref_out, ref_raw, v)
    assert rep["n_diff"] == 0 and rep["all_near_half"]
    out[2] += v  # a flip at a half count: allowed
    rep = conv.quant_disagreement(out, ref_out, ref_raw, v)
    assert rep["n_diff"] == 1 and rep["max_count_diff"] == 1
    assert rep["all_near_half"]
    out[1] += v  # a flip far from any half count: not allowed
    assert not conv.quant_disagreement(out, ref_out, ref_raw, v)[
        "all_near_half"]
