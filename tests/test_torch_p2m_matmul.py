"""The port's patch-level P²M product (`repro_torch.kernels.p2m_conv`:
`ops.p2m_matmul`, the wrapper `kernel.p2m_matmul_fused`, the oracle
`ref.p2m_matmul_ref`) against the JAX package on the CPU.

Mirrors `tests/test_p2m_kernel.py`: the reference's `p2m_matmul` runs its
Pallas kernel in interpret mode (forward) and its closed-form backward
(XLA off the TPU), as its own tests run it.  On the CPU the port's
wrapper runs its plain twin; the CUDA kernel B6 is held to that twin in
`tests/test_torch_cuda.py`, on a GPU.  Tolerances as the reference's own:
outputs rtol/atol 1e-4 (fp32; bfloat16 inputs 5e-2), gradients rtol 1e-4,
atol 1e-5.  The port casts bfloat16 x to float32 in `P2MMatmulFunction`
(it does not raise), and returns the gradient in bfloat16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.adc import ADCConfig as JADCConfig
from repro.core.pixel_model import default_pixel_model as j_default_model
from repro.kernels.p2m_conv import p2m_matmul as j_p2m_matmul
from repro.kernels.p2m_conv import p2m_matmul_jnp
from repro.kernels.p2m_conv import p2m_matmul_ref as j_p2m_matmul_ref
from repro_torch.core.adc import ADCConfig
from repro_torch.core.pixel_model import default_pixel_model, fit_pixel_model
from repro_torch.kernels.p2m_conv import (
    kernel,
    p2m_matmul,
    p2m_matmul_plain,
    p2m_matmul_ref,
)

MODEL = default_pixel_model()
ADC = ADCConfig()
J_MODEL = j_default_model()
J_ADC = JADCConfig()

# The reference's shapes: the paper geometry (75), off the tile quanta in
# every dim, a single row or column, more than one K tile.
SHAPES = [(100, 75, 8), (1, 75, 8), (256, 128, 128), (130, 33, 5),
          (64, 300, 16), (8, 1, 1), (1024, 75, 8)]


def _data(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((m, k)).astype(np.float32)
    w = rng.uniform(-1, 1, (k, n)).astype(np.float32)
    s = rng.uniform(-0.2, 0.2, (n,)).astype(np.float32)
    return x, w, s


def _t(*arrays, grad=False):
    return [torch.from_numpy(np.array(a)).requires_grad_(grad)
            for a in arrays]


def test_pixel_models_agree():
    np.testing.assert_array_equal(MODEL.coeffs, np.asarray(J_MODEL.coeffs))


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("mode", ["raw", "relu", "quant"])
def test_matmul_matches_reference(m, k, n, mode):
    x, w, s = _data(m, k, n)
    got = p2m_matmul(*_t(x, w, s), MODEL, ADC, mode).numpy()
    ref = np.asarray(j_p2m_matmul(x, w, s, J_MODEL, J_ADC, mode))
    oracle = np.asarray(
        j_p2m_matmul_ref(x, w, J_MODEL, s, None) if mode == "raw" else
        j_p2m_matmul_ref(x, w, J_MODEL, s, J_ADC, quantize=mode == "quant"))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
def test_matmul_dtypes(dtype, tol):
    x, w, s = _data(128, 75, 8)
    xt = torch.from_numpy(x).to(dtype)
    wt = torch.from_numpy(w).to(dtype)
    out = p2m_matmul(xt, wt, torch.from_numpy(s), MODEL, ADC, "relu")
    assert out.dtype == torch.float32
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = j_p2m_matmul(jnp.asarray(x, jdt), jnp.asarray(w, jdt), s, J_MODEL,
                       J_ADC, "relu")
    oracle = j_p2m_matmul_ref(x, w, J_MODEL, s, J_ADC)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle), rtol=tol,
                               atol=tol)
    xg = xt.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(
        p2m_matmul(xg, wt, torch.from_numpy(s), MODEL, ADC, "relu").sum(),
        [xg])
    assert g.dtype == dtype


def test_quant_mode_integer_exact():
    x, w, s = _data(64, 75, 8, seed=5)
    out = p2m_matmul(*_t(x, w, s), MODEL, ADC, "quant").numpy()
    counts = out / ADC.v_lsb
    assert np.allclose(counts, np.round(counts), atol=1e-4)
    assert counts.min() >= 0 and counts.max() <= ADC.max_count


@pytest.mark.parametrize("mode", ["raw", "relu"])
def test_gradients_match_reference_jnp_path(mode):
    x, w, s = _data(48, 75, 8, seed=2)
    ins = _t(x, w, s, grad=True)
    got = torch.autograd.grad(
        (p2m_matmul(*ins, MODEL, ADC, mode) ** 2).sum(), ins)

    def loss(x, w, s):
        return (p2m_matmul_jnp(x, w, s, J_MODEL, J_ADC, mode) ** 2).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(x, w, s)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


def test_quant_mode_ste_gradient():
    """The quant forward is stepped; its gradient is the relu path's."""
    x, w, s = _data(32, 27, 4, seed=7)
    (xq,) = _t(x, grad=True)
    wt, st = _t(w, s)
    (gq,) = torch.autograd.grad(
        p2m_matmul(xq, wt, st, MODEL, ADC, "quant").sum(), [xq])
    gr = jax.grad(lambda xx: p2m_matmul_jnp(xx, w, s, J_MODEL, J_ADC,
                                            "relu").sum())(x)
    np.testing.assert_allclose(gq.numpy(), np.asarray(gr), rtol=1e-4,
                               atol=1e-5)


def test_cds_sign_split_equivalence():
    """CDS double sampling: out == Σ g(w⁺,x) − Σ g(w⁻,x), w = w⁺ − w⁻."""
    x, w, s = _data(40, 75, 6, seed=3)
    xt, wt = _t(x, w)
    zero = torch.zeros(6)
    pos = p2m_matmul(xt, torch.clamp(wt, min=0.0), zero, MODEL, ADC, "raw")
    neg = p2m_matmul(xt, torch.clamp(-wt, min=0.0), zero, MODEL, ADC, "raw")
    full = p2m_matmul(xt, wt, zero, MODEL, ADC, "raw")
    torch.testing.assert_close(pos - neg, full, rtol=1e-4, atol=1e-5)


def test_zero_padding_exact():
    """Zero rows of K add exactly nothing (every basis term has i, j ≥ 1)."""
    x, w, s = _data(32, 50, 8, seed=4)
    xt, wt, st = _t(x, w, s)
    a = p2m_matmul(xt, wt, st, MODEL, ADC, "raw")
    b = p2m_matmul(torch.nn.functional.pad(xt, (0, 30)),
                   torch.nn.functional.pad(wt, (0, 0, 0, 30)), st, MODEL,
                   ADC, "raw")
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def _property_draws(n, seed=11):
    rng = np.random.default_rng(seed)
    draws = [(1, 1, 1), (64, 96, 12)]  # the strategies' corners
    draws += [(int(rng.integers(1, 65)), int(rng.integers(1, 97)),
               int(rng.integers(1, 13)), int(rng.integers(0, 2**31 - 1)))
              for _ in range(n)]
    return [d if len(d) == 4 else (*d, 0) for d in draws]


@pytest.mark.parametrize("m,k,n,seed", _property_draws(10))
def test_matmul_matches_reference_property(m, k, n, seed):
    x, w, s = _data(m, k, n, seed=seed)
    out = p2m_matmul(*_t(x, w, s), MODEL, ADC, "relu").numpy()
    ref = j_p2m_matmul_ref(x, w, J_MODEL, s, J_ADC)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_degree1_model_reduces_to_matmul():
    """With g(w, x) = w·x the product is a plain (signed) matmul."""
    lin = fit_pixel_model(degree_w=1, degree_x=1,
                          samples_w=np.array([0.5, 1.0, 0.25]),
                          samples_x=np.array([1.0, 0.5, 0.25]),
                          samples_v=np.array([0.5, 0.5, 0.0625]))
    x, w, s = _data(16, 12, 3, seed=9)
    xt, wt, st = _t(x, w, s)
    for fn in (p2m_matmul, p2m_matmul_plain):
        torch.testing.assert_close(fn(xt, wt, st, lin, ADC, "raw"),
                                   xt @ wt + st, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("m,k,n", [(100, 75, 8), (130, 33, 5), (3, 7, 2)])
@pytest.mark.parametrize("adc,quantize,shift", [
    (None, False, False), (None, False, True), ("adc", False, True),
    ("adc", True, True), ("adc", True, False)])
def test_ref_oracle_matches_reference_oracle(m, k, n, adc, quantize, shift):
    x, w, s = _data(m, k, n, seed=m + k + n)
    sh = s if shift else None
    got = p2m_matmul_ref(torch.from_numpy(x), torch.from_numpy(w), MODEL,
                         None if sh is None else torch.from_numpy(sh),
                         ADC if adc else None, quantize=quantize, chunk=64)
    want = j_p2m_matmul_ref(x, w, J_MODEL, sh, J_ADC if adc else None,
                            quantize=quantize, chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_cpu_tensors_launch_no_kernel():
    x, w, s = _data(64, 75, 8, seed=1)
    before = kernel.p2m_matmul_fused.launches
    ins = _t(x, w, s, grad=True)
    out = p2m_matmul(*ins, MODEL, ADC, "relu")
    torch.autograd.grad(out.sum(), ins)
    assert kernel.p2m_matmul_fused.launches == before
    plain = p2m_matmul_plain(*_t(x, w, s), MODEL, ADC, "relu")
    assert torch.equal(out.detach(), plain)
    got, raw = kernel.p2m_matmul_fused(*_t(x, w, s), coeffs=tuple(
        tuple(float(v) for v in row) for row in MODEL.coeffs),
        mode="quant", want_raw=True)
    assert torch.equal(raw, kernel.p2m_matmul_raw_plain(
        *_t(x, w), MODEL.coeffs))
