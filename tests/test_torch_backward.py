"""The port's closed-form P²M conv backward against the JAX reference.

* The plain twins of the backward kernels (`p2m_bwd_dx_plain`,
  `p2m_bwd_dw_plain`, through the CPU path of the wrappers `p2m_bwd_dx`
  and `p2m_bwd_dw`) and `epilogue_mask` against the Pallas kernels
  `p2m_bwd_dx_pallas` / `p2m_bwd_dw_pallas` in interpret mode and against
  `p2m_backward_jnp`.
* The autograd Function (`ops.P2MConvFunction` through `ops.p2m_conv`):
  gradients for images, w and shift against `jax.grad` of the
  reference's `p2m_conv(..., interpret=True, bwd_impl="pallas")`, and
  against torch autograd through `p2m_conv_plain`, at s == k and s < k
  (the col2im scatter-add), in modes raw, relu and quant (STE).
* The train form `apply_p2m_conv_train` (out, new BN state, gradients)
  for each CPU implementation against the reference's; `ste_adc` and
  `clip` (values and gradients, ties included).

Tolerance rtol 1e-4 / atol 1e-5, the JAX package's own for these
gradients (fp32 sums of a few hundred terms in another order).  Weights
stay off 0, where the closed form's ``i·|w|^(i-1)`` and autodiff through
``sign(w)·|w|^i`` differ.  The CUDA kernels are held to these twins on a
GPU in `tests/test_torch_cuda.py`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adc as jadc
from repro.core import p2m_conv as jp2m
from repro.core.adc import ADCConfig as JADCConfig
from repro.core.pixel_model import default_pixel_model as j_default_model
from repro.kernels.p2m_conv import backward as jbwd
from repro.kernels.p2m_conv.ops import _coeff_tuple as j_coeff_tuple
from repro.kernels.p2m_conv.ops import p2m_conv as j_p2m_conv
from repro.kernels.p2m_conv.ops import p2m_matmul_jnp
from repro_torch.core import adc as tadc
from repro_torch.core import p2m_conv as tp2m
from repro_torch.core.adc import ADCConfig
from repro_torch.core.pixel_model import default_pixel_model
from repro_torch.kernels.p2m_conv import backward, conv, ops
from repro_torch.kernels.p2m_conv.ops import _coeff_tuple

MODEL = default_pixel_model()
COEFFS = _coeff_tuple(MODEL)
J_MODEL = j_default_model()
J_COEFFS = j_coeff_tuple(J_MODEL)
ADC = ADCConfig()
J_ADC = JADCConfig()
RTOL, ATOL = 1e-4, 1e-5


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got.detach()) if torch.is_tensor(
        got) else np.asarray(got), np.asarray(ref), rtol=RTOL, atol=ATOL)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _bwd_data(m, k, n, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.random((m, k)).astype(np.float32)
    w = rng.uniform(-1, 1, (k, n)).astype(np.float32)
    s = rng.uniform(-0.2, 0.2, (n,)).astype(np.float32)
    g = rng.standard_normal((m, n)).astype(np.float32)
    return x, w, s, g


# ------------------------------------------------------------ plain twins


@pytest.mark.parametrize("m,k,n", [(48, 75, 8), (130, 33, 5), (8, 1, 1)])
@pytest.mark.parametrize("mode", ["raw", "relu"])
def test_plain_backward_matches_pallas_and_jnp(m, k, n, mode):
    x, w, s, g = _bwd_data(m, k, n)
    jraw = p2m_matmul_jnp(jnp.asarray(x), jnp.asarray(w), jnp.zeros(n),
                          J_MODEL, J_ADC, "raw")
    jmask = jbwd.epilogue_mask(jraw, jnp.asarray(s), mode=mode,
                               full_scale=J_ADC.full_scale)
    tmask = backward.epilogue_mask(_t(jraw), _t(s), mode=mode,
                                   full_scale=ADC.full_scale)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))

    g_eff = np.asarray(jnp.asarray(g) * jmask)
    ref_dx = jbwd.p2m_bwd_dx_pallas(jnp.asarray(g_eff), jnp.asarray(w),
                                    jnp.asarray(x), coeffs=J_COEFFS,
                                    interpret=True)
    ref_dw = jbwd.p2m_bwd_dw_pallas(jnp.asarray(g_eff), jnp.asarray(w),
                                    jnp.asarray(x), coeffs=J_COEFFS,
                                    interpret=True)
    jnp_dx, jnp_dw = jbwd.p2m_backward_jnp(jnp.asarray(g_eff), jnp.asarray(w),
                                           jnp.asarray(x), J_COEFFS)

    tg, tw, tx = _t(g_eff), _t(w), _t(x)
    before = (backward.p2m_bwd_dx.launches, backward.p2m_bwd_dw.launches)
    got_dx = backward.p2m_bwd_dx(tg, tw, tx, COEFFS)
    got_dw = backward.p2m_bwd_dw(tg, tw, tx, COEFFS)
    # a CPU tensor runs the plain twin: no kernel launch is counted
    assert (backward.p2m_bwd_dx.launches,
            backward.p2m_bwd_dw.launches) == before
    for got, ref in ((got_dx, ref_dx), (got_dx, jnp_dx),
                     (got_dw, ref_dw), (got_dw, jnp_dw)):
        _close(got, ref)
    # the premixed form of dX's weights, as the Function passes them
    wmix = conv.premix_weights(tw, COEFFS)
    _close(backward.p2m_bwd_dx(tg, wmix, tx, COEFFS), ref_dx)
    pdx, pdw = backward.p2m_backward_plain(tg, tw, tx, COEFFS)
    assert torch.equal(pdx, got_dx) and torch.equal(pdw, got_dw)


def test_plain_backward_in_float64_follows_its_inputs():
    x, w, _, g = _bwd_data(64, 27, 5, seed=3)
    d32 = backward.p2m_backward_plain(_t(g), _t(w), _t(x), COEFFS)
    d64 = backward.p2m_backward_plain(*(torch.from_numpy(a.astype(np.float64))
                                        for a in (g, w, x)), COEFFS)
    for a, b in zip(d32, d64):
        assert b.dtype == torch.float64
        torch.testing.assert_close(a.double(), b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["raw", "relu", "quant"])
def test_epilogue_mask_modes(mode):
    raw = torch.tensor([[-0.3, 0.1, 0.5, 0.99, 1.2]])
    shift = torch.tensor([0.1, 0.0, 0.0, 0.0, -0.1])
    mask = backward.epilogue_mask(raw, shift, mode=mode, full_scale=1.0)
    jmask = jbwd.epilogue_mask(jnp.asarray(raw.numpy()),
                               jnp.asarray(shift.numpy()), mode=mode,
                               full_scale=1.0)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


def test_wrappers_reject_bad_shapes():
    x, w, _, g = _bwd_data(16, 12, 4)
    with pytest.raises(ValueError, match="expected"):
        backward._check_shapes(_t(g), _t(w)[:5], _t(x))
    with pytest.raises(ValueError, match="expected"):
        backward._check_shapes(_t(g)[None], _t(w), _t(x))


def test_dw_split_covers_every_row_once():
    for m in (1, 31, 32, 1000, 100_003, 401_408, 5_000_000):
        for k, n in ((75, 8), (1, 1), (100, 3), (147, 32), (675, 8)):
            blocks, rows, tile = backward.dw_split(m, k, n)
            assert tile in (8, 16, 32, 64) and rows % tile == 0
            assert blocks * rows >= m > (blocks - 1) * rows
            # the partials' scratch, blocks·dx·K·N floats, within its
            # stated size
            assert blocks <= backward._DW_BLOCKS
            ring = backward._DW_STAGES * tile * (k + n) * 4
            assert ring <= backward._DW_RING_BYTES or tile == 8
    # the training shape: whole 64-row tiles, partials under 2 MB
    blocks, rows, tile = backward.dw_split(401_408, 75, 8)
    assert tile == 64 and blocks * 3 * 75 * 8 * 4 < 2 * 2 ** 20


# ------------------------------------------------------ autograd Function


def _conv_data(b, h, w_dim, c, k, n=8, seed=4):
    rng = np.random.default_rng(seed)
    imgs = rng.random((b, h, w_dim, c)).astype(np.float32)
    w = rng.uniform(-1, 1, (k * k * c, n)).astype(np.float32)
    s = rng.uniform(-0.2, 0.2, (n,)).astype(np.float32)
    return imgs, w, s


def _cotangent(shape, seed=5):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("b,h,w_dim,c,k,s",
                         [(2, 20, 20, 3, 5, 5), (2, 13, 11, 3, 5, 3)])
@pytest.mark.parametrize("mode", ["raw", "relu", "quant"])
def test_function_gradients_match_reference_and_autograd(b, h, w_dim, c, k,
                                                         s, mode):
    imgs, w, sh = _conv_data(b, h, w_dim, c, k)
    ho, wo = (h - k) // s + 1, (w_dim - k) // s + 1
    ct = _cotangent((b, ho, wo, 8))

    def j_loss(im, ww, ss):
        out = j_p2m_conv(im, ww, ss, J_MODEL, J_ADC, mode, k, s, True,
                         "pallas")
        return (out * ct).sum()

    ref = jax.grad(j_loss, argnums=(0, 1, 2))(
        jnp.asarray(imgs), jnp.asarray(w), jnp.asarray(sh))

    tim, tw, tsh = (_t(a).requires_grad_(True) for a in (imgs, w, sh))
    out = ops.p2m_conv(tim, tw, tsh, MODEL, ADC, mode, k, s)
    assert out.shape == (b, ho, wo, 8)
    got = torch.autograd.grad((out * _t(ct)).sum(), (tim, tw, tsh))
    for g_, r_ in zip(got, ref):
        _close(g_, r_)

    # autograd through the plain conv; quant's STE is the relu path's
    # gradient, so quant is held to relu there
    plain_mode = "relu" if mode == "quant" else mode
    pim, pw, psh = (_t(a).requires_grad_(True) for a in (imgs, w, sh))
    pout = conv.p2m_conv_plain(pim, pw, psh, kernel=k, stride=s,
                               coeffs=COEFFS, mode=plain_mode)
    if mode != "quant":
        torch.testing.assert_close(out, pout, rtol=1e-5, atol=1e-6)
    pgot = torch.autograd.grad((pout * _t(ct)).sum(), (pim, pw, psh))
    for g_, p_ in zip(got, pgot):
        _close(g_, p_.detach().numpy())


def test_function_runs_only_the_plain_twins_on_the_cpu():
    imgs, w, sh = _conv_data(1, 10, 10, 3, 5)
    counts = (conv.p2m_conv_fused.launches, backward.p2m_bwd_dx.launches,
              backward.p2m_bwd_dw.launches)
    tim, tw, tsh = (_t(a).requires_grad_(True) for a in (imgs, w, sh))
    out = ops.p2m_conv(tim, tw, tsh, MODEL, ADC, "relu", 5, 5)
    out.sum().backward()
    assert all(t.grad is not None for t in (tim, tw, tsh))
    assert (conv.p2m_conv_fused.launches, backward.p2m_bwd_dx.launches,
            backward.p2m_bwd_dw.launches) == counts


# ------------------------------------------------------------ train form


def _train_inputs(size=20, seed=1):
    jcfg = jp2m.P2MConvConfig()
    params = jp2m.init_p2m_conv(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    params = dict(params,
                  bn_gamma=rng.uniform(0.5, 1.5, 8).astype(np.float32),
                  bn_beta=rng.uniform(0.0, 0.3, 8).astype(np.float32))
    state = {"bn_mean": rng.uniform(0.0, 0.2, 8).astype(np.float32),
             "bn_var": rng.uniform(0.8, 1.2, 8).astype(np.float32)}
    imgs = rng.random((2, size, size, 3)).astype(np.float32)
    return jcfg, jax.tree.map(np.asarray, params), state, imgs


@pytest.mark.parametrize("impl", ["plain", "patches"])
@pytest.mark.parametrize("train", [True, False])
def test_train_form_matches_reference(impl, train):
    jcfg, params, state, imgs = _train_inputs()
    ct = _cotangent((2, 4, 4, 8), seed=7)

    def j_loss(p):
        out, new = jp2m.apply_p2m_conv_train(p, state, jnp.asarray(imgs),
                                             jcfg, train=train)
        return (out * ct).sum(), (out, new)

    (_, (ref_out, ref_state)), ref_g = jax.value_and_grad(
        j_loss, has_aux=True)(jax.tree.map(jnp.asarray, params))

    tp = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    ts = {k: _t(v) for k, v in state.items()}
    out, new = tp2m.apply_p2m_conv_train(tp, ts, _t(imgs), tp2m.P2MConvConfig(),
                                         train=train, impl=impl)
    _close(out, ref_out)
    for key in ("bn_mean", "bn_var"):
        _close(new[key], ref_state[key])
    got = torch.autograd.grad((out * _t(ct)).sum(), list(tp.values()))
    for key, g_ in zip(tp, got):
        _close(g_, ref_g[key])


def test_train_form_cuda_impl_needs_cuda_tensors():
    _, params, state, imgs = _train_inputs()
    tp = {k: _t(v) for k, v in params.items()}
    ts = {k: _t(v) for k, v in state.items()}
    with pytest.raises(ValueError, match="CUDA"):
        tp2m.apply_p2m_conv_train(tp, ts, _t(imgs), tp2m.P2MConvConfig(),
                                  impl="cuda")


def test_train_form_read_noise_comes_from_the_generator():
    _, params, state, imgs = _train_inputs()
    tp = {k: _t(v) for k, v in params.items()}
    ts = {k: _t(v) for k, v in state.items()}
    cfg = tp2m.P2MConvConfig()
    noisy = dataclasses.replace(default_pixel_model(), read_noise_std=0.05)

    def run(gen):
        return tp2m.apply_p2m_conv_train(tp, ts, _t(imgs), cfg, noisy,
                                         generator=gen)[0]

    quiet = run(None)
    a = run(torch.Generator().manual_seed(3))
    b = run(torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert not torch.equal(a, quiet)
    np.testing.assert_allclose(quiet.numpy(), tp2m.apply_p2m_conv_train(
        tp, ts, _t(imgs), cfg)[0].numpy(), rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ STE and clip


def test_ste_adc_matches_reference():
    rng = np.random.default_rng(8)
    v = rng.uniform(-0.5, 1.5, (64, 8)).astype(np.float32)
    shift = rng.uniform(-0.2, 0.2, 8).astype(np.float32)
    ct = _cotangent((64, 8), seed=9)
    ref, ref_g = jax.value_and_grad(lambda x: (jadc.ste_adc(
        x, jnp.asarray(shift), J_ADC) * ct).sum())(jnp.asarray(v))
    tv = _t(v).requires_grad_(True)
    out = tadc.ste_adc(tv, _t(shift), ADC)
    want = np.asarray(jadc.ste_adc(jnp.asarray(v), jnp.asarray(shift), J_ADC))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                               atol=1e-6)
    (got_g,) = torch.autograd.grad((out * _t(ct)).sum(), tv)
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(ref_g))


def test_clip_gradient_matches_jnp_clip_at_ties():
    x = np.array([-1.0, 0.0, 0.5, 6.0, 7.0], np.float32)
    ref = jax.grad(lambda a: jnp.clip(a, 0.0, 6.0).sum())(jnp.asarray(x))
    tx = _t(x).requires_grad_(True)
    y = tadc.clip(tx, 0.0, 6.0)
    np.testing.assert_array_equal(y.detach().numpy(), np.clip(x, 0.0, 6.0))
    (g,) = torch.autograd.grad(y.sum(), tx)
    np.testing.assert_array_equal(g.numpy(), np.asarray(ref))  # 0.5 at ties
