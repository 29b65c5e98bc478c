"""The port's P²M frontend (`repro_torch.core.frontend`) and
`prune_pixel_model` against the JAX reference, on the CPU.

Inputs come from a seeded numpy generator; the frontend's weights and
BN state are the reference's init with the BN affine and statistics
moved off their init values by seeded noise, carried across by
`repro_torch.compat.tree_from_reference`.  The reference runs as its
own tests run it off the TPU: its conv's ``fused`` impl (the XLA twin of
its Pallas kernel), against the port's ``plain`` (the CUDA kernels'
plain twin, what a CPU tensor takes); its ``patches`` against the
port's.  Tolerances, of the largest |reference value|:

* deploy form, relu: 1e-5 (fp32 sums in another order);
* deploy form, 8-bit quant: the feature map by the count rule of
  `tests/test_torch_p2m_conv.py` (a count may differ by one where the
  raw sum lies within 1e-3 of a half count, in at most 1e-4 of the
  elements), and the embeddings within 1e-5 on every token whose counts
  all agree;
* train form, embeddings and the new BN state: 1e-5;
* gradients of a fixed scalar of the embeddings: 1e-4 of ``jax.grad``'s;
* `prune_pixel_model`: the same coefficients, bit for bit (both fit in
  numpy).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.core import bn_fold as jbn_fold
from repro.core import frontend as jfrontend
from repro.core.p2m_conv import P2MConvConfig as JP2MConvConfig
from repro.core.p2m_conv import apply_p2m_conv_deploy as j_apply_deploy
from repro.core.pixel_model import default_pixel_model as j_default_model
from repro.core.pixel_model import prune_pixel_model as j_prune
from repro.kernels.p2m_conv import conv as jconv
from repro.models import vlm as jvlm
from repro_torch import compat
from repro_torch.configs import get_smoke_config
from repro_torch.core import frontend
from repro_torch.core.p2m_conv import P2MConvConfig, apply_p2m_conv_deploy
from repro_torch.core.pixel_model import (
    default_pixel_model,
    prune_pixel_model,
    spice_surrogate,
)
from repro_torch.kernels.p2m_conv import conv
from repro_torch.kernels.p2m_conv.ops import _coeff_tuple
from repro_torch.models import vlm

MODEL = default_pixel_model()
TOL = 1e-5
GRAD_TOL = 1e-4
IMPLS = [("plain", "fused"), ("patches", "patches")]  # (port, reference)
SHAPES = [(40, 4), (60, 2), (70, 4), (80, 2)]  # (image size, pool; 70: a crop)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These shapes are small: one intra-op thread runs them about ten
    times faster than eight, and the suite's parallel workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, what=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().double().numpy()
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    assert err <= tol * max(scale, 1e-30), \
        f"{what}: max abs err {err} of scale {scale}"


def _cfgs(size, pool, d_model=32):
    return (jfrontend.P2MFrontendConfig(image_size=size, d_model=d_model,
                                        pool=pool, conv=JP2MConvConfig()),
            frontend.P2MFrontendConfig(image_size=size, d_model=d_model,
                                       pool=pool, conv=P2MConvConfig()))


def _frontend(jcfg, seed=0):
    """(reference params, state; port params, state): the reference's init,
    the BN affine and running statistics moved off 1 and 0."""
    jparams = jax.tree.map(np.asarray, jfrontend.init_p2m_frontend(
        jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 100)
    n = jcfg.conv.out_channels
    jparams["conv"]["bn_gamma"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    jparams["conv"]["bn_beta"] = rng.uniform(-0.1, 0.3, n).astype(np.float32)
    jstate = {"conv": {
        "bn_mean": rng.uniform(-0.2, 0.2, n).astype(np.float32),
        "bn_var": rng.uniform(0.5, 2.0, n).astype(np.float32)}}
    return (jax.tree.map(jnp.asarray, jparams),
            jax.tree.map(jnp.asarray, jstate),
            compat.tree_from_reference(jparams, device="cpu"),
            compat.tree_from_reference(jstate, device="cpu"))


def _images(b, size, seed):
    return np.random.default_rng(seed).random((b, size, size, 3)).astype(
        np.float32)


# ------------------------------------------------------------------ config


def test_config_matches_reference():
    j, t = jfrontend.P2MFrontendConfig(), frontend.P2MFrontendConfig()
    assert (t.image_size, t.d_model, t.pool) == (560, 4096, 4)
    assert (t.tokens, t.token_feature_dim) == (j.tokens, j.token_feature_dim)
    assert (t.tokens, t.token_feature_dim) == (784, 128)
    for size, pool in SHAPES:
        jc, tc = _cfgs(size, pool)
        assert (tc.tokens, tc.token_feature_dim) == \
            (jc.tokens, jc.token_feature_dim)


def test_p2m_frontend_shapes():
    """The mirror of `tests/test_frontend_and_extras.py::
    test_p2m_frontend_shapes`, on the port's own init."""
    cfg = frontend.P2MFrontendConfig(image_size=80, d_model=64, pool=2,
                                     conv=P2MConvConfig())
    params = frontend.init_p2m_frontend(torch.Generator().manual_seed(0),
                                        cfg, device="cpu")
    state = frontend.init_p2m_frontend_state(cfg, device="cpu")
    imgs = torch.rand((2, 80, 80, 3), generator=torch.Generator()
                      .manual_seed(1))
    emb, new_state = frontend.apply_p2m_frontend(params, state, imgs, cfg,
                                                 train=True)
    assert emb.shape == (2, cfg.tokens, 64)
    assert cfg.tokens == (80 // 5 // 2) ** 2
    assert bool(torch.isfinite(emb).all())
    assert set(new_state["conv"]) == {"bn_mean", "bn_var"}
    assert params["proj"].shape == (cfg.token_feature_dim, 64)


def test_pool_tokens_order():
    """A token's features run (row in block, column in block, channel),
    blocks in raster order, the map cropped to whole blocks."""
    b, h, w, c, p = 2, 7, 9, 3, 2
    fmap = torch.arange(b * h * w * c, dtype=torch.float32).reshape(
        b, h, w, c)
    tokens = frontend.pool_tokens(fmap, p)
    assert tokens.shape == (b, (h // p) * (w // p), p * p * c)
    for bi in range(b):
        for ti in range(tokens.shape[1]):
            r, q = divmod(ti, w // p)
            block = fmap[bi, r * p:(r + 1) * p, q * p:(q + 1) * p, :]
            assert torch.equal(tokens[bi, ti], block.reshape(-1))


# ------------------------------------------------------------------ deploy


def _deploy(jparams, jstate, jcfg):
    jdep = jax.tree.map(np.asarray, jbn_fold.deploy_params(
        jparams["conv"], jstate["conv"], jcfg.conv))
    return jdep, compat.tree_from_reference(jdep, device="cpu")


@pytest.mark.parametrize("size,pool", SHAPES)
@pytest.mark.parametrize("impl,jimpl", IMPLS)
def test_deploy_relu_matches_reference(size, pool, impl, jimpl, monkeypatch):
    """The deploy form with the ADC's relu epilogue (no quantization) on
    both sides: the conv, the pool crop, the token order and ``proj``."""
    jcfg, cfg = _cfgs(size, pool)
    jparams, jstate, params, state = _frontend(jcfg, seed=1)
    jdep, dep = _deploy(jparams, jstate, jcfg)
    monkeypatch.setattr(jfrontend, "apply_p2m_conv_deploy",
                        functools.partial(j_apply_deploy, quantize=False))
    monkeypatch.setattr(frontend, "apply_p2m_conv_deploy",
                        functools.partial(apply_p2m_conv_deploy,
                                          quantize=False))
    imgs = _images(3, size, seed=2)
    want, _ = jfrontend.apply_p2m_frontend(
        jparams, jstate, jnp.asarray(imgs), jcfg, deploy=jdep, impl=jimpl)
    got, new_state = frontend.apply_p2m_frontend(
        params, state, torch.from_numpy(imgs), cfg, deploy=dep, impl=impl)
    _close(got, want, TOL, "embeddings")
    assert new_state is state


@pytest.mark.parametrize("size,pool", SHAPES)
def test_deploy_quant_matches_reference(size, pool):
    """The deploy form as the sensor emits it (8-bit counts): the feature
    map by the count rule, the embeddings on every token whose counts all
    agree."""
    jcfg, cfg = _cfgs(size, pool)
    jparams, jstate, params, state = _frontend(jcfg, seed=3)
    jdep, dep = _deploy(jparams, jstate, jcfg)
    dep = {**dep, "wrows": conv.premix_rows(dep["w"], _coeff_tuple(MODEL),
                                            cfg.conv.kernel)}
    imgs = _images(4, size, seed=4)
    want, _ = jfrontend.apply_p2m_frontend(jparams, jstate, jnp.asarray(imgs),
                                           jcfg, deploy=jdep)
    got, _ = frontend.apply_p2m_frontend(params, state, torch.from_numpy(imgs),
                                         cfg, deploy=dep)
    assert got.shape == (4, cfg.tokens, cfg.d_model)
    # the feature maps the two frontends pooled
    j_fmap = np.array(j_apply_deploy(jdep, jnp.asarray(imgs), jcfg.conv,
                                       j_default_model()))
    fmap = apply_p2m_conv_deploy(dep, torch.from_numpy(imgs), cfg.conv)
    k = cfg.conv.kernel
    j_raw = np.array(jconv.p2m_conv_raw_jnp(
        jnp.asarray(imgs), jnp.asarray(jdep["w"]), kernel=k,
        stride=cfg.conv.stride, coeffs=_coeff_tuple(MODEL))).reshape(
            j_fmap.shape)
    v_lsb = cfg.conv.adc.v_lsb
    rep = conv.quant_disagreement(fmap, torch.from_numpy(j_fmap),
                                  torch.from_numpy(j_raw), v_lsb)
    assert rep["max_count_diff"] <= 1, rep
    assert rep["n_diff"] <= 1e-4 * fmap.numel(), rep
    assert rep["all_near_half"], rep
    assert 0 < int((fmap > 0).sum()) < fmap.numel()  # the ADC clips some
    agree = (torch.round(fmap / v_lsb) == torch.round(
        torch.from_numpy(j_fmap) / v_lsb)).float()
    tok_ok = frontend.pool_tokens(agree, pool).min(dim=-1).values.bool()
    assert int(tok_ok.sum()) >= tok_ok.numel() - rep["n_diff"]
    _close(got[tok_ok], np.asarray(want)[tok_ok.numpy()], TOL, "embeddings")


def test_impl_names_are_the_ports():
    jcfg, cfg = _cfgs(40, 4)
    _, _, params, state = _frontend(jcfg)
    imgs = torch.from_numpy(_images(1, 40, seed=0))
    for impl in ("pallas", "fused"):
        with pytest.raises(ValueError, match="unknown"):
            frontend.apply_p2m_frontend(params, state, imgs, cfg, impl=impl)
    with pytest.raises(ValueError, match="CUDA"):
        frontend.apply_p2m_frontend(params, state, imgs, cfg, impl="cuda")


# ------------------------------------------------------------------ train form


@pytest.mark.parametrize("size,pool", SHAPES)
@pytest.mark.parametrize("train", [True, False])
def test_train_form_matches_reference(size, pool, train):
    """Batch statistics and their running update with ``train``, the
    running statistics without."""
    jcfg, cfg = _cfgs(size, pool)
    jparams, jstate, params, state = _frontend(jcfg, seed=5)
    imgs = _images(3, size, seed=6)
    want, jnew = jfrontend.apply_p2m_frontend(
        jparams, jstate, jnp.asarray(imgs), jcfg, train=train)
    got, new = frontend.apply_p2m_frontend(
        params, state, torch.from_numpy(imgs), cfg, train=train)
    _close(got, want, TOL, "embeddings")
    for key in ("bn_mean", "bn_var"):
        _close(new["conv"][key], jnew["conv"][key], TOL, key)


@pytest.mark.parametrize("impl,jimpl", IMPLS)
@pytest.mark.parametrize("size,pool", [(40, 4), (60, 2)])
def test_gradients_match_jax_grad(impl, jimpl, size, pool):
    """d/d(θ, γ, β, proj) and d/d images of a fixed scalar of the
    train-form embeddings (BN on batch statistics)."""
    jcfg, cfg = _cfgs(size, pool)
    jparams, jstate, params, state = _frontend(jcfg, seed=7)
    imgs = _images(2, size, seed=8)
    probe = np.random.default_rng(9).standard_normal(
        (2, cfg.tokens, cfg.d_model)).astype(np.float32)

    def jloss(p, x):
        emb, _ = jfrontend.apply_p2m_frontend(p, jstate, x, jcfg, train=True,
                                              impl=jimpl)
        return jnp.sum(emb * probe)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jparams, jnp.asarray(imgs))
    live = {"conv": {k: v.clone().requires_grad_()
                     for k, v in params["conv"].items()},
            "proj": params["proj"].clone().requires_grad_()}
    x = torch.from_numpy(imgs).requires_grad_()
    emb, _ = frontend.apply_p2m_frontend(live, state, x, cfg, train=True,
                                         impl=impl)
    (emb * torch.from_numpy(probe)).sum().backward()
    for key in ("theta", "bn_gamma", "bn_beta"):
        _close(live["conv"][key].grad, jg["conv"][key], GRAD_TOL, key)
    _close(live["proj"].grad, jg["proj"], GRAD_TOL, "proj")
    _close(x.grad, jgx, GRAD_TOL, "images")


# ------------------------------------------------------------------ the VLM


def test_p2m_frontend_feeds_vlm():
    """The mirror of `tests/test_frontend_and_extras.py::
    test_p2m_frontend_feeds_vlm`, held to the reference: P²M tokens as the
    VLM's image embeddings (SMOKE, float32, nonzero gates), the logits of
    the whole chain within 1e-4."""
    jmcfg = j_get_smoke_config("llama-3.2-vision-11b").replace(
        dtype=jnp.float32)
    mcfg = get_smoke_config("llama-3.2-vision-11b").replace(
        dtype=torch.float32)
    jcfg, cfg = _cfgs(40, 4, d_model=mcfg.d_model)
    assert cfg.tokens == 4  # 40/5/4 = 2 → 2² (forward takes any count)
    jparams, jstate, params, state = _frontend(jcfg, seed=10)
    imgs = _images(2, 40, seed=11)
    jemb, _ = jfrontend.apply_p2m_frontend(jparams, jstate, jnp.asarray(imgs),
                                           jcfg)
    emb, _ = frontend.apply_p2m_frontend(params, state, torch.from_numpy(imgs),
                                         cfg)
    _close(emb, jemb, TOL, "embeddings")

    jm = jax.tree.map(np.asarray, jvlm.init_vlm(jax.random.PRNGKey(2),
                                                jmcfg)[0])
    rng = np.random.default_rng(12)
    for gate in ("gate_attn", "gate_mlp"):
        jm["cross"][gate] = rng.uniform(0.5, 1.0, jm["cross"][gate].shape
                                        ).astype(np.float32)
    m = compat.tree_from_reference(jm, device="cpu")
    toks = rng.integers(0, mcfg.vocab, (2, 8)).astype(np.int32)
    want, _ = jvlm.forward(jax.tree.map(jnp.asarray, jm), jnp.asarray(toks),
                           jemb, jmcfg)
    got, _ = vlm.forward(m, torch.from_numpy(toks), emb, mcfg)
    assert bool(torch.isfinite(got).all())
    _close(got, want, 1e-4, "logits")


# ------------------------------------------------------------------ pruning


@pytest.mark.parametrize("threshold", [0.02, 0.06, 0.2])
def test_prune_pixel_model_matches_reference(threshold):
    got = prune_pixel_model(default_pixel_model(), threshold)
    want = j_prune(j_default_model(), threshold)
    np.testing.assert_array_equal(got.coeffs, want.coeffs)
    assert got.fit_rmse == want.fit_rmse
    assert (got.coeffs != 0).sum() == (np.abs(
        default_pixel_model().coeffs) >= threshold).sum()


def test_pruned_model_error_within_one_lsb():
    """The mirror of `tests/test_frontend_and_extras.py::
    test_pruned_model_error_within_one_lsb`."""
    mp = prune_pixel_model(default_pixel_model(), 0.06)
    n_terms = int((np.abs(mp.coeffs) > 0).sum())
    assert n_terms <= 5
    w = np.random.default_rng(0).random(2000)
    x = np.random.default_rng(1).random(2000)
    got = mp(torch.from_numpy(w), torch.from_numpy(x)).numpy()
    err = np.abs(got - spice_surrogate(w, x)).max()
    assert err < 1.5 / 255
