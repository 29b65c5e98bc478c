"""The port's dense decoder-only family (`repro_torch.models.attention`,
`.layers`, `.transformer`, the dense configs) against the JAX reference,
on the CPU.

Inputs come from a seeded numpy generator; model weights are the
reference's (`SMOKE`, float32 unless stated), carried across by
`repro_torch.compat.tree_from_reference`, with every zero-initialized
leaf (norm scales and biases, QKV biases, qk-norms) moved off zero by
seeded bfloat16-representable noise so that each is exercised.
Tolerances, of the largest |reference value|:

* attention (flash, dense, the sliding window, GQA, RoPE): 1e-5 against
  the reference's functions (the same arithmetic, sums in another
  order); gradients by torch autograd within 1e-4 of ``jax.grad``;
  flash against dense at the reference's own 2e-4 (`tests/test_attention.py`);
* decode against forward at the reference's rtol 2e-4, atol 5e-4
  (`tests/test_decode_equivalence.py`);
* logits and the loss: 1e-4 for all four configs;
* one llama3.2-1b forward in bfloat16 on both sides: 3e-2, which only a
  cast that differs from the reference's breaks (measured: 9.3e-3, about
  2.5 bfloat16 ulps of the largest |logit|, 16.9).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models.families import get_family as j_get_family
from repro_torch import compat
from repro_torch.configs import PORTED, get_config, get_smoke_config
from repro_torch.models import attention, layers, transformer
from repro_torch.models.families import (
    FAMILIES,
    get_family,
    validate_slot_layout,
)

ATTN_TOL = 1e-5
GRAD_TOL = 1e-4
MODEL_TOL = 1e-4
BF16_TOL = 3e-2
DECODE_RTOL, DECODE_ATOL = 2e-4, 5e-4
DENSE = ("llama3.2-1b", "stablelm-1.6b", "qwen3-32b", "qwen2-72b")


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
    err = np.abs(got - want).max() if got.size else 0.0
    scale = np.abs(want).max() if want.size else 0.0
    assert err <= tol * max(scale, 1e-30), \
        f"{what}: max abs err {err} of scale {scale}"


# ------------------------------------------------------------------ attention


def _qkv(b, s, h, d, seed=0, t=None):
    rng = np.random.default_rng(seed)
    t = t or s
    q, k, v = (rng.normal(0, 1, shape).astype(np.float32)
               for shape in ((b, s, h, d), (b, t, h, d), (b, t, h, d)))
    qp = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    kp = np.broadcast_to(np.arange(t)[None], (b, t)).astype(np.int32)
    return (q, k, v, qp, kp)


def _both(arrays):
    """(jax arrays, torch tensors) of the same numpy inputs."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


@pytest.mark.parametrize("s,qc,kc", [(64, 16, 16), (60, 16, 32),
                                     (128, 128, 128), (37, 8, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_dense(s, qc, kc, causal):
    (jq, jk, jv, jqp, jkp), (q, k, v, qp, kp) = _both(_qkv(2, s, 4, 16))
    dense = attention.dense_attention(q, k, v, qp, kp, causal=causal)
    flash = attention.flash_attention(q, k, v, qp, kp, causal=causal,
                                      q_chunk=qc, kv_chunk=kc)
    _close(dense, jattn.dense_attention(jq, jk, jv, jqp, jkp, causal=causal),
           ATTN_TOL, "dense")
    _close(flash, jattn.flash_attention(jq, jk, jv, jqp, jkp, causal=causal,
                                        q_chunk=qc, kv_chunk=kc),
           ATTN_TOL, "flash")
    np.testing.assert_allclose(flash.numpy(), dense.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("window", [4, 16, 100])
def test_flash_sliding_window(window):
    (jq, jk, jv, jqp, jkp), (q, k, v, qp, kp) = _both(_qkv(1, 48, 2, 8,
                                                           seed=1))
    dense = attention.dense_attention(q, k, v, qp, kp, causal=True,
                                      window=window)
    flash = attention.flash_attention(q, k, v, qp, kp, causal=True,
                                      window=window, q_chunk=16, kv_chunk=16)
    _close(flash, jattn.flash_attention(jq, jk, jv, jqp, jkp, causal=True,
                                        window=window, q_chunk=16,
                                        kv_chunk=16), ATTN_TOL, "flash")
    _close(dense, jattn.dense_attention(jq, jk, jv, jqp, jkp, causal=True,
                                        window=window), ATTN_TOL, "dense")
    np.testing.assert_allclose(flash.numpy(), dense.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_kv_len_and_padded_slots_are_masked():
    """``kv_len`` and keys at `PAD_KV_POS` mask as the reference's: the
    NEG_INF is added to the scores, not filled in."""
    q, k, v, qp, kp = _qkv(2, 12, 2, 8, seed=4, t=20)
    kp = kp.copy()
    kp[:, 15:] = attention.PAD_KV_POS
    kv_len = np.asarray([9, 20], np.int32)
    (jq, jk, jv, jqp, jkp, jkl), (tq, tk, tv, tqp, tkp, tkl) = _both(
        (q, k, v, qp + 8, kp, kv_len))
    for impl in ("dense", "flash"):
        got = attention.attend(tq, tk, tv, tqp, tkp, kv_len=tkl, impl=impl,
                               q_chunk=4, kv_chunk=8)
        want = jattn.attend(jq, jk, jv, jqp, jkp, kv_len=jkl, impl=impl,
                            q_chunk=4, kv_chunk=8)
        _close(got, want, ATTN_TOL, impl)
    assert attention.NEG_INF == jattn.NEG_INF
    assert attention.PAD_KV_POS == jattn.PAD_KV_POS


def test_flash_gradients_match_dense():
    arrays = _qkv(1, 32, 2, 8, seed=2)
    (jq, jk, jv, jqp, jkp), (q, k, v, qp, kp) = _both(arrays)

    def j_loss(fn, **kw):
        return lambda q, k, v: (fn(q, k, v, jqp, jkp, causal=True, **kw)
                                ** 2).sum()

    def grads(fn, **kw):
        ins = [a.clone().requires_grad_(True) for a in (q, k, v)]
        (fn(*ins, qp, kp, causal=True, **kw) ** 2).sum().backward()
        return [a.grad for a in ins]

    flash_kw = dict(q_chunk=8, kv_chunk=8)
    g_dense = grads(attention.dense_attention)
    g_flash = grads(attention.flash_attention, **flash_kw)
    jg_dense = jax.grad(j_loss(jattn.dense_attention), argnums=(0, 1, 2))(
        jq, jk, jv)
    jg_flash = jax.grad(j_loss(jattn.flash_attention, **flash_kw),
                        argnums=(0, 1, 2))(jq, jk, jv)
    for name, a, b, ja, jb in zip("qkv", g_dense, g_flash, jg_dense,
                                  jg_flash):
        _close(a, ja, GRAD_TOL, f"dense d{name}")
        _close(b, jb, GRAD_TOL, f"flash d{name}")
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-3)


def test_gqa_repeat():
    kv = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    rep = attention.gqa_repeat(torch.from_numpy(kv), 6)
    assert rep.shape == (2, 3, 6, 4)
    np.testing.assert_array_equal(
        rep.numpy(), np.asarray(jattn.gqa_repeat(jnp.asarray(kv), 6)))
    for g in range(3):
        np.testing.assert_array_equal(rep[:, :, g].numpy(), kv[:, :, 0])
        np.testing.assert_array_equal(rep[:, :, 3 + g].numpy(), kv[:, :, 1])
    same = torch.from_numpy(kv)
    assert attention.gqa_repeat(same, 2) is same


@pytest.mark.parametrize("theta", [1e4, 5e5, 1e6])
def test_rope_matches_reference(theta):
    """Float32 angles at every published θ, positions up to 4096."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 6, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 6)).astype(np.int32)
    got = attention.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                               theta)
    _close(got, jattn.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           ATTN_TOL, f"theta {theta}")


def test_rope_relative_property():
    """RoPE: ⟨q_m, k_n⟩ depends only on (m − n)."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(0, 1, (1, 1, 1, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(0, 1, (1, 1, 1, 16)).astype(np.float32))

    def dot_at(m, n):
        qm = attention.apply_rope(q, torch.tensor([[m]]), 10000.0)
        kn = attention.apply_rope(k, torch.tensor([[n]]), 10000.0)
        return float(torch.sum(qm * kn))

    assert abs(dot_at(5, 3) - dot_at(12, 10)) < 1e-4
    assert abs(dot_at(7, 7) - dot_at(0, 0)) < 1e-4


@settings(max_examples=15, deadline=None)
@given(st.integers(1, 3), st.integers(2, 40), st.integers(1, 4),
       st.integers(0, 2**31 - 1))
def test_flash_matches_dense_property(b, s, h, seed):
    (jq, jk, jv, jqp, jkp), (q, k, v, qp, kp) = _both(_qkv(b, s, h, 8,
                                                           seed=seed))
    out = attention.flash_attention(q, k, v, qp, kp, causal=True, q_chunk=8,
                                    kv_chunk=8)
    ref = attention.dense_attention(q, k, v, qp, kp, causal=True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=5e-4,
                               atol=5e-4)
    _close(out, jattn.flash_attention(jq, jk, jv, jqp, jkp, causal=True,
                                      q_chunk=8, kv_chunk=8), ATTN_TOL)


# ------------------------------------------------------------------ model


def _lm(arch, dtype="float32", cfg_kw=None):
    """(reference cfg, port cfg, reference params, port params) at SMOKE,
    every zero-initialized leaf moved off zero by seeded noise that
    bfloat16 holds exactly."""
    cfg_kw = cfg_kw or {}
    jcfg = j_get_smoke_config(arch).replace(dtype=getattr(jnp, dtype),
                                            **cfg_kw)
    cfg = get_smoke_config(arch).replace(dtype=getattr(torch, dtype),
                                         **cfg_kw)
    jparams, _ = j_get_family(jcfg).init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(11)

    def nudge(a):
        a = np.asarray(a)
        if np.any(a):
            return a
        noise = (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        return np.asarray(jnp.asarray(noise, jnp.bfloat16).astype(a.dtype))

    np_params = jax.tree.map(nudge, jparams)
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = compat.tree_from_reference(np_params, device="cpu",
                                        dtype=getattr(torch, dtype))
    return jcfg, cfg, jparams, params


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(
        np.int32)


def test_dense_configs_match_reference():
    """Field for field the reference's, with a torch dtype (bfloat16, as
    the reference's); the registry has all four and the estimate gives
    the reference's integer for every config the port has."""
    for name in DENSE:
        assert name in PORTED
        for ours, theirs in ((get_config(name), j_get_config(name)),
                             (get_smoke_config(name),
                              j_get_smoke_config(name))):
            a = dataclasses.asdict(ours)
            b = dataclasses.asdict(theirs)
            for key in ("dtype", "wkv_impl", "moe_impl"):
                a.pop(key), b.pop(key)
            assert a == b
            assert ours.dtype == torch.bfloat16
            assert (ours.q_dim, ours.kv_dim, ours.padded_vocab) == \
                (theirs.q_dim, theirs.kv_dim, theirs.padded_vocab)
            get_family(ours)
    for name in PORTED:
        for ours, theirs in ((get_config(name), j_get_config(name)),
                             (get_smoke_config(name),
                              j_get_smoke_config(name))):
            assert ours.param_count_estimate() == \
                theirs.param_count_estimate(), name
    # the tree adds 33 norm vectors of 2048: 1,235,814,400
    assert get_config("llama3.2-1b").param_count_estimate() == 1_235_746_816
    # every family of the reference is ported; another is a KeyError, as
    # the reference's FAMILIES[cfg.family]
    assert {"dense", "moe", "vlm", "encdec"} <= set(FAMILIES)
    assert get_family(get_smoke_config("llama3.2-1b").replace(
        family="vlm")) is FAMILIES["vlm"]
    with pytest.raises(KeyError):
        get_family(get_smoke_config("llama3.2-1b").replace(family="cnn"))


@pytest.mark.parametrize("arch", DENSE)
def test_init_matches_reference_layout(arch):
    """Same tree, shapes and logical axes as the reference's init and
    cache; the tree counts the estimate plus norms and biases."""
    jcfg, cfg, jparams, _ = _lm(arch)
    _, jaxes = jtransformer.init_lm(jax.random.PRNGKey(0), jcfg)
    own, axes = transformer.init_lm(torch.Generator().manual_seed(0), cfg)
    assert axes == jaxes
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]  # noqa: E731
    jshapes = sorted((jax.tree_util.keystr(p), tuple(a.shape))
                     for p, a in flat(jparams))
    assert sorted((jax.tree_util.keystr(p), tuple(a.shape))
                  for p, a in flat(own)) == jshapes
    n = sum(a.numel() for a in jax.tree.leaves(own))
    L, d = cfg.n_layers, cfg.d_model
    extra = (2 * L + 1) * d * (2 if cfg.use_layernorm else 1)
    extra += L * (cfg.q_dim + 2 * cfg.kv_dim) * cfg.qkv_bias
    extra += 2 * L * cfg.resolved_head_dim * cfg.qk_norm
    assert n == cfg.param_count_estimate() + extra
    cache, caxes = transformer.init_cache(cfg, 3, 24, device="cpu")
    jcache, jcaxes = jtransformer.init_cache(jcfg, 3, 24)
    assert caxes == jcaxes
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    abstract, _ = transformer.init_cache(cfg, 3, 24, abstract=True)
    assert all(v.device.type == "meta" for v in abstract.values())
    validate_slot_layout(cfg)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_loss_match_reference(arch):
    jcfg, cfg, jparams, params = _lm(arch)
    toks = _tokens(cfg, (2, 21), 1)
    targets = _tokens(cfg, (2, 21), 2)
    with torch.no_grad():
        logits, aux = transformer.forward(params, torch.from_numpy(toks), cfg)
        loss, metrics = get_family(cfg).loss(
            params, {"tokens": torch.from_numpy(toks),
                     "targets": torch.from_numpy(targets)}, cfg)
    jlogits, _ = jtransformer.forward(jparams, jnp.asarray(toks), jcfg)
    jloss, jmetrics = j_get_family(jcfg).loss(
        jparams, {"tokens": jnp.asarray(toks),
                  "targets": jnp.asarray(targets)}, jcfg)
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    _close(logits, jlogits, MODEL_TOL, "logits")
    _close(loss, jloss, MODEL_TOL, "loss")
    _close(metrics["ce"], jmetrics["ce"], MODEL_TOL, "ce")
    assert float(metrics["acc"]) == pytest.approx(float(jmetrics["acc"]))


def _decode_all(family, params, cfg, toks, state):
    outs = []
    b = toks.shape[0]
    for t in range(toks.shape[1]):
        lg, state = family.decode(params, state, toks[:, t:t + 1],
                                  torch.full((b,), t), cfg)
        outs.append(lg[:, 0])
    return torch.stack(outs, dim=1), state


@pytest.mark.parametrize("arch", ["qwen3-32b", "llama3.2-1b"])
def test_decode_matches_forward(arch):
    jcfg, cfg, jparams, params = _lm(arch)
    family = get_family(cfg)
    toks = torch.from_numpy(_tokens(cfg, (2, 18), 3))
    with torch.no_grad():
        ref, _ = transformer.forward(params, toks, cfg)
        state, _ = family.init_decode_state(cfg, 2, 64, device="cpu")
        dec, state = _decode_all(family, params, cfg, toks, state)
    np.testing.assert_allclose(dec.numpy(), ref.numpy(), rtol=DECODE_RTOL,
                               atol=DECODE_ATOL)
    # and each decode step against the reference's
    jstate, _ = j_get_family(jcfg).init_decode_state(jcfg, 2, 64)
    jdec = []
    for t in range(toks.shape[1]):
        lg, jstate = jtransformer.decode_step(
            jparams, jstate, jnp.asarray(toks[:, t:t + 1].numpy()),
            jnp.full((2,), t, jnp.int32), jcfg)
        jdec.append(np.asarray(lg[:, 0]))
    _close(dec, np.stack(jdec, 1), MODEL_TOL, "decode")
    _close(state["k"], jstate["k"], MODEL_TOL, "cache k")
    _close(state["v"], jstate["v"], MODEL_TOL, "cache v")


def test_rolling_window_cache_decode():
    """SWA decode with a cache smaller than the sequence stays exact
    (llama3.2-1b SMOKE with a 16-token window: 40 tokens wrap the
    rolling buffer twice)."""
    jcfg, cfg, jparams, params = _lm("llama3.2-1b",
                                     cfg_kw=dict(sliding_window=16))
    family = get_family(cfg)
    toks = torch.from_numpy(_tokens(cfg, (1, 40), 4))
    with torch.no_grad():
        ref, _ = transformer.forward(params, toks, cfg)
        state, _ = family.init_decode_state(cfg, 1, 64, device="cpu")
        assert state["k"].shape[2] == cfg.sliding_window  # rolling buffer
        dec, _ = _decode_all(family, params, cfg, toks, state)
    np.testing.assert_allclose(dec.numpy(), ref.numpy(), rtol=DECODE_RTOL,
                               atol=DECODE_ATOL)
    jref, _ = jtransformer.forward(jparams, jnp.asarray(toks.numpy()), jcfg)
    _close(ref, jref, MODEL_TOL, "forward")


def test_cached_attention_leaves_its_inputs_and_other_slots():
    """The step writes one row a slot, at ``pos % T``, into a new cache;
    the cache it was given keeps its bits."""
    _, cfg, _, params = _lm("llama3.2-1b")
    lp = {k: v[0] for k, v in params["layers"]["attn"].items()}
    rng = np.random.default_rng(6)
    ck = torch.from_numpy(rng.standard_normal(
        (3, 8, cfg.n_kv_heads, cfg.resolved_head_dim)).astype(np.float32))
    cv = ck.flip(0).contiguous()
    before = (ck.clone(), cv.clone())
    x = torch.from_numpy(rng.standard_normal((3, 1, cfg.d_model)).astype(
        np.float32))
    pos = torch.tensor([0, 9, 5])
    with torch.no_grad():
        _, nk, nv = layers.cached_attention(lp, x, ck, cv, pos, cfg)
    assert torch.equal(ck, before[0]) and torch.equal(cv, before[1])
    written = torch.zeros(3, 8, dtype=torch.bool)
    written[torch.arange(3), pos % 8] = True
    assert torch.equal(nk[~written], ck[~written])
    assert torch.equal(nv[~written], cv[~written])
    assert not torch.equal(nk[written], ck[written])


def test_bfloat16_forward_keeps_the_reference_casts():
    """One llama3.2-1b SMOKE forward in bfloat16 on both sides: norms,
    scores, softmax, RoPE's angles and logits in float32, as the
    reference casts them."""
    jcfg, cfg, jparams, params = _lm("llama3.2-1b", dtype="bfloat16")
    assert params["layers"]["attn"]["wq"].dtype == torch.bfloat16
    toks = _tokens(cfg, (2, 24), 5)
    with torch.no_grad():
        logits, _ = transformer.forward(params, torch.from_numpy(toks), cfg)
    jlogits, _ = jtransformer.forward(jparams, jnp.asarray(toks), jcfg)
    assert logits.dtype == torch.float32 and jlogits.dtype == jnp.float32
    _close(logits, jlogits, BF16_TOL, "bf16 logits")


def test_mlp_branches_match_reference():
    """The gated SiLU MLP and the ungated GELU (tanh, as ``jax.nn.gelu``)
    and SiLU branches."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    tree = {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
            for k, s in (("wi", (16, 32)), ("wg", (16, 32)), ("wo", (32, 16)))}
    for gated in (True, False):
        p = dict(tree) if gated else {k: tree[k] for k in ("wi", "wo")}
        for act in ("silu", "gelu"):
            got = layers.apply_mlp({k: torch.from_numpy(v) for k, v in
                                    p.items()}, torch.from_numpy(x), act)
            want = jlayers.apply_mlp({k: jnp.asarray(v) for k, v in
                                      p.items()}, jnp.asarray(x), act)
            _close(got, want, ATTN_TOL, f"gated={gated} {act}")
