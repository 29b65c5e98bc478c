"""The port's RWKV-6 model and its chunked WKV (`repro_torch.models.rwkv6`,
`repro_torch.kernels.rwkv_wkv`) against the JAX reference, on the CPU.

Inputs come from a seeded numpy generator; model weights are the
reference's, carried across by `repro_torch.compat.tree_from_reference`.
Tolerances, all float32:

* WKV: the plain twin against the reference's chunked twin
  (`wkv_chunked_ref`) and its Pallas kernel (interpret mode), and the
  per-token scans against each other, within 1e-5 of the largest |value|
  (the same arithmetic, sums in another order); the chunked forms against
  the per-token scan within 1e-4, as the reference holds its own kernel
  (`tests/test_rwkv_wkv.py`).
* Model at `SMOKE` (the reference with ``wkv_impl="xla"``, the port with
  its default ``"cuda"``, which on CPU tensors is the plain twin): logits
  and states within 1e-4 (rtol and atol).
* Rows with zero active tokens keep their state bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.data.lm import SyntheticLMDataset as JSyntheticLMDataset
from repro.kernels.rwkv_wkv import ref as jref
from repro.kernels.rwkv_wkv.kernel import wkv_pallas
from repro.models import layers as jlayers
from repro.models import rwkv6 as jrwkv6
from repro_torch import compat
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.kernels.rwkv_wkv import kernel, ops, ref
from repro_torch.models import layers, rwkv6
from repro_torch.models.families import get_family, validate_slot_layout

WKV_TOL = 1e-5
NAIVE_TOL = 1e-4
MODEL_TOL = 1e-4


def _wkv_inputs(b, s, h, d, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    r, k, v = (f(b, s, h, d) * scale for _ in range(3))
    # log decays in the band the model produces, [-5, -1e-6]
    lw = -rng.uniform(1e-6, 5.0, (b, s, h, d)).astype(np.float32)
    u = f(h, d) * 0.3
    s0 = f(b, h, d, d) * scale
    return r, k, v, lw, u, s0


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max() if got.size else 0.0
    scale = max(1.0, np.abs(want).max() if want.size else 0.0)
    assert err <= tol * scale, f"max abs err {err} of scale {scale}"


# ------------------------------------------------------------------ WKV


@pytest.mark.parametrize("shape,chunk", [
    ((2, 45, 3, 16), 16), ((1, 16, 1, 8), 16), ((3, 7, 2, 32), 16),
    ((2, 17, 2, 16), 16), ((1, 1, 2, 64), 16), ((2, 33, 2, 16), 4),
    ((1, 15, 3, 64), 16), ((2, 100, 1, 16), 16),
] + [((2, s, 3, d), 16) for d in (1, 33) for s in (16, 64, 100)])
def test_wkv_plain_matches_reference_twin_and_pallas(shape, chunk):
    ins = _wkv_inputs(*shape)
    y, sf = ref.wkv_chunked_plain(*_t(*ins), chunk)
    y_ref, s_ref = jref.wkv_chunked_ref(*map(jnp.asarray, ins), chunk)
    _close(y, y_ref, WKV_TOL)
    _close(sf, s_ref, WKV_TOL)
    y_k, s_k = wkv_pallas(*map(jnp.asarray, ins), chunk=chunk,
                          interpret=True)
    _close(y, y_k, WKV_TOL)
    _close(sf, s_k, WKV_TOL)


@pytest.mark.parametrize("shape", [(2, 45, 3, 16), (3, 7, 2, 32),
                                   (1, 20, 2, 64)])
def test_wkv_chunked_matches_naive(shape):
    ins = _t(*_wkv_inputs(*shape, seed=1))
    y_n, s_n = rwkv6.wkv_naive(*ins)
    for impl in ("cuda", "plain"):
        y, sf = rwkv6.wkv_chunked(*ins, impl=impl)
        _close(y, y_n, NAIVE_TOL)
        _close(sf, s_n, NAIVE_TOL)
    y, sf = rwkv6.wkv_chunked(*ins, impl="naive")
    assert torch.equal(y, y_n) and torch.equal(sf, s_n)


@pytest.mark.parametrize("shape", [(2, 9, 3, 16), (1, 1, 2, 8)])
def test_wkv_naive_matches_reference(shape):
    ins = _wkv_inputs(*shape, seed=2)
    y, sf = rwkv6.wkv_naive(*_t(*ins))
    y_ref, s_ref = jrwkv6.wkv_naive(*map(jnp.asarray, ins))
    _close(y, y_ref, WKV_TOL)
    _close(sf, s_ref, WKV_TOL)


@pytest.mark.parametrize("d", [1, 33, 64])
def test_wkv_plain_passes_the_state_through_at_zero_length(d):
    """S = 0: no token, an empty y and the state unchanged, as the
    reference's chunked twin (the Pallas kernel takes no empty grid)."""
    ins = _wkv_inputs(2, 0, 3, d, seed=7)
    y, sf = ref.wkv_chunked_plain(*_t(*ins))
    y_ref, s_ref = jref.wkv_chunked_ref(*map(jnp.asarray, ins), 16)
    assert y.shape == y_ref.shape == (2, 0, 3, d)
    assert torch.equal(sf, torch.from_numpy(ins[5]))
    assert np.array_equal(np.asarray(s_ref), ins[5])


def test_wkv_zero_length_rows_keep_state_bitwise():
    """A row whose lw and k are 0 at every position (a slot that advances
    no token) keeps its state bit for bit, at a ragged length."""
    r, k, v, lw, u, s0 = _wkv_inputs(3, 21, 2, 16, seed=3)
    lw[1] = 0.0
    k[1] = 0.0
    lw[2, 5:] = 0.0  # a row active for its first 5 positions only
    k[2, 5:] = 0.0
    _, sf = ref.wkv_chunked_plain(*_t(r, k, v, lw, u, s0))
    assert torch.equal(sf[1], torch.from_numpy(s0[1]))
    _, s5 = ref.wkv_chunked_plain(*_t(r[:, :5], k[:, :5], v[:, :5],
                                      lw[:, :5], u, s0))
    _close(sf[2], s5[2], WKV_TOL)
    _, s_ref = jref.wkv_chunked_ref(*map(jnp.asarray, (r, k, v, lw, u, s0)))
    assert np.array_equal(np.asarray(s_ref[1]), s0[1])


def test_wkv_chunk_start_states_match_reference():
    r, k, v, lw, u, s0 = _wkv_inputs(2, 37, 2, 16, seed=4)
    sf, starts = ref.chunk_start_states(*_t(k, v, lw, s0), 16)
    sf_ref, starts_ref = jref.chunk_start_states(
        *map(jnp.asarray, (k, v, lw, s0)), 16)
    assert starts.shape == starts_ref.shape
    _close(sf, sf_ref, WKV_TOL)
    _close(starts, starts_ref, WKV_TOL)


def test_chunk_inputs_and_unchunk_round_trip():
    r, k, v, lw, *_ = _wkv_inputs(2, 19, 3, 8, seed=5)
    rc, *_, n, pad = ref.chunk_inputs(*_t(r, k, v, lw), 8)
    j_rc, *_, j_n, j_pad = jref.chunk_inputs(
        *map(jnp.asarray, (r, k, v, lw)), 8)
    assert (n, pad) == (j_n, j_pad) == (3, 5)
    assert np.array_equal(rc.numpy(), np.asarray(j_rc))
    assert torch.equal(ref.unchunk(rc, 2, 19, 3, 8, 8), torch.from_numpy(r))


def test_wkv_fused_runs_the_plain_twin_for_cpu_tensors():
    ins = _t(*_wkv_inputs(2, 23, 2, 16, seed=6))
    before = kernel.wkv_fused.launches
    y, sf = kernel.wkv_fused(*ins)
    y_p, s_p = ref.wkv_chunked_plain(*ins)
    assert torch.equal(y, y_p) and torch.equal(sf, s_p)
    assert kernel.wkv_fused.launches == before  # no kernel ran
    y_o, s_o = ops.wkv(*ins, impl="plain")
    assert torch.equal(y_o, y_p) and torch.equal(s_o, s_p)
    with pytest.raises(ValueError, match="impl"):
        ops.wkv(*ins, impl="pallas")


# ------------------------------------------------------------------ model


def _cfgs():
    jcfg = j_get_smoke_config("rwkv6-3b").replace(dtype=jnp.float32,
                                                  wkv_impl="xla")
    cfg = get_smoke_config("rwkv6-3b").replace(dtype=torch.float32)
    return jcfg, cfg


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _cfgs()
    jparams, _ = jrwkv6.init_rwkv(jax.random.PRNGKey(0), jcfg)
    params = compat.tree_from_reference(
        jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


def _random_state(jcfg, cfg, batch, seed):
    """A nonzero decode state (numpy) in both frameworks' trees."""
    rng = np.random.default_rng(seed)
    jstate, _ = jrwkv6.init_rwkv_state(jcfg, batch)
    np_state = {k: (rng.standard_normal(a.shape) * 0.5).astype(np.float32)
                for k, a in jstate.items()}
    return ({k: jnp.asarray(a) for k, a in np_state.items()},
            compat.tree_from_reference(np_state, device="cpu"))


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(
        np.int32)


def _assert_tree_close(got, want, tol=MODEL_TOL):
    assert set(got) == set(want)
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=tol, atol=tol, err_msg=key)


def test_configs_match_reference():
    for name in ("rwkv6-3b",):
        for ours, theirs in ((get_config(name), j_get_config(name)),
                             (get_smoke_config(name),
                              j_get_smoke_config(name))):
            a = {f.name: getattr(ours, f.name)
                 for f in dataclasses.fields(ours)}
            b = {f.name: getattr(theirs, f.name)
                 for f in dataclasses.fields(theirs)}
            for key in ("dtype", "wkv_impl", "moe_impl"):
                a.pop(key), b.pop(key)
            assert a == b
            assert ours.padded_vocab == theirs.padded_vocab
            assert ours.n_rwkv_heads == theirs.n_rwkv_heads
    cfg = get_config("rwkv6-3b")
    assert (cfg.wkv_impl, cfg.dtype) == ("cuda", torch.bfloat16)
    # the multimodal configs and families load (ported since the vlm and
    # encdec slice); an unknown arch or family is a KeyError
    vision = get_config("llama-3.2-vision-11b")
    assert (vision.family, vision.n_layers) == ("vlm", 40)
    assert get_family(vision).batch_keys[-1] == "image_embeds"
    assert get_family(cfg.replace(family="encdec")).batch_keys[-1] == \
        "src_embeds"
    with pytest.raises(KeyError):
        get_config("gpt-5")
    with pytest.raises(KeyError):
        get_family(cfg.replace(family="cnn"))


def test_init_matches_reference_layout(model):
    """Same tree, shapes and logical axes as the reference's init; the
    port's own init draws on its generator's device."""
    jcfg, cfg, jparams, params = model
    _, jaxes = jrwkv6.init_rwkv(jax.random.PRNGKey(0), jcfg)
    own, axes = rwkv6.init_rwkv(torch.Generator().manual_seed(0), cfg)
    assert axes == jaxes
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]  # noqa: E731
    jshapes = [(jax.tree_util.keystr(p), tuple(a.shape))
               for p, a in flat(jparams)]
    ours = [(jax.tree_util.keystr(p), tuple(a.shape)) for p, a in flat(own)]
    assert sorted(ours) == sorted(jshapes)
    # the constant inits equal the reference's exactly
    for key in ("w0", "u", "gn_scale", "gn_bias"):
        assert np.array_equal(own["layers"]["att"][key].numpy(),
                              np.asarray(jparams["layers"]["att"][key]))
    state, saxes = rwkv6.init_rwkv_state(cfg, 3, device="cpu")
    jstate, jsaxes = jrwkv6.init_rwkv_state(jcfg, 3)
    assert saxes == jsaxes
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in jstate.items()}
    abstract, _ = rwkv6.init_rwkv_state(cfg, 3, abstract=True)
    assert all(v.device.type == "meta" for v in abstract.values())
    validate_slot_layout(cfg)


def test_norms_match_reference():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32) * 0.1
    bias = rng.standard_normal(32).astype(np.float32) * 0.1
    _close(layers.rms_norm(*_t(x, scale), 1e-6),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6), 1e-6)
    _close(layers.layer_norm(*_t(x, scale, bias), 1e-6),
           jlayers.layer_norm(*map(jnp.asarray, (x, scale, bias)), 1e-6),
           1e-6)


def test_forward_matches_reference(model):
    jcfg, cfg, jparams, params = model
    tokens = _tokens(cfg, (2, 21), 8)
    jl, _, jst = jrwkv6.forward(jparams, jnp.asarray(tokens), jcfg)
    logits, aux, st = rwkv6.forward(params, torch.from_numpy(tokens), cfg)
    assert logits.shape == (2, 21, cfg.padded_vocab) and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                               rtol=MODEL_TOL, atol=MODEL_TOL)
    _assert_tree_close(st, jst)
    # the naive per-token scan agrees with the chunked forward
    naive, _, _ = rwkv6.forward(params, torch.from_numpy(tokens),
                                cfg.replace(wkv_impl="naive"))
    np.testing.assert_allclose(naive.numpy(), logits.numpy(),
                               rtol=MODEL_TOL, atol=MODEL_TOL)


def test_prefill_step_matches_reference_with_ragged_lengths(model):
    """Ragged ``lengths`` including 0 and the full chunk, from a nonzero
    state: last logits and the state within tolerance of the reference;
    rows at 0 keep every state leaf bit for bit."""
    jcfg, cfg, jparams, params = model
    jstate, state = _random_state(jcfg, cfg, 4, 9)
    tokens = _tokens(cfg, (4, 19), 10)
    lengths = np.array([19, 0, 7, 1], np.int32)
    jl, jst = jrwkv6.prefill_step(jparams, jstate, jnp.asarray(tokens),
                                  jnp.asarray(lengths), jcfg)
    last, st = rwkv6.prefill_step(params, state, torch.from_numpy(tokens),
                                  torch.from_numpy(lengths).long(), cfg)
    np.testing.assert_allclose(last.numpy(), np.asarray(jl),
                               rtol=MODEL_TOL, atol=MODEL_TOL)
    _assert_tree_close(st, jst)
    for key in st:
        assert torch.equal(st[key][:, 1], state[key][:, 1]), key


def test_decode_step_matches_reference(model):
    jcfg, cfg, jparams, params = model
    jstate, state = _random_state(jcfg, cfg, 3, 11)
    tokens = _tokens(cfg, (3, 1), 12)
    pos = np.zeros(3, np.int32)
    jl, jst = jrwkv6.decode_step(jparams, jstate, jnp.asarray(tokens),
                                 jnp.asarray(pos), jcfg)
    logits, st = rwkv6.decode_step(params, state, torch.from_numpy(tokens),
                                   torch.from_numpy(pos), cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                               rtol=MODEL_TOL, atol=MODEL_TOL)
    _assert_tree_close(st, jst)


def test_tree_from_reference_keeps_lm_layouts(model):
    _, cfg, jparams, params = model
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat:
        node = params
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.float32
        assert np.array_equal(node.numpy(), np.asarray(leaf)), path
    # The 4-D ``lora_b`` is no conv weight: only a leaf keyed "w" turns.
    assert params["layers"]["att"]["mix"]["lora_b"].shape == (
        cfg.n_layers, 5, cfg.rwkv_lora_dim, cfg.d_model)


def test_synthetic_lm_dataset_is_the_reference_copy():
    ours = SyntheticLMDataset(vocab=97, seq_len=12, batch=3, seed=4)
    theirs = JSyntheticLMDataset(vocab=97, seq_len=12, batch=3, seed=4)
    for step in (0, 5):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        assert a.keys() == b.keys()
        for key in a:
            assert np.array_equal(a[key], b[key])
