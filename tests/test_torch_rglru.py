"""The port's RG-LRU family (`repro_torch.models.rglru`, the
recurrentgemma-9b config) against the JAX reference, on the CPU in
float32.

Inputs come from a seeded numpy generator; weights are the reference's
`SMOKE` (one group of (rec, rec, attn) and a 2-layer recurrent tail),
carried across by `repro_torch.compat.tree_from_reference`, with every
zero-initialized leaf moved off zero by seeded noise.  Tolerances, of
the largest |reference value|:

* `_rglru_scan` and `_rec_block`: 1e-5.  The port scans in log2(S)
  rounds of the reference's combine, the reference with
  ``jax.lax.associative_scan``; the products are taken in another order;
* forward logits, the loss, each decode step and the state leaf by
  leaf: 1e-4;
* decode against forward at the reference's rtol 2e-4, atol 5e-4
  (`tests/test_decode_equivalence.py`).

And the reference's refusals: the decode state keeps batch at axis 2 of
its grouped recurrent leaves, so `validate_slot_layout`, `ServeEngine`,
`greedy_generate`'s chunked prefill and the launcher raise the
``cache_batch`` ValueError, and `SessionEngine` its ``prefill`` one
(`tests/test_serving.py::test_slot_layout_validation_rejects_rglru`).
"""
import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.launch import serve as j_launch_serve
from repro.models import rglru as jrglru
from repro.models.families import get_family as j_get_family
from repro.serving import ServeEngine as JServeEngine
from repro.serving import SessionEngine as JSessionEngine
from repro.serving import greedy_generate as j_greedy_generate
from repro_torch import compat
from repro_torch.configs import PORTED, get_config, get_smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import rglru
from repro_torch.models.families import get_family, validate_slot_layout
from repro_torch.serving import ServeEngine, SessionEngine, greedy_generate

ARCH = "recurrentgemma-9b"
SCAN_TOL = 1e-5
MODEL_TOL = 1e-4
DECODE_RTOL, DECODE_ATOL = 2e-4, 5e-4


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
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    assert err <= tol * max(scale, 1e-30), \
        f"{what}: max abs err {err} of scale {scale}"


def _tree_close(got, want, tol, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for key in want:
            _tree_close(got[key], want[key], tol, f"{what}/{key}")
    else:
        assert tuple(got.shape) == tuple(want.shape), what
        _close(got, want, tol, what)


@pytest.fixture(scope="module")
def lm():
    """(reference cfg, port cfg, reference params, port params) at SMOKE
    in float32, every zero-initialized leaf moved off zero."""
    jcfg = j_get_smoke_config(ARCH).replace(dtype=jnp.float32)
    cfg = get_smoke_config(ARCH).replace(dtype=torch.float32)
    jparams, _ = j_get_family(jcfg).init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(11)

    def nudge(a):
        a = np.asarray(a)
        if np.any(a):
            return a
        return (rng.standard_normal(a.shape) * 0.1).astype(a.dtype)

    np_params = jax.tree.map(nudge, jparams)
    return (jcfg, cfg, jax.tree.map(jnp.asarray, np_params),
            compat.tree_from_reference(np_params, device="cpu"))


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(
        np.int32)


# ------------------------------------------------------------------ blocks


@pytest.mark.parametrize("s", [1, 2, 7, 33])
def test_rglru_scan_matches_reference(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.2, 1.0, (3, s, 16)).astype(np.float32)
    b = rng.normal(0, 1, (3, s, 16)).astype(np.float32)
    h0 = rng.normal(0, 1, (3, 16)).astype(np.float32)
    got = rglru._rglru_scan(*(torch.from_numpy(v) for v in (a, b, h0)))
    want = jrglru._rglru_scan(*(jnp.asarray(v) for v in (a, b, h0)))
    _close(got, want, SCAN_TOL, f"S={s}")
    if s == 1:  # the fold alone: b + a·h0, the same op order
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and the recurrence itself, step by step in float64
    h = h0.astype(np.float64)
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        _close(got[:, t], h, SCAN_TOL, f"S={s} t={t}")


@pytest.mark.parametrize("with_state", [False, True])
def test_rec_block_matches_reference(lm, with_state):
    jcfg, cfg, jparams, params = lm
    jp = jax.tree.map(lambda a: a[0], jparams["groups"]["b0"])
    p = {k: (v[0] if not isinstance(v, dict) else
             {kk: vv[0] for kk, vv in v.items()})
         for k, v in params["groups"]["b0"].items()}
    rng = np.random.default_rng(4)
    dr = cfg.d_rnn
    x = rng.normal(0, 1, (2, 9, cfg.d_model)).astype(np.float32)
    state = ({"conv": rng.normal(0, 1, (2, cfg.conv_width - 1, dr)).astype(
                 np.float32),
              "h": rng.normal(0, 1, (2, dr)).astype(np.float32)}
             if with_state else None)
    with torch.no_grad():
        y, new = rglru._rec_block(
            p, torch.from_numpy(x),
            None if state is None else {k: torch.from_numpy(v)
                                        for k, v in state.items()}, cfg)
    jy, jnew = jrglru._rec_block(
        jp, jnp.asarray(x),
        None if state is None else {k: jnp.asarray(v)
                                    for k, v in state.items()}, jcfg)
    _close(y, jy, SCAN_TOL, "x")
    _tree_close(new, jnew, SCAN_TOL, "state")
    assert new["h"].dtype == torch.float32


def test_softplus_has_no_threshold():
    """``jax.nn.softplus`` is log(1 + eˣ) everywhere (within an ulp in
    float32); `F.softplus` returns x itself above 20, which float64
    tells apart."""
    x = np.array([-30.0, -1.0, 0.0, 0.7, 19.9, 20.0, 20.5, 40.0], np.float32)
    got = rglru._softplus(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=2e-7, atol=0)
    x64 = torch.tensor([21.0, 25.0, 30.0], dtype=torch.float64)
    want = np.logaddexp(x64.numpy(), 0.0)
    np.testing.assert_allclose(rglru._softplus(x64).numpy(), want,
                               rtol=1e-15)
    assert torch.equal(torch.nn.functional.softplus(x64), x64)
    assert not np.array_equal(want, x64.numpy())


# ------------------------------------------------------------------ the model


def test_rglru_config_matches_reference():
    assert ARCH in PORTED
    for ours, theirs in ((get_config(ARCH), j_get_config(ARCH)),
                         (get_smoke_config(ARCH), j_get_smoke_config(ARCH))):
        a = dataclasses.asdict(ours)
        b = dataclasses.asdict(theirs)
        for key in ("dtype", "wkv_impl"):
            a.pop(key), b.pop(key)
        assert a == b
        assert ours.dtype == torch.bfloat16
        assert ours.param_count_estimate() == theirs.param_count_estimate()
        get_family(ours)
    assert get_config(ARCH).param_count_estimate() == 9_562_030_080
    assert rglru._pattern_split(get_config(ARCH)) == (12, 2)


def test_init_and_state_match_reference_layout(lm):
    """Same parameter tree, shapes and axes as the reference's init, and
    the same decode-state tree; the published config's tree holds
    10,444,877,824 parameters (counted from the abstract shapes)."""
    jcfg, cfg, jparams, _ = lm
    _, jaxes = jrglru.init_rglru(jax.random.PRNGKey(0), jcfg)
    own, axes = rglru.init_rglru(torch.Generator().manual_seed(0), cfg)
    assert axes == jaxes
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]  # noqa: E731
    shapes = lambda t: sorted((jax.tree_util.keystr(p), tuple(a.shape))  # noqa: E731
                              for p, a in flat(t))
    assert shapes(own) == shapes(jparams)
    assert list(own) == ["embed", "groups", "tail"]
    assert own["groups"]["b0"]["lam"].dtype == torch.float32
    for b, max_len in ((3, 24), (1, 4)):
        state, saxes = rglru.init_rglru_state(cfg, b, max_len, device="cpu")
        jstate, jsaxes = jrglru.init_rglru_state(jcfg, b, max_len)
        assert saxes == jsaxes
        assert shapes(state) == shapes(jstate)
        assert state["rec_h"].dtype == torch.float32
    abstract, _ = rglru.init_rglru_state(cfg, 3, 24, abstract=True)
    assert all(a.device.type == "meta" for a in jax.tree.leaves(abstract))
    full = get_config(ARCH)
    tree = jax.eval_shape(lambda: jrglru.init_rglru(jax.random.PRNGKey(0),
                                                    j_get_config(ARCH))[0])
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree)) == \
        10_444_877_824
    assert full.n_layers == 38


def test_forward_and_loss_match_reference(lm):
    jcfg, cfg, jparams, params = lm
    toks = _tokens(cfg, (2, 21), 1)
    targets = _tokens(cfg, (2, 21), 2)
    with torch.no_grad():
        logits, aux = rglru.forward(params, torch.from_numpy(toks), cfg)
        loss, metrics = get_family(cfg).loss(
            params, {"tokens": torch.from_numpy(toks),
                     "targets": torch.from_numpy(targets)}, cfg)
    jlogits, _ = jrglru.forward(jparams, jnp.asarray(toks), jcfg)
    jloss, jmetrics = j_get_family(jcfg).loss(
        jparams, {"tokens": jnp.asarray(toks),
                  "targets": jnp.asarray(targets)}, jcfg)
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    _close(logits, jlogits, MODEL_TOL, "logits")
    _close(loss, jloss, MODEL_TOL, "loss")
    assert float(metrics["acc"]) == pytest.approx(float(jmetrics["acc"]))


def test_forward_gradients_reach_every_leaf(lm):
    """The loss differentiates through the scan and the conv (remat a
    group, as the reference's ``cfg.remat``)."""
    _, cfg, _, params = lm
    params = jax.tree.map(lambda a: a.clone().requires_grad_(), params)
    toks = torch.from_numpy(_tokens(cfg, (2, 9), 5))
    loss, _ = get_family(cfg).loss(params, {"tokens": toks,
                                            "targets": toks}, cfg)
    loss.backward()
    for leaf in jax.tree.leaves(params):
        assert leaf.grad is not None and bool(torch.isfinite(leaf.grad).all())
    assert float(params["groups"]["b0"]["lam"].grad.abs().max()) > 0.0


def _decode_all(family, params, cfg, toks, state):
    outs = []
    b = toks.shape[0]
    for t in range(toks.shape[1]):
        lg, state = family.decode(params, state, toks[:, t:t + 1],
                                  torch.full((b,), t), cfg)
        outs.append(lg[:, 0])
    return torch.stack(outs, dim=1), state


def test_decode_matches_reference_and_forward(lm):
    """18 tokens (the window is 8): every step's logits and the final
    state leaf by leaf against the reference's `decode_step`, and the
    logits against the port's forward (the mirror of
    `test_decode_equivalence.py::test_decode_matches_forward`)."""
    jcfg, cfg, jparams, params = lm
    family = get_family(cfg)
    toks = torch.from_numpy(_tokens(cfg, (2, 18), 3))
    with torch.no_grad():
        ref, _ = rglru.forward(params, toks, cfg)
        state, _ = family.init_decode_state(cfg, 2, 64, device="cpu")
        assert state["attn"]["k"].shape[2] == cfg.sliding_window
        dec, state = _decode_all(family, params, cfg, toks, state)
    np.testing.assert_allclose(dec.numpy(), ref.numpy(), rtol=DECODE_RTOL,
                               atol=DECODE_ATOL)
    jstate, _ = j_get_family(jcfg).init_decode_state(jcfg, 2, 64)
    jstep = jax.jit(functools.partial(jrglru.decode_step, cfg=jcfg))
    jdec = []
    for t in range(toks.shape[1]):
        lg, jstate = jstep(jparams, jstate,
                           jnp.asarray(toks[:, t:t + 1].numpy()),
                           jnp.full((2,), t, jnp.int32))
        jdec.append(np.asarray(lg[:, 0]))
    _close(dec, np.stack(jdec, 1), MODEL_TOL, "decode")
    _tree_close(state, jstate, MODEL_TOL, "state")


def test_decode_step_leaves_its_input_state(lm):
    _, cfg, _, params = lm
    state, _ = rglru.init_rglru_state(cfg, 2, 16, device="cpu")
    state = jax.tree.map(lambda a: torch.randn(a.shape, generator=torch.
                                               Generator().manual_seed(1)),
                         state)
    before = jax.tree.map(torch.clone, state)
    with torch.no_grad():
        _, new = rglru.decode_step(params, state, torch.tensor([[3], [7]]),
                                   torch.tensor([5, 9]), cfg)
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(before)):
        assert torch.equal(a, b)
    assert jax.tree.structure(new) == jax.tree.structure(state)


def test_greedy_generate_token_by_token_matches_reference(lm):
    """``prefill_chunk=1`` (the token-by-token loop) is the one way
    `greedy_generate` runs this family: the reference's tokens.  Any
    chunked prefill of a longer prompt raises, as the reference's."""
    jcfg, cfg, jparams, params = lm
    prompts = _tokens(cfg, (3, 7), 7)
    out = greedy_generate(params, cfg, prompts, 5, max_len=64,
                          prefill_chunk=1)
    want = j_greedy_generate(jparams, jcfg, jnp.asarray(prompts), 5,
                             max_len=64, prefill_chunk=1)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    for chunk in (None, 3):
        with pytest.raises(ValueError, match="cache_batch"):
            greedy_generate(params, cfg, prompts, 2, max_len=64,
                            prefill_chunk=chunk)
        with pytest.raises(ValueError, match="cache_batch"):
            j_greedy_generate(jparams, jcfg, jnp.asarray(prompts), 2,
                              max_len=64, prefill_chunk=chunk)


# ------------------------------------------------------------------ refusals


def test_slot_layout_validation_rejects_rglru(lm):
    """The mirror of `tests/test_serving.py::
    test_slot_layout_validation_rejects_rglru`, with the reference's
    message, and `SessionEngine`'s refusal (no prefill hook)."""
    jcfg, cfg, jparams, params = lm
    with pytest.raises(ValueError, match="cache_batch") as ours:
        validate_slot_layout(cfg)
    with pytest.raises(ValueError, match="cache_batch") as theirs:
        from repro.models.families import validate_slot_layout as jvalidate
        jvalidate(jcfg)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="cache_batch"):
        ServeEngine(params, cfg, max_batch=1, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="cache_batch"):
        JServeEngine(jparams, jcfg, max_batch=1, max_len=16)
    with pytest.raises(ValueError, match="prefill") as ours:
        SessionEngine(params, cfg, max_batch=1, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="prefill") as theirs:
        JSessionEngine(jparams, jcfg, max_batch=1, max_len=16)
    assert str(ours.value) == str(theirs.value)


def test_launcher_refuses_rglru_as_the_reference_does(monkeypatch):
    """``--arch recurrentgemma-9b --smoke`` builds the model, then
    `ServeEngine` raises the ``cache_batch`` ValueError, in both
    launchers."""
    with pytest.raises(ValueError, match="cache_batch") as ours:
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--requests", "2"])
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--smoke",
                                      "--requests", "2"])
    with pytest.raises(ValueError, match="cache_batch") as theirs:
        j_launch_serve.main()
    assert str(ours.value) == str(theirs.value)
