"""The port's MoE family (`repro_torch.models.moe`, the MoE branch of
`repro_torch.models.transformer`, the qwen3-moe and mixtral configs)
against the JAX reference, on the CPU in float32.

Inputs come from a seeded numpy generator; weights are the reference's,
carried across by `repro_torch.compat.tree_from_reference`, with every
zero-initialized leaf of a model moved off zero by seeded noise.
Tolerances, of the largest |reference value|:

* `apply_moe`'s output and aux loss: 1e-5 (the same arithmetic, sums in
  another order), with and without capacity drops, and where two
  experts tie on the router's probability (the lower id goes first, as
  `jax.lax.top_k` orders them);
* gradients of ``sum(y²) + aux`` by torch autograd: 1e-4 of ``jax.grad``'s;
* logits and the loss (ce + aux) of both SMOKE configs: 1e-4;
* decode against forward at the reference's rtol 2e-4, atol 5e-4
  (`tests/test_decode_equivalence.py`).

The first five tests mirror `tests/test_moe.py` on the port.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.models.config import ModelConfig as JModelConfig
from repro.models.families import get_family as j_get_family
from repro.models.init_utils import KeyGen as JKeyGen
from repro.models.init_utils import split_tree as j_split_tree
from repro_torch import compat
from repro_torch.configs import PORTED, get_config, get_smoke_config
from repro_torch.models import moe, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.families import get_family, validate_slot_layout
from repro_torch.models.init_utils import KeyGen, split_tree

MOE_TOL = 1e-5
GRAD_TOL = 1e-4
MODEL_TOL = 1e-4
DECODE_RTOL, DECODE_ATOL = 2e-4, 5e-4
MOE_ARCHS = ("qwen3-moe-30b-a3b", "mixtral-8x22b")


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


# ------------------------------------------------------------------ the layer


_CFG_KW = dict(name="m", family="moe", n_layers=1, d_model=32, n_heads=4,
               n_kv_heads=4, d_ff=48, vocab=64)


def _cfg(e=8, k=2, cf=8.0):
    """test_moe.py's config: a huge capacity factor ⇒ no drops."""
    return ModelConfig(n_experts=e, top_k=k, capacity_factor=cf,
                       dtype=torch.float32, **_CFG_KW)


def _jcfg(cfg: ModelConfig) -> JModelConfig:
    return JModelConfig(n_experts=cfg.n_experts, top_k=cfg.top_k,
                        capacity_factor=cfg.capacity_factor,
                        dtype=jnp.float32, **_CFG_KW)


def _params(cfg, seed=0):
    """The port's own init, layer dim dropped."""
    tree = moe.init_moe(KeyGen(torch.Generator().manual_seed(seed)), cfg,
                        (1,))
    params, _ = split_tree(tree)
    return {k: v[0] for k, v in params.items()}


def _ref_params(jcfg, seed=0):
    """(reference params, the same as port tensors), layer dim dropped."""
    tree = jmoe.init_moe(JKeyGen(jax.random.PRNGKey(seed)), jcfg, (1,))
    jparams, _ = j_split_tree(tree)
    np_params = {k: np.asarray(v[0]) for k, v in jparams.items()}
    return ({k: jnp.asarray(v) for k, v in np_params.items()},
            compat.tree_from_reference(np_params, device="cpu"))


def _x(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _bruteforce(p, x, cfg):
    """Every token through its top-k experts (test_moe.py's reference,
    on the port)."""
    g, s, d = x.shape
    probs = torch.softmax(x @ p["router"], dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :cfg.top_k], idx[..., :cfg.top_k]
    vals = vals / vals.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for gi in range(g):
        for si in range(s):
            for ki in range(cfg.top_k):
                e = int(idx[gi, si, ki])
                h = x[gi, si] @ p["wi"][e]
                gate = x[gi, si] @ p["wg"][e]
                out[gi, si] += vals[gi, si, ki] * (
                    (torch.nn.functional.silu(gate) * h) @ p["wo"][e])
    return out


def test_moe_matches_bruteforce_no_drops():
    cfg = _cfg()
    p = _params(cfg)
    x = torch.from_numpy(_x((2, 12, 32), 0))
    with torch.no_grad():
        y, aux = moe.apply_moe(p, x, cfg)
        ref = _bruteforce(p, x, cfg)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=2e-4, atol=2e-4)
    assert float(aux) > 0.0


def test_capacity_drops_tokens():
    cfg = _cfg(cf=0.25)  # tiny capacity ⇒ forced drops
    p = _params(cfg)
    x = torch.from_numpy(_x((1, 64, 32), 1))
    with torch.no_grad():
        y, _ = moe.apply_moe(p, x, cfg)
        ref = _bruteforce(p, x, cfg)
    assert bool(torch.isfinite(y).all())
    # dropped tokens make outputs differ: dispatch must NOT silently equal
    assert float((y - ref).abs().max()) > 1e-3


def test_capacity_rounding():
    cfg = _cfg()
    c = moe.capacity(cfg, 128)
    assert c % 8 == 0 and c >= 128 * cfg.top_k / cfg.n_experts


def test_aux_loss_uniform_vs_skewed():
    """Balanced routing must have lower aux loss than a collapsed router."""
    cfg = _cfg(e=4, k=1)
    p = _params(cfg, seed=2)
    x = torch.from_numpy(_x((1, 64, 32), 2))
    with torch.no_grad():
        _, aux_balanced = moe.apply_moe(p, x, cfg)
        router = torch.zeros(32, 4)
        router[:, 0] = 10.0  # everything to expert 0
        _, aux_collapsed = moe.apply_moe({**p, "router": router}, x, cfg)
    assert float(aux_collapsed) > float(aux_balanced)


def test_moe_grads_flow_to_all_parts():
    cfg = _cfg()
    p = {k: v.requires_grad_() for k, v in _params(cfg, seed=3).items()}
    x = torch.from_numpy(_x((1, 16, 32), 3))
    y, aux = moe.apply_moe(p, x, cfg)
    ((y ** 2).sum() + aux).backward()
    for name in ("router", "wi", "wg", "wo"):
        assert float(p[name].grad.abs().max()) > 0.0, name


def _tie_router(d, e, seed):
    """Integer router whose experts 1..e−1 have one column: every token's
    probabilities tie among them, bit for bit (integer inputs, exact
    sums), so the top-k order at ties picks the experts."""
    rng = np.random.default_rng(seed)
    col = rng.integers(-2, 3, d)
    router = np.stack([rng.integers(-2, 3, d)] + [col] * (e - 1), axis=1)
    return router.astype(np.float32)


@pytest.mark.parametrize("case", ["smoke-qwen3", "smoke-mixtral", "drops",
                                  "tie"])
def test_apply_moe_matches_reference(case):
    """y and the aux loss against the reference's `apply_moe`: both SMOKE
    widths, a capacity factor that drops tokens, and a router whose
    top-2 is decided by the order at ties."""
    if case.startswith("smoke"):
        arch = MOE_ARCHS[0] if case == "smoke-qwen3" else MOE_ARCHS[1]
        cfg = get_smoke_config(arch).replace(dtype=torch.float32)
        jcfg = j_get_smoke_config(arch).replace(dtype=jnp.float32)
        shape = (3, 21, cfg.d_model)
    else:
        cfg = _cfg(cf=0.25) if case == "drops" else _cfg(e=4, k=2, cf=0.5)
        jcfg = _jcfg(cfg)
        shape = (2, 40, 32) if case == "drops" else (2, 24, 32)
    jp, p = _ref_params(jcfg, seed=5)
    x = _x(shape, 6)
    if case == "tie":
        x = np.round(x).astype(np.float32)
        router = _tie_router(32, cfg.n_experts, 7)
        jp["router"], p["router"] = jnp.asarray(router), torch.from_numpy(
            router)
    with torch.no_grad():
        y, aux = moe.apply_moe(p, torch.from_numpy(x), cfg)
    jy, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    _close(y, jy, MOE_TOL, f"{case} y")
    _close(aux, jaux, MOE_TOL, f"{case} aux")
    if case == "drops":
        _, _, idx = moe.route(p, torch.from_numpy(x), cfg)
        pos = moe.positions(idx, cfg.n_experts)
        assert int((pos >= moe.capacity(cfg, shape[1])).sum()) > 0
    if case == "tie":
        probs, _, idx = moe.route(p, torch.from_numpy(x), cfg)
        tied = probs[..., 1:]
        assert torch.equal(tied, tied[..., :1].expand_as(tied))
        # the lower ids win the tie, where the top-2 lies among them
        top1 = probs[..., 0] < tied[..., 0]
        assert bool(top1.any())
        assert torch.equal(idx[top1], torch.tensor([1, 2]).expand(
            int(top1.sum()), 2))


def test_capacity_matches_reference():
    for s in (1, 7, 24, 64, 128, 333):
        for e, k in ((4, 2), (8, 2), (128, 8), (8, 1)):
            for cf in (0.25, 1.0, 1.25, 4.0, e / k):
                cfg = _cfg(e=e, k=k, cf=cf)
                assert moe.capacity(cfg, s) == jmoe.capacity(_jcfg(cfg), s), \
                    (s, e, k, cf)
    # decode groups hold one token: top_k slots, so nothing drops
    for arch in MOE_ARCHS:
        cfg = get_config(arch)
        assert moe.capacity(cfg, 1) == cfg.top_k


def test_gradients_match_jax_grad():
    cfg = _cfg(cf=0.5)  # with drops
    jp, p = _ref_params(_jcfg(cfg), seed=8)
    x = _x((2, 16, 32), 9)
    p = {k: v.requires_grad_() for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe.apply_moe(p, xt, cfg)
    ((y ** 2).sum() + aux).backward()

    def loss(jp, jx):
        jy, jaux = jmoe.apply_moe(jp, jx, _jcfg(cfg))
        return (jy ** 2).sum() + jaux

    jg, jgx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    for name in ("router", "wi", "wg", "wo"):
        _close(p[name].grad, jg[name], GRAD_TOL, name)
    _close(xt.grad, jgx, GRAD_TOL, "x")


# ------------------------------------------------------------------ the model


def _lm(arch):
    """(reference cfg, port cfg, reference params, port params) at SMOKE
    in float32, every zero-initialized leaf moved off zero."""
    jcfg = j_get_smoke_config(arch).replace(dtype=jnp.float32)
    cfg = get_smoke_config(arch).replace(dtype=torch.float32)
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


def test_moe_configs_match_reference():
    """Field for field the reference's; the estimate counts the active
    experts, to the integer."""
    for name in MOE_ARCHS:
        assert name in PORTED
        for ours, theirs in ((get_config(name), j_get_config(name)),
                             (get_smoke_config(name),
                              j_get_smoke_config(name))):
            a = dataclasses.asdict(ours)
            b = dataclasses.asdict(theirs)
            for key in ("dtype", "wkv_impl"):
                a.pop(key), b.pop(key)
            assert a == b
            assert ours.dtype == torch.bfloat16
            assert ours.param_count_estimate() == \
                theirs.param_count_estimate()
            get_family(ours)
    assert get_config("qwen3-moe-30b-a3b").param_count_estimate() == \
        3_352_821_760
    assert get_config("mixtral-8x22b").param_count_estimate() == \
        39_160_774_656


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_matches_reference_layout(arch):
    """Same tree, shapes and logical axes as the reference's init and
    cache; the experts' leaves are the stacked (L, E, ·, ·) ones."""
    jcfg, cfg, jparams, _ = _lm(arch)
    _, jaxes = jtransformer.init_lm(jax.random.PRNGKey(0), jcfg)
    own, axes = transformer.init_lm(torch.Generator().manual_seed(0), cfg)
    assert axes == jaxes
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]  # noqa: E731
    assert sorted((jax.tree_util.keystr(p), tuple(a.shape))
                  for p, a in flat(own)) == \
        sorted((jax.tree_util.keystr(p), tuple(a.shape))
               for p, a in flat(jparams))
    assert own["layers"]["moe"]["router"].dtype == torch.float32
    assert "mlp" not in own["layers"]
    cache, caxes = transformer.init_cache(cfg, 3, 24, device="cpu")
    _, jcaxes = jtransformer.init_cache(jcfg, 3, 24)
    assert caxes == jcaxes
    validate_slot_layout(cfg)


def test_tree_from_reference_keeps_the_experts_layout():
    """compat transposes only a 4-D leaf named ``w``: the MoE's 4-D
    ``wi``/``wg``/``wo`` (L, E, d, ff) pass through untouched."""
    _, _, jparams, params = _lm("qwen3-moe-30b-a3b")
    for name in ("wi", "wg", "wo", "router"):
        want = np.asarray(jparams["layers"]["moe"][name])
        got = params["layers"]["moe"][name]
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    assert params["layers"]["moe"]["wi"].ndim == 4


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_and_loss_match_reference(arch):
    jcfg, cfg, jparams, params = _lm(arch)
    toks = _tokens(cfg, (2, 21), 1)
    targets = _tokens(cfg, (2, 21), 2)
    with torch.no_grad():
        logits, aux = transformer.forward(params, torch.from_numpy(toks), cfg)
        loss, metrics = get_family(cfg).loss(
            params, {"tokens": torch.from_numpy(toks),
                     "targets": torch.from_numpy(targets)}, cfg)
    jlogits, jaux = jtransformer.forward(jparams, jnp.asarray(toks), jcfg)
    jloss, jmetrics = j_get_family(jcfg).loss(
        jparams, {"tokens": jnp.asarray(toks),
                  "targets": jnp.asarray(targets)}, jcfg)
    assert logits.dtype == torch.float32 and float(aux) > 0.0
    _close(logits, jlogits, MODEL_TOL, "logits")
    _close(aux, jaux, MODEL_TOL, "aux")
    _close(loss, jloss, MODEL_TOL, "loss")
    _close(metrics["ce"], jmetrics["ce"], MODEL_TOL, "ce")
    _close(metrics["aux"], jmetrics["aux"], MODEL_TOL, "aux metric")
    assert float(metrics["acc"]) == pytest.approx(float(jmetrics["acc"]))


def _decode_all(family, params, cfg, toks, state):
    outs = []
    b = toks.shape[0]
    for t in range(toks.shape[1]):
        lg, state = family.decode(params, state, toks[:, t:t + 1],
                                  torch.full((b,), t), cfg)
        outs.append(lg[:, 0])
    return torch.stack(outs, dim=1), state


@pytest.mark.parametrize("n_tokens", [18, 40])
def test_decode_matches_forward(n_tokens):
    """mixtral SMOKE (window 16): 18 tokens as
    `test_decode_equivalence.py::test_decode_matches_forward`, 40 (the
    rolling buffer wraps twice) as `::test_rolling_window_cache_decode`;
    and each decode step against the reference's."""
    jcfg, cfg, jparams, params = _lm("mixtral-8x22b")
    family = get_family(cfg)
    b = 2 if n_tokens == 18 else 1
    toks = torch.from_numpy(_tokens(cfg, (b, n_tokens), 3))
    with torch.no_grad():
        ref, _ = transformer.forward(params, toks, cfg)
        state, _ = family.init_decode_state(cfg, b, 64, device="cpu")
        assert state["k"].shape[2] == cfg.sliding_window  # rolling buffer
        dec, state = _decode_all(family, params, cfg, toks, state)
    np.testing.assert_allclose(dec.numpy(), ref.numpy(), rtol=DECODE_RTOL,
                               atol=DECODE_ATOL)
    jstate, _ = j_get_family(jcfg).init_decode_state(jcfg, b, 64)
    jstep = jax.jit(functools.partial(jtransformer.decode_step, cfg=jcfg))
    jdec = []
    for t in range(n_tokens):
        lg, jstate = jstep(jparams, jstate,
                           jnp.asarray(toks[:, t:t + 1].numpy()),
                           jnp.full((b,), t, jnp.int32))
        jdec.append(np.asarray(lg[:, 0]))
    _close(dec, np.stack(jdec, 1), MODEL_TOL, "decode")
    _close(state["k"], jstate["k"], MODEL_TOL, "cache k")
    _close(state["v"], jstate["v"], MODEL_TOL, "cache v")
