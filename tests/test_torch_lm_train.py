"""The port's LM training path against the JAX reference, on the CPU at
small sizes: the differentiable WKV (`kernels/rwkv_wkv/ops.py`), the
RWKV-6 loss and train step (`models/families.py`, `train/step.py`), the
in-place optimizer update and the launcher (`launch/train.py`).

Inputs come from a seeded numpy generator; model weights are the
reference's, carried across by `repro_torch.compat`.  Tolerances:

* WKV in float32 (the port's `WKVFunction`, whose forward on CPU tensors
  is the plain twin, against ``jax.vjp`` of the reference's
  ``wkv(impl="pallas", interpret=True)``): every output and gradient
  within 1e-5 of its largest |value| (the same closed form, sums in
  another order).
* WKV in float64 (the closed form against autograd of the plain twin):
  within 1e-12 of the largest |value| (two derivations of one function).
* One train step in float64 on both sides (the reference under
  `jax.enable_x64`, ``wkv_impl="xla"``), as `tests/test_torch_train.py`
  holds the VWW step.  The model runs its WKV and its logits in float32
  in both frameworks (``.astype(float32)`` in the reference), so the step
  is float64 but there; their rounding, carried through the layers,
  moves the gradients far more than float64's own would.  Loss
  and metrics within 1e-6 relative, new params and moments within 1e-4
  of each leaf's largest |value|.  With int8 error feedback a gradient
  that lies at a half step may round to the other count: at most 1e-3
  of the elements may flip (the EF error then differs by about one
  step), and elsewhere the EF error agrees within 5e-2 of its largest
  |value| (it is under half a step, 1/254 of the gradient's largest).
* accum_steps=2 against the reference's scan of micro-batches, in
  float32 (the reference's accumulator is float32): the momentum
  buffer, the mean gradient, within 1e-4 of its largest |value|.
* The decay clip at an exact tie: gradients within 1e-4 of the largest
  |value|, float32 (through the GroupNorm, as the model's float32
  tolerance in `tests/test_torch_rwkv.py`).
* Remat and the in-place optimizer: bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.kernels.rwkv_wkv import ops as jops
from repro.models import rwkv6 as jrwkv6
from repro.models.families import get_family as j_get_family
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.train import make_train_step as j_make_train_step
from repro.train.state import TrainState as JTrainState
from repro_torch import compat
from repro_torch.common.pytree import flatten_with_names
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataPipeline, SyntheticLMDataset
from repro_torch.kernels.rwkv_wkv import ops
from repro_torch.launch import train as launch_train
from repro_torch.models import rwkv6
from repro_torch.models.families import cross_entropy, get_family
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.train import TrainState, make_train_step
from repro_torch.train.step import make_eval_step
from repro_torch.tree import tree_leaves, tree_map

WKV_TOL = 1e-5
WKV_F64_TOL = 1e-12
STEP_TOL = 1e-4
METRIC_RTOL = 1e-6
EF_TOL = 5e-2
FLIP_SHARE = 1e-3
TIE_TOL = 1e-4


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
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max() if got.size else 0.0
    scale = np.abs(want).max() if want.size else 0.0
    assert err <= tol * max(scale, 1e-30), \
        f"{what}: max abs err {err} of scale {scale}"


# ------------------------------------------------------------------ WKV


def _wkv_case(b, s, h, d, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    lw = -rng.uniform(1e-6, 5.0, (b, s, h, d)).astype(np.float32)
    ins = (f(b, s, h, d), f(b, s, h, d), f(b, s, h, d), lw, f(h, d) * 0.3,
           f(b, h, d, d) * 0.5)
    return ins, f(b, s, h, d), f(b, h, d, d)


#: (shape, with a dstate): a ragged tail with a nonzero state and dstate,
#: one whole chunk, and dstate None.
WKV_CASES = [((2, 37, 2, 16), True), ((2, 16, 2, 16), True),
             ((2, 37, 2, 16), False)]


def _port_grads(ins, dy, ds, dtype, impl="cuda"):
    live = [torch.from_numpy(a).to(dtype).requires_grad_() for a in ins]
    y, sf = ops.wkv(*live, impl=impl)
    outs, cots = [y], [torch.from_numpy(dy).to(dtype)]
    if ds is not None:
        outs.append(sf)
        cots.append(torch.from_numpy(ds).to(dtype))
    grads = torch.autograd.grad(outs, live, cots)
    return (y.detach(), sf.detach()), grads


@pytest.mark.parametrize("shape,with_dstate", WKV_CASES)
def test_wkv_function_matches_reference_vjp(shape, with_dstate):
    ins, dy, ds = _wkv_case(*shape)
    ds = ds if with_dstate else None
    (y, sf), grads = _port_grads(ins, dy, ds, torch.float32)
    (yj, sj), vjp = jax.vjp(
        lambda *a: jops.wkv(*a, impl="pallas", interpret=True),
        *map(jnp.asarray, ins))
    want = vjp((jnp.asarray(dy),
                jnp.asarray(ds) if with_dstate else jnp.zeros_like(sj)))
    _close(y.numpy(), yj, WKV_TOL, "y")
    _close(sf.numpy(), sj, WKV_TOL, "state")
    for name, g, w in zip(("dr", "dk", "dv", "dlw", "du", "dstate0"),
                          grads, want):
        _close(g.numpy(), w, WKV_TOL, name)


@pytest.mark.parametrize("shape,with_dstate", WKV_CASES)
def test_wkv_function_matches_autograd_of_plain_twin_f64(shape, with_dstate):
    ins, dy, ds = _wkv_case(*shape, seed=1)
    ds = ds if with_dstate else None
    (y, sf), grads = _port_grads(ins, dy, ds, torch.float64)
    (yp, sp), want = _port_grads(ins, dy, ds, torch.float64, impl="plain")
    assert torch.equal(y, yp) and torch.equal(sf, sp)
    for name, g, w in zip(("dr", "dk", "dv", "dlw", "du", "dstate0"),
                          grads, want):
        _close(g.numpy(), w.numpy(), WKV_F64_TOL, name)


def test_wkv_backward_of_an_empty_sequence():
    ins, _, ds = _wkv_case(2, 0, 2, 8)
    grads = ops.wkv_backward(*map(torch.from_numpy, ins), None,
                             torch.from_numpy(ds))
    assert all(float(g.abs().sum()) == 0 for g in grads[:5])
    assert torch.equal(grads[5], torch.from_numpy(ds))


# ------------------------------------------------------------------ model


@pytest.fixture(scope="module")
def lm():
    jcfg = j_get_smoke_config("rwkv6-3b").replace(dtype=jnp.float32,
                                                  wkv_impl="xla")
    cfg = get_smoke_config("rwkv6-3b").replace(dtype=torch.float32)
    jparams, _ = j_get_family(jcfg).init(jax.random.PRNGKey(0), jcfg)
    jparams = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, compat.tree_from_reference(jparams,
                                                          device="cpu")


def _batch(vocab, seq=20, batch=4, step=0):
    return SyntheticLMDataset(vocab=vocab, seq_len=seq, batch=batch,
                              seed=3).batch_at(step)


def _tensors(batch):
    """A numpy batch placed on the CPU, as the train step takes it."""
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_loss_matches_reference(lm):
    jcfg, cfg, jparams, params = lm
    batch = _batch(cfg.vocab)
    with torch.no_grad():
        loss, metrics = get_family(cfg).loss(
            params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    jloss, jmetrics = j_get_family(jcfg).loss(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(metrics["acc"]) == float(jmetrics["acc"])
    assert set(metrics) == set(jmetrics) == {"ce", "aux", "acc"}


def test_cross_entropy_with_mask_matches_reference():
    from repro.models.families import cross_entropy as j_cross_entropy

    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    targets = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32)
    for m in (mask, None, np.zeros_like(mask)):
        got = cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(targets),
                            None if m is None else torch.from_numpy(m))
        want = j_cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                               None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_accuracy_takes_the_first_index_at_ties():
    from repro.models.families import _accuracy as j_accuracy
    from repro_torch.models.families import _accuracy

    logits = np.zeros((1, 3, 4), np.float32)
    logits[0, 1, [1, 3]] = 1.0  # a tie between 1 and 3
    targets = np.array([[0, 1, 3]], np.int32)
    got = float(_accuracy(torch.from_numpy(logits), torch.from_numpy(targets)))
    assert got == float(j_accuracy(jnp.asarray(logits), jnp.asarray(targets)))
    assert got == pytest.approx(2 / 3)


#: float32 ω whose exp is exactly 5.0 in both frameworks: −exp(ω) lands
#: on LOG_DECAY_MIN.
OMEGA_AT_THE_BOUND = np.float32(1.609438)


def test_decay_clip_tie_gradient_matches_reference(lm, monkeypatch):
    """`_time_mix` with −exp(ω) exactly on ``LOG_DECAY_MIN`` at half the
    channels (``w_lora_b`` = 0, so ω = w0): the gradient to ``w0`` is the
    reference's, half the upstream one at the tie, where `torch.clamp`
    would pass all of it."""
    jcfg, cfg, jparams, params = lm
    assert float(torch.exp(torch.tensor(OMEGA_AT_THE_BOUND))) == 5.0
    assert float(jnp.exp(jnp.asarray(OMEGA_AT_THE_BOUND))) == 5.0
    jp = jax.tree.map(lambda a: np.array(a[0]), jparams["layers"]["att"])
    jp["w_lora_b"] = np.zeros_like(jp["w_lora_b"])
    w0 = np.array(jp["w0"])
    w0.reshape(-1)[::2] = OMEGA_AT_THE_BOUND
    jp["w0"] = w0
    rng = np.random.default_rng(6)
    b, s, d = 2, 20, cfg.d_model
    h, hd = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    prev = rng.standard_normal((b, d)).astype(np.float32)
    cot = rng.standard_normal((b, s, d)).astype(np.float32)
    st = np.zeros((b, h, hd, hd), np.float32)

    def j_out(w0_):
        p = dict(jp, w0=w0_)
        out, _, _ = jrwkv6._time_mix(p, jnp.asarray(x), jnp.asarray(prev),
                                     jnp.asarray(st), jcfg)
        return jnp.sum(out * cot)

    want = np.asarray(jax.grad(j_out)(jnp.asarray(w0)))

    def port_grad():
        p = compat.tree_from_reference(jp, device="cpu")
        p["w0"].requires_grad_()
        out, _, _ = rwkv6._time_mix(p, torch.from_numpy(x),
                                    torch.from_numpy(prev),
                                    torch.from_numpy(st), cfg)
        return torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                   p["w0"])[0].numpy()

    got = port_grad()
    _close(got, want, TIE_TOL, "dw0")
    tie = np.zeros(w0.size, bool)
    tie[::2] = True
    assert np.abs(want.reshape(-1)[tie]).max() > 0
    # the check sees the fault it guards: torch.clamp passes the whole
    # gradient at the tie
    monkeypatch.setattr(rwkv6, "clip", torch.clamp)
    clamped = port_grad()
    np.testing.assert_allclose(clamped.reshape(-1)[tie],
                               2 * got.reshape(-1)[tie], rtol=1e-6)
    with pytest.raises(AssertionError):
        _close(clamped, want, TIE_TOL, "dw0 through torch.clamp")


def _live_grads(params, batch, cfg):
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    from repro_torch.tree import tree_unflatten

    loss, _ = get_family(cfg).loss(tree_unflatten(params, live), batch, cfg)
    return torch.autograd.grad(loss, live)


def test_remat_gives_the_same_gradient_bits(lm):
    _, cfg, _, params = lm
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab).items()}
    with_remat = _live_grads(params, batch, cfg.replace(remat=True))
    without = _live_grads(params, batch, cfg.replace(remat=False))
    assert all(torch.equal(a, b) for a, b in zip(with_remat, without))
    assert any(float(g.abs().max()) > 0 for g in with_remat)


def test_remat_recomputes_each_layer_once(lm, monkeypatch):
    """A backward with remat runs each layer's WKV forward twice (once in
    the forward, once in the recompute), without remat once."""
    _, cfg, _, params = lm
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab).items()}
    calls = []
    real = ops.wkv_fused

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ops, "wkv_fused", counting)
    for remat, want in ((True, 2 * cfg.n_layers), (False, cfg.n_layers)):
        calls.clear()
        _live_grads(params, batch, cfg.replace(remat=remat))
        assert len(calls) == want


# ------------------------------------------------------------------ the step


def _f64_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _to_port(tree, dtype=torch.float64):
    return tree_map(lambda t: t.to(dtype),
                    compat.tree_from_reference(tree, device="cpu"))


@pytest.mark.parametrize("compression", [None, "int8_ef"])
def test_train_step_matches_reference_f64(lm, compression):
    """One AdamW step with clipping (from step 3, nonzero moments), and
    with int8 error feedback, in float64 on both sides."""
    jcfg, cfg, jparams, _ = lm
    rng = np.random.default_rng(7)
    moments = {name: jax.tree.map(
        lambda p: (scale * rng.standard_normal(np.shape(p))).astype(
            np.float32), jparams)
        for name, scale in (("m", 0.01), ("v", 0.0))}
    moments["v"] = jax.tree.map(lambda p: (1e-4 * rng.random(np.shape(p))
                                           ).astype(np.float32), jparams)
    extras = None
    if compression:
        extras = {"ef_error": jax.tree.map(
            lambda p: (1e-3 * rng.standard_normal(np.shape(p))).astype(
                np.float32), jparams)}
    batch = _batch(cfg.vocab, seq=20, batch=4, step=1)
    sched = (jsched.cosine_warmup(3e-3, 2, 50), tsched.cosine_warmup(3e-3, 2, 50))

    with jax.enable_x64(True):
        jc = jcfg.replace(dtype=jnp.float64)
        jstate = JTrainState(_f64_tree(jparams), moments, step=3,
                             extras=extras)
        jstep = jax.jit(j_make_train_step(jc, jopt.adamw(sched[0]),
                                          grad_compression=compression))
        jnew, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        jnew = jax.tree.map(np.asarray, jnew)
        jm = {k: float(v) for k, v in jm.items()}

    tc = cfg.replace(dtype=torch.float64)
    state = TrainState(_to_port(jparams),
                       {k: _to_port(v, torch.float32)
                        for k, v in moments.items()},
                       step=3,
                       extras=None if extras is None else
                       {"ef_error": _to_port(extras["ef_error"],
                                             torch.float32)})
    given = state
    state, m = make_train_step(tc, topt.adamw(sched[1]),
                               grad_compression=compression)(
                                   state, _tensors(batch))
    assert state is given and state["step"] == 4 == int(jnew["step"])
    assert set(m) == set(jm)
    for key in jm:
        np.testing.assert_allclose(float(m[key]), jm[key], rtol=METRIC_RTOL,
                                   atol=1e-12, err_msg=key)
    got, want = ({k: dict(flatten_with_names(t[k]))
                  for k in ("params", "opt", "extras") if k in t}
                 for t in (state, _to_port_exact(jnew)))
    flipped, total = {}, 0
    if compression:
        for name, w in want["extras"].items():
            g = got["extras"][name]
            far = (g - w).abs() > EF_TOL * w.abs().max()
            flipped[name.removeprefix("ef_error.")] = far
            total += w.numel()
        n_flips = sum(int(f.sum()) for f in flipped.values())
        assert n_flips <= FLIP_SHARE * total, f"{n_flips} of {total} flipped"
    for key in ("params", "opt"):
        for name, w in want[key].items():
            leaf = name if key == "params" else name.split(".", 1)[1]
            keep = ~flipped.get(leaf, torch.zeros(w.shape, dtype=torch.bool))
            err = float((got[key][name] - w).abs()[keep].max())
            assert err <= STEP_TOL * float(w.abs().max()), (key, name, err)


def _to_port_exact(tree):
    """The reference's float64 results as float64 tensors, not through
    float32 as `compat` carries weights."""
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float64)),
                        tree)


def test_grad_accumulation_equivalence(lm):
    """accum_steps=2 over a 2×batch equals the whole batch at once (the
    mean of two half-batch gradients), as
    `tests/test_system.py::test_grad_accumulation_equivalence` holds the
    reference."""
    _, cfg, _, params = lm
    opt = topt.sgd(tsched.constant(1e-2), momentum=0.0)
    batch = _batch(cfg.vocab, seq=16, batch=8)
    outs = []
    for accum in (1, 2):
        p = tree_map(torch.clone, params)
        state = TrainState(p, opt.init(p))
        state, m = make_train_step(cfg, opt, accum_steps=accum)(
            state, _tensors(batch))
        outs.append((state, m))
    diff = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(outs[0][0]["params"]), tree_leaves(outs[1][0]["params"])))
    assert diff < 1e-5
    np.testing.assert_allclose(float(outs[0][1]["loss"]),
                               float(outs[1][1]["loss"]), rtol=1e-5)
    assert set(outs[1][1]) == {"loss"}


def test_accumulated_step_matches_reference(lm):
    """accum_steps=2 against the reference's scan of micro-batches, in
    float32: the loss and the momentum buffer (one step from zero
    momentum, so the mean gradient)."""
    jcfg, cfg, jparams, params = lm
    batch = _batch(cfg.vocab, seq=16, batch=4, step=2)
    jo = jopt.sgd(jsched.constant(1e-2), momentum=0.9)
    jnew, jm = jax.jit(j_make_train_step(jcfg, jo, accum_steps=2))(
        JTrainState(jparams, jo.init(jparams)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    opt = topt.sgd(tsched.constant(1e-2), momentum=0.9)
    p = tree_map(torch.clone, params)
    state, m = make_train_step(cfg, opt, accum_steps=2)(
        TrainState(p, opt.init(p)), _tensors(batch))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=METRIC_RTOL)
    want = compat.tree_from_reference(jax.tree.map(np.asarray,
                                                   jnew["opt"]["mu"]),
                                      device="cpu")
    tree_map(lambda g, w: _close(g.numpy(), w.numpy(), STEP_TOL, "mu"),
             state["opt"]["mu"], want)


def test_eval_step_matches_the_loss(lm):
    _, cfg, _, params = lm
    batch = _batch(cfg.vocab)
    metrics = make_eval_step(cfg)(params, _tensors(batch))
    loss, _ = get_family(cfg).loss(params, _tensors(batch), cfg)
    assert float(metrics["loss"]) == float(loss)
    assert not metrics["loss"].requires_grad


def test_lm_training_loss_decreases():
    """40 AdamW steps from the port's own init, as
    `tests/test_system.py::test_lm_training_loss_decreases` trains the
    reference's dense LM."""
    cfg = get_smoke_config("rwkv6-3b").replace(dtype=torch.float32)
    fam = get_family(cfg)
    params, _ = fam.init(torch.Generator().manual_seed(0), cfg)
    opt = topt.adamw(tsched.constant(3e-3), weight_decay=0.0)
    state = TrainState(params, opt.init(params))
    step = make_train_step(cfg, opt)
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=32, batch=8)
    losses = []
    for i in range(40):
        state, m = step(state, _tensors(ds.batch_at(i)))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < 0.8 * np.mean(losses[:5])


# ------------------------------------------------------------------ optimizer


def _opt_trees(seed):
    rng = np.random.default_rng(seed)

    def tree():
        return {"w": torch.from_numpy(rng.standard_normal((6, 5)).astype(
                    np.float32)),
                "sub": {"b": torch.from_numpy(rng.standard_normal(7).astype(
                    np.float32)),
                        "z": torch.from_numpy(rng.standard_normal(
                            (2, 3, 4)).astype(np.float32))}}

    return tree(), [tree() for _ in range(3)]


@pytest.mark.parametrize("name,clip", [("sgd", None), ("sgd", 0.5),
                                       ("adamw", None), ("adamw", 1.0)])
def test_in_place_update_equals_functional_bit_for_bit(name, clip):
    """Three steps of ``update_in_place`` against ``update`` from the same
    state; a clip small enough to bind, a schedule that changes.
    ``update`` leaves the grads, state and params it is given as they
    were; ``update_in_place`` writes the same tensors."""
    sched = tsched.cosine_warmup(0.05, 1, 4)
    opt = (topt.sgd(sched, momentum=0.9, clip_norm=clip, weight_decay=1e-3)
           if name == "sgd" else
           topt.adamw(sched, clip_norm=clip, weight_decay=0.1))
    params, grads = _opt_trees(8)
    fp, fs = params, opt.init(params)
    ip, ist = tree_map(torch.clone, params), opt.init(params)
    leaves = tree_leaves(ip)
    for step, g in enumerate(grads):
        given = [tree_map(torch.clone, t) for t in (g, fs, fp)]
        new_p, new_s = opt.update(g, fs, fp, step)
        for was, now in zip(given, (g, fs, fp)):
            assert all(torch.equal(a, b) for a, b in
                       zip(tree_leaves(was), tree_leaves(now)))
        fp, fs = new_p, new_s
        opt.update_in_place(tree_map(torch.clone, g), ist, ip, step)
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(fp), tree_leaves(ip)))
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(fs), tree_leaves(ist)))
    # the same tensors, written in place
    assert all(a is b for a, b in zip(leaves, tree_leaves(ip)))


def test_in_place_clip_scales_the_grads_it_is_given():
    _, grads = _opt_trees(9)
    g = grads[0]
    want, norm = topt.clip_by_global_norm(g, 0.5)
    got_norm = topt.clip_by_global_norm_(g, 0.5)
    assert torch.equal(norm, got_norm) and float(norm) > 0.5
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(g), tree_leaves(want)))


# ------------------------------------------------------------------ launcher


def test_launcher_trains_on_the_cpu(capsys):
    trainer = launch_train.main(["--arch", "rwkv6-3b", "--smoke", "--device",
                                 "cpu", "--steps", "3", "--batch", "2",
                                 "--seq", "24"])
    assert trainer.state["step"] == 3 and len(trainer.history) == 3
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    assert "final: {" in capsys.readouterr().out
    assert tree_leaves(trainer.state["params"])[0].device.type == "cpu"


def test_launcher_resumes_bit_exact(tmp_path):
    """4 steps with checkpoints, then a fresh run that restores and takes
    2 more: the losses equal an uninterrupted 6-step run's (all inside
    the warmup, so the schedule does not depend on --steps)."""
    base = ["--arch", "rwkv6-3b", "--smoke", "--device", "cpu", "--batch",
            "2", "--seq", "24"]
    whole = launch_train.main(base + ["--steps", "6"])
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    first = launch_train.main(base + ck + ["--steps", "4"])
    second = launch_train.main(base + ck + ["--steps", "2"])
    assert second.state["step"] == 6
    losses = [h["loss"] for h in first.history + second.history]
    assert losses == [h["loss"] for h in whole.history]


def test_launcher_refuses_model_parallel_and_a_missing_gpu():
    """``--model-parallel 2 --world 2`` trains under the plan (two gloo
    ranks, the RWKV heads and the vocab split over them) and its losses
    match ``--model-parallel 1``'s; each rank's leaves have the plan's
    shard shapes.  A ``--model-parallel`` that does not divide
    ``--world`` is refused, and so is a run with no GPU to default to."""
    base = ["--arch", "rwkv6-3b", "--smoke", "--device", "cpu", "--steps",
            "3", "--batch", "2", "--seq", "16"]
    single = [h["loss"] for h in launch_train.main(base).history]
    ranks = launch_train.main(base + ["--model-parallel", "2", "--world",
                                      "2"])
    assert len(ranks) == 2
    for res in ranks:
        assert res["step"] == 3
        np.testing.assert_allclose([h["loss"] for h in res["history"]],
                                   single, rtol=1e-5)
        assert all(local == want for local, want in res["shapes"].values())
        assert res["shapes"]["params/embed/table"][0] == (256, 64)
    with pytest.raises(SystemExit, match="must divide --world"):
        launch_train.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu",
                           "--model-parallel", "2", "--world", "3"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_train.main(["--arch", "rwkv6-3b", "--smoke", "--steps",
                               "1"])


def test_int8_ef_launcher_keeps_the_accumulator(tmp_path):
    trainer = launch_train.main(["--arch", "rwkv6-3b", "--smoke", "--device",
                                 "cpu", "--steps", "2", "--batch", "2",
                                 "--seq", "16", "--grad-compression",
                                 "int8_ef", "--ckpt-dir", str(tmp_path)])
    err = tree_leaves(trainer.state["extras"]["ef_error"])
    assert any(float(e.abs().max()) > 0 for e in err)


def test_pipeline_places_batches_on_the_device():
    ds = SyntheticLMDataset(vocab=64, seq_len=8, batch=2)
    pipe = DataPipeline(ds, prefetch=1, device="cpu")
    batch = next(pipe)
    pipe.close()
    assert isinstance(batch["tokens"], torch.Tensor)
    np.testing.assert_array_equal(batch["tokens"].numpy(),
                                  ds.batch_at(0)["tokens"])


def test_lm_train_state_from_reference(lm):
    jcfg, _, jparams, params = lm
    jo = jopt.adamw(jsched.constant(1e-3))
    jstate = jax.tree.map(np.asarray, JTrainState(jparams, jo.init(jparams),
                                                  step=5))
    state = compat.train_state_from_reference(jstate, device="cpu")
    assert set(state) == {"params", "opt", "step"} and state["step"] == 5
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(state["params"]), tree_leaves(params)))
    assert set(state["opt"]) == {"m", "v"}
