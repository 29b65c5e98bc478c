"""The port's training path against the JAX reference, on the CPU.

* MobileNetV2 ``train=True``: logits and the new BN state (batch mean and
  population variance, ``0.9·old + 0.1·batch``) for both variants, the
  backbone in float64 (see `test_train_step_matches_reference`);
* the functional optimizers (`sgd`, `adamw`, clipping), the LR schedules
  and int8 error-feedback compression over three steps on random trees;
* a whole VWW train state carried across (`compat.train_state_from_reference`);
* one step of `make_vww_train_step` against the reference's step: loss,
  accuracy, new params, BN state and momentum (in float64, for the
  reasons `test_train_step_matches_reference` gives);
* a port-native run of 80 steps at 40² that ends above chance, as
  `tests/test_system.py::test_p2m_vww_trains_above_chance` does for the
  reference.

Weights and data are the reference's, carried across by
`repro_torch.compat` or drawn with numpy from a seed.  Tolerance rtol
1e-4 / atol 1e-5 (fp32 through a few dozen convs whose sums run in
another order); the step is compared at one step only, since the clip
nonlinearities amplify float noise over more.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mobilenetv2 as jm
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.train import compression as jcomp
from repro.train import vision as jvision
from repro_torch import compat
from repro_torch.data import SyntheticVWW
from repro_torch.models import mobilenetv2 as tm
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.train import compression as tcomp
from repro_torch.train import vision as tvision
from repro_torch.tree import tree_leaves, tree_map

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These shapes are small: one intra-op thread runs them about ten
    times faster than eight, and the suite's parallel workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(got, ref, rtol=RTOL, atol=ATOL):
    """``got`` a port tree, ``ref`` the reference's tree in the port's
    layout (`compat.tree_from_reference`)."""
    tree_map(lambda g, r: np.testing.assert_allclose(
        g.detach().numpy(), r.numpy(), rtol=rtol, atol=atol), got, ref)


def _cfgs(variant, size=40, width=0.25, head=32):
    return (jm.MNV2Config(variant=variant, image_size=size, width=width,
                          head_channels=head),
            tm.MNV2Config(variant=variant, image_size=size, width=width,
                          head_channels=head))


def _model(jcfg, seed=0):
    params, state = jm.init_mnv2(jax.random.PRNGKey(seed), jcfg)
    # non-trivial running statistics, so that the momentum update shows
    rng = np.random.default_rng(seed)
    state = jax.tree.map(lambda x: np.asarray(x) + rng.uniform(
        0.0, 0.2, np.shape(x)).astype(np.float32), state)
    return _np(params), state


# ------------------------------------------------------------ model


def _f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


def test_train_mode_logits_and_bn_state_match_reference():
    """Baseline variant, whole model, in float64 on both sides (see
    `test_train_step_matches_reference` for why not float32)."""
    jcfg, tcfg = _cfgs("baseline")
    params, state = map(_f64, _model(jcfg))
    imgs = np.random.default_rng(1).random((8, 40, 40, 3))
    with jax.enable_x64(True):
        ref_logits, ref_state = _np(jax.jit(lambda p, s, x: jm.apply_mnv2(
            p, s, x, jcfg, train=True))(params, state, imgs))
    logits, new_state = tm.apply_mnv2(_port(params, torch.float64),
                                      _port(state, torch.float64),
                                      torch.from_numpy(imgs), tcfg,
                                      train=True)
    np.testing.assert_allclose(logits.detach().numpy(), ref_logits,
                               rtol=RTOL, atol=ATOL)
    _assert_tree_close(new_state, _port(ref_state, torch.float64))
    assert not any(t.requires_grad for t in tree_leaves(new_state))


def test_p2m_train_mode_stem_and_backbone_match_reference():
    """P²M variant: the stem's train form in float32 (its working type on
    both sides), then the backbone and head in float64 on the reference's
    stem activations, so that the stem's float32 rounding is not
    amplified by the backbone's batch statistics (over 8 values per
    channel at the 1x1 tail), which alone moves the logits by 5e-6."""
    jcfg, tcfg = _cfgs("p2m")
    params, state = _model(jcfg)
    imgs = np.random.default_rng(1).random((8, 40, 40, 3)).astype(np.float32)
    ref_stem, ref_stem_state = _np(jax.jit(lambda p, s, x: jm.apply_mnv2_stem(
        p, s, x, jcfg, train=True))(params, state, imgs))
    stem, stem_state = tm.apply_mnv2_stem(_port(params), _port(state),
                                          torch.from_numpy(imgs), tcfg,
                                          train=True)
    tol = dict(rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(stem.detach().numpy(), ref_stem, **tol)
    _assert_tree_close(stem_state, _port(ref_stem_state))

    params, state, x = _f64(params), _f64(state), ref_stem.astype(np.float64)

    def j_rest(p, s, x):
        feats, new_s = jm.apply_mnv2_backbone(p, s, x, jcfg, train=True)
        return feats.mean(axis=(1, 2)) @ p["fc"]["w"] + p["fc"]["b"], new_s

    with jax.enable_x64(True):
        ref_logits, ref_state = _np(jax.jit(j_rest)(params, state, x))
    tp = _port(params, torch.float64)
    feats, new_state = tm.apply_mnv2_backbone(
        tp, _port(state, torch.float64), torch.from_numpy(x), tcfg,
        train=True)
    logits = feats.mean(dim=(1, 2)) @ tp["fc"]["w"] + tp["fc"]["b"]
    np.testing.assert_allclose(logits.detach().numpy(), ref_logits, **tol)
    _assert_tree_close(new_state, _port(ref_state, torch.float64))


# ------------------------------------------------------------ optimizers


def _random_tree(rng, scale=1.0):
    return {"a": {"w": (rng.standard_normal((3, 4)) * scale).astype(
                np.float32),
                  "b": (rng.standard_normal(4) * scale).astype(np.float32)},
            "c": (rng.standard_normal((2, 2, 3)) * scale).astype(np.float32)}


def _to_t(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


OPTIMIZERS = {
    "sgd": (lambda m: m.sgd(m_sched(m).step_decay(0.1, (1, 2)),
                            momentum=0.9)),
    "sgd_wd_clip": (lambda m: m.sgd(m_sched(m).constant(0.05), momentum=0.8,
                                    clip_norm=0.5, weight_decay=0.01)),
    "adamw": (lambda m: m.adamw(m_sched(m).cosine_warmup(0.01, 1, 3),
                                weight_decay=0.1, clip_norm=1.0)),
    "adamw_noclip": (lambda m: m.adamw(m_sched(m).constant(3e-3),
                                       clip_norm=None)),
}


def m_sched(mod):
    return jsched if mod is jopt else tsched


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizers_match_reference_over_three_steps(name):
    rng = np.random.default_rng(0)
    params = _random_tree(rng)
    jo, to = OPTIMIZERS[name](jopt), OPTIMIZERS[name](topt)
    jp, js = jax.tree.map(jnp.asarray, params), None
    tp = _to_t(params)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        grads = _random_tree(rng, scale=2.0)
        jp, js = jo.update(jax.tree.map(jnp.asarray, grads), js, jp,
                           jnp.asarray(step, jnp.int32))
        tp, ts = to.update(_to_t(grads), ts, tp, step)
    _assert_tree_close(tp, _to_t(_np(jp)), rtol=1e-6, atol=1e-7)
    _assert_tree_close(ts, _to_t(_np(js)), rtol=1e-6, atol=1e-7)


def test_global_norm_and_clipping_match_reference():
    rng = np.random.default_rng(1)
    tree = _random_tree(rng, scale=3.0)
    ref = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 1.5)
    got = topt.clip_by_global_norm(_to_t(tree), 1.5)
    np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-6)
    np.testing.assert_allclose(float(topt.global_norm(_to_t(tree))),
                               float(jopt.global_norm(tree)), rtol=1e-6)
    _assert_tree_close(got[0], _to_t(_np(ref[0])), rtol=1e-6, atol=1e-7)
    small = _random_tree(rng, scale=1e-3)  # under the limit: unchanged
    _assert_tree_close(topt.clip_by_global_norm(_to_t(small), 1.5)[0],
                       _to_t(small), rtol=0, atol=0)


@pytest.mark.parametrize("sched", ["constant", "step_decay", "cosine_warmup"])
def test_schedules_match_reference(sched):
    make = {
        "constant": lambda m: m.constant(0.05),
        "step_decay": lambda m: m.step_decay(0.1, (3, 7, 9), factor=0.2),
        "cosine_warmup": lambda m: m.cosine_warmup(0.01, 4, 20, floor=0.1),
    }[sched]
    jfn, tfn = make(jsched), make(tsched)
    for step in range(25):
        got = tfn(step)
        assert isinstance(got, float)
        # float32 on both sides; numpy's and XLA's cos may differ by an ulp
        np.testing.assert_allclose(got, float(jfn(jnp.asarray(
            step, jnp.int32))), rtol=2.5e-7, atol=0, err_msg=str(step))


def test_int8_ef_matches_reference_over_three_steps():
    rng = np.random.default_rng(2)
    jerr, terr = None, None
    for _ in range(3):
        grads = _random_tree(rng, scale=0.3)
        jdeq, jerr = jcomp.compress_grads_int8_ef(
            jax.tree.map(jnp.asarray, grads), jerr)
        tdeq, terr = tcomp.compress_grads_int8_ef(_to_t(grads), terr)
        _assert_tree_close(tdeq, _to_t(_np(jdeq)), rtol=0, atol=1e-7)
        _assert_tree_close(terr, _to_t(_np(jerr)), rtol=0, atol=1e-7)


# ------------------------------------------------------------ train state


@pytest.mark.parametrize("opt_name,compression",
                         [("sgd", None), ("adamw", "int8_ef")])
def test_train_state_carries_across(opt_name, compression):
    jcfg, _ = _cfgs("p2m")
    params, bn = _model(jcfg)
    jo = (jopt.sgd(jsched.constant(0.1)) if opt_name == "sgd"
          else jopt.adamw(jsched.constant(0.1)))
    rng = np.random.default_rng(3)
    opt_state = jax.tree.map(lambda p: rng.standard_normal(np.shape(p)).astype(
        np.float32), _np(jo.init(params)))
    state = _np(jvision.vww_train_state(params, bn, opt_state, step=5,
                                        grad_compression=compression))
    got = compat.train_state_from_reference(state, device="cpu")
    assert got["step"] == 5 and isinstance(got["step"], int)
    assert set(got) == set(state)
    # the optimizer state and the EF accumulator mirror the parameters
    # and take their layouts
    for sub in got["opt"].values():
        assert tree_map(lambda t: tuple(t.shape), sub) == tree_map(
            lambda t: tuple(t.shape), got["params"])
    if compression:
        assert tree_map(lambda t: tuple(t.shape),
                        got["extras"]["ef_error"]) == tree_map(
            lambda t: tuple(t.shape), got["params"])
    stem = got["params"]["block1"]["dw"]["w"]
    ref_stem = state["params"]["block1"]["dw"]["w"]  # HWIO (3, 3, 1, C)
    np.testing.assert_array_equal(stem.numpy(),
                                  np.transpose(ref_stem, (3, 2, 0, 1)))


def test_vww_train_state_structure():
    params, bn = tm.init_mnv2(torch.Generator().manual_seed(0),
                              _cfgs("p2m")[1], device="cpu")
    opt = topt.sgd(tsched.constant(0.1))
    plain = tvision.vww_train_state(params, bn, opt.init(params))
    assert set(plain) == {"params", "bn", "opt", "step"}
    ef = tvision.vww_train_state(params, bn, opt.init(params),
                                 grad_compression="int8_ef")
    assert all(float(t.abs().sum()) == 0.0
               for t in tree_leaves(ef["extras"]["ef_error"]))
    with pytest.raises(ValueError, match="grad_compression"):
        tvision.vww_train_state(params, bn, {}, grad_compression="fp4")


# ------------------------------------------------------------ the step


def _step_inputs(jcfg, dtype):
    params, bn = _model(jcfg)
    cast = lambda t: jax.tree.map(lambda x: np.asarray(x, dtype), t)  # noqa: E731
    # uniform noise: the smooth SyntheticVWW frames leave the tail's batch
    # statistics closer together, and float32 rounding then moves the P²M
    # variant's deepest BN state by 2e-4
    rng = np.random.default_rng(4)
    batch = {"images": rng.random((8, 40, 40, 3)).astype(dtype),
             "labels": rng.integers(0, 2, 8).astype(np.int32)}
    # non-zero momentum, so that the buffer's update shows
    mu = jax.tree.map(lambda p: (0.01 * rng.standard_normal(np.shape(p))
                                 ).astype(np.float32), params)
    return cast(params), cast(bn), mu, batch


def _steps(variant, dtype):
    """(reference's new state and metrics, port's), one SGD step from the
    same state and batch, the reference's under `jax.enable_x64` for
    float64."""
    jcfg, tcfg = _cfgs(variant)
    params, bn, mu, batch = _step_inputs(jcfg, dtype)
    jo = jopt.sgd(jsched.step_decay(0.05, (10,)), momentum=0.9)
    with jax.enable_x64(dtype == np.float64):
        jstate = jvision.vww_train_state(params, bn, {"mu": mu}, step=0)
        ref = _np(jax.jit(jvision.make_vww_train_step(jcfg, jo))(jstate,
                                                                 batch))
    tdtype = getattr(torch, np.dtype(dtype).name)
    tstate = {"params": _port(params, tdtype), "bn": _port(bn, tdtype),
              "opt": {"mu": _port(mu)}, "step": 0}
    to = topt.sgd(tsched.step_decay(0.05, (10,)), momentum=0.9)
    return ref, tvision.make_vww_train_step(tcfg, to)(tstate, batch)


def _port(tree, dtype=torch.float32):
    """The reference's tree in the port's layout, as ``dtype`` (float64
    results pass through float32 there, within the stated tolerance)."""
    return tree_map(lambda t: t.to(dtype),
                    compat.tree_from_reference(tree, device="cpu"))


def test_train_step_matches_reference():
    """The whole step, baseline variant, in float64 on both sides: loss,
    accuracy, new params, BN state, momentum and step.

    In float32 a one-step gradient of this network in train mode is
    dominated by rounding: BN on batch statistics over 8 values per
    channel at the 1x1 tail amplifies it by 1e3 to 1e6, and at 40² the
    port's own float32 and float64 gradients differ by up to 0.3 where
    they reach 18 (the reference's by as much).  The P²M variant cannot
    run in float64: its stem conv is float32 by design on both sides, and
    that rounding alone moves its gradient by 1e-3.  Its stem is held to
    the reference's in `test_torch_backward.py` (train form, gradients),
    its forward in `test_p2m_train_mode_stem_and_backbone_match_reference`.
    """
    (ref_state, ref_m), (new_state, m) = _steps("baseline", np.float64)
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                               rtol=RTOL, atol=ATOL)
    assert float(m["acc"]) == float(ref_m["acc"])
    assert new_state["step"] == 1 and int(ref_state["step"]) == 1
    _assert_tree_close(new_state["params"],
                       _port(ref_state["params"], torch.float64))
    _assert_tree_close(new_state["bn"], _port(ref_state["bn"], torch.float64))
    _assert_tree_close(new_state["opt"], _port(ref_state["opt"]))
    assert new_state["opt"]["mu"]["fc"]["w"].dtype == torch.float32


def test_int8_ef_step_is_the_composition_of_its_parts():
    _, tcfg = _cfgs("p2m")
    params, bn = tm.init_mnv2(torch.Generator().manual_seed(1), tcfg,
                              device="cpu")
    opt = topt.sgd(tsched.constant(0.05), momentum=0.9)
    state = tvision.vww_train_state(params, bn, opt.init(params),
                                    grad_compression="int8_ef")
    batch = SyntheticVWW(image_size=40, batch=8, seed=1).batch_at(0)
    new_state, _ = tvision.make_vww_train_step(
        tcfg, opt, grad_compression="int8_ef")(state, batch)
    _, _, grads, _ = tvision.vww_value_and_grad(params, bn, batch, tcfg)
    deq, err = tcomp.compress_grads_int8_ef(grads, state["extras"]["ef_error"])
    want, _ = opt.update(deq, state["opt"], params, 0)
    _assert_tree_close(new_state["params"], want, rtol=0, atol=0)
    _assert_tree_close(new_state["extras"]["ef_error"], err, rtol=0, atol=0)


def test_port_native_training_beats_chance():
    """80 steps of the paper's optimizer from the port's own init, as
    `tests/test_system.py` trains the reference: the loss falls and the
    held-out accuracy ends above chance.  The task leaves chance only
    after 60 to 80 steps: over init seeds 0 to 5, 80 steps end at eval
    accuracies 0.52, 0.66, 0.61, 0.57, 0.68 and 0.63 (seed 0 has not left
    chance yet); the reference's seed-0 run ends at 0.60."""
    _, tcfg = _cfgs("p2m")
    params, bn = tm.init_mnv2(torch.Generator().manual_seed(1), tcfg,
                              device="cpu")
    opt = topt.sgd(tsched.constant(0.05), momentum=0.9)  # paper's optimizer
    state = tvision.vww_train_state(params, bn, opt.init(params))
    step = tvision.make_vww_train_step(tcfg, opt)
    ds = SyntheticVWW(image_size=40, batch=32, seed=1)
    losses = []
    for i in range(80):
        state, m = step(state, ds.batch_at(i))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    acc = tvision.make_vww_eval(tcfg)(
        state["params"], state["bn"],
        SyntheticVWW(image_size=40, batch=128, seed=999).batch_at(0))
    assert acc > 0.55, f"eval accuracy {acc} not above chance"
