"""The port's vlm and encdec families (`repro_torch.models.vlm`,
`repro_torch.models.whisper`, the llama-3.2-vision-11b and whisper-tiny
configs) against the JAX reference, on the CPU in float32.

Inputs come from a seeded numpy generator; weights are the reference's
`SMOKE` init carried across by `repro_torch.compat.tree_from_reference`,
every zero-initialized leaf moved off zero by seeded noise and the VLM's
cross-attention gates set to seeded values in [0.5, 1] on both sides
(at init they are 0, and the image path adds ``tanh(0)·out = 0``).
Tolerances, of the largest |reference value|:

* forward logits, the loss, `prefill_cross_kv`, one `decode_step` and
  the gradients of the loss: 1e-4;
* decode against forward at the reference's rtol 2e-4, atol 5e-4
  (`tests/test_decode_equivalence.py`);
* whisper's sinusoidal positions: 1e-6 up to the SMOKE length; further
  out within two float32 ulps of the largest angle, the reach of one
  last-bit difference between XLA's and torch's float32 ``exp``
  (`test_sinusoid_matches_reference`).

And the reference's refusals: the serve launcher refuses both families,
`SessionEngine` has no ``prefill`` hook for either.
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
from repro.models import vlm as jvlm
from repro.models import whisper as jwhisper
from repro.models.families import get_family as j_get_family
from repro_torch import compat
from repro_torch.configs import PORTED, get_config, get_smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import vlm, whisper
from repro_torch.models.families import (
    FAMILIES,
    get_family,
    validate_slot_layout,
)
from repro_torch.serving import SessionEngine
from repro_torch.tree import tree_leaves, tree_unflatten

VLM, WHISPER = "llama-3.2-vision-11b", "whisper-tiny"
ARCHS = (VLM, WHISPER)
MODEL_TOL = 1e-4
GRAD_TOL = 1e-4
SIN_TOL = 1e-6
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
    assert got.shape == want.shape, (what, got.shape, want.shape)
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
        _close(got, want, tol, what)


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(reference cfg, port cfg, reference params, port params) at SMOKE
    in float32: zero leaves moved off zero, the VLM's gates in [0.5, 1]."""
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
    if arch == VLM:
        for gate in ("gate_attn", "gate_mlp"):
            np_params["cross"][gate] = rng.uniform(
                0.5, 1.0, np_params["cross"][gate].shape).astype(np.float32)
    return (jcfg, cfg, jax.tree.map(jnp.asarray, np_params),
            compat.tree_from_reference(np_params, device="cpu"))


def _inputs(cfg, b, s, seed, n_src=None):
    """(tokens (b, s), the modality input): image embeddings (b,
    n_image_tokens, d) or source frames (b, n_src, d)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    n = cfg.n_image_tokens if cfg.family == "vlm" else (
        n_src or cfg.max_source_positions)
    return toks, rng.standard_normal((b, n, cfg.d_model)).astype(np.float32)


def _forward(mod, params, toks, emb, cfg):
    if mod in (vlm, jvlm):
        return mod.forward(params, toks, emb, cfg)[0]
    return mod.forward(params, emb, toks, cfg)[0]


def _mods(arch):
    return (vlm, jvlm) if arch == VLM else (whisper, jwhisper)


# ------------------------------------------------------------------ configs


def test_configs_match_reference():
    for name in ARCHS:
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
            assert ours.param_count_estimate() == \
                theirs.param_count_estimate()
            assert get_family(ours) is FAMILIES[ours.family]
    assert set(FAMILIES) == {"dense", "moe", "rwkv", "rglru", "vlm",
                             "encdec"}
    assert FAMILIES["vlm"].batch_keys == ("tokens", "targets",
                                          "image_embeds")
    assert FAMILIES["encdec"].batch_keys == ("tokens", "targets",
                                             "src_embeds")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_cache_match_reference_layout(arch):
    """Same trees, shapes and logical axes as the reference's init and
    decode state; the self layers of the VLM stacked (G, n_self, ...)."""
    jcfg, cfg, jparams, _ = _model(arch)
    jfam, fam = j_get_family(jcfg), get_family(cfg)
    _, jaxes = jfam.init(jax.random.PRNGKey(0), jcfg)
    own, axes = fam.init(torch.Generator().manual_seed(0), cfg)
    assert axes == jaxes
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]  # noqa: E731
    shapes = lambda t: sorted((jax.tree_util.keystr(p), tuple(a.shape))  # noqa: E731
                              for p, a in flat(t))
    assert shapes(own) == shapes(jparams)
    jstate, jsaxes = jfam.init_decode_state(jcfg, 3, 16)
    state, saxes = fam.init_decode_state(cfg, 3, 16, device="cpu")
    assert saxes == jsaxes and shapes(state) == shapes(jstate)
    abstract, _ = fam.init_decode_state(cfg, 3, 16, abstract=True)
    assert all(a.device.type == "meta" for a in tree_leaves(abstract))
    validate_slot_layout(cfg)  # every leaf keeps batch at axis 1
    if arch == VLM:
        g, n_self = vlm._n_groups(cfg)
        assert own["self"]["attn"]["wq"].shape[:2] == (g, n_self)
        assert not own["cross"]["gate_attn"].any()  # zero at init


def test_tree_from_reference_keeps_the_layouts():
    """No leaf of either model's tree or cache is a 4-D ``w``, so every
    leaf crosses as it is, the (G, n_self, d, ·) self layers included."""
    for arch in ARCHS:
        jcfg, _, jparams, params = _model(arch)
        jstate, _ = j_get_family(jcfg).init_decode_state(jcfg, 2, 8)
        for tree, ours in ((jparams, params),
                           (jstate, compat.tree_from_reference(
                               jax.tree.map(np.asarray, jstate),
                               device="cpu"))):
            paths = jax.tree_util.tree_flatten_with_path(tree)[0]
            assert not any(jax.tree_util.keystr(p).endswith("['w']")
                           and np.ndim(a) == 4 for p, a in paths)
            for want, got in zip(jax.tree.leaves(tree), tree_leaves(ours)):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------ forward


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    jcfg, cfg, jparams, params = _model(arch)
    mod, jmod = _mods(arch)
    toks, emb = _inputs(cfg, 2, 12, seed=1)
    want = _forward(jmod, jparams, jnp.asarray(toks), jnp.asarray(emb), jcfg)
    got = _forward(mod, params, torch.from_numpy(toks), torch.from_numpy(emb),
                   cfg)
    assert got.dtype == torch.float32
    _close(got, want, MODEL_TOL, "logits")
    key = "image_embeds" if arch == VLM else "src_embeds"
    targets = np.random.default_rng(2).integers(0, cfg.vocab, toks.shape)
    batch = {"tokens": toks, "targets": targets.astype(np.int32), key: emb}
    jloss, jm = j_get_family(jcfg).loss(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss, m = get_family(cfg).loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    _close(loss, jloss, MODEL_TOL, "loss")
    assert float(m["acc"]) == float(jm["acc"])


def test_the_image_moves_the_logits():
    """With nonzero gates the image path is live: other embeddings give
    other logits, and zero gates give the text-only model's."""
    _, cfg, _, params = _model(VLM)
    toks, emb = _inputs(cfg, 2, 6, seed=3)
    toks, emb = torch.from_numpy(toks), torch.from_numpy(emb)
    base = vlm.forward(params, toks, emb, cfg)[0]
    moved = vlm.forward(params, toks, emb.flip(0), cfg)[0]
    assert float((base - moved).abs().max()) > 1e-2 * float(base.abs().max())
    shut = {**params, "cross": {**params["cross"],
                                "gate_attn": torch.zeros_like(
                                    params["cross"]["gate_attn"])}}
    a = vlm.forward(shut, toks, emb, cfg)[0]
    b = vlm.forward(shut, toks, emb.flip(0), cfg)[0]
    assert torch.equal(a, b)


def test_gated_product_promotes_as_jax():
    """``tanh(gate)·y`` with a float32 gate and a bfloat16 ``y`` is taken
    in float32 and cast back, as JAX promotes it."""
    rng = np.random.default_rng(4)
    gate = np.float32(0.7)
    y = rng.standard_normal((3, 5, 8)).astype(np.float32)
    want = (jnp.tanh(jnp.asarray(gate)) * jnp.asarray(y, jnp.bfloat16)
            ).astype(jnp.bfloat16)
    got = vlm._gated(torch.tensor(gate), torch.from_numpy(y).bfloat16(),
                     torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


# ------------------------------------------------------------------ decode


def _decode_all(fam, params, cfg, toks, state):
    outs = []
    b = toks.shape[0]
    for t in range(toks.shape[1]):
        lg, state = fam.decode(params, state, toks[:, t:t + 1],
                               torch.full((b,), t, dtype=torch.int32), cfg)
        outs.append(lg[:, 0])
    return torch.stack(outs, dim=1)


@pytest.mark.parametrize("arch,s,max_len", [(VLM, 12, 32), (WHISPER, 10, 16)])
def test_decode_matches_forward(arch, s, max_len):
    """The mirrors of `tests/test_decode_equivalence.py::
    test_vlm_decode_matches_forward` and `::test_whisper_decode_matches_
    forward`: `prefill_cross_kv`, then token-by-token decode."""
    _, cfg, _, params = _model(arch)
    mod, _ = _mods(arch)
    toks, emb = _inputs(cfg, 2, s, seed=5)
    toks, emb = torch.from_numpy(toks), torch.from_numpy(emb)
    fam = get_family(cfg)
    ref = _forward(mod, params, toks, emb, cfg)
    state, _ = fam.init_decode_state(cfg, 2, max_len, device="cpu")
    state = dict(state)
    state["cross"] = mod.prefill_cross_kv(params, emb, cfg)
    dec = _decode_all(fam, params, cfg, toks, state)
    np.testing.assert_allclose(dec.numpy(), ref.numpy(), rtol=DECODE_RTOL,
                               atol=DECODE_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_step_match_reference(arch):
    """`prefill_cross_kv`, then three decode steps: each step's logits and
    the whole new cache against the reference's; the cache given is not
    written."""
    jcfg, cfg, jparams, params = _model(arch)
    mod, jmod = _mods(arch)
    toks, emb = _inputs(cfg, 3, 3, seed=6)
    jcross = jmod.prefill_cross_kv(jparams, jnp.asarray(emb), jcfg)
    cross = mod.prefill_cross_kv(params, torch.from_numpy(emb), cfg)
    _tree_close(cross, jcross, MODEL_TOL, "cross")
    jstate, _ = j_get_family(jcfg).init_decode_state(jcfg, 3, 8)
    jstate = {**jstate, "cross": jcross}
    state, _ = get_family(cfg).init_decode_state(cfg, 3, 8, device="cpu")
    state = {**state, "cross": cross}
    for t in range(3):
        pos = np.asarray([t, t + 1, 2 * t], np.int32)  # ragged rows
        jlg, jstate = jmod.decode_step(jparams, jstate,
                                       jnp.asarray(toks[:, t:t + 1]),
                                       jnp.asarray(pos), jcfg)
        before = [a.clone() for a in tree_leaves(state)]
        lg, new = mod.decode_step(params, state, torch.from_numpy(
            toks[:, t:t + 1]), torch.from_numpy(pos), cfg)
        assert all(torch.equal(a, b)
                   for a, b in zip(before, tree_leaves(state)))
        assert new["cross"] is state["cross"]
        _close(lg, jlg, MODEL_TOL, f"logits step {t}")
        _tree_close(new, jstate, MODEL_TOL, f"cache step {t}")
        state = new


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_grad(arch):
    """Every leaf's gradient of the family's loss (remat on, as the config
    has it) and the modality input's, against ``jax.grad``."""
    jcfg, cfg, jparams, params = _model(arch)
    assert cfg.remat and jcfg.remat
    key = "image_embeds" if arch == VLM else "src_embeds"
    toks, emb = _inputs(cfg, 2, 8, seed=7, n_src=12)
    targets = np.random.default_rng(8).integers(0, cfg.vocab, toks.shape
                                                ).astype(np.int32)

    def jloss(p, e):
        batch = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(targets),
                 key: e}
        return j_get_family(jcfg).loss(p, batch, jcfg)[0]

    jg, jge = jax.grad(jloss, argnums=(0, 1))(jparams, jnp.asarray(emb))
    leaves = [a.clone().requires_grad_() for a in tree_leaves(params)]
    live = tree_unflatten(params, leaves)
    e = torch.from_numpy(emb).requires_grad_()
    batch = {"tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(targets), key: e}
    loss, _ = get_family(cfg).loss(live, batch, cfg)
    grads = torch.autograd.grad(loss, leaves + [e])
    paths = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(paths) == len(leaves)
    for (path, want), got in zip(paths, grads[:-1]):
        _close(got, want, GRAD_TOL, jax.tree_util.keystr(path))
    _close(grads[-1], jge, GRAD_TOL, key)


# ------------------------------------------------------------------ whisper


@pytest.mark.parametrize("length,d", [(16, 64), (16, 384), (7, 10),
                                      (1500, 384), (448, 384)])
def test_sinusoid_matches_reference(length, d):
    """Float32 on both sides, log(10000) a float32 operand.  Up to the
    SMOKE length the two agree within 1e-6.  Further out they differ by
    the last bit of float32 ``exp``: XLA's differs from the correctly
    rounded value for 22 of the 192 frequencies at d = 384, torch's for
    2, and at position p a one-ulp change of a frequency moves the angle
    by up to p ulps of the frequency, so the angle rounds to a
    neighbouring float32.  There the two are held within two ulps of the
    largest angle, length − 1 radians."""
    got = whisper._sinusoid(length, d)
    want = np.asarray(jwhisper._sinusoid(length, d))
    assert got.dtype == torch.float32
    tol = SIN_TOL if length <= 16 else max(
        SIN_TOL, 2 * float(np.spacing(np.float32(length - 1))))
    _close(got, want, tol, "sinusoid")
    np.testing.assert_array_equal(got[0].numpy(), want[0])  # [0 | 1]


def test_decode_clips_the_learned_position():
    """At ``pos`` ≥ 448 the decoder's learned position is row 447, as the
    reference clips it: the logits at 447, 448 and 1000 equal the
    reference's."""
    jcfg, cfg, jparams, params = _model(WHISPER)
    assert whisper.MAX_DECODER_POSITIONS == jwhisper.MAX_DECODER_POSITIONS
    toks, emb = _inputs(cfg, 3, 1, seed=9)
    pos = np.asarray([447, 448, 1000], np.int32)
    jstate, _ = j_get_family(jcfg).init_decode_state(jcfg, 3, 8)
    jstate = {**jstate, "cross": jwhisper.prefill_cross_kv(
        jparams, jnp.asarray(emb), jcfg)}
    state, _ = get_family(cfg).init_decode_state(cfg, 3, 8, device="cpu")
    state = {**state, "cross": whisper.prefill_cross_kv(
        params, torch.from_numpy(emb), cfg)}
    jlg, _ = jwhisper.decode_step(jparams, jstate, jnp.asarray(toks),
                                  jnp.asarray(pos), jcfg)
    lg, _ = whisper.decode_step(params, state, torch.from_numpy(toks),
                                torch.from_numpy(pos), cfg)
    _close(lg, jlg, MODEL_TOL, "logits")
    assert params["pos_embed"].shape[0] == 448  # row 1000 exists only clipped


# ------------------------------------------------------------------ launchers


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_on_the_cpu(arch, capsys):
    trainer = launch_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                                 "--steps", "3", "--batch", "2", "--seq",
                                 "16"])
    assert trainer.state["step"] == 3 and len(trainer.history) == 3
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    assert "final: {" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_and_session_engine_refuse(arch):
    """The reference's launcher refuses both families
    (`src/repro/launch/serve.py:290-293`); `SessionEngine` needs a
    ``prefill`` hook, which neither has."""
    with pytest.raises(SystemExit, match="pure-text families"):
        launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    _, cfg, _, params = _model(arch)
    with pytest.raises(ValueError, match="prefill"):
        SessionEngine(params, cfg, max_batch=1, max_len=32, device="cpu")
