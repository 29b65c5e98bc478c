"""The port's scale-out of the LM path on the CPU, in spawned gloo worlds
of 2 and 4 ranks (`repro_torch.launch.world.spawn_world`, one intra-op
thread a rank; the rank bodies are `tests/_lm_scale_out_ranks.py`):
tensor-, expert- and fully-sharded train steps under `plan_for`, the
split-KV decode under ``cache_seq_shard`` and the sharded
`SessionEngine`.  Weights are the reference's ``init`` at
``PRNGKey(0)`` (float32), carried across by `repro_torch.compat`; data
from seeded numpy generators.

The port's counterparts of `tests/test_distributed.py`:

* qwen3-32b SMOKE, one SGD (1e-2) step, mesh (2, 2) with ``fsdp=True``
  (4 ranks; (2, 1) on 2): loss and params within 1e-3 of the reference's
  single device (the reference test's tolerance) and within 1e-5 of the
  port's single process; each rank's leaves have the plan's shard shapes.
* qwen3-moe SMOKE, experts over the whole world's model axis (8 experts,
  4 or 2 a rank), both ``moe_impl``s: the loss within 1e-5 (relative) of
  the reference's *single-device* loss (the reference's own sharded test
  is red), and at a capacity factor of 1 (where slots drop) within 1e-5
  of the port's single process, with its drops a layer.
* its decode under ``cache_seq_shard`` (and Llama's, tied embeddings):
  each teacher-forced step's logits within 1e-5 of the single device's
  largest |logit|, and the greedy tokens equal.
* llama3.2-1b SMOKE, ``int8_ef``, model = 2, 8 SGD steps: losses within
  1e-3 of the port's single process, the last below the first (the
  reference's test is red).
* RWKV-6 SMOKE at mesh (1, 2) and (1, 4) (4 heads: 2 and 1 a rank), and
  under FSDP: one step within 1e-5 (loss, relative) and 1e-5 (params) of
  the reference's single device.
* the model-replicated leaves stay equal bit for bit across ranks, and
  a backward run off the caller's thread (as a CUDA backward runs, with
  no plan set there) gives the same gradients.

And of `tests/test_sessions.py`: the sharded `SessionEngine` (8 slots
over the data axis) bit for bit to the port's single engine, tokens and
state, and its recycled-slot leak test; `ServeEngine(mesh=)` with a
``max_batch`` the data axis does not divide raises; rglru, vlm and
encdec, which once refused a model axis, give the single process's loss
under one (`tests/test_torch_scale_out_rest.py` holds their gradients
and decode).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _lm_scale_out_ranks as ranks
from repro.configs import get_smoke_config as j_smoke
from repro.models.families import get_family as j_family
from repro.optim import constant as j_constant
from repro.optim import sgd as j_sgd
from repro.train import TrainState as JTrainState
from repro.train import make_train_step as j_make_train_step
from repro_torch.launch.world import spawn_world
from repro_torch.models.families import get_family
from repro_torch.serving.engine import greedy_generate
from repro_torch.serving.sessions import SessionEngine, SessionRequest
from repro_torch.train import TrainState, make_train_step
from repro_torch.tree import tree_leaves, tree_map

ARCHS = ("qwen3-32b", "qwen3-moe-30b-a3b", "llama3.2-1b", "rwkv6-3b")
REF_TOL = 1e-3  # the reference's sharded tests
PORT_TOL = 1e-5
DECODE_TOL = 1e-5  # of the largest |logit|
INT8_TOL = 1e-3
DECODE_STEPS = 6
SMOKE_FACTOR = 4.0  # qwen3-moe SMOKE's: no slot drops at 24 tokens
DROP_FACTOR = 1.0  # slots drop
WORLD_TIMEOUT = 240.0


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small shapes: one intra-op thread, as the spawned ranks have."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _max_diff(a, b) -> float:
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        return max(_max_diff(a[k], b[k]) for k in a)
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _j_cfg(arch):
    return j_smoke(arch).replace(dtype=jnp.float32)


def _turns(rng, vocab, n_turns, lo=3, hi=8):
    return [rng.integers(0, vocab, rng.integers(lo, hi)).tolist()
            for _ in range(n_turns)]


@pytest.fixture(scope="module")
def inputs():
    """The reference's weights (numpy) and every scenario's data."""
    weights = {}
    for arch in ARCHS:
        params, _ = j_family(_j_cfg(arch)).init(jax.random.PRNGKey(0),
                                                _j_cfg(arch))
        weights[arch] = jax.tree.map(np.asarray, params)
    vocab = _j_cfg("qwen3-32b").vocab
    dense = {"tokens": np.random.default_rng(0).integers(
                 0, vocab, (8, 16)).astype(np.int64),
             "targets": np.random.default_rng(1).integers(
                 0, vocab, (8, 16)).astype(np.int64)}
    rng = np.random.default_rng(0)
    int8 = []
    for _ in range(8):
        toks = rng.integers(0, vocab, (8, 16)).astype(np.int64)
        int8.append({"tokens": toks, "targets": toks})
    toks = np.random.default_rng(0).integers(0, vocab, (4, 24)).astype(
        np.int64)
    rng = np.random.default_rng(7)
    turns = [_turns(rng, vocab, 2) for _ in range(8)]
    leak = _turns(np.random.default_rng(8), vocab, 2)
    return {"weights": weights, "dense_batches": [dense],
            "int8_batches": int8, "moe_batch": {"tokens": toks,
                                                "targets": toks},
            "prompts": np.random.default_rng(3).integers(
                0, vocab, (4, 6)).astype(np.int64),
            "decode_steps": DECODE_STEPS, "turns": turns,
            "capacity_factors": (SMOKE_FACTOR, DROP_FACTOR),
            "leak_turns": leak}


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def world(request, inputs):
    n = request.param
    return n, spawn_world(ranks.scenarios, n, backend="gloo",
                          args=(inputs,), timeout=WORLD_TIMEOUT)


# ------------------------------------------------------------ references


def _reference_step(arch, weights, batch):
    """The reference's single-device SGD step: (loss, params)."""
    cfg = _j_cfg(arch)
    opt = j_sgd(j_constant(ranks.SGD_LR))
    params = jax.tree.map(jnp.asarray, weights)
    new, m = jax.jit(j_make_train_step(cfg, opt))(
        JTrainState(params, opt.init(params)),
        {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()})
    return float(m["loss"]), jax.tree.map(np.asarray, new["params"])


def _port_steps(arch, weights, batches, grad_compression=None):
    """The port's single-process steps: (losses, params after the first
    step)."""
    cfg = ranks.config(arch)
    opt = ranks.optimizer()
    params = ranks.tensors(weights)
    extras = None
    if grad_compression:
        extras = {"ef_error": tree_map(torch.zeros_like, params)}
    state = TrainState(params, opt.init(params), extras=extras)
    step = make_train_step(cfg, opt, grad_compression=grad_compression)
    losses, first = [], None
    for batch in batches:
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        losses.append(float(m["loss"]))
        first = first or ranks.arrays(state["params"])
    return losses, first


@pytest.fixture(scope="module")
def dense_refs(inputs):
    out = {}
    for arch in ("qwen3-32b", "rwkv6-3b"):
        batch = inputs["dense_batches"][0]
        loss, params = _reference_step(arch, inputs["weights"][arch], batch)
        port_losses, port = _port_steps(arch, inputs["weights"][arch],
                                        [batch])
        out[arch] = {"ref_loss": loss, "ref": params,
                     "port_loss": port_losses[0], "port": port}
    return out


def _check_step(res, ref, ref_tol, port_tol):
    assert abs(res["losses"][0] - ref["ref_loss"]) <= ref_tol * abs(
        ref["ref_loss"])
    assert _max_diff(res["first"], ref["ref"]) < ref_tol
    assert abs(res["losses"][0] - ref["port_loss"]) <= port_tol * abs(
        ref["port_loss"])
    assert _max_diff(res["first"], ref["port"]) < port_tol


# ------------------------------------------------------------ train steps


def test_fsdp_tp_dense_step_matches_single_device(world, dense_refs):
    n, out = world
    for res in out:
        _check_step(res["dense"], dense_refs["qwen3-32b"], REF_TOL, PORT_TOL)


def test_rank_shards_have_the_plans_shapes(world):
    n, out = world
    for res in out:
        for name in ("dense", "int8", "rwkv", "rwkv_fsdp"):
            assert res[name]["shapes_agree"], name


def test_rwkv_tp_step_matches_reference_single_device(world, dense_refs):
    """4 heads over a model axis of n: B7's place runs on 4/n heads a
    rank (its plain twin here)."""
    n, out = world
    for res in out:
        _check_step(res["rwkv"], dense_refs["rwkv6-3b"], PORT_TOL, PORT_TOL)


def test_rwkv_fsdp_step_matches_reference_single_device(world, dense_refs):
    n, out = world
    for res in out:
        _check_step(res["rwkv_fsdp"], dense_refs["rwkv6-3b"], PORT_TOL,
                    PORT_TOL)


def test_remat_recompute_needs_no_thread_local_plan(world):
    """A CUDA backward runs on the autograd engine's thread, where no
    plan is set: the recompute of each remat layer reads the model axis
    from its params' shardings, so the backward run off the caller's
    thread gives the same gradients bit for bit."""
    n, out = world
    for res in out:
        for arch, diff in res["off_thread"].items():
            assert diff == 0.0, arch


def test_replicated_leaves_equal_across_ranks(world):
    """Each rank's whole params: the model-replicated leaves (never
    gathered) equal rank 0's bit for bit after every scenario's steps."""
    n, out = world
    for name in ("dense", "int8", "rwkv", "rwkv_fsdp"):
        head = out[0][name]
        for res in out[1:]:
            assert res[name]["losses"] == head["losses"], name
            for a, b in zip(tree_leaves(res[name]["last"]),
                            tree_leaves(head["last"])):
                np.testing.assert_array_equal(a, b)


def test_int8_ef_under_sharding_tracks_single_process(world, inputs):
    n, out = world
    want, _ = _port_steps("llama3.2-1b", inputs["weights"]["llama3.2-1b"],
                          inputs["int8_batches"], "int8_ef")
    for res in out:
        got = res["int8"]["losses"]
        assert len(got) == 8 and got[-1] < got[0]
        np.testing.assert_allclose(got, want, atol=INT8_TOL, rtol=0)


# ------------------------------------------------------------ experts


@pytest.fixture(scope="module")
def moe_single(inputs):
    """At each capacity factor: the reference's single-device loss, the
    port's, and the port's drops a layer."""
    from repro_torch.models import moe

    arch = "qwen3-moe-30b-a3b"
    batch = inputs["moe_batch"]
    out = {}
    for factor in (SMOKE_FACTOR, DROP_FACTOR):
        cfg = _j_cfg(arch).replace(capacity_factor=factor)
        params = jax.tree.map(jnp.asarray, inputs["weights"][arch])
        ref, _ = j_family(cfg).loss(params, {k: jnp.asarray(v, jnp.int32)
                                             for k, v in batch.items()}, cfg)
        drops, positions = [], moe.positions
        tcfg = ranks.config(arch, capacity_factor=factor)

        def counting(top_idx, n_experts):
            pos = positions(top_idx, n_experts)
            drops.append(int((pos >= moe.capacity(tcfg, top_idx.shape[1]))
                             .sum()))
            return pos

        moe.positions = counting
        try:
            with torch.no_grad():
                loss, _ = get_family(tcfg).loss(
                    ranks.tensors(inputs["weights"][arch]),
                    {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
        finally:
            moe.positions = positions
        out[factor] = {"ref": float(ref), "port": float(loss),
                       "drops": drops}
    return out


def test_expert_parallel_loss_matches_reference_for_both_impls(world,
                                                              moe_single):
    n, out = world
    want = moe_single[SMOKE_FACTOR]
    for res in out:
        for impl in ("xla", "shard_map"):
            got = res["moe"][SMOKE_FACTOR][impl]
            assert got["experts_here"] == 8 // n
            assert abs(got["loss"] - want["ref"]) <= PORT_TOL * abs(
                want["ref"]), impl
            assert abs(got["loss"] - want["port"]) <= PORT_TOL * abs(
                want["port"]), impl


def test_expert_parallel_drops_equal_single_device(world, moe_single):
    """Positions from the global cumsum: at a capacity factor of 1 slots
    drop, and every rank sees the single device's drops layer by layer,
    with its loss."""
    n, out = world
    want = moe_single[DROP_FACTOR]
    assert sum(want["drops"]) > 0
    assert moe_single[SMOKE_FACTOR]["drops"] == [0, 0]
    for res in out:
        for impl in ("xla", "shard_map"):
            got = res["moe"][DROP_FACTOR][impl]
            assert got["drops"] == want["drops"], impl
            assert abs(got["loss"] - want["port"]) <= PORT_TOL * abs(
                want["port"]), impl
            assert res["moe"][SMOKE_FACTOR][impl]["drops"] == [0, 0]


# ------------------------------------------------------------ decode


@pytest.fixture(scope="module")
def decode_single(inputs):
    out = {}
    prompts = inputs["prompts"]
    b, p = prompts.shape
    for arch in ("qwen3-moe-30b-a3b", "llama3.2-1b"):
        cfg = ranks.config(arch)
        family = get_family(cfg)
        params = ranks.tensors(inputs["weights"][arch])
        state, _ = family.init_decode_state(cfg, b, 32, device="cpu")
        logits = []
        with torch.no_grad():
            for t in range(p):
                lg, state = family.decode(
                    params, state, torch.from_numpy(prompts[:, t:t + 1]),
                    torch.full((b,), t), cfg)
                logits.append(lg.numpy().copy())
            tokens = greedy_generate(params, cfg, prompts, DECODE_STEPS,
                                     max_len=32, prefill_chunk=1)
        out[arch] = {"logits": np.stack(logits, 1)[:, :, 0],
                     "tokens": tokens.numpy()}
    return out


def test_split_kv_decode_matches_single_device_logits(world, decode_single):
    """The cache's sequence over the model axis (32 slots, 32/n a rank),
    its heads whole; each rank's logits against the single device's."""
    n, out = world
    for res in out:
        for arch, want in decode_single.items():
            got = res["decode"][arch]
            assert got["cache_local"][2] == 32 // n
            scale = np.abs(want["logits"]).max()
            assert np.abs(got["logits"] - want["logits"]).max() <= (
                DECODE_TOL * scale), arch


def test_decode_with_the_heads_split_matches_single_device(world,
                                                          decode_single):
    """Under plain ``plan_for`` the cache's 2 KV heads split over a model
    axis of 2 (each rank decodes its query heads against its KV heads),
    and stay whole over 4 (the whole-cache path): logits and tokens as
    the single device's."""
    n, out = world
    want = decode_single["llama3.2-1b"]
    for res in out:
        got = res["decode_heads"]
        assert got["cache_local"][2:4] == (32, 2 // n if n == 2 else 2)
        assert np.abs(got["logits"] - want["logits"]).max() <= (
            DECODE_TOL * np.abs(want["logits"]).max())
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_split_kv_greedy_tokens_match(world, decode_single):
    n, out = world
    for res in out:
        for arch, want in decode_single.items():
            np.testing.assert_array_equal(res["decode"][arch]["tokens"],
                                          want["tokens"])


# ------------------------------------------------------------ engines


@pytest.fixture(scope="module")
def single_sessions(inputs):
    cfg = ranks.config("rwkv6-3b")
    params = ranks.tensors(inputs["weights"]["rwkv6-3b"])
    eng = SessionEngine(params, cfg, max_batch=8, max_len=256,
                        prefill_chunk=4, device="cpu")
    reqs = [SessionRequest(uid=i, turns=[list(t) for t in ts],
                           max_new_tokens=4)
            for i, ts in enumerate(inputs["turns"])]
    for r in reqs:
        eng.submit(r)
    eng.run()
    # the leak reference: one session replayed token by token
    family = get_family(cfg)
    state, _ = family.init_decode_state(cfg, 1, 256, device="cpu")
    pos = torch.zeros(1, dtype=torch.long)
    leak, logits = [], None
    with torch.no_grad():
        for prompt in inputs["leak_turns"]:
            for tok in prompt:
                logits, state = family.decode(params, state,
                                              torch.tensor([[tok]]), pos, cfg)
            gen = []
            for i in range(3):
                gen.append(int(torch.argmax(logits[0, -1])))
                if i + 1 < 3:
                    logits, state = family.decode(
                        params, state, torch.tensor([[gen[-1]]]), pos, cfg)
            leak.append(gen)
    return {"outputs": [r.outputs for r in reqs],
            "state": ranks.arrays(eng.state), "leak": leak}


def test_sharded_sessions_match_single_engine_bitwise(world,
                                                      single_sessions):
    n, out = world
    rows = [res["sessions"]["rows"] for res in out]
    assert sorted(sum(rows, [])) == list(range(8))
    for res in out:
        got = res["sessions"]
        assert got["outputs"] == single_sessions["outputs"]
        for a, b in zip(tree_leaves(got["state"]),
                        tree_leaves(single_sessions["state"])):
            np.testing.assert_array_equal(a, b)


def test_sharded_recycled_slot_no_leak(world, single_sessions):
    n, out = world
    for res in out:
        assert res["sessions"]["leak"] == single_sessions["leak"]


def test_sharded_engine_refuses_indivisible_max_batch(world):
    n, out = world
    for res in out:
        assert f"max_batch=3 must divide over the data axis ({n})" in (
            res["refusals"]["max_batch"])


def test_unported_families_refuse_a_model_axis(world):
    """The rglru, vlm and encdec families, which refused a model axis
    until their tensor and fully-sharded parallelism was ported, now run
    under it: the loss at a model axis of 2 (FSDP over the rest) within
    1e-5 (relative) of the single process's."""
    n, out = world
    for arch in ranks.FAMILY_ARCHS:
        cfg, params, batch = ranks.family_case(arch)
        with torch.no_grad():
            want, _ = get_family(cfg).loss(params, batch, cfg)
        for res in out:
            got = res["refusals"][cfg.family]
            assert abs(got - float(want)) <= PORT_TOL * abs(float(want)), \
                cfg.family
