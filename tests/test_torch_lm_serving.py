"""The port's LM serving path (`repro_torch.serving.engine`,
`repro_torch.serving.sessions`, `repro_torch.launch.serve`) against the JAX
reference engines, on the CPU at `SMOKE` in float32.

The reference's weights are carried across by
`compat.tree_from_reference`; the reference runs its chunked WKV as
the XLA twin (``wkv_impl="xla"``), the port its default ``"cuda"``, which
on CPU tensors is the plain twin.  Held token for token: the same
requests give the same tokens, and the same ticks, in both frameworks.
Also mirrors the single-device tests of `tests/test_serving.py` and
`tests/test_sessions.py`, those the reference runs on both families for
rwkv6-3b and llama3.2-1b (the dense family: the masked decode scan), and
holds the rules: no GPU ⇒ the default engine raises; a failing launch
surfaces as failed requests; a masked slot's KV rows keep their bits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models.families import get_family as j_get_family
from repro.serving import engine as j_engine
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro.serving import SessionEngine as JSessionEngine
from repro.serving import SessionRequest as JSessionRequest
from repro.serving import greedy_generate as j_greedy_generate
from repro_torch import compat
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import families
from repro_torch.models.families import get_family
from repro_torch.serving import (
    Request,
    ServeEngine,
    SessionEngine,
    SessionRequest,
    greedy_generate,
)
from repro_torch.serving.engine import (
    FAILED_TOKEN,
    _chunk_step_for,
    _decode_step_for,
)
from repro_torch.tree import tree_leaves, tree_map


ARCHS = ["rwkv6-3b", "llama3.2-1b"]
MOE_ARCHS = ["qwen3-moe-30b-a3b", "mixtral-8x22b"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These shapes are small: one intra-op thread runs them about ten
    times faster than eight, and the suite's parallel workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(arch):
    kw = {"wkv_impl": "xla"} if arch == "rwkv6-3b" else {}
    jcfg = j_get_smoke_config(arch).replace(dtype=jnp.float32, **kw)
    cfg = get_smoke_config(arch).replace(dtype=torch.float32)
    jparams, _ = j_get_family(jcfg).init(jax.random.PRNGKey(0), jcfg)
    params = compat.tree_from_reference(
        jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module")
def lm():
    return _load("rwkv6-3b")


@pytest.fixture(scope="module", params=ARCHS)
def any_lm(request):
    """Each family the engine tests of the reference run on."""
    return _load(request.param)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_lm(request):
    """The MoE family, served by the masked decode scan as dense."""
    return _load(request.param)


def _engine(lm, **kw):
    _, cfg, _, params = lm
    return ServeEngine(params, cfg, device="cpu", **kw)


def _ref_engine(lm, **kw):
    jcfg, _, jparams, _ = lm
    return JServeEngine(jparams, jcfg, **kw)


def _reference_decode(lm, prompt, n_new):
    """Single-request greedy decode (fresh state), the port's."""
    _, cfg, _, params = lm
    out = greedy_generate(params, cfg, np.asarray([prompt]), n_new,
                          max_len=64)
    return out[0].tolist()


def _serve(engine, reqs):
    for r in reqs:
        engine.submit(r)
    return engine.run()


def _ledger(done):
    return sorted((r.uid, r.output, r.served_tick, r.finished_tick)
                  for r in done)


def _engine_matches_reference_engine(lm, chunk):
    """Prompt lengths below, at and above the chunk, more requests than
    slots: the same tokens at the same ticks as the JAX engine."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, n).tolist() for n in (1, 3, 5, 7, 11, 17)]
    kw = dict(max_batch=2, max_len=64, prefill_chunk=chunk)
    done = _serve(_engine(lm, **kw),
                  [Request(uid=i, prompt=p, max_new_tokens=4)
                   for i, p in enumerate(prompts)])
    ref = _serve(_ref_engine(lm, **kw),
                 [JRequest(uid=i, prompt=p, max_new_tokens=4)
                  for i, p in enumerate(prompts)])
    assert len(done) == 6
    assert _ledger(done) == _ledger(ref)


@pytest.mark.parametrize("chunk", [1, 4, 16])
def test_engine_matches_reference_engine(any_lm, chunk):
    _engine_matches_reference_engine(any_lm, chunk)


@pytest.mark.parametrize("chunk", [1, 4])
def test_moe_engine_matches_reference_engine(moe_lm, chunk):
    """qwen3-moe and mixtral SMOKE: decode groups of one token each, so
    the capacity dispatch drops nothing and a slot's tokens do not
    depend on its neighbours'."""
    _engine_matches_reference_engine(moe_lm, chunk)


@pytest.mark.parametrize("bad_token", ["padded_vocab", "below"])
def test_out_of_range_prompt_token_fails_alone(lm, bad_token):
    """A prompt token outside the embedding table fails that request at
    submit, alone; the others' tokens equal the reference engine's, which
    embeds the bad row as NaN (`jnp.take`) and serves it.  A token of -1
    wraps to the last row, as in both frameworks."""
    _, cfg, _, _ = lm
    v = cfg.padded_vocab
    bad = v if bad_token == "padded_vocab" else -v - 1
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, n).tolist() for n in (4, 9, 6, 3)]
    prompts[1][4] = bad
    prompts[3][0] = -1
    kw = dict(max_batch=2, max_len=64, prefill_chunk=4)
    eng = _engine(lm, **kw)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=4)
            for i, p in enumerate(prompts)]
    statuses = [eng.submit(r) for r in reqs]
    assert statuses == ["admitted", FAILED_TOKEN, "admitted", "admitted"]
    done = eng.run(on_undrained="raise")
    assert eng.failed == [reqs[1]] and reqs[1].failure == "token"
    assert sorted(r.uid for r in done) == [0, 2, 3]
    ref = _serve(_ref_engine(lm, **kw),
                 [JRequest(uid=i, prompt=p, max_new_tokens=4)
                  for i, p in enumerate(prompts) if i != 1 or
                  bad_token == "padded_vocab"])
    ref_out = {r.uid: r.output for r in ref}
    for r in done:
        assert r.output == ref_out[r.uid], r.uid
    # the engine serves on
    again = eng.run([Request(uid=9, prompt=prompts[0], max_new_tokens=4)],
                    on_undrained="raise")
    assert again[-1].uid == 9 and again[-1].output == ref_out[0]


def test_out_of_range_session_token_fails_alone(lm):
    _, cfg, _, _ = lm
    rng = np.random.default_rng(6)
    turns = [_turns(rng, 2) for _ in range(3)]
    turns[1][1][0] = cfg.padded_vocab  # in the second turn
    eng = _sessions(lm, max_batch=2, max_len=256, prefill_chunk=4)
    reqs = [SessionRequest(uid=i, turns=t, max_new_tokens=3)
            for i, t in enumerate(turns)]
    assert [eng.submit(r) for r in reqs][1] == FAILED_TOKEN
    done = eng.run(on_undrained="raise")
    assert eng.failed == [reqs[1]]
    assert sorted(r.uid for r in done) == [0, 2]
    for r in done:
        assert r.outputs == _reference_session(lm, r.turns, 3), r.uid


def test_engine_matches_single_request_decode(any_lm):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, 6).tolist() for _ in range(5)]
    done = _serve(_engine(any_lm, max_batch=2, max_len=64),
                  [Request(uid=i, prompt=p, max_new_tokens=5)
                   for i, p in enumerate(prompts)])
    assert len(done) == 5
    for req in done:
        assert req.output == _reference_decode(any_lm, req.prompt, 5), req.uid


def test_more_requests_than_slots(lm):
    done = _serve(_engine(lm, max_batch=2, max_len=32),
                  [Request(uid=i, prompt=[i + 1, i + 2], max_new_tokens=3)
                   for i in range(7)])
    assert sorted(r.uid for r in done) == list(range(7))
    assert all(len(r.output) == 3 for r in done)


def test_reset_slot_zeroes_only_that_slot(lm):
    engine = _engine(lm, max_batch=3, max_len=16)
    engine.state = tree_map(torch.ones_like, engine.state)
    engine._reset_slot(1)
    for leaf in tree_leaves(engine.state):
        assert torch.all(leaf[:, 1] == 0), "freed slot not cleared"
        assert torch.all(leaf[:, 0] == 1) and torch.all(leaf[:, 2] == 1)


@pytest.mark.parametrize("chunk", [1, 4])
def test_recycled_slot_sees_no_stale_state(any_lm, chunk):
    rng = np.random.default_rng(1)
    p1 = rng.integers(0, 512, 5).tolist()
    p2 = rng.integers(0, 512, 4).tolist()
    engine = _engine(any_lm, max_batch=1, max_len=32, prefill_chunk=chunk)
    _serve(engine, [Request(uid=0, prompt=p1, max_new_tokens=4)])
    assert len(engine.completed) == 1
    engine.state = tree_map(lambda a: torch.full_like(a, 7.0), engine.state)
    done = _serve(engine, [Request(uid=1, prompt=p2, max_new_tokens=4)])
    (req2,) = [r for r in done if r.uid == 1]
    assert req2.output == _reference_decode(any_lm, p2, 4), \
        "recycled slot leaked previous occupant's state"


@pytest.mark.parametrize("chunk", [4, 16])
def test_chunked_prefill_token_identical_and_saves_ticks(any_lm, chunk):
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, n).tolist() for n in (1, 3, 5, 7, 11)]
    outs = {}
    for c in (1, chunk):
        engine = _engine(any_lm, max_batch=2, max_len=64, prefill_chunk=c)
        done = _serve(engine, [Request(uid=i, prompt=p, max_new_tokens=4)
                               for i, p in enumerate(prompts)])
        outs[c] = ({r.uid: r.output for r in done}, engine.tick)
    assert outs[chunk][0] == outs[1][0], "chunked prefill diverged"
    assert outs[chunk][1] < outs[1][1], "chunked prefill saved no ticks"


def test_chunked_prefill_matches_reference_decode(lm):
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 512, 6).tolist() for _ in range(3)]
    done = _serve(_engine(lm, max_batch=2, max_len=64, prefill_chunk=4),
                  [Request(uid=i, prompt=p, max_new_tokens=5)
                   for i, p in enumerate(prompts)])
    for req in done:
        assert req.output == _reference_decode(lm, req.prompt, 5)


def test_bounded_queue_drop_newest(lm):
    engine = _engine(lm, max_batch=1, max_len=32, max_queue=2)
    for uid in range(5):
        engine.submit(Request(uid=uid, prompt=[uid + 1], max_new_tokens=2))
    assert [r.uid for r in engine.evicted] == [2, 3, 4]
    done = engine.run()
    assert sorted(r.uid for r in done) == [0, 1]
    assert engine.latency_summary()["evictions"] == 3


def test_greedy_generate_matches_reference(any_lm):
    """Every chunking (partial tail, exact, one step) emits the tokens of
    the token-by-token loop, and those of the reference's
    `greedy_generate`."""
    jcfg, cfg, jparams, params = any_lm
    prompts = np.random.default_rng(7).integers(0, 512, (3, 7))
    ref = np.asarray(j_greedy_generate(jparams, jcfg,
                                       jnp.asarray(prompts, jnp.int32),
                                       steps=5, max_len=64, prefill_chunk=1))
    for chunk in (1, 3, 7, None):
        out = greedy_generate(params, cfg, prompts, steps=5, max_len=64,
                              prefill_chunk=chunk)
        assert out.shape == (3, 5) and int(out.max()) < cfg.padded_vocab
        np.testing.assert_array_equal(out.numpy(), ref,
                                      err_msg=f"chunk={chunk}")


def test_masked_scan_keeps_a_masked_slots_kv_rows(monkeypatch):
    """One chunk step of the masked decode scan (llama3.2-1b SMOKE, C = 4)
    from a random cache: a slot at 0 tokens keeps every KV row bit for
    bit, a slot at 2 keeps every row but the two it writes, and the step
    equals the reference's (last logits and cache within 1e-5 of their
    largest |value|), stopping after max(n_active) = 3 steps."""
    jcfg, cfg, jparams, params = _load("llama3.2-1b")
    rng = np.random.default_rng(9)
    state, _ = get_family(cfg).init_decode_state(cfg, 3, 16, device="cpu")
    np_state = {k: rng.standard_normal(a.shape).astype(np.float32)
                for k, a in state.items()}
    state = {k: torch.from_numpy(a.copy()) for k, a in np_state.items()}
    before = {k: a.clone() for k, a in state.items()}
    tokens = rng.integers(0, cfg.vocab, (3, 4))
    pos = np.asarray([5, 3, 0])
    n_active = np.asarray([0, 2, 3])
    calls = []
    family = get_family(cfg)

    def counted(*args):
        calls.append(1)
        return family.decode(*args)

    monkeypatch.setitem(families.FAMILIES, "dense",
                        dataclasses.replace(family, decode=counted))
    run = _chunk_step_for.__wrapped__(cfg, 4)  # a step of the patched family
    last, new = run(params, state, *(torch.from_numpy(a) for a in
                                     (tokens, pos, n_active)))
    assert len(calls) == 3
    for key in ("k", "v"):
        assert torch.equal(state[key], before[key])  # the input kept
        assert torch.equal(new[key][:, 0], before[key][:, 0])
        rows = torch.ones(16, dtype=torch.bool)
        rows[3:5] = False  # slot 1 writes positions 3 and 4
        assert torch.equal(new[key][:, 1, rows], before[key][:, 1, rows])
        assert not torch.equal(new[key][:, 1, ~rows], before[key][:, 1, ~rows])
    jrun = j_engine._chunk_step_for(jcfg, 4)
    jlast, jnew = jrun(jparams, {k: jnp.asarray(a) for k, a in
                                 np_state.items()},
                       *(jnp.asarray(a, jnp.int32) for a in
                         (tokens, pos, n_active)))
    for got, want in [(last, jlast)] + [(new[k], jnew[k]) for k in new]:
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_steps_are_shared_across_engines(lm):
    _, cfg, _, _ = lm
    _engine(lm, max_batch=1, max_len=16)
    before = _decode_step_for.cache_info().hits
    _engine(lm, max_batch=2, max_len=16)
    assert _decode_step_for.cache_info().hits == before + 1
    assert _decode_step_for(cfg) is _decode_step_for(cfg)


def test_engine_without_device_needs_a_gpu(lm, monkeypatch):
    """The default device is the GPU; without one the engines raise and
    never carry on on the CPU by themselves."""
    _, cfg, _, params = lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(params, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        SessionEngine(params, cfg)


def test_failed_launch_surfaces_as_failed_requests(lm, monkeypatch):
    engine = _engine(lm, max_batch=2, max_len=32, prefill_chunk=4,
                     launch_retries=1)
    calls = []

    def broken(*args):
        calls.append(len(args))
        raise RuntimeError("wkv CUDA launch failed: cudaError 1")

    monkeypatch.setattr(engine, "_chunk_step", broken)
    engine.run([Request(uid=i, prompt=[1, 2, 3], max_new_tokens=2)
                for i in range(2)], on_undrained="raise")
    assert engine.completed == []
    assert [(r.uid, r.failure) for r in engine.failed] == [
        (0, "launch"), (1, "launch")]
    assert len(calls) == 2  # one try, one retry, same path


def _launcher_serves_smoke(capsys, arch):
    """``--arch`` serves alone (chunked, the masked decode scan) and
    ``--mixed`` behind the front door."""
    launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "3", "--max-batch", "2",
                       "--max-new-tokens", "4", "--prefill-chunk", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "on cpu" in out
    launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "2", "--max-new-tokens", "3",
                       "--mixed", "--vision-requests", "2"])
    out = capsys.readouterr().out
    assert out.startswith("front door: 2 LM requests (6 tokens) + 2 frames "
                          "+ 0 video streams")


def test_launcher_serves_dense_smoke_on_the_cpu(capsys):
    _launcher_serves_smoke(capsys, "llama3.2-1b")


def test_launcher_serves_moe_smoke_on_the_cpu(capsys):
    _launcher_serves_smoke(capsys, "mixtral-8x22b")


def test_launcher_serves_smoke_on_the_cpu(capsys):
    launch_serve.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu",
                       "--requests", "3", "--max-batch", "2",
                       "--max-new-tokens", "4", "--prefill-chunk", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "on cpu" in out
    launch_serve.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu",
                       "--requests", "2", "--max-new-tokens", "3",
                       "--mixed", "--vision-requests", "2"])
    out = capsys.readouterr().out
    assert out.startswith("front door: 2 LM requests (6 tokens) + 2 frames "
                          "+ 0 video streams")


# ------------------------------------------------------------------ sessions


def _turns(rng, n_turns, lo=3, hi=8):
    return [rng.integers(0, 512, rng.integers(lo, hi)).tolist()
            for _ in range(n_turns)]


def _reference_session(lm, turns, max_new):
    """Single-session greedy replay on the port's decode step: persistent
    state, per-token feed; a turn's last token is never fed back."""
    _, cfg, _, params = lm
    family = get_family(cfg)
    state, _ = family.init_decode_state(cfg, 1, 256, device="cpu")
    pos = torch.zeros(1, dtype=torch.long)
    outs, logits = [], None
    for prompt in turns:
        for tok in prompt:
            logits, state = family.decode(params, state,
                                          torch.tensor([[tok]]), pos, cfg)
        gen = []
        for i in range(max_new):
            nxt = int(torch.argmax(logits[0, -1]))
            gen.append(nxt)
            if i + 1 < max_new:
                logits, state = family.decode(params, state,
                                              torch.tensor([[nxt]]), pos, cfg)
        outs.append(gen)
    return outs


def _sessions(lm, **kw):
    _, cfg, _, params = lm
    return SessionEngine(params, cfg, device="cpu", **kw)


@pytest.mark.parametrize("prefill_chunk", [1, 4])
def test_sessions_match_reference_engine_and_persistent_state(lm,
                                                              prefill_chunk):
    jcfg, _, jparams, _ = lm
    rng = np.random.default_rng(0)
    all_turns = [_turns(rng, 3) for _ in range(3)]
    kw = dict(max_batch=2, max_len=256, prefill_chunk=prefill_chunk)
    reqs = [SessionRequest(uid=i, turns=t, max_new_tokens=5)
            for i, t in enumerate(all_turns)]
    done = _serve(_sessions(lm, **kw), reqs)
    jreqs = [JSessionRequest(uid=i, turns=t, max_new_tokens=5)
             for i, t in enumerate(all_turns)]
    _serve(JSessionEngine(jparams, jcfg, **kw), jreqs)
    assert sorted(r.uid for r in done) == [0, 1, 2]
    for r, jr in zip(reqs, jreqs):
        assert r.done and r.outputs == jr.outputs, r.uid
        assert (r.served_tick, r.finished_tick) == (jr.served_tick,
                                                    jr.finished_tick)
        assert r.outputs == _reference_session(lm, r.turns, 5), r.uid


def test_state_actually_persists_across_turns(lm):
    rng = np.random.default_rng(1)
    turns = _turns(rng, 2, lo=6, hi=10)
    req = SessionRequest(uid=0, turns=turns, max_new_tokens=6)
    _serve(_sessions(lm, max_batch=1, max_len=256, prefill_chunk=4), [req])
    fresh = _reference_session(lm, [turns[1]], 6)[0]
    assert req.outputs[1] != fresh, "session state is not being carried"


def test_recycled_slot_sees_no_stale_session_state(lm):
    rng = np.random.default_rng(2)
    t1, t2 = _turns(rng, 2), _turns(rng, 2)
    eng = _sessions(lm, max_batch=1, max_len=256, prefill_chunk=4)
    _serve(eng, [SessionRequest(uid=0, turns=t1, max_new_tokens=4)])
    assert len(eng.completed) == 1
    eng.state = tree_map(lambda a: torch.full_like(a, 7.0), eng.state)
    req2 = SessionRequest(uid=1, turns=t2, max_new_tokens=4)
    _serve(eng, [req2])
    assert req2.outputs == _reference_session(lm, t2, 4), \
        "recycled slot leaked previous conversation's WKV state"


def test_more_sessions_than_slots(lm):
    rng = np.random.default_rng(3)
    reqs = [SessionRequest(uid=i, turns=_turns(rng, 2), max_new_tokens=3)
            for i in range(5)]
    done = _serve(_sessions(lm, max_batch=2, max_len=256, prefill_chunk=4),
                  reqs)
    assert sorted(r.uid for r in done) == list(range(5))
    assert all(len(r.outputs) == 2 for r in reqs)
    assert all(len(o) == 3 for r in reqs for o in r.outputs)


def test_session_length_cap_ends_conversation(lm):
    rng = np.random.default_rng(4)
    req = SessionRequest(uid=0, turns=_turns(rng, 8), max_new_tokens=4)
    done = _serve(_sessions(lm, max_batch=1, max_len=16, prefill_chunk=4),
                  [req])
    assert len(done) == 1 and req.done
    assert len(req.outputs) < 8  # capped before the last turn


@pytest.mark.parametrize("family", ["dense", "moe", "vlm"])
def test_session_engine_needs_a_ported_prefill_family(lm, family):
    """The mirror of `tests/test_sessions.py::
    test_session_engine_rejects_kv_cache_family`: a KV-cache family (dense,
    moe, vlm) has no positionless prefill hook, so construction fails
    loudly, with the reference's ValueError."""
    if family in ("dense", "moe"):
        arch = "llama3.2-1b" if family == "dense" else "mixtral-8x22b"
        _, cfg, _, params = _load(arch)
    else:
        cfg = get_smoke_config("llama-3.2-vision-11b").replace(
            dtype=torch.float32)
        params, _ = get_family(cfg).init(torch.Generator().manual_seed(0),
                                         cfg)
    with pytest.raises(ValueError, match="prefill"):
        SessionEngine(params, cfg, max_batch=1, max_len=32, device="cpu")


def test_session_replay_is_deterministic(lm):
    rng = np.random.default_rng(6)
    all_turns = [_turns(rng, 2) for _ in range(3)]
    runs = []
    for _ in range(2):
        eng = _sessions(lm, max_batch=2, max_len=256, prefill_chunk=4)
        reqs = [SessionRequest(uid=i, turns=[list(t) for t in ts],
                               max_new_tokens=4)
                for i, ts in enumerate(all_turns)]
        _serve(eng, reqs)
        runs.append(([r.outputs for r in reqs], eng.tick,
                     [a.clone() for a in tree_leaves(eng.state)]))
    assert runs[0][:2] == runs[1][:2], "session replay nondeterministic"
    assert all(torch.equal(a, b) for a, b in zip(runs[0][2], runs[1][2]))
