"""The port's replica pools and event-driven front door
(`repro_torch.serving.pool`, `repro_torch.launch.serve.FrontDoor`) on
the CPU: a mirror of `tests/test_serve_pool.py` (lockstep equivalence of
the event loop, least-loaded dispatch, halted-replica exclusion,
exactly-once accounting under overload, cadences, the door-clock latency
conversion), with each mixed trace also replayed through the reference's
door and pools for the same ledgers; and the door tests of
`tests/test_sessions.py` (sessions beside the LM) and
`tests/test_video_stream.py` (streams beside vision) on the port's
engines.  The reference's pool of mesh-sharded vision engines has its
mirror in `tests/test_torch_scale_out.py`, on spawned gloo worlds.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.launch.serve import FrontDoor as JFrontDoor
from repro.serving import ReplicaPool as JReplicaPool
from repro.serving.scheduler import ScheduledRequest as JScheduledRequest
from repro.serving.scheduler import SlotEngine as JSlotEngine
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticVWW
from repro_torch.launch.serve import FrontDoor
from repro_torch.models.families import get_family
from repro_torch.models.mobilenetv2 import MNV2Config, init_mnv2
from repro_torch.obs import MetricsRegistry
from repro_torch.serving import (
    ReplicaPool,
    Request,
    ServeEngine,
    SessionEngine,
    SessionRequest,
    VisionEngine,
    VisionRequest,
)
from repro_torch.serving.scheduler import (
    ADMITTED,
    REJECTED_HALTED,
    REJECTED_QUEUE,
    ScheduledRequest,
    SlotEngine,
)
from repro_torch.video import (
    DetectConfig,
    StreamEngine,
    StreamRequest,
    SyntheticVideo,
    init_detect_head,
)

# ------------------------------------------------------------ dummy adapters


def _adapters(base_req, base_engine):
    """The dummies of `tests/test_serve_pool.py` over either framework's
    scheduler: a one-tick modality (the vision shape) and a multi-tick
    one (the LM/stream shape)."""

    @dataclasses.dataclass
    class AReq(base_req):
        uid: int = 0

    @dataclasses.dataclass
    class BReq(base_req):
        uid: int = 0
        work: int = 1  # engine ticks of slot residency
        done: int = 0

    class AEngine(base_engine):
        request_type = AReq

        def _launch(self, active):
            return None

        def _absorb(self, i, req, result):
            return True

    class BEngine(base_engine):
        request_type = BReq

        def _launch(self, active):
            return None

        def _absorb(self, i, req, result):
            req.done += 1
            return req.done >= req.work

    return AReq, BReq, AEngine, BEngine


_AReq, _BReq, _AEngine, _BEngine = _adapters(ScheduledRequest, SlotEngine)
_JAReq, _JBReq, _JAEngine, _JBEngine = _adapters(JScheduledRequest,
                                                  JSlotEngine)


class _RaisingEngine(_AEngine):
    """Escapes its own launch containment after ``fail_at`` ticks."""

    def __init__(self, *a, fail_at=2, **kw):
        super().__init__(*a, **kw)
        self.fail_at = fail_at

    def step(self):
        if self.tick + 1 >= self.fail_at:
            self.tick += 1
            raise RuntimeError("replica wedged")
        return super().step()


def _mixed_trace(seed: int, n: int, areq=_AReq, breq=_BReq) -> list:
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        arrival = int(rng.integers(0, max(1, n // 2)))
        if rng.random() < 0.5:
            reqs.append(areq(uid=i, arrival_tick=arrival))
        else:
            reqs.append(breq(uid=i, work=1 + int(rng.integers(0, 4)),
                             arrival_tick=arrival))
    return reqs


def _ledger(door) -> list:
    rows = [("done", name, r.uid, r.submitted_tick, r.served_tick,
             r.finished_tick, r.queue_ticks, r.serve_ticks)
            for name, r in door.completed]
    for name, e in door.engines.items():
        for kind in ("failed", "evicted", "rejected"):
            rows += [(kind, name, r.uid, r.submitted_tick, r.evicted_tick,
                      r.queue_ticks) for r in getattr(e, kind)]
    return sorted(rows)


# ------------------------------------------------- lockstep equivalence


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 10_000), st.integers(1, 40))
def test_event_loop_matches_lockstep_door(seed, n):
    """With every tick_cost equal, the event-driven door over 1-replica
    pools replays the lockstep door bit-identically, and the reference's
    event-driven door over its pools gives the same ledgers."""
    def build(lockstep, pooled, door=FrontDoor, pool=ReplicaPool,
              a=_AEngine, b=_BEngine):
        def wrap(e):
            return pool(e) if pooled else e
        return door(
            lockstep=lockstep,
            a=wrap(a(2, max_queue=3, evict="drop-newest")),
            b=wrap(b(2, max_queue=3, evict="drop-oldest")))

    ref = build(lockstep=True, pooled=False)
    evt = build(lockstep=False, pooled=True)
    jevt = build(lockstep=False, pooled=True, door=JFrontDoor,
                 pool=JReplicaPool, a=_JAEngine, b=_JBEngine)
    ref.run(_mixed_trace(seed, n), max_ticks=10_000, on_undrained="raise")
    evt.run(_mixed_trace(seed, n), max_ticks=10_000, on_undrained="raise")
    jevt.run(_mixed_trace(seed, n, _JAReq, _JBReq), max_ticks=10_000,
             on_undrained="raise")
    assert _ledger(ref) == _ledger(evt) == _ledger(jevt)
    assert ref.tick == evt.tick == jevt.tick


# ------------------------------------------------------- pool dispatch


def test_pool_least_loaded_dispatch_deterministic():
    def run_once():
        pool = ReplicaPool(_AEngine(1, max_queue=8), _AEngine(1, max_queue=8))
        for uid in range(5):
            assert pool.submit(_AReq(uid=uid)) == ADMITTED
        return [[r.uid for r in rep.queue] for rep in pool.replicas]

    first = run_once()
    assert first == [[0, 2, 4], [1, 3]]
    assert run_once() == first


def test_pool_rejects_only_when_all_replicas_reject():
    pool = ReplicaPool(_AEngine(1, max_queue=1), _AEngine(1, max_queue=1))
    assert [pool.submit(_AReq(uid=u)) for u in range(2)] == [ADMITTED] * 2
    assert pool.submit(_AReq(uid=2)) == REJECTED_QUEUE
    assert sum(len(rep.evicted) for rep in pool.replicas) == 1


def test_pool_halted_replica_excluded_but_pool_serves():
    bad = _RaisingEngine(1, max_queue=4, fail_at=1)
    good = _AEngine(1, max_queue=4)
    pool = ReplicaPool(bad, good)
    done = pool.run([_AReq(uid=u, arrival_tick=u) for u in range(6)],
                    max_ticks=50, on_undrained="warn")
    assert pool.down == {0: "RuntimeError: replica wedged"}
    assert pool.halted is None
    assert bad.halted is not None
    assert {r.uid for r in done} | {r.uid for r in pool.failed} == set(range(6))
    assert all(r.uid in {r2.uid for r2 in good.completed} for r in done)
    assert pool.health()["halted"] is None
    good.halt("drained")
    assert pool.halted is not None
    assert pool.submit(_AReq(uid=9)) == REJECTED_HALTED


def test_pool_exactly_once_accounting_under_overload():
    pool = ReplicaPool(_AEngine(1, max_queue=2), _AEngine(1, max_queue=2))
    reqs = [_AReq(uid=u, arrival_tick=u // 8) for u in range(80)]
    done = pool.run(reqs, max_ticks=200, on_undrained="raise")
    uids = [r.uid for r in done] + [r.uid for r in pool.evicted]
    assert sorted(uids) == list(range(80))
    assert not pool.failed and not pool.rejected
    assert all(len(rep.completed) > 0 for rep in pool.replicas)
    served = {r.uid for rep in pool.replicas for r in rep.completed}
    assert len(served) == len(done)


def test_pool_validates_replica_homogeneity():
    with pytest.raises(ValueError):
        ReplicaPool(_AEngine(1), _BEngine(1))
    with pytest.raises(ValueError):
        ReplicaPool(_AEngine(1, tick_cost=1), _AEngine(1, tick_cost=2))
    with pytest.raises(ValueError):
        ReplicaPool()


def test_pool_registers_its_views_and_traces_dispatch():
    from repro_torch.obs import Tracer, validate_trace_events

    reg, tr = MetricsRegistry(), Tracer()
    pool = ReplicaPool(_AEngine(1, registry=reg), _AEngine(1, registry=reg),
                       tracer=tr, registry=reg)
    pool.run([_AReq(uid=u) for u in range(3)], on_undrained="raise")
    views = reg.snapshot()["components"][pool.metrics_scope]
    assert views["latency"] == pool.latency_summary()
    assert views["health"] == pool.health()
    assert views["health"]["degraded"] is None
    events = tr.trace_events()
    assert validate_trace_events(events) == []
    assert [e["args"]["replica"] for e in events
            if e["name"] == "dispatch"] == [0, 1, 0]
    assert {e["args"]["name"] for e in events if e["ph"] == "M"} >= \
        {"replica[0]", "replica[1]"}


# ------------------------------------------------- cadences + door clock


def test_door_cadences_fire_engines_at_tick_cost():
    fast, slow = _AEngine(1), _BEngine(1, tick_cost=3)
    door = FrontDoor(fast=fast, slow=slow)
    ticks = []
    for _ in range(9):
        door.step()
        ticks.append((fast.tick, slow.tick))
    assert ticks[0] == (1, 0)
    assert ticks[2] == (3, 1)
    assert ticks[8] == (9, 3)


def test_door_converts_latency_to_door_clock():
    slow = _BEngine(1, max_queue=4, tick_cost=2)
    door = FrontDoor(slow=slow)
    done = door.run([_BReq(uid=u, work=1, arrival_tick=0) for u in range(3)],
                    max_ticks=50, on_undrained="raise")
    assert len(done) == 3
    eng = slow.latency_summary()
    via_door = door.latency_summary()["slow"]
    for key in ("mean_queue_ticks", "mean_serve_ticks", "p95_queue_ticks",
                "p99_serve_ticks"):
        assert via_door[key] == 2 * eng[key]
    assert via_door["served"] == eng["served"]
    health = door.health()["engines"]["slow"]
    assert health["tick_cost"] == 2
    assert health["queue_depth"] == 0
    assert health["latency"]["mean_serve_ticks"] == 2 * eng["mean_serve_ticks"]


def test_door_converts_pool_latency_at_depth():
    pool = ReplicaPool(_BEngine(1, tick_cost=2), _BEngine(1, tick_cost=2))
    door = FrontDoor(b=pool)
    door.run([_BReq(uid=u, work=2) for u in range(4)],
             max_ticks=50, on_undrained="raise")
    summary = door.latency_summary()["b"]
    for rep_summary, rep in zip(summary["replicas"], pool.replicas):
        raw = rep.latency_summary()
        assert rep_summary["mean_serve_ticks"] == 2 * raw["mean_serve_ticks"]


def test_door_route_error_lists_registered_types():
    door = FrontDoor(a=_AEngine(1), b=_BEngine(1))
    with pytest.raises(TypeError) as err:
        door.submit(object())
    msg = str(err.value)
    assert "AReq" in msg and "BReq" in msg


def test_lockstep_door_rejects_nonunit_costs():
    with pytest.raises(ValueError):
        FrontDoor(lockstep=True, b=_BEngine(1, tick_cost=2))
    with pytest.raises(ValueError):
        FrontDoor()


# ------------------------------------ the door over the port's real engines


def test_front_door_routes_sessions_next_to_lm():
    """SessionRequest routes to the SessionEngine while a plain Request
    lands on the LM engine: one merged completion stream."""
    cfg = get_smoke_config("rwkv6-3b").replace(dtype=torch.float32)
    params, _ = get_family(cfg).init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(5)
    lm = ServeEngine(params, cfg, max_batch=2, max_len=64, device="cpu")
    chat = SessionEngine(params, cfg, max_batch=1, max_len=256,
                         prefill_chunk=4, device="cpu")
    door = FrontDoor(lm=lm, chat=chat)
    turns = [rng.integers(0, cfg.vocab, rng.integers(3, 8)).tolist()
             for _ in range(2)]
    reqs = [Request(uid=0, prompt=rng.integers(0, cfg.vocab, 4).tolist(),
                    max_new_tokens=3),
            SessionRequest(uid=100, turns=turns, max_new_tokens=3)]
    merged = door.run(reqs)
    assert sorted(n for n, _ in merged) == ["chat", "lm"]
    (sreq,) = [r for n, r in merged if n == "chat"]
    assert sreq.done and len(sreq.outputs) == 2


def test_front_door_routes_streams_next_to_vision():
    """StreamRequest routes to the StreamEngine while VisionRequest lands
    on the VisionEngine; per-engine clocks in lockstep."""
    cfg = MNV2Config(variant="p2m", image_size=20, width=0.25,
                     head_channels=16)
    params, bn = init_mnv2(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    dcfg = DetectConfig(head_channels=8, max_dets=4)
    det = init_detect_head(torch.Generator().manual_seed(1), 16, dcfg,
                           device="cpu")
    stream = StreamEngine(params, bn, cfg, det, det_cfg=dcfg, max_streams=1,
                          device="cpu")
    vision = VisionEngine(params, bn, cfg, max_batch=2, device="cpu")
    door = FrontDoor(stream=stream, vision=vision)
    imgs = SyntheticVWW(image_size=20, batch=2).batch_at(0)["images"]
    frames = SyntheticVideo(image_size=20, n_frames=3, hold=2,
                            seed=0).frames()
    reqs = [StreamRequest(uid=0, frames=frames)] + [
        VisionRequest(uid=100 + i, image=imgs[i]) for i in range(2)]
    merged = door.run(reqs)
    names = [n for n, _ in merged]
    assert names.count("stream") == 1 and names.count("vision") == 2
    (sreq,) = [r for n, r in merged if n == "stream"]
    assert sreq.frames_done == 3
    assert door.tick == stream.tick == vision.tick
    assert door.health()["engines"]["vision"]["degraded"] is None
