"""The port's fault tolerance (`repro_torch.serving.faults`, the
scheduler's containment, the front door's isolation) on the CPU: a
mirror of `tests/test_faults.py` against the port's scheduler and
engines, and the port's injector held to the reference's.

The injector draws every decision from a per-decision
`np.random.SeedSequence`, so for the same plan and the same traffic the
port's injector and the reference's poison the same uids at the same
ticks; that is held on the scheduler's dummy adapters in both
frameworks, with their tick-domain traces compared byte for byte.

Left out: the reference's degradation ladder (the vision and stream
engines swapping the fused conv for the patches path after repeated
launch faults).  On the card that would be a quiet fall back from a
kernel to a plain version, so the port has none, and a test here holds
the opposite: after the faults the engine serves through its own stem
path.  The sharded-engine test has its mirror in
`tests/test_torch_scale_out.py`, on spawned gloo worlds.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.obs import Tracer as JTracer
from repro.serving import FaultInjector as JFaultInjector
from repro.serving import FaultPlan as JFaultPlan
from repro.serving import ScheduledRequest as JScheduledRequest
from repro.serving import SlotEngine as JSlotEngine
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticVWW
from repro_torch.launch.serve import FrontDoor
from repro_torch.models.families import get_family
from repro_torch.models.mobilenetv2 import MNV2Config, init_mnv2
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serving import (
    ADMITTED,
    REJECTED_DEADLINE,
    REJECTED_HALTED,
    REJECTED_QUEUE,
    SMOKE_PLAN,
    FaultInjector,
    FaultPlan,
    InjectedLaunchError,
    Request,
    ScheduledRequest,
    ServeEngine,
    SlotEngine,
    VisionEngine,
    VisionRequest,
    shed_deadline,
)
from repro_torch.serving.faults import _corrupt_slot_row

# ------------------------------------------------------------- dummy adapters


@dataclasses.dataclass
class _Req(ScheduledRequest):
    uid: int = 0


@dataclasses.dataclass
class _ReqB(ScheduledRequest):
    uid: int = 0


@dataclasses.dataclass
class _StreamReq(ScheduledRequest):
    uid: int = 0
    length: int = 1
    observed: list = dataclasses.field(default_factory=list)


class _OneTickEngine(SlotEngine):
    request_type = _Req

    def _launch(self, active):
        return None

    def _absorb(self, i, req, result):
        return True


class _StatefulStreamEngine(SlotEngine):
    """Multi-tick adapter with observable per-slot state: the occupant
    sees its slot counter as exactly 1..length iff recycling is
    leak-free."""

    request_type = _StreamReq

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.slot_state = [0] * self.n_slots

    def _on_admit(self, i, req):
        self.slot_state[i] = 0

    def _launch(self, active):
        for i, _ in active:
            self.slot_state[i] += 1
        return None

    def _absorb(self, i, req, result):
        req.observed.append(self.slot_state[i])
        return len(req.observed) >= req.length


class _PoisonEngine(_StatefulStreamEngine):
    """Raises a slot-attributed fault whenever a poisoned uid occupies a
    slot."""

    def __init__(self, *a, poison=(), **kw):
        super().__init__(*a, **kw)
        self.poison = set(poison)

    def _launch(self, active):
        for i, r in active:
            if r.uid in self.poison:
                exc = RuntimeError(f"poisoned uid {r.uid}")
                exc.slot = i
                raise exc
        return super()._launch(active)


class _AnonFaultEngine(_OneTickEngine):
    """Raises an *anonymous* fault (no .slot) on the given ticks."""

    def __init__(self, *a, bad_ticks=(), **kw):
        super().__init__(*a, **kw)
        self.bad_ticks = set(bad_ticks)

    def _launch(self, active):
        if self.tick in self.bad_ticks:
            raise RuntimeError("anonymous launch fault")
        return None


class _FloatEngine(SlotEngine):
    """Launch result is a per-slot float array — NaN-guard territory."""

    request_type = _Req

    def _launch(self, active):
        return np.full((self.n_slots, 3), 0.5, np.float32)

    def _absorb(self, i, req, result):
        return True


class _BadAbsorbEngine(SlotEngine):
    """An adapter bug past launch containment: ``_absorb`` raises."""

    request_type = _ReqB

    def _launch(self, active):
        return None

    def _absorb(self, i, req, result):
        raise RuntimeError("absorb bug")


# --------------------------------------------------- deadline shedding policy


def test_shed_deadline_expired_waiter_first():
    q = [_Req(uid=0, deadline_tick=9), _Req(uid=1, deadline_tick=2),
         _Req(uid=2)]
    inc = _Req(uid=3)
    inc.submitted_tick = 3
    victim = shed_deadline(q, inc)
    assert victim.uid == 1
    assert [r.uid for r in q] == [0, 2]


def test_shed_deadline_lowest_priority_newest_within_class():
    q = [_Req(uid=0, priority=1), _Req(uid=1, priority=0),
         _Req(uid=2, priority=0)]
    inc = _Req(uid=3, priority=2)
    inc.submitted_tick = 0
    victim = shed_deadline(q, inc)
    assert victim.uid == 2
    assert [r.uid for r in q] == [0, 1]


def test_shed_deadline_arrival_can_be_the_victim():
    q = [_Req(uid=0, priority=1)]
    inc = _Req(uid=1, priority=0)
    inc.submitted_tick = 0
    assert shed_deadline(q, inc) is inc
    assert [r.uid for r in q] == [0]


def test_engine_deadline_eviction_sheds_expired():
    eng = _StatefulStreamEngine(1, max_queue=2, evict="deadline")
    eng.submit(_StreamReq(uid=0, length=6))
    eng.step()
    eng.submit(_StreamReq(uid=1, length=1, deadline_tick=2))
    eng.submit(_StreamReq(uid=2, length=1))
    eng.step()
    eng.step()
    assert eng.submit(_StreamReq(uid=3, length=1)) == ADMITTED
    assert [r.uid for r in eng.evicted] == [1]
    assert eng.evicted[0].evicted_tick == 3
    assert eng.evicted[0].queue_ticks == 2
    assert eng.evicted[0].deadline_missed
    done = eng.run()
    assert {r.uid for r in done} == {0, 2, 3}


# ----------------------------------------------------------- admission control


def test_admission_control_rejects_projected_misses():
    eng = _OneTickEngine(1, admission="deadline")
    statuses = [eng.submit(_Req(uid=i, deadline_tick=2)) for i in range(6)]
    assert statuses[0] == ADMITTED and statuses[1] == ADMITTED
    assert statuses[2:] == [REJECTED_DEADLINE] * 4
    assert [r.uid for r in eng.rejected] == [2, 3, 4, 5]
    assert all(r.evicted and r.evicted_tick == 0 for r in eng.rejected)
    done = eng.run()
    assert [r.uid for r in done] == [0, 1]
    assert all(not r.deadline_missed for r in done)
    s = eng.latency_summary()
    assert s["rejections"] == 4 and s["rejected"] == 4


def test_admission_control_ignores_deadline_free_traffic():
    eng = _OneTickEngine(1, admission="deadline")
    assert all(eng.submit(_Req(uid=i)) == ADMITTED for i in range(10))
    assert len(eng.run()) == 10


def test_submit_status_on_queue_overflow():
    eng = _OneTickEngine(1, max_queue=1, evict="drop-newest")
    assert eng.submit(_Req(uid=0)) == ADMITTED
    assert eng.submit(_Req(uid=1)) == REJECTED_QUEUE
    old = _OneTickEngine(1, max_queue=1, evict="drop-oldest")
    assert old.submit(_Req(uid=0)) == ADMITTED
    assert old.submit(_Req(uid=1)) == ADMITTED
    assert [r.uid for r in old.evicted] == [0]


def test_evicted_accounting_in_latency_summary():
    eng = _StatefulStreamEngine(1, max_queue=1, evict="drop-oldest")
    eng.submit(_StreamReq(uid=0, length=4))
    eng.step()
    eng.submit(_StreamReq(uid=1, length=1))
    eng.step()
    eng.submit(_StreamReq(uid=2, length=1))
    assert [r.uid for r in eng.evicted] == [1]
    assert eng.evicted[0].queue_ticks == 1
    assert all(r.queue_ticks >= 0
               for r in eng.evicted + eng.completed + eng.queue)
    eng.run()
    s = eng.latency_summary()
    assert s["evicted"] == 1 and s["evictions"] == 1
    assert s["failed"] == 0 and s["failures"] == 0


# ------------------------------------------------------------- slot watchdog


def test_watchdog_evicts_stuck_occupant_leak_free():
    inj = FaultInjector(FaultPlan(stuck_uids=(0,)))
    eng = _StatefulStreamEngine(1, max_serve_ticks=3, faults=inj)
    done = eng.run([_StreamReq(uid=0, length=1),
                    _StreamReq(uid=1, length=2)])
    assert [r.uid for r in done] == [1]
    assert done[0].observed == [1, 2]
    assert [r.uid for r in eng.failed] == [0]
    assert eng.failed[0].failure == "watchdog"
    assert eng.failed[0].serve_ticks == 3
    assert eng.stats["watchdog_evictions"] == 1
    assert inj.counts["stuck"] == 1 and inj.poisoned_uids == {0}


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 3))
def test_watchdog_containment_property(seed, n_slots):
    rng = np.random.default_rng(seed)
    n_req = int(rng.integers(4, 14))
    stuck = tuple(int(u) for u in rng.choice(n_req, n_req // 3,
                                             replace=False))
    inj = FaultInjector(FaultPlan(stuck_uids=stuck))
    eng = _StatefulStreamEngine(n_slots, max_queue=4, evict="drop-newest",
                                max_serve_ticks=4, faults=inj)
    reqs = [_StreamReq(uid=i, length=int(rng.integers(1, 4)),
                       arrival_tick=int(rng.integers(0, 6)))
            for i in range(n_req)]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        done = eng.run(reqs, max_ticks=400)
    assert all(s is None for s in eng.slots)
    seen = ([r.uid for r in done] + [r.uid for r in eng.failed]
            + [r.uid for r in eng.evicted])
    assert sorted(seen) == list(range(n_req))
    assert {r.uid for r in eng.failed} == set(stuck) - {
        r.uid for r in eng.evicted}
    for r in done:
        assert r.observed == list(range(1, r.length + 1))


# ------------------------------------------------------ drive() undrained


def test_drive_never_silently_truncates():
    inj = FaultInjector(FaultPlan(stuck_uids=(0,)))
    eng = _StatefulStreamEngine(1, faults=inj)
    eng.submit(_StreamReq(uid=0, length=1))
    with pytest.warns(RuntimeWarning, match="1 slots occupied"):
        eng.run(max_ticks=5)
    eng2 = _StatefulStreamEngine(1, faults=FaultInjector(
        FaultPlan(stuck_uids=(0,))))
    eng2.submit(_StreamReq(uid=0, length=1))
    with pytest.raises(RuntimeError, match="undrained"):
        eng2.run(max_ticks=5, on_undrained="raise")


def test_drive_undrained_counts_unsubmitted_arrivals():
    eng = _OneTickEngine(1)
    with pytest.warns(RuntimeWarning, match="1 arrivals unsubmitted"):
        eng.run([_Req(uid=0, arrival_tick=50)], max_ticks=3)


# ------------------------------------------------------- launch containment


def test_slot_attributed_fault_quarantines_only_victim():
    eng = _PoisonEngine(2, poison={2, 4}, launch_retries=1)
    done = eng.run([_StreamReq(uid=i, length=2) for i in range(6)])
    assert {r.uid for r in done} == {0, 1, 3, 5}
    assert {r.uid for r in eng.failed} == {2, 4}
    assert all(r.failure == "launch" for r in eng.failed)
    assert eng.stats["launch_faults"] == 4
    for r in done:
        assert r.observed == list(range(1, r.length + 1))


def test_anonymous_fault_quarantines_cohort_and_recovers():
    eng = _AnonFaultEngine(2, bad_ticks={1}, launch_retries=2)
    done = eng.run([_Req(uid=i) for i in range(4)])
    assert {r.uid for r in eng.failed} == {0, 1}
    assert {r.uid for r in done} == {2, 3}
    assert eng.stats["launch_faults"] == 3


def test_transient_fault_cleared_by_retry():
    class _Transient(_OneTickEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.raises_left = 1

        def _launch(self, active):
            if self.raises_left:
                self.raises_left -= 1
                raise RuntimeError("transient")
            return None

    eng = _Transient(2, launch_retries=2)
    done = eng.run([_Req(uid=i) for i in range(2)])
    assert {r.uid for r in done} == {0, 1}
    assert eng.failed == []
    assert eng.stats["launch_faults"] == 1


def test_injected_launch_error_names_its_slot():
    """An explicit fault tick is persistent: each raise names one victim
    slot, that request alone is quarantined, and the survivors' fresh
    attempt on the same tick raises again and names the next."""
    inj = FaultInjector(FaultPlan(launch_error_ticks=(1,)))
    eng = _OneTickEngine(2, launch_retries=0, faults=inj)
    eng.submit(_Req(uid=0))
    eng.submit(_Req(uid=1))
    eng.step()
    assert [r.failure for r in eng.failed] == ["launch", "launch"]
    assert inj.counts["launch"] == 2 and inj.poisoned_uids == {0, 1}
    eng.submit(_Req(uid=2))
    assert [r.uid for r in eng.step()] == [2]  # tick 2 is clean
    err = InjectedLaunchError(3, 7)
    assert (err.slot, err.tick) == (3, 7) and "slot 3" in str(err)


# ------------------------------------------------------------- NaN/Inf guard


def test_nan_guard_fails_one_request_not_the_engine():
    inj = FaultInjector(FaultPlan(nan_ticks=(1,)))
    eng = _FloatEngine(2, faults=inj)
    done = eng.run([_Req(uid=i) for i in range(4)])
    assert len(done) == 3 and len(eng.failed) == 1
    assert eng.failed[0].failure == "nonfinite"
    assert eng.failed[0].uid in {0, 1}
    assert inj.counts["nan"] == 1


def test_serve_engine_validate_rejects_corrupted_token():
    nxt, adv = np.array([3, -1]), np.array([1, 1])
    assert ServeEngine._validate(None, 0, None, (nxt, adv))
    assert not ServeEngine._validate(None, 1, None, (nxt, adv))


def test_corruption_clones_a_tensor_on_its_own_device():
    """A tensor leaf is cloned and written where it lies (a CUDA tensor is
    never copied to the host); host arrays are copied; the input is
    untouched; leaves without a slot axis and bool leaves pass."""
    probs = torch.full((3, 2), 0.5)
    toks = torch.arange(3)
    mask = torch.ones(3, dtype=torch.bool)
    host = np.ones((3, 4), np.float32)
    out = _corrupt_slot_row((probs, {"t": toks, "m": mask}, [host],
                             torch.ones(5)), 1, 3)
    p, d, (h,), other = out
    assert isinstance(p, torch.Tensor) and p.device == probs.device
    assert torch.isnan(p[1]).all() and not torch.isnan(p[[0, 2]]).any()
    assert d["t"].tolist() == [0, -1, 2] and d["m"] is mask
    assert np.isnan(h[1]).all() and np.isfinite(host).all()
    assert other.shape == (5,) and torch.equal(other, torch.ones(5))
    assert not torch.isnan(probs).any() and toks.tolist() == [0, 1, 2]


# ------------------------------------------------- injector free when off


def test_zero_fault_injector_is_bitwise_free_on_schedule():
    def run_one(faults):
        eng = _StatefulStreamEngine(2, max_queue=2, evict="deadline",
                                    max_serve_ticks=10, faults=faults)
        rng = np.random.default_rng(7)
        reqs = [_StreamReq(uid=i, length=int(rng.integers(1, 5)),
                           arrival_tick=int(rng.integers(0, 4)),
                           deadline_tick=20 + i, priority=i % 3)
                for i in range(9)]
        done = eng.run(reqs)
        return eng, [(r.uid, r.submitted_tick, r.served_tick,
                      r.finished_tick, r.serve_ticks, tuple(r.observed))
                     for r in done]

    bare, ledger_bare = run_one(None)
    inj = FaultInjector(FaultPlan())
    wrapped, ledger_wrapped = run_one(inj)
    assert ledger_bare == ledger_wrapped
    assert [r.uid for r in bare.evicted] == [r.uid for r in wrapped.evicted]
    for k in ("launches", "served", "evictions", "failures",
              "watchdog_evictions", "launch_faults", "slot_ticks",
              "busy_slot_ticks"):
        assert bare.stats[k] == wrapped.stats[k], k
    assert inj.counts == {"launch": 0, "nan": 0, "slow": 0, "stuck": 0}
    assert inj.poisoned_uids == set()


CFG = MNV2Config(variant="p2m", image_size=20, width=0.25, head_channels=16)


@pytest.fixture(scope="module")
def vision_model():
    return init_mnv2(torch.Generator().manual_seed(0), CFG, device="cpu")


def _images(n, seed=0):
    return SyntheticVWW(image_size=20, batch=n, seed=seed).batch_at(0)[
        "images"]


def test_zero_fault_injector_is_bitwise_free_on_real_outputs(vision_model):
    params, bn = vision_model
    imgs = _images(5)

    def run_one(faults):
        eng = VisionEngine(params, bn, CFG, max_batch=2, faults=faults,
                           device="cpu")
        return eng.run([VisionRequest(uid=i, image=imgs[i])
                        for i in range(5)])

    bare = run_one(None)
    wrapped = run_one(FaultInjector(FaultPlan()))
    for a, b in zip(bare, wrapped):
        assert a.uid == b.uid and a.label == b.label
        np.testing.assert_array_equal(a.probs, b.probs)


# ------------------------------------------------ no degradation ladder


def test_vision_engine_keeps_its_stem_path_after_launch_faults(
        vision_model, monkeypatch):
    """Where the reference degrades to the patches conv after
    ``degrade_after`` launch faults, the port's engine quarantines the
    faulted request and serves the rest through its own stem path: the
    same forward (the same ``p2m_impl``) and the bits of a fault-free
    run."""
    params, bn = vision_model
    imgs = _images(4)
    inj = FaultInjector(FaultPlan(launch_error_ticks=(1, 2)))
    eng = VisionEngine(params, bn, CFG, max_batch=1, launch_retries=0,
                       faults=inj, device="cpu")
    impls = []
    real = eng.forward

    def forward(images, p2m_impl=None):
        impls.append(p2m_impl)
        return real(images, p2m_impl=p2m_impl)

    monkeypatch.setattr(eng, "forward", forward)
    done = eng.run([VisionRequest(uid=i, image=imgs[i]) for i in range(4)])
    assert inj.counts["launch"] == 2 and eng.stats["launch_faults"] == 2
    assert {r.uid for r in eng.failed} == {0, 1}
    assert eng.health()["degraded"] is None
    assert impls == [None, None]
    bare = VisionEngine(params, bn, CFG, max_batch=1, device="cpu")
    ref = {r.uid: r for r in bare.run(
        [VisionRequest(uid=i, image=imgs[i]) for i in range(4)])}
    assert {r.uid for r in done} == {2, 3}
    for r in done:
        np.testing.assert_array_equal(r.probs, ref[r.uid].probs)


def test_stream_engine_gate_drops_to_dense_on_poisoned_cache(vision_model):
    from repro_torch.models.mobilenetv2 import head_out_channels
    from repro_torch.video import (DetectConfig, StreamEngine, StreamRequest,
                                   SyntheticVideo, init_detect_head)

    params, bn = vision_model
    det = init_detect_head(torch.Generator().manual_seed(2),
                           head_out_channels(CFG), DetectConfig(),
                           device="cpu")
    eng = StreamEngine(params, bn, CFG, det, max_streams=1, device="cpu")
    frames = SyntheticVideo(image_size=20, n_frames=6, hold=6,
                            seed=0).frames()
    req = StreamRequest(uid=0, frames=frames)
    eng.submit(req)
    eng.step()
    eng.step()
    assert req.ledger.rerun_frames == 1
    eng._cached_stem[0, 0, 0, 0] = float("nan")
    eng.step()
    assert eng._gates[0].disabled
    assert eng._gate_faults == 1
    assert eng.health()["gate_faults"] == 1
    done = eng.run()
    assert [r.uid for r in done] == [0]
    assert req.ledger.rerun_frames == 5
    for boxes, scores in req.frame_outputs:
        assert np.isfinite(boxes).all() and np.isfinite(scores).all()


def test_delta_gate_disable_and_self_validation():
    from repro_torch.core.bandwidth import FirstLayerGeom
    from repro_torch.video.delta import DeltaGate, DeltaGateConfig

    geom = FirstLayerGeom(image_size=8, kernel=4, padding=0, stride=4,
                          out_channels=4, out_bits=8)
    frame = np.zeros((8, 8, 3), np.float32)
    gate = DeltaGate(DeltaGateConfig(threshold=1.0), geom)
    assert gate.should_rerun(frame)
    gate.observe(frame, True)
    assert not gate.should_rerun(frame)
    gate.disable()
    assert gate.should_rerun(frame)

    g2 = DeltaGate(DeltaGateConfig(threshold=1.0), geom)
    g2.observe(frame, True)
    assert g2.should_rerun(np.zeros((4, 4, 3), np.float32))
    assert g2.disabled

    g3 = DeltaGate(DeltaGateConfig(threshold=1.0), geom)
    g3.observe(np.full((8, 8, 3), np.nan, np.float32), True)
    assert g3.should_rerun(frame)
    assert g3.disabled


# ------------------------------------------------------ halt + front door


def test_halt_fails_all_traffic_visibly():
    eng = _StatefulStreamEngine(1)
    eng.submit(_StreamReq(uid=0, length=5))
    eng.submit(_StreamReq(uid=1, length=1))
    eng.step()
    eng.halt("test outage")
    assert not eng.busy()
    assert {r.uid for r in eng.failed} == {0, 1}
    assert all(r.failure == "halt:test outage" for r in eng.failed)
    assert eng.queue == [] and all(s is None for s in eng.slots)
    assert eng.submit(_StreamReq(uid=2, length=1)) == REJECTED_HALTED
    assert eng.step() == []
    assert eng.health()["halted"] == "test outage"


def test_front_door_isolates_failed_engine():
    good, bad = _OneTickEngine(2), _BadAbsorbEngine(2)
    door = FrontDoor(good=good, bad=bad)
    reqs = ([_Req(uid=i) for i in range(4)]
            + [_ReqB(uid=10 + i) for i in range(3)])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        done = door.run(reqs)
    assert [n for n, _ in done] == ["good"] * 4
    assert "bad" in door.down and "absorb bug" in door.down["bad"]
    assert bad.halted is not None
    assert {r.uid for r in bad.failed} == {10, 11, 12}
    assert door.submit(_ReqB(uid=13)) == REJECTED_HALTED
    assert door.submit(_Req(uid=4)) == ADMITTED
    assert [r.uid for _, r in door.run()] == [0, 1, 2, 3, 4]
    health = door.health()
    assert health["down"] == door.down
    assert health["engines"]["bad"]["halted"] is not None
    assert health["engines"]["good"]["halted"] is None


def test_front_door_chaos_smoke_never_deadlocks():
    rng = np.random.default_rng(0)
    a = _OneTickEngine(2, max_queue=4, evict="deadline",
                       admission="deadline", max_serve_ticks=6,
                       launch_retries=1,
                       faults=FaultInjector(SMOKE_PLAN))
    b = _StatefulStreamEngine(
        2, max_queue=4, evict="deadline", admission="deadline",
        max_serve_ticks=8, launch_retries=1,
        faults=FaultInjector(dataclasses.replace(SMOKE_PLAN, seed=1)))
    door = FrontDoor(a=a, b=b)
    reqs = [_Req(uid=i, arrival_tick=int(rng.integers(0, 6)),
                 deadline_tick=int(rng.integers(10, 40)))
            for i in range(12)]
    reqs += [_StreamReq(uid=100 + i, length=int(rng.integers(1, 5)),
                        arrival_tick=int(rng.integers(0, 6)),
                        deadline_tick=int(rng.integers(20, 60)))
             for i in range(12)]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        door.run(reqs, max_ticks=400)
    for eng in (a, b):
        assert all(s is None for s in eng.slots)
        seen = [r.uid for r in
                eng.completed + eng.failed + eng.evicted + eng.rejected]
        assert sorted(seen) == sorted(set(seen))
    total = sum(len(e.completed) + len(e.failed) + len(e.evicted)
                + len(e.rejected) for e in (a, b))
    assert total == 24
    assert len(door.completed) > 0


def test_serve_engine_contains_injected_corruption_end_to_end():
    cfg = get_smoke_config("rwkv6-3b").replace(dtype=torch.float32)
    params, _ = get_family(cfg).init(torch.Generator().manual_seed(0), cfg)
    inj = FaultInjector(FaultPlan(nan_ticks=(2,)))
    eng = ServeEngine(params, cfg, max_batch=2, max_len=16, faults=inj,
                      device="cpu")
    done = eng.run([Request(uid=i, prompt=[1 + i], max_new_tokens=2)
                    for i in range(3)])
    assert len(eng.failed) == 1 and eng.failed[0].failure == "nonfinite"
    assert {r.uid for r in done} == set(range(3)) - {eng.failed[0].uid}
    for r in done:
        assert len(r.output) == 2 and all(t >= 0 for t in r.output)


def test_injector_registers_its_summary():
    reg = MetricsRegistry()
    inj = FaultInjector(FaultPlan(stuck_uids=(0,)), registry=reg)
    _StatefulStreamEngine(1, max_serve_ticks=2, faults=inj,
                          registry=reg).run([_StreamReq(uid=0)])
    (scope,) = [s for s in reg.snapshot()["components"]
                if s.startswith("FaultInjector")]
    assert reg.snapshot()["components"][scope]["faults"] == inj.summary()
    assert inj.summary() == {"launch": 0, "nan": 0, "slow": 0, "stuck": 1,
                             "poisoned": 1}


# ------------------------------------- the port's injector = the reference's


@dataclasses.dataclass
class _JStreamReq(JScheduledRequest):
    uid: int = 0
    length: int = 1
    observed: list = dataclasses.field(default_factory=list)


class _JFloatStreamEngine(JSlotEngine):
    """The reference's scheduler with the port adapter's behaviour: a
    per-slot float result (NaN-guard territory), multi-tick slots."""

    request_type = _JStreamReq

    def _launch(self, active):
        return np.full((self.n_slots, 2), 0.5, np.float32)

    def _absorb(self, i, req, result):
        req.observed.append(self.tick)
        return len(req.observed) >= req.length


class _FloatStreamEngine(SlotEngine):
    request_type = _StreamReq

    def _launch(self, active):
        return np.full((self.n_slots, 2), 0.5, np.float32)

    def _absorb(self, i, req, result):
        req.observed.append(self.tick)
        return len(req.observed) >= req.length


PLANS = [
    dict(launch_error_rate=0.2, nan_rate=0.15, stuck_rate=0.1, seed=3),
    dict(launch_error_rate=0.05, nan_rate=0.05, slow_rate=0.1,
         stuck_rate=0.08, seed=0),  # SMOKE_PLAN
    dict(launch_error_rate=0.5, seed=11, launch_error_ticks=(2, 5),
         nan_ticks=(4,), stuck_uids=(1, 7)),
    dict(nan_rate=1.0, seed=2),
]


@pytest.mark.parametrize("plan", PLANS, ids=[f"plan{i}" for i in
                                             range(len(PLANS))])
@pytest.mark.parametrize("n_slots", [1, 3])
def test_injector_decisions_match_the_reference(plan, n_slots):
    """The same plan over the same traffic: the same faults (counts,
    poisoned uids, failures with their kinds), the same completions, and
    byte-identical tick-domain traces, which stamp every injection."""
    rng = np.random.default_rng(n_slots)
    traffic = [(i, 1 + int(rng.integers(0, 4)), int(rng.integers(0, 8)))
               for i in range(14)]
    kw = dict(max_queue=6, evict="deadline", max_serve_ticks=5,
              launch_retries=1)

    def run(engine_cls, req_cls, injector, plan_cls, tracer):
        tr = tracer()
        inj = injector(plan_cls(**plan))
        eng = engine_cls(n_slots, faults=inj, tracer=tr, **kw)
        tr.label(eng, "engine")  # the classes' names differ
        eng.run([req_cls(uid=u, length=n, arrival_tick=t)
                 for u, n, t in traffic], max_ticks=500,
                on_undrained="raise")
        return (inj.counts, sorted(inj.poisoned_uids),
                [(r.uid, r.failure) for r in eng.failed],
                [(r.uid, r.finished_tick) for r in eng.completed],
                [r.uid for r in eng.evicted], tr.export())

    ref = run(_JFloatStreamEngine, _JStreamReq, JFaultInjector, JFaultPlan,
              JTracer)
    port = run(_FloatStreamEngine, _StreamReq, FaultInjector, FaultPlan,
               Tracer)
    assert port == ref
    assert sum(ref[0].values()) > 0  # the plan injected something
    assert '"inject"' in port[-1]
