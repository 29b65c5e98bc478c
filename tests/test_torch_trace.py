"""The port's tick-domain tracer (`repro_torch.obs.trace`) on the CPU: a
mirror of the tracer, validator and undrained-report tests of
`tests/test_obs.py` on the port's scheduler, front door and injector,
and the port's export held byte for byte to the reference's on the same
seeded chaos through a mixed-cadence door.

The two contracts of DESIGN.md §13.3 hold on the port as on the
reference: tracing is bit-for-bit free when disabled, and deterministic
when enabled (two fresh tracers over the same seeded run export the same
bytes, which pass `validate_trace_events`).
"""
import dataclasses
import json

import pytest

from repro.launch.serve import FrontDoor as JFrontDoor
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import Tracer as JTracer
from repro.serving import FaultInjector as JFaultInjector
from repro.serving import FaultPlan as JFaultPlan
from repro.serving import ScheduledRequest as JScheduledRequest
from repro.serving import SlotEngine as JSlotEngine
from repro_torch import obs
from repro_torch.launch.serve import FrontDoor
from repro_torch.obs import (
    EVENT_NAMES,
    REQUEST_TID_BASE,
    TERMINAL_EVENTS,
    MetricsRegistry,
    Tracer,
    validate_trace_events,
)
from repro_torch.serving import (
    FaultInjector,
    FaultPlan,
    ScheduledRequest,
    SlotEngine,
)

# ------------------------------------------------------------- dummy adapters


def _adapters(base_req, base_engine):
    """The dummy adapters of `tests/test_obs.py` over either framework's
    scheduler: a one-tick modality, a second one-tick modality and a
    multi-tick one that records the ticks it was served on."""

    @dataclasses.dataclass
    class Req(base_req):
        uid: int = 0

    @dataclasses.dataclass
    class ReqB(base_req):
        uid: int = 0

    @dataclasses.dataclass
    class StreamReq(base_req):
        uid: int = 0
        length: int = 1
        observed: list = dataclasses.field(default_factory=list)

    class OneTickEngine(base_engine):
        request_type = Req

        def _launch(self, active):
            return None

        def _absorb(self, i, req, result):
            return True

    class OneTickEngineB(OneTickEngine):
        request_type = ReqB

    class StreamEngine(base_engine):
        request_type = StreamReq

        def _launch(self, active):
            return None

        def _absorb(self, i, req, result):
            req.observed.append(self.tick)
            return len(req.observed) >= req.length

    return Req, ReqB, StreamReq, OneTickEngine, OneTickEngineB, StreamEngine


PORT = dict(zip(("Req", "ReqB", "StreamReq", "OneTick", "OneTickB",
                 "Stream"), _adapters(ScheduledRequest, SlotEngine)),
            FrontDoor=FrontDoor, FaultInjector=FaultInjector,
            FaultPlan=FaultPlan, Tracer=Tracer,
            MetricsRegistry=MetricsRegistry)
REF = dict(zip(("Req", "ReqB", "StreamReq", "OneTick", "OneTickB",
                "Stream"), _adapters(JScheduledRequest, JSlotEngine)),
           FrontDoor=JFrontDoor, FaultInjector=JFaultInjector,
           FaultPlan=JFaultPlan, Tracer=JTracer,
           MetricsRegistry=JMetricsRegistry)


def _chaos_run(tracer=None, registry=None, m=PORT):
    inj = m["FaultInjector"](m["FaultPlan"](launch_error_rate=0.2,
                                            stuck_rate=0.15, seed=7),
                             registry=registry)
    eng = m["Stream"](2, max_queue=4, evict="deadline", max_serve_ticks=6,
                      launch_retries=1, faults=inj, tracer=tracer,
                      registry=registry)
    reqs = [m["StreamReq"](uid=i, length=1 + i % 3, arrival_tick=i // 2,
                           deadline_tick=i + 25) for i in range(10)]
    eng.run(reqs, max_ticks=200)
    return eng


def _traced_door_replay(tracer, m=PORT):
    """One seeded chaos replay through a mixed-cadence event-driven
    front door: two modalities, tick_cost 1 and 2, launch faults and
    stuck slots."""
    reg = m["MetricsRegistry"]
    inj = m["FaultInjector"](m["FaultPlan"](launch_error_rate=0.15,
                                            stuck_rate=0.1, seed=3),
                             registry=reg())
    a = m["OneTick"](2, max_queue=3, evict="deadline", max_serve_ticks=5,
                     launch_retries=1, faults=inj, registry=reg())
    b = m["OneTickB"](1, max_queue=2, tick_cost=2, registry=reg())
    door = m["FrontDoor"](tracer=tracer, fast=a, slow=b, registry=reg())
    reqs = [m["Req"](uid=i, arrival_tick=i // 3, deadline_tick=i + 20)
            for i in range(12)]
    reqs += [m["ReqB"](uid=100 + i, arrival_tick=i // 2) for i in range(6)]
    door.run(reqs, max_ticks=300)
    return door


# ------------------------------------------------------------------ exports


def test_obs_exports_the_reference_names():
    import repro.obs

    assert sorted(obs.__all__) == sorted(repro.obs.__all__)
    assert EVENT_NAMES == repro.obs.EVENT_NAMES
    assert TERMINAL_EVENTS == repro.obs.TERMINAL_EVENTS
    assert REQUEST_TID_BASE == repro.obs.REQUEST_TID_BASE


# ------------------------------------------------------------------ tracer


def test_disabled_tracer_is_bitwise_free():
    base = _chaos_run(tracer=None, registry=MetricsRegistry())
    off = Tracer(enabled=False)
    dis = _chaos_run(tracer=off, registry=MetricsRegistry())
    on = _chaos_run(tracer=Tracer(), registry=MetricsRegistry())
    assert off.events == []

    def ledgers(e):
        return {
            "completed": [r.uid for r in e.completed],
            "failed": [(r.uid, r.failure) for r in e.failed],
            "evicted": [r.uid for r in e.evicted],
            "rejected": [r.uid for r in e.rejected],
            "observed": {r.uid: r.observed for r in e.completed},
            "latency": {k: v for k, v in e.latency_summary().items()
                        if not k.endswith("_us") and k != "mean_launch_us"},
        }

    assert ledgers(base) == ledgers(dis) == ledgers(on)


def test_enabled_tracer_deterministic_and_valid():
    tr1, tr2 = Tracer(), Tracer()
    _traced_door_replay(tr1)
    _traced_door_replay(tr2)
    e1, e2 = tr1.export(), tr2.export()
    assert e1 == e2
    payload = json.loads(e1)
    assert validate_trace_events(payload) == []
    names = {ev["name"] for ev in payload["traceEvents"]}
    assert {"submit", "queue", "admit", "serve", "complete",
            "engine_tick", "door_tick"} <= names
    assert names & {"launch", "fail", "watchdog"}
    labels = {ev["args"]["name"] for ev in payload["traceEvents"]
              if ev["ph"] == "M"}
    assert {"door", "fast", "slow"} <= labels


def test_door_chaos_export_equals_the_reference_byte_for_byte():
    """The same seeded chaos through the port's door and the
    reference's: the same bytes, injections and containment included."""
    tr, jtr = Tracer(), JTracer()
    door = _traced_door_replay(tr)
    ref = _traced_door_replay(jtr, REF)
    assert tr.export() == jtr.export()
    assert [(n, r.uid) for n, r in door.completed] == \
        [(n, r.uid) for n, r in ref.completed]
    assert '"inject"' in tr.export()


def test_tracer_scale_maps_engine_ticks_to_door_clock():
    tr = Tracer()
    eng = object()
    tr.attach(eng, "e")
    tr.set_scale(eng, 3)
    tr.tick_instant(eng, "engine_tick", 5)
    tr.tick_span(eng, "serve", 2, 4, 1000)
    inst, span = tr.events
    assert inst["ts"] == 15
    assert (span["ts"], span["dur"]) == (6, 12)


def test_tracer_wall_opt_in_is_outside_byte_identity():
    runs = []
    for _ in range(2):
        tr = Tracer()
        eng = PORT["OneTick"](1, tracer=tr, registry=MetricsRegistry())
        eng.run([PORT["Req"](uid=0)])
        runs.append(tr.export())
    assert runs[0] == runs[1]
    assert "wall_us" not in runs[0]
    tr = Tracer(wall=True)
    eng = PORT["OneTick"](1, tracer=tr, registry=MetricsRegistry())
    eng.run([PORT["Req"](uid=0)])
    assert "wall_us" in tr.export()
    assert validate_trace_events(json.loads(tr.export())) == []


def test_export_writes_the_same_bytes_to_a_file(tmp_path):
    tr = Tracer()
    _traced_door_replay(tr)
    path = tmp_path / "trace.json"
    text = tr.export(path)
    assert path.read_text() == text + "\n"
    assert json.loads(text)["otherData"] == {"clock": "ticks", "schema": 1}


def test_registry_snapshot_matches_legacy_summaries():
    reg = MetricsRegistry()
    eng = _chaos_run(registry=reg)
    snap = reg.snapshot()
    comp = snap["components"][eng.metrics_scope]
    assert comp["latency"] == eng.latency_summary()
    assert comp["health"] == eng.health()
    inj_scopes = [s for s in snap["components"]
                  if s.startswith("FaultInjector")]
    assert inj_scopes
    assert snap["components"][inj_scopes[0]]["faults"] == \
        eng.faults.summary()
    hq = snap["tick_histograms"][f"{eng.metrics_scope}.queue_ticks"]
    hs = snap["tick_histograms"][f"{eng.metrics_scope}.serve_ticks"]
    s = eng.latency_summary()
    assert hq["count"] == hs["count"] == s["served"]
    assert hq["p50"] == s["p50_queue_ticks"]
    assert hs["p50"] == s["p50_serve_ticks"]


# -------------------------------------------------------- trace validation


def _ev(name, ph="i", pid=1, tid=0, ts=0, **kw):
    e = {"name": name, "ph": ph, "pid": pid, "tid": tid, "ts": ts}
    if ph == "i":
        e["s"] = "t"
    e.update(kw)
    return e


def test_validate_catches_orphaned_terminal():
    probs = validate_trace_events([
        _ev("complete", tid=REQUEST_TID_BASE + 5, ts=4)])
    assert any("orphaned" in p for p in probs)


def test_validate_catches_double_terminal():
    tid = REQUEST_TID_BASE
    probs = validate_trace_events([
        _ev("submit", tid=tid), _ev("complete", tid=tid, ts=2),
        _ev("evict", tid=tid, ts=3)])
    assert any("second terminal" in p for p in probs)


def test_validate_catches_nonmonotone_ts():
    probs = validate_trace_events([
        _ev("engine_tick", ts=5), _ev("engine_tick", ts=3)])
    assert any("monotone" in p for p in probs)


def test_validate_catches_unknown_name_and_malformed():
    probs = validate_trace_events([
        _ev("made_up_event"),
        {"name": "serve", "ph": "X", "pid": 1, "tid": 0, "ts": 0,
         "dur": -2},
        {"name": "admit", "ph": "i", "pid": "one", "tid": 0, "ts": 0}])
    assert any("taxonomy" in p for p in probs)
    assert any("dur" in p for p in probs)
    assert any("pid" in p for p in probs)


def test_validate_accepts_clean_payload():
    tid = REQUEST_TID_BASE + 1
    assert validate_trace_events({"traceEvents": [
        _ev("submit", tid=tid, ts=0),
        _ev("queue", ph="X", tid=tid, ts=0, dur=2),
        _ev("admit", tid=tid, ts=2),
        _ev("serve", ph="X", tid=tid, ts=2, dur=3),
        _ev("complete", tid=tid, ts=5)]}) == []


@pytest.mark.parametrize("payload", [{"no": "events"}, [1, {"ph": "B"}]])
def test_validate_rejects_what_is_not_a_trace(payload):
    assert validate_trace_events(payload) != []


# ------------------------------------------------------ undrained reporting


def test_undrained_warning_names_uids_and_ledgers():
    inj = FaultInjector(FaultPlan(stuck_uids=(7,)),
                        registry=MetricsRegistry())
    eng = PORT["Stream"](1, faults=inj, registry=MetricsRegistry())
    eng.submit(PORT["StreamReq"](uid=7, length=1))
    eng.submit(PORT["StreamReq"](uid=9, length=1))
    with pytest.warns(RuntimeWarning, match="undrained") as rec:
        eng.run(max_ticks=5)
    msg = next(str(w.message) for w in rec if "undrained" in str(w.message))
    assert "1 queued" in msg and "1 slots occupied" in msg
    assert "queued=1 uids=[9]" in msg
    assert "occupied=1 uids=[7]" in msg


def test_undrained_warning_reports_per_engine_behind_door():
    a = PORT["OneTick"](1, registry=MetricsRegistry())
    b = PORT["Stream"](1, faults=FaultInjector(FaultPlan(stuck_uids=(3,)),
                                               registry=MetricsRegistry()),
                       registry=MetricsRegistry())
    door = FrontDoor(fast=a, slow=b, registry=MetricsRegistry())
    door.submit(PORT["StreamReq"](uid=3, length=1))
    with pytest.warns(RuntimeWarning, match=r"slow: .*occupied=1 uids=\[3\]"):
        door.run(max_ticks=5)
