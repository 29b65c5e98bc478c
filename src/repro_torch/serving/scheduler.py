"""Continuous-batching scheduler core shared by the LM and vision engines.

Copy of `repro.serving.scheduler` (JAX-free), imports rewritten to this
package; the port's vision engine is its first adapter here.

``ServeEngine`` (many-tick decode slots) and ``VisionEngine`` (one-tick
microbatch slots) are the same machine wearing different compute: a
bounded arrival queue feeding a fixed table of slots that one compiled
launch advances every tick.  This module owns that machine — the queue
with its pluggable eviction policy, the slot table with admit/recycle
semantics, the tick loop with arrival replay, and the per-request
latency ledger — so the engines reduce to three adapter hooks
(DESIGN.md §8):

  _on_admit(slot, req)   recycle the slot for a new occupant (LM: zero
                         the decode-state column; vision: nothing)
  _launch(active)        run ONE compiled, shape-stable launch covering
                         every slot (free slots ride as padding) and
                         return whatever _absorb needs
  _absorb(slot, req, r)  fold the launch result into the request;
                         return True when the request is finished
                         (vision: always — a slot lives one tick)

Eviction policies (applied when the bounded queue overflows on submit):

  "drop-newest"  reject the arriving request (LM front door: an
                 accepted prompt is a promise; shed load at the door)
  "drop-oldest"  evict the oldest *waiting* request (the always-on
                 sensor: stale frames are worthless, fresh ones are not)
  "deadline"     shed already-expired requests first, then the
                 lowest-priority one (SLO-aware load shedding)

Fault tolerance (DESIGN.md §10) is first-class scheduler semantics, not
adapter code: ``submit`` applies admission control and returns an
explicit status (backpressure, never a silent drop); a slot watchdog
(``max_serve_ticks``) evicts stuck occupants and recycles their slots
leak-free; ``step`` contains ``_launch`` failures with bounded
retry-with-backoff and then quarantines the poisoned requests onto the
``failed`` ledger while the rest of the traffic keeps serving; absorbed
results are guarded against NaN/Inf so one corrupted analog activation
fails one request, not the engine.  A seeded `serving.faults`
``FaultInjector`` plugs into any adapter via ``faults=`` and is
bit-for-bit free when its plan injects nothing.

Latency accounting is unified and per request: ``queue_ticks`` (ticks
between submit and first slot tick — or between submit and shedding for
evicted requests), ``serve_ticks`` (ticks occupying a slot — 1 for
vision, prefill+decode for LM), and ``launch_wall_us`` (summed
wall-clock of the launches that served the request; for a one-tick
vision slot this is the single batch launch it rode in).
"""
from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Any, Callable, Sequence

import numpy as np

from repro_torch.obs.metrics import default_registry

#: Explicit admission statuses ``submit`` returns — overload is
#: backpressure the caller can see, never a silent drop.
ADMITTED = "admitted"
REJECTED_DEADLINE = "rejected-deadline"  # projected queue residency misses it
REJECTED_QUEUE = "rejected-queue-full"  # the arrival was the eviction victim
REJECTED_HALTED = "rejected-halted"  # the engine was halted (front-door isolation)

#: Sentinel for "no launch succeeded this tick" — ``None`` is a valid
#: adapter launch result, so it cannot double as the failure marker.
_NO_RESULT = object()


@dataclasses.dataclass(kw_only=True)
class ScheduledRequest:
    """Accounting fields the scheduler core maintains on every request.

    Engine request types (``Request``, ``VisionRequest``) inherit from
    this; all fields are keyword-only so subclasses keep positional
    fields of their own.
    """

    arrival_tick: int = 0  # traffic-replay metadata; ``run`` consults it
    deadline_tick: int = -1  # absolute engine tick; -1 = no deadline
    priority: int = 0  # higher survives "deadline" shedding longer
    submitted_tick: int = -1  # tick at which submit() saw the request
    served_tick: int = -1  # first tick the request held a slot
    finished_tick: int = -1  # tick the request completed (or failed)
    evicted_tick: int = -1  # tick the request was shed/rejected
    serve_ticks: int = 0  # ticks spent occupying a slot
    launch_wall_us: float = 0.0  # summed wall-clock of its launches
    evicted: bool = False
    failed: bool = False
    failure: str = ""  # "", "launch", "nonfinite", "watchdog", "halt:…"

    @property
    def queue_ticks(self) -> int:
        """Ticks spent waiting in the queue — until first service for
        served requests, until shedding for evicted ones (never
        negative: eviction stamps ``evicted_tick``)."""
        if self.served_tick >= 0:
            return self.served_tick - self.submitted_tick
        if self.evicted_tick >= 0:
            return self.evicted_tick - self.submitted_tick
        return 0

    @property
    def deadline_missed(self) -> bool:
        """True when a deadline was set and not met: completed too late,
        or shed/failed before completing at all."""
        if self.deadline_tick < 0:
            return False
        if self.failed or self.evicted:
            return True
        return self.finished_tick < 0 or self.finished_tick > self.deadline_tick


def drop_newest(queue: list, incoming: ScheduledRequest) -> ScheduledRequest:
    """Reject the arriving request; the queue is untouched."""
    return incoming


def drop_oldest(queue: list, incoming: ScheduledRequest) -> ScheduledRequest:
    """Evict the oldest waiting request to make room for the arrival.
    With nothing waiting (max_queue=0) the arrival itself is shed, same
    as drop-newest — there is no older frame to trade away."""
    return queue.pop(0) if queue else incoming


def shed_deadline(queue: list, incoming: ScheduledRequest) -> ScheduledRequest:
    """SLO-aware shedding: already-expired requests first, then the
    lowest-priority one.

    "Now" is ``incoming.submitted_tick`` — ``submit`` stamps it with the
    engine clock before consulting the policy.  An expired waiter (its
    deadline at or before now) is worthless however important it once
    was; with none expired, the victim is the lowest-priority request
    among the queue and the arrival, newest-first within a priority
    class (an old promise outranks a new one of equal worth).
    """
    now = incoming.submitted_tick
    for j, r in enumerate(queue):
        if 0 <= r.deadline_tick <= now:
            return queue.pop(j)  # oldest expired waiter
    pool = list(enumerate(queue)) + [(len(queue), incoming)]
    j, victim = min(pool, key=lambda jr: (jr[1].priority, -jr[0]))
    return incoming if victim is incoming else queue.pop(j)


EVICTION_POLICIES: dict[str, Callable] = {
    "drop-newest": drop_newest,
    "drop-oldest": drop_oldest,
    "deadline": shed_deadline,
}


def tick_percentiles(values: Sequence[float]) -> tuple[float, float, float]:
    """(p50, p95, p99) of a tick series; zeros when empty.  Shared by
    `SlotEngine.latency_summary`, the replica pool's pooled ledger, and
    the serving benches, so every percentile in the stack is the same
    (linear-interpolation) estimator."""
    if not values:
        return 0.0, 0.0, 0.0
    arr = np.asarray(values, np.float64)
    return (float(np.percentile(arr, 50)), float(np.percentile(arr, 95)),
            float(np.percentile(arr, 99)))


def _uids(requests) -> list:
    return [getattr(r, "uid", None) for r in requests]


def _undrained_report(engine, name: str = "engine") -> list[tuple]:
    """Per-ledger undrained detail across an engine or a front door:
    ``(ledger name, queued uids, occupied-slot uids)`` triples, one per
    leaf engine (front doors report each registered engine under its
    registration key)."""
    subs = getattr(engine, "engines", None)
    if subs is not None:  # multi-engine front door
        out: list[tuple] = []
        for sub, e in subs.items():
            out.extend(_undrained_report(e, sub))
        return out
    queued = _uids(getattr(engine, "queue", ()))
    occupied = _uids(s for s in getattr(engine, "slots", ())
                     if s is not None)
    return [(name, queued, occupied)]


def drive(engine, requests: Sequence | None = None,
          max_ticks: int = 10_000, on_undrained: str = "warn") -> None:
    """Arrival-replay loop: submit each request when the clock reaches
    its ``arrival_tick``, tick until all traffic drains.  ``engine`` is
    anything with ``submit``/``step``/``busy``/``tick`` — a single
    ``SlotEngine`` or the multi-engine front door — so single-engine and
    front-door runs replay traffic with identical semantics.

    Stopping at ``max_ticks`` with traffic still pending is never
    silent: the message names every stranded request — per-ledger
    undrained counts *and* the offending uids, per engine behind a front
    door — via ``RuntimeWarning`` (``on_undrained="warn"``, the default)
    or raised (``on_undrained="raise"``).  A truncated replay that looks
    drained is how deadlocks hide; a count without uids is a deadlock an
    operator cannot chase.
    """
    pending = sorted(requests or [], key=lambda r: r.arrival_tick)
    ticks = 0
    while (pending or engine.busy()) and ticks < max_ticks:
        while pending and pending[0].arrival_tick <= engine.tick:
            engine.submit(pending.pop(0))
        engine.step()
        ticks += 1
    if pending or engine.busy():
        report = _undrained_report(engine)
        queued = sum(len(q) for _, q, _ in report)
        occupied = sum(len(o) for _, _, o in report)
        detail = "; ".join(
            f"{name}: queued={len(q)} uids={q}, occupied={len(o)} uids={o}"
            for name, q, o in report if q or o)
        msg = (f"drive() stopped at max_ticks={max_ticks} with traffic "
               f"undrained: {len(pending)} arrivals unsubmitted "
               f"(uids {_uids(pending)}), {queued} queued, "
               f"{occupied} slots occupied"
               + (f" [{detail}]" if detail else ""))
        if on_undrained == "raise":
            raise RuntimeError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=2)


class SlotEngine:
    """The shared continuous-batching core (see module docstring).

    Subclasses implement ``_on_admit`` / ``_launch`` / ``_absorb`` and
    get submit/step/run/latency accounting for free.  Public state the
    adapters and tests rely on:

      tick        engine clock (ticks once per step, idle or not)
      queue       waiting requests, FIFO
      slots       fixed table, ``None`` = free
      completed   finished requests in completion order
      evicted     requests shed by the queue policy
      rejected    requests bounced at admission (backpressure)
      failed      requests quarantined by fault containment
      stats       aggregate counters (launches, served, evictions,
                  rejections, failures, watchdog_evictions,
                  launch_faults, slot_ticks, busy_slot_ticks, wall_us)
    """

    #: Request class this adapter serves — the multi-engine front door
    #: (`launch/serve.py::FrontDoor`) routes submissions on it, so each
    #: adapter declares its own traffic type instead of the router
    #: hardcoding an engine/request table.
    request_type: type | None = None

    def __init__(self, n_slots: int, *, max_queue: int | None = None,
                 evict: str | Callable = "drop-newest",
                 admission: str | None = None,
                 max_serve_ticks: int | None = None,
                 launch_retries: int = 2,
                 retry_backoff_s: float = 0.0,
                 tick_cost: int = 1,
                 faults=None,
                 tracer=None,
                 registry=None):
        """Fault-tolerance knobs (all off by default — the core without
        them is tick-for-tick the pre-§10 machine):

        ``admission="deadline"``    reject at submit when projected queue
                                    residency implies a deadline miss
        ``max_serve_ticks=N``       slot watchdog: evict any occupant
                                    after N held ticks (stuck streams)
        ``launch_retries``          bounded retry budget before a failing
                                    ``_launch`` quarantines requests
        ``retry_backoff_s``         base sleep between retries (doubles
                                    per attempt; 0 = no backoff sleep)
        ``faults``                  a `serving.faults.FaultInjector` —
                                    deterministic chaos for any adapter

        ``tick_cost`` is declarative capacity metadata for the
        event-driven front door (`launch/serve.py::FrontDoor`,
        DESIGN.md §11): one engine tick costs this many ticks of
        front-door time, so a cheap engine (vision microbatch) ticks
        several times while an expensive one (LM prefill) ticks once.
        The engine itself never reads it — its own clock stays
        one-per-step — and the door converts tick-denominated ledgers
        onto the shared clock exactly once.

        Observability knobs (DESIGN.md §13, both schedule-neutral):

        ``tracer``      an `obs.Tracer` recording this engine's request
                        lifecycles and tick/launch spans.  ``None`` (the
                        default) or a disabled tracer is bit-for-bit
                        free — every hook sits behind a ``None`` check
                        and no hook touches schedule state.
        ``registry``    the `obs.MetricsRegistry` this engine publishes
                        its latency/health views and tick histograms
                        into; ``None`` means the process-wide default.
        """
        if isinstance(evict, str):
            evict = EVICTION_POLICIES[evict]
        if admission not in (None, "deadline"):
            raise ValueError(f"unknown admission policy {admission!r}")
        if not (isinstance(tick_cost, int) and tick_cost >= 1):
            raise ValueError(f"tick_cost must be an int >= 1, got "
                             f"{tick_cost!r}")
        self.n_slots = n_slots
        self.max_queue = max_queue
        self._evict = evict
        self.admission = admission
        self.max_serve_ticks = max_serve_ticks
        self.launch_retries = launch_retries
        self.retry_backoff_s = retry_backoff_s
        self.tick_cost = tick_cost
        self.faults = faults
        self.tracer = tracer
        self.registry = registry if registry is not None else default_registry()
        self.metrics_scope = self.registry.register_component(
            self, {"latency": self.latency_summary, "health": self.health})
        self._hist_queue = self.registry.tick_histogram(
            f"{self.metrics_scope}.queue_ticks")
        self._hist_serve = self.registry.tick_histogram(
            f"{self.metrics_scope}.serve_ticks")
        self.tick = 0
        self.queue: list = []
        self.slots: list = [None] * n_slots
        self.completed: list = []
        self.evicted: list = []
        self.rejected: list = []
        self.failed: list = []
        self.halted: str | None = None
        self.degraded: str | None = None  # adapters set on fallback
        self.stats = {"launches": 0, "served": 0, "evictions": 0,
                      "rejections": 0, "failures": 0,
                      "watchdog_evictions": 0, "launch_faults": 0,
                      "slot_ticks": 0, "busy_slot_ticks": 0, "wall_us": 0.0}

    @property
    def max_batch(self) -> int:
        """The slot count, under the name the engines' callers use."""
        return self.n_slots

    # -------------------------------------------------- adapter contract

    def _on_admit(self, slot: int, req) -> None:
        """Recycle ``slot`` for ``req`` (zero per-slot state, cursors)."""

    def _launch(self, active: list[tuple[int, Any]]):
        """One compiled launch over the whole slot table; ``active`` is
        the occupied ``(slot, request)`` pairs.  Returns the per-slot
        result object ``_absorb`` consumes.  Must be retry-safe: mutate
        engine state only after the compiled call returns, so a raise
        leaves the engine exactly as before the attempt."""
        raise NotImplementedError

    def _absorb(self, slot: int, req, result) -> bool:
        """Fold this tick's result into ``req``; True ⇒ finished."""
        raise NotImplementedError

    def _validate(self, slot: int, req, result) -> bool:
        """Guard a slot's share of the launch result before ``_absorb``
        sees it.  The default rejects NaN/Inf in any float array leaf
        with a leading slot axis — a corrupted analog activation
        (tri-design, arXiv:2304.02968) fails its own request, never the
        engine.  Adapters extend with domain checks (LM: sampled token
        in range)."""
        stack = [result]
        while stack:
            x = stack.pop()
            if isinstance(x, (tuple, list)):
                stack.extend(x)
            elif isinstance(x, dict):
                stack.extend(x.values())
            elif (getattr(x, "ndim", 0) >= 1
                  and getattr(x, "shape", (0,))[0] == self.n_slots):
                row = np.asarray(x[slot])
                if (np.issubdtype(row.dtype, np.floating)
                        and not np.isfinite(row).all()):
                    return False
        return True

    def _on_launch_fault(self, exc: Exception) -> None:
        """Called once per ``_launch`` failure (before any retry).  The
        port's vision engine keeps the default: a failing kernel surfaces
        as failed requests, never as answers from another conv path."""

    # -------------------------------------------------------------- API

    def submit(self, req) -> str:
        """Enqueue now; returns an explicit admission status
        (``ADMITTED`` / ``REJECTED_*``) so overload is visible
        backpressure, not a silent drop.  ``arrival_tick`` is
        traffic-replay metadata that only ``run`` consults to delay
        submission; calling ``submit`` directly means the request exists
        as of the current tick."""
        req.submitted_tick = self.tick
        tr = self.tracer
        if tr is not None:
            tr.tick_instant(self, "submit", self.tick, tr.req_tid(req),
                            uid=getattr(req, "uid", None))
        if self.halted is not None:
            self._reject(req, REJECTED_HALTED)
            return REJECTED_HALTED
        if self.admission == "deadline" and self._projected_miss(req):
            self._reject(req, REJECTED_DEADLINE)
            return REJECTED_DEADLINE
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            victim = self._evict(self.queue, req)
            victim.evicted = True
            victim.evicted_tick = self.tick
            self.evicted.append(victim)
            self.stats["evictions"] += 1
            if tr is not None:
                vid = tr.req_tid(victim)
                tr.tick_span(self, "queue", victim.submitted_tick,
                             victim.queue_ticks, vid)
                tr.tick_instant(self, "evict", self.tick, vid,
                                uid=getattr(victim, "uid", None))
            if victim is req:
                return REJECTED_QUEUE
        self.queue.append(req)
        return ADMITTED

    def _reject(self, req, reason: str = "rejected") -> None:
        req.evicted = True
        req.evicted_tick = self.tick
        self.rejected.append(req)
        self.stats["rejections"] += 1
        if self.tracer is not None:
            self.tracer.tick_instant(
                self, "reject", self.tick, self.tracer.req_tid(req),
                uid=getattr(req, "uid", None), status=reason)

    def admission_probe(self, req) -> str:
        """Non-mutating forecast of the status ``submit`` would return
        for ``req`` at the current tick — nothing lands on any ledger,
        no victim is evicted, the request is untouched on return.

        `serving.pool.ReplicaPool` dispatches on this: it probes
        replicas in least-loaded order and commits the request to the
        first that will admit, so a rejection is recorded on exactly
        one replica instead of every one it was offered to.  The
        forecast is exact because probe and the committing ``submit``
        run back-to-back on one thread: the admission projection and
        the eviction policy see identical state (the policy runs
        against a *copy* of the queue, so a victim-selecting policy
        like ``shed_deadline`` cannot shed anyone during the probe).
        """
        if self.halted is not None:
            return REJECTED_HALTED
        prev = req.submitted_tick
        req.submitted_tick = self.tick  # policies read "now" off the request
        try:
            if self.admission == "deadline" and self._projected_miss(req):
                return REJECTED_DEADLINE
            if self.max_queue is not None and len(self.queue) >= self.max_queue:
                if self._evict(list(self.queue), req) is req:
                    return REJECTED_QUEUE
            return ADMITTED
        finally:
            req.submitted_tick = prev

    def _estimated_serve_ticks(self) -> float:
        """Mean slot residency of completed traffic (1.0 before any)."""
        if not self.completed:
            return 1.0
        return max(1.0, sum(r.serve_ticks for r in self.completed)
                   / len(self.completed))

    def _projected_miss(self, req) -> bool:
        """Admission projection: with the backlog ahead of this arrival
        draining ``n_slots`` requests per estimated-residency round,
        would it finish past its deadline?  Deliberately a heuristic —
        it holds the door against hopeless work, the "deadline" eviction
        policy sheds whatever the projection lets through that expires
        anyway."""
        if req.deadline_tick < 0:
            return False
        est = self._estimated_serve_ticks()
        occupied = sum(s is not None for s in self.slots)
        ahead = len(self.queue) + occupied
        if ahead < self.n_slots:
            wait = 0.0  # a slot is free (or frees) before its turn
        else:
            wait = est * math.ceil((ahead - self.n_slots + 1) / self.n_slots)
        return self.tick + wait + est > req.deadline_tick

    def _admit(self) -> None:
        tr = self.tracer
        for i in range(self.n_slots):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                self._on_admit(i, req)
                self.slots[i] = req
                req.served_tick = self.tick
                if tr is not None:
                    tid = tr.req_tid(req)
                    tr.tick_span(self, "queue", req.submitted_tick,
                                 req.queue_ticks, tid)
                    tr.tick_instant(self, "admit", self.tick, tid,
                                    uid=getattr(req, "uid", None), slot=i)

    def _fail(self, slot: int | None, req, reason: str) -> None:
        """Quarantine ``req`` onto the failed ledger; recycle its slot."""
        if slot is not None:
            self.slots[slot] = None
        req.failed = True
        req.failure = reason
        req.finished_tick = self.tick
        self.failed.append(req)
        self.stats["failures"] += 1
        tr = self.tracer
        if tr is not None:
            tid = tr.req_tid(req)
            if req.served_tick >= 0:  # failed while holding a slot
                tr.tick_span(self, "serve", req.served_tick,
                             req.serve_ticks, tid)
            else:  # failed while still queued (engine halt)
                tr.tick_span(self, "queue", req.submitted_tick,
                             self.tick - req.submitted_tick, tid)
            tr.tick_instant(self, "fail", self.tick, tid,
                            uid=getattr(req, "uid", None), reason=reason)

    def _watchdog(self) -> None:
        """Evict occupants stuck past ``max_serve_ticks``: the slot is
        recycled leak-free (the next ``_on_admit`` resets all per-slot
        state — the same contract recycling always relies on)."""
        if self.max_serve_ticks is None:
            return
        for i, req in enumerate(self.slots):
            if req is not None and req.serve_ticks >= self.max_serve_ticks:
                self.stats["watchdog_evictions"] += 1
                if self.tracer is not None:
                    self.tracer.tick_instant(
                        self, "watchdog", self.tick, 0,
                        uid=getattr(req, "uid", None), slot=i)
                self._fail(i, req, "watchdog")

    def _attempt_launch(self, active: list, attempt: int):
        """One launch attempt, with the fault injector (if any) wrapped
        around it — injection raises/slowdowns land before the real
        launch, result corruption after, so a raise never leaves the
        adapter half-mutated."""
        if self.faults is not None:
            self.faults.pre_launch(self, active, attempt)
            return self.faults.post_launch(self, active, self._launch(active))
        return self._launch(active)

    def _launch_contained(self, active: list):
        """Run ``_launch`` with bounded retry-with-backoff, then
        quarantine: a fault that names its slot (``exc.slot``) costs
        exactly that request and the survivors retry with a fresh
        budget; an anonymous fault after exhausted retries quarantines
        the whole cohort — honest containment when the launch cannot say
        which occupant poisoned it.  Returns ``(result, served,
        quarantined)``; ``result is _NO_RESULT`` when no launch
        succeeded.  Terminates: every exhausted budget removes at least
        one slot."""
        act = list(active)
        quarantined: list = []
        attempt = 0
        tr = self.tracer
        while act:
            try:
                result = self._attempt_launch(act, attempt), act, quarantined
                if tr is not None:
                    tr.tick_span(self, "launch", self.tick, 1, 0,
                                 attempt=attempt, n_active=len(act), ok=True)
                return result
            except Exception as exc:  # noqa: BLE001 — containment boundary
                attempt += 1
                self.stats["launch_faults"] += 1
                if tr is not None:
                    tr.tick_span(self, "launch", self.tick, 1, 0,
                                 attempt=attempt - 1, n_active=len(act),
                                 ok=False)
                    tr.tick_instant(self, "launch_fault", self.tick, 0,
                                    error=type(exc).__name__,
                                    slot=getattr(exc, "slot", None),
                                    attempt=attempt - 1)
                self._on_launch_fault(exc)
                if attempt <= self.launch_retries:
                    if self.retry_backoff_s:
                        time.sleep(self.retry_backoff_s * 2 ** (attempt - 1))
                    continue
                slot = getattr(exc, "slot", None)
                hit = [(i, r) for i, r in act if i == slot]
                if tr is not None:
                    for i, r in (hit or act):
                        tr.tick_instant(self, "quarantine", self.tick, 0,
                                        uid=getattr(r, "uid", None), slot=i)
                quarantined.extend(hit or act)
                act = [] if not hit else [(i, r) for i, r in act if i != slot]
                attempt = 0
        return _NO_RESULT, [], quarantined

    def step(self) -> list:
        """One engine tick: watchdog-evict stuck occupants, admit into
        free slots, run one contained launch over the slot table,
        validate + absorb results, release finished slots.  Returns the
        requests that *completed* this tick (empty when idle — the tick
        still advances, so arrival-driven ``run`` loops make
        progress)."""
        self.tick += 1
        if self.halted is not None:
            return []
        self._watchdog()
        self._admit()
        active = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return []

        t0 = time.perf_counter()
        result, served, quarantined = self._launch_contained(active)
        wall_us = (time.perf_counter() - t0) * 1e6

        tr = self.tracer
        for i, req in quarantined:
            req.serve_ticks += 1
            req.launch_wall_us += wall_us
            self._fail(i, req, "launch")

        finished = []
        if result is not _NO_RESULT:
            for i, req in served:
                req.serve_ticks += 1
                req.launch_wall_us += wall_us
                if self.faults is not None and self.faults.holds(self, req):
                    continue  # injected stuck occupant: the watchdog's prey
                if not self._validate(i, req, result):
                    if tr is not None:
                        tr.tick_instant(self, "validate_fail", self.tick, 0,
                                        uid=getattr(req, "uid", None), slot=i)
                    self._fail(i, req, "nonfinite")
                    continue
                if self._absorb(i, req, result):
                    req.finished_tick = self.tick
                    self.completed.append(req)
                    self.slots[i] = None
                    finished.append(req)
                    self._hist_queue.observe(req.queue_ticks)
                    self._hist_serve.observe(req.serve_ticks)
                    if tr is not None:
                        tid = tr.req_tid(req)
                        tr.tick_span(self, "serve", req.served_tick,
                                     req.serve_ticks, tid)
                        tr.tick_instant(self, "complete", self.tick, tid,
                                        uid=getattr(req, "uid", None),
                                        serve_ticks=req.serve_ticks)
            self.stats["launches"] += 1
            self.stats["wall_us"] += wall_us

        self.stats["served"] += len(finished)
        self.stats["slot_ticks"] += self.n_slots
        self.stats["busy_slot_ticks"] += len(active)
        if tr is not None:
            wall = {"wall_us": round(wall_us, 1)} if tr.wall else {}
            tr.tick_span(self, "engine_tick", self.tick, 1, 0,
                         n_active=len(active), finished=len(finished),
                         **wall)
        return finished

    def busy(self) -> bool:
        if self.halted is not None:
            return False
        return bool(self.queue) or any(s is not None for s in self.slots)

    def halt(self, reason: str) -> None:
        """Take the engine out of service (front-door isolation): every
        in-flight and queued request fails visibly onto the ledger —
        callers see the outage, nothing hangs — and subsequent submits
        return ``REJECTED_HALTED``."""
        self.halted = reason or "halted"
        tag = f"halt:{self.halted}"
        if self.tracer is not None:
            self.tracer.tick_instant(self, "halt", self.tick, 0,
                                     reason=self.halted)
        for i, req in enumerate(self.slots):
            if req is not None:
                self._fail(i, req, tag)
        for req in self.queue:
            self._fail(None, req, tag)
        self.queue.clear()

    def run(self, requests: Sequence | None = None,
            max_ticks: int = 10_000, on_undrained: str = "warn") -> list:
        """Drive the engine until all traffic drains.  ``requests`` with
        ``arrival_tick`` in the future are submitted when the engine
        clock reaches them (variable-arrival traffic replay)."""
        drive(self, requests, max_ticks, on_undrained)
        return self.completed

    def health(self) -> dict:
        """Degradation/fault report: halted state, adapter degradation
        (none in the port's vision engine), the fault
        counters, and the instantaneous load signal (queue depth +
        occupied slots — the same score `ReplicaPool` dispatches on) —
        what an operator reads before trusting the latency summary."""
        return {
            "halted": self.halted,
            "degraded": self.degraded,
            "launch_faults": self.stats["launch_faults"],
            "watchdog_evictions": self.stats["watchdog_evictions"],
            "failed": len(self.failed),
            "evicted": len(self.evicted),
            "rejected": len(self.rejected),
            "queue_depth": len(self.queue),
            "occupied_slots": sum(s is not None for s in self.slots),
        }

    def latency_summary(self) -> dict:
        """Aggregate counters: completions, slot utilization (completed /
        slot-ticks and busy / slot-ticks over non-idle launches), mean
        *and* p50/p95/p99 queueing delay, slot residency in ticks, mean
        per-launch wall-clock, and the shed/failed accounting (eviction,
        rejection, failure, deadline-miss counts).  Tick-denominated
        keys all end in ``_ticks`` — the front door relies on that
        suffix to convert them onto its shared clock (DESIGN.md §11).
        """
        served = self.stats["served"]
        slot_ticks = self.stats["slot_ticks"]
        q50, q95, q99 = tick_percentiles(
            [r.queue_ticks for r in self.completed])
        s50, s95, s99 = tick_percentiles(
            [r.serve_ticks for r in self.completed])
        return {
            "served": served,
            "launches": self.stats["launches"],
            "evictions": self.stats["evictions"],
            "rejections": self.stats["rejections"],
            "failures": self.stats["failures"],
            "evicted": len(self.evicted),
            "failed": len(self.failed),
            "rejected": len(self.rejected),
            "deadline_misses": sum(r.deadline_missed for r in self.completed),
            "utilization": served / slot_ticks if slot_ticks else 0.0,
            "busy_utilization": (self.stats["busy_slot_ticks"] / slot_ticks
                                 if slot_ticks else 0.0),
            "mean_queue_ticks": (
                sum(r.queue_ticks for r in self.completed) / served
                if served else 0.0),
            "mean_serve_ticks": (
                sum(r.serve_ticks for r in self.completed) / served
                if served else 0.0),
            "p50_queue_ticks": q50, "p95_queue_ticks": q95,
            "p99_queue_ticks": q99,
            "p50_serve_ticks": s50, "p95_serve_ticks": s95,
            "p99_serve_ticks": s99,
            "mean_launch_us": (self.stats["wall_us"] / self.stats["launches"]
                               if self.stats["launches"] else 0.0),
        }
