"""Replica pools: N adapters of one modality behind one engine surface;
port of `repro.serving.pool` (imports rewritten).

``ReplicaPool`` wraps N `SlotEngine` adapters (same modality, same
``request_type``, same ``tick_cost``) and presents the exact interface
the event-driven front door (`launch/serve.py::FrontDoor`, DESIGN.md
§11) drives — ``submit`` / ``step`` / ``busy`` / ``halt`` / ``health`` /
``latency_summary`` plus the ledger attributes — so a pool registers in
place of a single engine without the router or the drive loop changing.

Dispatch is **least-loaded and deterministic**: an arrival goes to the
live replica with the lowest load score ``queue depth + occupied
slots``, ties broken by replica index.  Admission composes with the
scheduler's overload control (DESIGN.md §10) through
`SlotEngine.admission_probe`: replicas are probed in score order and the
request commits to the first that will admit it, so the pool rejects
only when *every* replica rejects — and the rejection is recorded on
exactly one replica's ledger (the least-loaded one), never duplicated.

Fault isolation mirrors the front door one level down: a replica whose
``step`` escapes its own launch containment is halted — its in-flight
and queued traffic drains onto its ``failed`` ledger — and excluded
from dispatch while the siblings keep serving.  The pool as a whole
reports ``halted`` only when every replica is down.

Scale-out: each replica is an ordinary adapter, so sharded engines plug
in unchanged — e.g. N ``VisionEngine(mesh=submesh)`` replicas over the
disjoint submeshes of `launch.mesh.make_submeshes`, data parallelism
within a replica and replica parallelism across the pool.  Every rank of
the world runs the pool on the same requests; a replica's launch is
computed by the ranks of its submesh and its result broadcast to the
others (`parallel.collectives.SlotShards`), so every rank's ledgers
agree.
"""
from __future__ import annotations

from repro_torch.obs.metrics import default_registry
from repro_torch.serving.scheduler import (
    ADMITTED,
    SlotEngine,
    drive,
    tick_percentiles,
)


class ReplicaPool:
    """N same-modality `SlotEngine` replicas behind least-loaded
    dispatch; see module docstring."""

    def __init__(self, *replicas: SlotEngine, tracer=None, registry=None):
        """``tracer``/``registry``: observability knobs (DESIGN.md §13).
        The tracer records a ``dispatch`` instant per submission (chosen
        replica + load score); when the pool sits behind a traced
        `FrontDoor` the door propagates its tracer and clock scale to
        the pool *and* every replica, so an explicit ``tracer`` here is
        only for standalone pools.  Both are schedule-neutral."""
        if not replicas:
            raise ValueError("ReplicaPool needs at least one replica")
        want = getattr(replicas[0], "request_type", None)
        cost = getattr(replicas[0], "tick_cost", 1)
        for ix, r in enumerate(replicas):
            if getattr(r, "request_type", None) is not want:
                raise ValueError(
                    f"replica {ix} serves "
                    f"{getattr(r, 'request_type', None)!r}, pool serves "
                    f"{want!r} — a pool is one modality")
            if getattr(r, "tick_cost", 1) != cost:
                raise ValueError(
                    f"replica {ix} has tick_cost "
                    f"{getattr(r, 'tick_cost', 1)}, pool cadence is {cost} "
                    "— replicas of one pool share one cadence")
        self.replicas = list(replicas)
        self.request_type = want
        self.tick_cost = cost
        self.tracer = tracer
        if tracer is not None:  # standalone traced pool: wire replicas
            for ix, r in enumerate(self.replicas):
                r.tracer = tracer
                tracer.label(r, f"replica[{ix}]")
        self.tick = 0
        self.completed: list = []  # pool-level merged completion order
        self.down: dict[int, str] = {}  # replica index -> failure reason
        reg = registry if registry is not None else default_registry()
        self.metrics_scope = reg.register_component(
            self, {"latency": self.latency_summary, "health": self.health})

    # ------------------------------------------------------- dispatch

    def load_score(self, ix: int) -> int:
        """The dispatch score of replica ``ix``: queue depth + occupied
        slots — everything admitted but not finished.  Lower is
        less loaded."""
        r = self.replicas[ix]
        return len(r.queue) + sum(s is not None for s in r.slots)

    def _dispatch_order(self) -> list[int]:
        """Live replicas, least-loaded first, ties by replica index."""
        return sorted(
            (ix for ix, r in enumerate(self.replicas) if r.halted is None),
            key=lambda ix: (self.load_score(ix), ix))

    def submit(self, req) -> str:
        """Least-loaded dispatch with pool-level admission: probe
        replicas in score order, commit to the first that admits.
        Rejection only when every replica rejects — committed on the
        least-loaded live replica (or replica 0 when all are down), so
        the request lands on exactly one ledger."""
        order = self._dispatch_order()
        chosen = None
        for ix in order:
            if self.replicas[ix].admission_probe(req) == ADMITTED:
                chosen = ix
                break
        if chosen is None:
            chosen = order[0] if order else 0
        if self.tracer is not None:
            self.tracer.tick_instant(
                self, "dispatch", self.tick, 0,
                uid=getattr(req, "uid", None), replica=chosen,
                score=self.load_score(chosen), probed=len(order))
        return self.replicas[chosen].submit(req)

    # ------------------------------------------------------- tick loop

    def step(self) -> list:
        """One pool tick: step every live replica (one modality — one
        cadence), merging completions in replica-index order.  A replica
        step that escapes its launch containment halts *that replica*
        (its traffic fails onto its ledger, dispatch excludes it) and
        the pool keeps serving — the front door's isolation boundary,
        one level down."""
        self.tick += 1
        out = []
        for ix, r in enumerate(self.replicas):
            if ix in self.down:
                continue
            try:
                out.extend(r.step())
            except Exception as exc:  # noqa: BLE001 — isolation boundary
                reason = f"{type(exc).__name__}: {exc}"
                self.down[ix] = reason
                r.halt(reason)
        self.completed.extend(out)
        return out

    def busy(self) -> bool:
        return any(r.busy() for r in self.replicas)

    def run(self, requests=None, max_ticks: int = 10_000,
            on_undrained: str = "warn") -> list:
        """Drive the pool until all traffic drains — same arrival-replay
        semantics as `SlotEngine.run` (the pool is an engine to
        `drive`); returns the pool-level merged completions."""
        drive(self, requests, max_ticks, on_undrained)
        return self.completed

    def halt(self, reason: str) -> None:
        """Take the whole pool out of service (front-door isolation when
        the *pool's* step raises): every replica halts visibly."""
        for ix, r in enumerate(self.replicas):
            if r.halted is None:
                r.halt(reason)
            self.down.setdefault(ix, reason)

    @property
    def halted(self) -> str | None:
        """Non-None only when every replica is down — one live replica
        keeps the pool serving."""
        if any(r.halted is None for r in self.replicas):
            return None
        return "; ".join(f"replica {ix}: {r.halted}"
                         for ix, r in enumerate(self.replicas))

    # ---------------------------------------------- aggregate ledgers
    # (list-valued views so `drive()`'s undrained accounting and the
    # benches read a pool exactly like a single engine)

    @property
    def queue(self) -> list:
        return [req for r in self.replicas for req in r.queue]

    @property
    def slots(self) -> list:
        return [s for r in self.replicas for s in r.slots]

    @property
    def failed(self) -> list:
        return [req for r in self.replicas for req in r.failed]

    @property
    def evicted(self) -> list:
        return [req for r in self.replicas for req in r.evicted]

    @property
    def rejected(self) -> list:
        return [req for r in self.replicas for req in r.rejected]

    # ------------------------------------------------------ reporting

    def health(self) -> dict:
        """Pool health: the single-engine keys (so front-door
        aggregation reads a pool like an engine — ``halted`` is
        all-replicas-down, counters sum) plus per-replica reports and
        the pool's own view of which replicas are down."""
        per = [r.health() for r in self.replicas]
        agg = {
            "halted": self.halted,
            "degraded": next((h["degraded"] for h in per
                              if h["degraded"] is not None), None),
            "down": dict(self.down),
            "replicas": per,
        }
        for key in ("launch_faults", "watchdog_evictions", "failed",
                    "evicted", "rejected", "queue_depth", "occupied_slots"):
            agg[key] = sum(h[key] for h in per)
        return agg

    def latency_summary(self) -> dict:
        """Pool-level aggregation with the same keys as
        `SlotEngine.latency_summary` (counts sum; utilizations and
        means re-derive from pooled totals; percentiles pool the
        completed ledgers — *not* a mean of per-replica percentiles,
        which would be biased), plus ``replicas`` with the per-replica
        summaries.  Tick-denominated keys keep the ``_ticks`` suffix so
        the front door's clock conversion applies at every depth."""
        per = [r.latency_summary() for r in self.replicas]
        served = sum(s["served"] for s in per)
        launches = sum(s["launches"] for s in per)
        slot_ticks = sum(r.stats["slot_ticks"] for r in self.replicas)
        busy_ticks = sum(r.stats["busy_slot_ticks"] for r in self.replicas)
        wall_us = sum(r.stats["wall_us"] for r in self.replicas)
        done = [req for r in self.replicas for req in r.completed]
        q50, q95, q99 = tick_percentiles([req.queue_ticks for req in done])
        s50, s95, s99 = tick_percentiles([req.serve_ticks for req in done])
        return {
            "served": served,
            "launches": launches,
            "evictions": sum(s["evictions"] for s in per),
            "rejections": sum(s["rejections"] for s in per),
            "failures": sum(s["failures"] for s in per),
            "evicted": sum(s["evicted"] for s in per),
            "failed": sum(s["failed"] for s in per),
            "rejected": sum(s["rejected"] for s in per),
            "deadline_misses": sum(s["deadline_misses"] for s in per),
            "utilization": served / slot_ticks if slot_ticks else 0.0,
            "busy_utilization": busy_ticks / slot_ticks if slot_ticks else 0.0,
            "mean_queue_ticks": (
                sum(req.queue_ticks for req in done) / served
                if served else 0.0),
            "mean_serve_ticks": (
                sum(req.serve_ticks for req in done) / served
                if served else 0.0),
            "p50_queue_ticks": q50, "p95_queue_ticks": q95,
            "p99_queue_ticks": q99,
            "p50_serve_ticks": s50, "p95_serve_ticks": s95,
            "p99_serve_ticks": s99,
            "mean_launch_us": wall_us / launches if launches else 0.0,
            "replicas": per,
        }
