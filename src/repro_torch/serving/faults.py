"""Deterministic, seeded fault injection for the serving stack
(DESIGN.md §10); port of `repro.serving.faults`.

Process variation makes corrupted analog activations a real input class
the digital stack must survive (tri-design, arXiv:2304.02968), and an
always-on sensor pipeline has to keep serving through kernel raises and
stuck streams (Neuromorphic-P2M, arXiv:2301.09111 frames the workload).
`FaultInjector` manufactures those conditions on demand, reproducibly:

  launch raises   ``_launch`` throws `InjectedLaunchError` naming the
                  victim slot — exercises retry → quarantine containment
  NaN outputs     one slot's rows of the launch result are corrupted to
                  NaN (float) / -1 (int) — exercises the NaN/Inf guard
  slow launches   a ``time.sleep`` before the launch — exercises the
                  latency ledger's tail, never the schedule
  stuck slots     a request that never absorbs, holding its slot until
                  the ``max_serve_ticks`` watchdog evicts it

Every decision is a pure function of ``(seed, fault kind, engine tick /
request uid, attempt)`` via per-decision `np.random.SeedSequence` draws:
no global RNG state, no draw-order coupling — the same plan over the
same traffic replays the same faults, and a rate of 0 for a kind means
that kind draws nothing.  A plan that injects nothing is **bit-for-bit
free**: the wrapped engine's schedule, outputs, and tick ledgers are
identical to running without the injector (pinned by
`tests/test_faults.py`, and for the port by
`tests/test_torch_faults.py`, which also holds its decisions equal to
the reference injector's for the same plan and traffic).

Plug into any `SlotEngine` adapter via the ``faults=`` constructor
argument; the core calls ``pre_launch`` / ``post_launch`` around each
launch attempt and ``holds`` before absorbing each slot.  Targeted
deterministic chaos (for tests) uses the explicit ``launch_error_ticks``
/ ``nan_ticks`` / ``stuck_uids`` plan fields instead of rates.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.obs.metrics import default_registry

# Fault-kind salts for the per-decision seed streams: each (kind, key)
# pair owns an independent stream, so toggling one rate never shifts
# another kind's decisions.
_LAUNCH, _SLOW, _NAN, _STUCK, _VICTIM = range(5)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Injection plan: per-kind rates in [0, 1] plus explicit targets.

    Rates draw once per (tick, attempt) for launch/slow faults, once per
    tick for NaN corruption, and once per request uid for stuck slots
    (a stuck request is stuck for life — the decision never flips).
    ``launch_error_ticks`` / ``nan_ticks`` / ``stuck_uids`` force the
    fault regardless of rate — deterministic chaos for tests."""

    launch_error_rate: float = 0.0
    nan_rate: float = 0.0
    slow_rate: float = 0.0
    stuck_rate: float = 0.0
    slow_s: float = 1e-4  # sleep per slow fault (latency tail, not schedule)
    launch_error_ticks: tuple[int, ...] = ()
    nan_ticks: tuple[int, ...] = ()
    stuck_uids: tuple[int, ...] = ()
    seed: int = 0

    @property
    def enabled(self) -> bool:
        return bool(self.launch_error_rate or self.nan_rate
                    or self.slow_rate or self.stuck_rate
                    or self.launch_error_ticks or self.nan_ticks
                    or self.stuck_uids)


#: The reference's chaos-bench smoke plan: every fault kind present at
#: rates low enough that most traffic completes.
SMOKE_PLAN = FaultPlan(launch_error_rate=0.05, nan_rate=0.05,
                       slow_rate=0.1, stuck_rate=0.08, seed=0)


class InjectedLaunchError(RuntimeError):
    """A manufactured ``_launch`` failure.  Carries the victim ``slot``
    so containment can quarantine exactly the poisoned request — the
    shape real per-slot kernel faults (a poisoned operand, a corrupted
    stream state) would take."""

    def __init__(self, slot: int, tick: int):
        super().__init__(f"injected launch fault (slot {slot}, tick {tick})")
        self.slot = slot
        self.tick = tick


def _corrupt_slot_row(result, slot: int, n_slots: int):
    """Copy-on-write corruption of one slot's rows across the result
    tree: NaN into float arrays, -1 into int arrays (sampled tokens are
    non-negative, so -1 is the integer analogue of NaN).  Arrays without
    a leading slot axis pass through untouched.  A host array is copied
    with `np.array`; a tensor is cloned and written on its own device
    (never copied to the host)."""
    if isinstance(result, tuple):
        return tuple(_corrupt_slot_row(x, slot, n_slots) for x in result)
    if isinstance(result, list):
        return [_corrupt_slot_row(x, slot, n_slots) for x in result]
    if isinstance(result, dict):
        return {k: _corrupt_slot_row(v, slot, n_slots)
                for k, v in result.items()}
    if getattr(result, "ndim", 0) < 1 or result.shape[0] != n_slots:
        return result
    if isinstance(result, torch.Tensor):
        if result.is_floating_point():
            fill = float("nan")
        elif result.dtype != torch.bool and not result.is_complex():
            fill = -1
        else:
            return result
        out = result.clone()
        out[slot] = fill
        return out
    arr = np.array(result, copy=True)
    if np.issubdtype(arr.dtype, np.floating):
        arr[slot] = np.nan
        return arr
    if np.issubdtype(arr.dtype, np.integer):
        arr[slot] = -1
        return arr
    return result


class FaultInjector:
    """Seeded chaos source for one engine; see module docstring.

    ``counts`` tallies injected faults per kind; ``poisoned_uids`` is
    every request uid an injection targeted (launch victims that later
    survive a retry stay listed — the set is "touched by a fault", and
    the chaos bench's non-faulted completion floor reads it as the
    conservative denominator)."""

    def __init__(self, plan: FaultPlan = SMOKE_PLAN, registry=None):
        self.plan = plan
        self.counts = {"launch": 0, "nan": 0, "slow": 0, "stuck": 0}
        self.poisoned_uids: set = set()
        self._stuck_uids: set = set()
        reg = registry if registry is not None else default_registry()
        reg.register_component(self, {"faults": self.summary})

    def _trace(self, engine, kind: str, **args) -> None:
        """Record an ``inject`` instant on the wrapped engine's trace
        track (DESIGN.md §13.1).  Injection *decisions* are pure
        functions of (seed, kind, tick/uid) — the trace only witnesses
        them, so tracing never perturbs the fault schedule."""
        tr = getattr(engine, "tracer", None)
        if tr is not None:
            tr.tick_instant(engine, "inject", engine.tick, 0,
                            kind=kind, **args)

    def _draw(self, *key: int) -> float:
        seq = np.random.SeedSequence(
            [int(self.plan.seed)] + [int(k) & 0x7FFFFFFF for k in key])
        return float(np.random.default_rng(seq).random())

    def _victim(self, active: list, *key: int):
        """Pick the victim (slot, request) among the active pairs."""
        k = int(self._draw(_VICTIM, *key) * len(active)) % len(active)
        return active[k]

    # ------------------------------------------------- SlotEngine hooks

    def pre_launch(self, engine, active: list, attempt: int) -> None:
        """Before a launch attempt: maybe sleep (slow fault), maybe
        raise (launch fault).  Keyed per (tick, attempt) so a transient
        fault can clear on retry while ``rate=1.0`` (or an explicit
        tick) stays persistent through the whole retry budget."""
        p = self.plan
        if p.slow_rate and self._draw(_SLOW, engine.tick, attempt) < p.slow_rate:
            self.counts["slow"] += 1
            self._trace(engine, "slow", attempt=attempt)
            time.sleep(p.slow_s)
        hit = engine.tick in p.launch_error_ticks or (
            p.launch_error_rate
            and self._draw(_LAUNCH, engine.tick, attempt) < p.launch_error_rate)
        if hit:
            slot, req = self._victim(active, _LAUNCH, engine.tick, attempt)
            self.counts["launch"] += 1
            self.poisoned_uids.add(getattr(req, "uid", None))
            self._trace(engine, "launch", slot=slot,
                        uid=getattr(req, "uid", None), attempt=attempt)
            raise InjectedLaunchError(slot, engine.tick)

    def post_launch(self, engine, active: list, result):
        """After a successful launch: maybe corrupt one victim slot's
        rows to NaN/-1 — the corrupted-analog-activation input class the
        NaN/Inf guard must contain to one request."""
        p = self.plan
        hit = engine.tick in p.nan_ticks or (
            p.nan_rate and self._draw(_NAN, engine.tick) < p.nan_rate)
        if not hit:
            return result
        slot, req = self._victim(active, _NAN, engine.tick)
        self.counts["nan"] += 1
        self.poisoned_uids.add(getattr(req, "uid", None))
        self._trace(engine, "nan", slot=slot, uid=getattr(req, "uid", None))
        return _corrupt_slot_row(result, slot, engine.n_slots)

    def holds(self, engine, req) -> bool:
        """True ⇒ this occupant is stuck: its result is never absorbed,
        the slot stays held, and only the watchdog frees it.  Decided
        once per uid (seeded), so the answer never flips mid-stream."""
        uid = getattr(req, "uid", 0)
        p = self.plan
        stuck = uid in p.stuck_uids or uid in self._stuck_uids or (
            p.stuck_rate and self._draw(_STUCK, uid) < p.stuck_rate)
        if stuck and uid not in self._stuck_uids:
            self._stuck_uids.add(uid)
            self.counts["stuck"] += 1
            self.poisoned_uids.add(uid)
            self._trace(engine, "stuck", uid=uid)
        return bool(stuck)

    def summary(self) -> dict:
        """Injected-fault tallies plus the touched-uid count."""
        return {**self.counts, "poisoned": len(self.poisoned_uids)}
