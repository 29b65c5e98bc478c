"""Deterministic tick-domain tracing for the serving stack
(DESIGN.md §13.1/§13.3); copy of `repro.obs.trace` (JAX-free).

A `Tracer` records the causal life of every request — submit → admit →
queue → launch attempt/retry/quarantine → absorb → complete/evict/fault
— plus engine-tick, replica-dispatch, and fault-injection events, all
stamped in **tick-domain time**: the front door's virtual clock when the
engine runs behind a door, the engine's own clock otherwise.  Export is
Chrome/Perfetto trace-event JSON (``chrome://tracing`` /
``ui.perfetto.dev`` load it directly), with 1 trace microsecond ≡ 1
tick.

Two hard contracts, the reason this is a subsystem and not a logger:

* **Bit-for-bit free when disabled.**  ``tracer=None`` (the default
  everywhere) and a constructed-but-disabled ``Tracer(enabled=False)``
  are pinned like `serving.faults.FaultInjector`'s off mode: schedules,
  ledgers, and model outputs are identical to a run with no tracer
  anywhere on the path (``tests/test_obs.py``,
  ``tests/test_torch_trace.py``).  Every hook in the
  serving stack is behind an ``if tracer is not None`` (and the hooks
  themselves no-op when disabled); no hook ever touches schedule state.
* **Deterministic when enabled.**  Same seed + same trace config ⇒
  byte-identical export.  Every stamp is a tick, every arg is schedule
  state (uids, slots, statuses, counts) — never the wall clock.  Wall
  time is observability too, so per-launch wall spans exist behind
  ``wall=True``, an explicit opt-out of the byte-identity contract
  (the bench artifact and the determinism tests keep the default).
  ``export()`` serializes with sorted keys and compact separators.

Track model: ``pid`` is an engine (assigned per-tracer in attach order,
so identical runs get identical pids regardless of process history);
``tid`` 0 is the engine's tick/launch track, ``tid`` 1000+uid is a
request's track.  The span taxonomy and the validator's well-formedness
rules are documented in DESIGN.md §13.1 and enforced by
:func:`validate_trace_events`.  The port's engines run the reference's
schedule, so a port door's tick-domain export equals the reference
door's byte for byte on the same traffic (``tests/test_torch_front_door.py``).
"""
from __future__ import annotations

import json
from typing import Any

#: Offset separating request tracks from engine-level tracks within a
#: pid: request uid u lives on tid REQUEST_TID_BASE + u.
REQUEST_TID_BASE = 1000

#: Event names the validator treats as terminal for a request's track —
#: at most one per submitted uid per engine.
TERMINAL_EVENTS = ("complete", "evict", "reject", "fail")

#: The full span/instant taxonomy (DESIGN.md §13.1).  The validator
#: rejects events outside it: a trace consumer should never meet an
#: undocumented name.
EVENT_NAMES = frozenset({
    "submit", "admit", "queue", "serve", "complete", "evict", "reject",
    "fail", "engine_tick", "door_tick", "launch", "launch_fault",
    "quarantine", "watchdog", "validate_fail", "halt", "dispatch",
    "inject", "session_turn",
})


class Tracer:
    """Deterministic tick-domain trace recorder; see module docstring.

    One tracer spans one run (a front door and all its engines, or a
    lone engine).  Attach it via the ``tracer=`` constructor knob on
    `SlotEngine` adapters / `FrontDoor` / `ReplicaPool`; the components
    call :meth:`attach` themselves.
    """

    def __init__(self, enabled: bool = True, wall: bool = False):
        self.enabled = enabled
        #: opt-in wall-clock args on engine-tick spans — explicitly
        #: outside the byte-identity contract (DESIGN.md §13.3)
        self.wall = wall
        self.events: list[dict] = []
        self._pids: dict[int, int] = {}  # id(component) -> pid
        self._labels: dict[int, str] = {}  # pid -> label
        self._scales: dict[int, int] = {}  # id(component) -> ticks/tick

    # ----------------------------------------------------------- wiring

    def attach(self, component, label: str | None = None) -> int:
        """Assign (or look up) the pid for a component.  Pids count up
        from 1 in attach order — per tracer, so a fresh tracer over a
        fresh run always yields the same pids."""
        key = id(component)
        if key not in self._pids:
            pid = len(self._pids) + 1
            self._pids[key] = pid
            self._labels[pid] = (label
                                 or type(component).__name__)
        return self._pids[key]

    def label(self, component, label: str) -> None:
        """Re-label a component's track (the front door names engines by
        their registration keys — "lm" beats "ServeEngine")."""
        if not self.enabled:
            return
        pid = self.attach(component)
        self._labels[pid] = label

    # ------------------------------------------------------------ clock

    def set_scale(self, component, ticks_per_tick: int) -> None:
        """Declare the component's tick-domain conversion: one of its
        engine ticks spans ``ticks_per_tick`` front-door ticks.  The
        event-driven `FrontDoor` sets this to each engine's
        ``tick_cost`` at construction — engine tick ``e`` fired at door
        tick ``e × cost`` on the event heap (DESIGN.md §11), so scaling
        every stamp and duration by the cost lands all tracks on the
        door's shared virtual clock.  Standalone engines keep the
        default scale 1 (their own clock is the trace clock)."""
        self._scales[id(component)] = int(ticks_per_tick)

    def scale(self, component) -> int:
        return self._scales.get(id(component), 1)

    # ------------------------------------------------------- recording

    def tick_instant(self, component, name: str, tick: int, tid: int = 0,
                     **args: Any) -> None:
        """An instant ("i") event at engine-domain ``tick`` (converted
        onto the trace clock by the component's scale)."""
        if not self.enabled:
            return
        self.events.append({
            "name": name, "ph": "i", "s": "t",
            "pid": self.attach(component), "tid": int(tid),
            "ts": int(tick) * self.scale(component), "args": args,
        })

    def tick_span(self, component, name: str, start_tick: int,
                  dur_ticks: int, tid: int = 0, **args: Any) -> None:
        """A complete ("X") span of ``dur_ticks`` engine ticks starting
        at engine-domain ``start_tick`` (both converted by scale)."""
        if not self.enabled:
            return
        k = self.scale(component)
        self.events.append({
            "name": name, "ph": "X",
            "pid": self.attach(component), "tid": int(tid),
            "ts": int(start_tick) * k, "dur": int(dur_ticks) * k,
            "args": args,
        })

    @staticmethod
    def req_tid(req) -> int:
        return REQUEST_TID_BASE + int(getattr(req, "uid", 0))

    # --------------------------------------------------------- export

    def trace_events(self) -> list[dict]:
        """The recorded events plus the metadata events naming each pid
        track (Perfetto reads ``process_name``)."""
        meta = [
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": label}}
            for pid, label in sorted(self._labels.items())
        ]
        return meta + self.events

    def export(self, path=None) -> str:
        """Chrome/Perfetto trace-event JSON; deterministic byte-for-byte
        under the §13.3 contract (sorted keys, compact separators, no
        wall stamps unless ``wall=True`` was requested)."""
        payload = {
            "displayTimeUnit": "ms",
            "otherData": {"clock": "ticks", "schema": 1},
            "traceEvents": self.trace_events(),
        }
        text = json.dumps(payload, sort_keys=True, separators=(",", ":"))
        if path is not None:
            from pathlib import Path

            Path(path).write_text(text + "\n")
        return text


def validate_trace_events(payload: dict | list) -> list[str]:
    """Schema validation for an exported trace (DESIGN.md §13.1);
    returns a list of problems (empty ⇒ valid).  Enforced:

    * **well-formed spans** — every event carries name/ph/pid/tid/ts
      with the right types, "X" spans a non-negative integer ``dur``,
      names stay inside the documented taxonomy;
    * **no orphaned spans** — a terminal request event (complete /
      evict / reject / fail) on a track that never saw ``submit`` is an
      orphan, and a second terminal event on one track is a double
      completion;
    * **monotone tick stamps** — within each (pid, tid) track, ``ts``
      never decreases in recorded order (the tick domain only moves
      forward).
    """
    if isinstance(payload, dict):
        events = payload.get("traceEvents")
        if not isinstance(events, list):
            return ["payload has no traceEvents list"]
    else:
        events = payload
    problems: list[str] = []
    last_ts: dict[tuple, int] = {}
    submitted: dict[tuple, bool] = {}
    terminal: dict[tuple, str] = {}
    for k, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {k}: not an object")
            continue
        ph = ev.get("ph")
        if ph == "M":
            continue  # metadata (track names)
        name = ev.get("name")
        if ph not in ("i", "X"):
            problems.append(f"event {k} ({name}): unknown ph {ph!r}")
            continue
        if name not in EVENT_NAMES:
            problems.append(f"event {k}: name {name!r} outside the "
                            "documented taxonomy")
        bad = [f for f in ("pid", "tid", "ts")
               if not isinstance(ev.get(f), int)]
        if ph == "X" and not (isinstance(ev.get("dur"), int)
                              and ev["dur"] >= 0):
            bad.append("dur")
        if bad:
            problems.append(f"event {k} ({name}): malformed fields {bad}")
            continue
        track = (ev["pid"], ev["tid"])
        if track in last_ts and ev["ts"] < last_ts[track]:
            problems.append(
                f"event {k} ({name}): ts {ev['ts']} < previous "
                f"{last_ts[track]} on track {track} — tick stamps must "
                "be monotone")
        last_ts[track] = ev["ts"]
        if ev["tid"] >= REQUEST_TID_BASE:
            if name == "submit":
                submitted[track] = True
            elif name in TERMINAL_EVENTS:
                if track not in submitted:
                    problems.append(
                        f"event {k}: terminal {name!r} on track {track} "
                        "with no submit — orphaned span")
                if track in terminal:
                    problems.append(
                        f"event {k}: second terminal {name!r} on track "
                        f"{track} (already {terminal[track]!r})")
                terminal[track] = name
    return problems
