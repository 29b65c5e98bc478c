"""Unified metrics registry for the P²M serving stack (DESIGN.md §13.2).

Copy of `repro.obs.metrics` (JAX-free), imports rewritten to this package.

One process-wide (or test-local) `MetricsRegistry` replaces the stack's
fragmented one-off summary dicts as the queryable surface: engines,
pools, the front door, the fault injectors, the delta-gate ledgers, the
autotuner, and the compile caches all publish into it, and
``registry.snapshot()`` returns everything at once.  The legacy dict
APIs (`SlotEngine.latency_summary`, `FrontDoor.health`,
`StreamEngine.stream_summary`, `FaultInjector.summary`, …) stay — they
are the per-component *views* the registry aggregates, so existing
callers and tests read the same numbers through either surface
(pinned by ``tests/test_obs.py``).

Three instrument kinds, all deterministic state:

* **Counter** — monotone float/int accumulator (``inc``).  Used for
  compile-cache hits/misses, autotuner decisions, structured-log event
  counts, injected-fault tallies.
* **Gauge** — last-set value (``set``).  Used for instantaneous load
  signals published at snapshot time.
* **TickHistogram** — append-only series of tick-denominated
  observations with the same (p50, p95, p99) estimator the serving
  ledgers use (`serving.scheduler.tick_percentiles`), so a percentile
  read from the registry equals the one in the legacy summary.

Component views are registered with ``register_view(scope, name, fn)``
where ``fn`` is a zero-arg callable (typically a bound method like
``engine.latency_summary``).  Views hold the component via **weakref**:
a dead engine silently drops out of the snapshot instead of being kept
alive by the registry — a process-wide registry must not leak every
engine ever constructed.

Scopes are deterministic per process: ``scope_for(obj)`` assigns
``<classname>#<k>`` with ``k`` counting instances of that class in
registration order.  (Trace ``pid`` labels are assigned per-*tracer*,
not from these process-global scopes, so two identical runs in one
process still export byte-identical traces — DESIGN.md §13.3.)
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Sequence

import numpy as np


def tick_percentiles(values: Sequence[float]) -> tuple[float, float, float]:
    """(p50, p95, p99) of a tick series; zeros when empty.  The same
    linear-interpolation estimator as
    `repro_torch.serving.scheduler.tick_percentiles` — defined here (the
    serving module re-exports compatibly) so the obs layer never imports
    the serving layer it instruments."""
    if not values:
        return 0.0, 0.0, 0.0
    arr = np.asarray(values, np.float64)
    return (float(np.percentile(arr, 50)), float(np.percentile(arr, 95)),
            float(np.percentile(arr, 99)))


class Counter:
    """Monotone accumulator."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increments are non-negative, got {n}")
        self.value += n


class Gauge:
    """Last-set value."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class TickHistogram:
    """Append-only tick-denominated series; percentile reads share the
    serving stack's estimator so registry and ledger numbers agree."""

    __slots__ = ("values",)

    def __init__(self) -> None:
        self.values: list[float] = []

    def observe(self, v: float) -> None:
        self.values.append(float(v))

    def percentiles(self) -> tuple[float, float, float]:
        return tick_percentiles(self.values)

    def summary(self) -> dict:
        p50, p95, p99 = self.percentiles()
        n = len(self.values)
        return {"count": n,
                "sum": float(sum(self.values)),
                "mean": (sum(self.values) / n) if n else 0.0,
                "p50": p50, "p95": p95, "p99": p99}


class MetricsRegistry:
    """Process-wide metric surface; see module docstring."""

    def __init__(self) -> None:
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, TickHistogram] = {}
        # scope -> view name -> weakly-bound callable
        self._views: dict[str, dict[str, Callable[[], Any]]] = {}
        self._scope_counts: dict[str, int] = {}

    # ------------------------------------------------------ instruments

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge())

    def tick_histogram(self, name: str) -> TickHistogram:
        return self._hists.setdefault(name, TickHistogram())

    # ------------------------------------------------------------ views

    def scope_for(self, obj: object) -> str:
        """Deterministic per-process scope name for one component:
        ``<classname>#<k>`` in registration order."""
        cls = type(obj).__name__
        k = self._scope_counts.get(cls, 0)
        self._scope_counts[cls] = k + 1
        return f"{cls}#{k}"

    def register_view(self, scope: str, name: str, method) -> None:
        """Register a component view: ``method`` is a *bound method*
        (``engine.latency_summary``); only a weakref to its receiver is
        held, so registration never extends the component's life."""
        ref = weakref.ref(method.__self__)
        func = method.__func__

        def call():
            obj = ref()
            return None if obj is None else func(obj)

        self._views.setdefault(scope, {})[name] = call

    def register_component(self, obj: object,
                           views: dict[str, Any] | None = None,
                           scope: str | None = None) -> str:
        """Register a component's named views in one call; returns the
        scope assigned.  ``views`` maps view name → bound method."""
        scope = scope or self.scope_for(obj)
        for name, method in (views or {}).items():
            self.register_view(scope, name, method)
        return scope

    # --------------------------------------------------------- snapshot

    def snapshot(self) -> dict:
        """Everything at once: instrument values plus every live
        component view (dead components drop out silently)."""
        out: dict = {
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "tick_histograms": {k: h.summary()
                                for k, h in sorted(self._hists.items())},
        }
        comps: dict = {}
        for scope, views in sorted(self._views.items()):
            live = {}
            for name, call in sorted(views.items()):
                val = call()
                if val is not None:
                    live[name] = val
            if live:
                comps[scope] = live
        out["components"] = comps
        return out

    def reset(self) -> None:
        """Drop every instrument and view (test isolation)."""
        self._counters.clear()
        self._gauges.clear()
        self._hists.clear()
        self._views.clear()
        self._scope_counts.clear()


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry every component publishes into unless
    handed an explicit one (tests pass their own for isolation)."""
    return _DEFAULT


def counted_lru_cache(name: str, maxsize: int | None = None):
    """``functools.lru_cache`` with registry-visible hit/miss counters.

    Drop-in replacement for ``@functools.lru_cache(maxsize=None)`` on
    the serving stack's compile caches (`_decode_step_for`,
    `_chunk_step_for`, `_deploy_forward_for`, `_stream_forward_for`):
    every call increments ``compile_cache.<name>.hits`` or
    ``compile_cache.<name>.misses`` in the default registry, so the
    snapshot shows whether engines are actually sharing compilations
    (a re-jit-per-engine regression shows up as a flat hit count).

    ``cache_info``/``cache_clear`` pass through, so callers and tests
    that poke the cache keep working unchanged.
    """
    import functools

    def deco(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            before = cached.cache_info()
            out = cached(*args, **kwargs)
            after = cached.cache_info()
            # counters re-fetched per call so a registry reset() (test
            # isolation) never leaves the cache feeding orphans
            reg = default_registry()
            reg.counter(f"compile_cache.{name}.hits").inc(
                after.hits - before.hits)
            reg.counter(f"compile_cache.{name}.misses").inc(
                after.misses - before.misses)
            return out

        wrapper.cache_info = cached.cache_info
        wrapper.cache_clear = cached.cache_clear
        wrapper.__wrapped__ = fn
        return wrapper

    return deco
