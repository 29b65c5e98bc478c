"""Observability: deterministic tick-domain tracing, the unified metrics
registry, and structured logging (DESIGN.md §13); copies of
`repro.obs` (JAX-free), the same names exported.

This layer never imports the serving stack it instruments — components
take a ``tracer=`` knob and publish views into the registry, so the
dependency arrow points serving → obs only.
"""
from repro_torch.obs.log import SCHEMA_VERSION, format_record, structured
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    MetricsRegistry,
    TickHistogram,
    counted_lru_cache,
    default_registry,
    tick_percentiles,
)
from repro_torch.obs.trace import (
    EVENT_NAMES,
    REQUEST_TID_BASE,
    TERMINAL_EVENTS,
    Tracer,
    validate_trace_events,
)

__all__ = [
    "SCHEMA_VERSION",
    "format_record",
    "structured",
    "Counter",
    "Gauge",
    "MetricsRegistry",
    "TickHistogram",
    "counted_lru_cache",
    "default_registry",
    "tick_percentiles",
    "EVENT_NAMES",
    "REQUEST_TID_BASE",
    "TERMINAL_EVENTS",
    "Tracer",
    "validate_trace_events",
]
