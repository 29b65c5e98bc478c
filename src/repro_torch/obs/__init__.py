"""Observability: the unified metrics registry and structured logging,
copied from `repro.obs` (the scheduler's ``tracer=`` is duck-typed, so
the tracer waits for a later slice)."""
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

__all__ = ["SCHEMA_VERSION", "format_record", "structured", "Counter",
           "Gauge", "MetricsRegistry", "TickHistogram", "counted_lru_cache",
           "default_registry", "tick_percentiles"]
