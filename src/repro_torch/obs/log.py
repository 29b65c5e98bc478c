"""Structured logging: one machine-parseable record schema for the
stack's operational notices (DESIGN.md §13.4).

Copy of `repro.obs.log` (JAX-free), imports rewritten to this package.

Every notice the stack emits outside the trace/metric surfaces — the
autotuner's "disabled, serving defaults" info line, the bench gate's
cross-backend skip warnings — goes through :func:`structured` instead of
a bare ``logging``/``warnings``/``print`` call, so an operator (or a CI
log scraper) parses one schema instead of N ad-hoc formats:

    {"event": "<dotted.event.name>", "schema": 1, **fields}

The record is serialized with ``sort_keys`` and compact separators, so
identical records are byte-identical strings — the same determinism
contract the tracer export holds (§13.3).  ``structured`` also counts
each event name into the metrics registry (``log.<event>``), so the
registry snapshot shows *that* a notice fired even when the log stream
was discarded.

No timestamps: a structured record is stamped by its position in the
log stream (and, for tick-domain events, by the ``tick`` field the
caller supplies), never by the wall clock — wall stamps would break the
byte-identity contract and add nothing a log collector doesn't already
attach.
"""
from __future__ import annotations

import json
import logging
from typing import Any

#: Schema version embedded in every record; bump on breaking changes to
#: the field contract so parsers can dispatch.
SCHEMA_VERSION = 1


def format_record(event: str, **fields: Any) -> str:
    """The canonical serialized form of one structured record —
    deterministic: sorted keys, compact separators, no wall stamps."""
    record = {"event": event, "schema": SCHEMA_VERSION, **fields}
    return json.dumps(record, sort_keys=True, separators=(",", ":"),
                      default=str)


def structured(logger: logging.Logger, event: str,
               level: int = logging.INFO, **fields: Any) -> str:
    """Emit one structured record through ``logger`` and count it into
    the metrics registry; returns the serialized record (callers that
    also need a human-facing line print it themselves)."""
    line = format_record(event, **fields)
    logger.log(level, line)
    from repro_torch.obs.metrics import default_registry

    default_registry().counter(f"log.{event}").inc()
    return line
