"""Train state: params + optimizer state + step, as a plain dict; port of
`repro.train.state`.  ``step`` is a host int.  The reference's
``state_logical_axes`` comes with scale-out."""
from __future__ import annotations

from typing import Any


def TrainState(params: Any, opt_state: Any, step: int = 0,
               extras: dict | None = None) -> dict:
    state = {"params": params, "opt": opt_state, "step": int(step)}
    if extras:
        state["extras"] = extras
    return state
