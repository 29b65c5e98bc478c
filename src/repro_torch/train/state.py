"""Train state: params + optimizer state + step, as a plain dict; port of
`repro.train.state`.  ``step`` is a host int."""
from __future__ import annotations

from typing import Any


def TrainState(params: Any, opt_state: Any, step: int = 0,
               extras: dict | None = None) -> dict:
    state = {"params": params, "opt": opt_state, "step": int(step)}
    if extras:
        state["extras"] = extras
    return state


def _rename_opt_axes(axes: Any) -> Any:
    """Optimizer-state axes get their own logical names (``opt_embed`` /
    ``opt_mlp``), which mirror the param rules unless a plan overrides
    them (ZeRO-1: optimizer sharded more than params)."""
    if isinstance(axes, tuple):
        ren = {"embed": "opt_embed", "mlp": "opt_mlp"}
        return tuple(ren.get(a, a) for a in axes)
    return {k: _rename_opt_axes(v) for k, v in axes.items()}


def state_logical_axes(param_axes: Any, opt_state: Any) -> dict:
    """Logical-axes tree matching the `TrainState` structure: optimizer
    moments (``"mu"`` / ``"m"`` / ``"v"``) mirror the param axes through
    the ``opt_*`` aliases; the step scalar is unsharded."""
    opt_axes = {k: _rename_opt_axes(param_axes) for k in opt_state.keys()}
    return {"params": param_axes, "opt": opt_axes, "step": ()}
