"""`NamedSharding` trees from (value tree, logical-axes tree), and each
rank's local part of a tree; port of `repro.parallel.sharding_utils`.

Logical-axes trees mirror the value trees, with *tuples of axis names*
as leaves; the walk goes through dicts by hand, so a tuple is a leaf.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.parallel.axes import (
    P,
    NamedSharding,
    ShardingPlan,
    logical_spec,
)
from repro_torch.tree import tree_map


def _shape(x) -> tuple[int, ...]:
    shape = getattr(x, "shape", None)
    return tuple(shape) if shape is not None else np.shape(x)


def _is_axes_leaf(x: Any) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def shardings_for(values: Any, axes: Any, plan: ShardingPlan) -> Any:
    """values: tree of tensors (``meta`` ones too) or arrays; axes: the
    matching tree of logical-axis tuples → tree of `NamedSharding`."""
    if _is_axes_leaf(axes):
        return NamedSharding(plan.mesh,
                             logical_spec(_shape(values), axes, plan))
    if not (isinstance(values, dict) and isinstance(axes, dict)):
        raise TypeError(f"value tree {type(values).__name__} against axes "
                        f"tree {type(axes).__name__}")
    return {k: shardings_for(values[k], axes[k], plan) for k in values}


def replicated(plan: ShardingPlan) -> NamedSharding:
    return NamedSharding(plan.mesh, P())


def replicated_tree(values: Any, plan: ShardingPlan) -> Any:
    """Every leaf replicated: the param/optimizer sharding of plain-DP
    models (the VWW MobileNetV2's conv stacks live whole on every rank)."""
    rep = replicated(plan)
    return tree_map(lambda _: rep, values)


def batch_shardings(batch: Any, plan: ShardingPlan) -> Any:
    """Dimension 0 of every leaf sharded by the ``"batch"`` rule, the
    other dimensions replicated: the input sharding of data-parallel
    steps over (B, ...) arrays.  Scalar leaves replicate."""
    def leaf(x):
        shape = _shape(x)
        if not shape:
            return replicated(plan)
        axes = ("batch",) + (None,) * (len(shape) - 1)
        return NamedSharding(plan.mesh, logical_spec(shape, axes, plan))

    return tree_map(leaf, batch)


def local_tree(values: Any, shardings: Any) -> Any:
    """Each leaf's part on this rank (`NamedSharding.local`): what a rank
    holds of a tree the reference would ``device_put`` by ``shardings``."""
    return tree_map(lambda x, sh: sh.local(x), values, shardings)
