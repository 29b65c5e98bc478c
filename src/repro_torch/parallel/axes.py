"""Logical-axis sharding: context-managed rules and constraint helpers;
port of `repro.parallel.axes`.

A :class:`ShardingPlan` binds a mesh to a rule table ``logical axis name →
mesh axis (or tuple of mesh axes, or None)``.  Code resolves logical
names (``"batch"``, ``"embed"``, …) through the plan to a `P` — one entry
per tensor dimension — and a `NamedSharding` turns that into what a rank
holds: its local slice, or `torch.distributed.tensor` placements.  Outside
a plan ``shard`` is a no-op, so the same code runs on one device.

Divisibility guard: a mesh axis is dropped from a dimension's spec when
it does not divide the dimension (8 KV heads over a 16-way model axis):
that dimension replicates along the axis.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Mapping, Sequence

_STATE = threading.local()


class P(tuple):
    """A partition spec: one entry a tensor dimension, each ``None``, a
    mesh axis name or a tuple of names.  A tuple, so it compares equal to
    the reference's ``PartitionSpec`` of the same entries."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    mesh: Any  # a DeviceMesh, or anything `mesh_shape` reads
    rules: dict[str, Any]  # logical name -> mesh axis | tuple | None

    def mesh_axes_for(self, logical: str | None):
        if logical is None:
            return None
        return self.rules.get(logical, None)

    def with_rules(self, **overrides) -> "ShardingPlan":
        rules = dict(self.rules)
        rules.update(overrides)
        return ShardingPlan(mesh=self.mesh, rules=rules)


def current_plan() -> ShardingPlan | None:
    return getattr(_STATE, "plan", None)


@contextlib.contextmanager
def use_plan(plan: ShardingPlan | None):
    prev = current_plan()
    _STATE.plan = plan
    try:
        yield plan
    finally:
        _STATE.plan = prev


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a `DeviceMesh` (its ``mesh_dim_names``
    against its shape), or of any object whose ``shape`` is already such a
    mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    shape = mesh.shape
    if not isinstance(shape, Mapping):
        raise TypeError(f"mesh shape {shape!r} names no axes")
    return dict(shape)


def _axes_tuple(axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def sanitize_spec(shape: Sequence[int], spec: Sequence, mesh) -> P:
    """Make a raw spec legal for (shape, mesh):

    * mesh axes absent from the mesh are dropped (a single-pod mesh has
      no "pod" axis);
    * axes that do not divide their dimension are dropped (replicate);
    * an axis may appear only once: the first dimension to claim it keeps
      it (MoE (expert, embed, mlp): when expert takes "model" the mlp
      dimension replicates, and when expert is not divisible the mlp
      dimension inherits "model").
    """
    sizes = mesh_shape(mesh)
    out = []
    used: set[str] = set()
    padded = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, axes in zip(shape, padded):
        kept: list[str] = []
        size = dim
        for a in _axes_tuple(axes):
            if a not in sizes or a in used:
                continue
            n = sizes[a]
            if size % n == 0:
                kept.append(a)
                used.add(a)
                size //= n
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    return P(*out)


def logical_spec(shape: Sequence[int], logical_axes: Sequence[str | None],
                 plan: ShardingPlan | None = None) -> P:
    """Resolve logical axis names to a (sanitized) `P`."""
    plan = plan or current_plan()
    if plan is None:
        return P()
    if len(shape) != len(logical_axes):
        raise ValueError(f"shape {tuple(shape)} and logical axes "
                         f"{tuple(logical_axes)} differ in rank")
    raw = P(*(plan.mesh_axes_for(name) for name in logical_axes))
    return sanitize_spec(shape, raw, plan.mesh)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """The reference's ``NamedSharding(mesh, spec)``: how a tensor of the
    global shape lies over the mesh.  ``local`` takes this rank's slice
    (``jax.device_put``'s part on one rank); ``placements`` gives the
    same as `torch.distributed.tensor` placements."""

    mesh: Any
    spec: P

    def _dims(self) -> list[tuple[str, ...]]:
        return [_axes_tuple(a) for a in self.spec]

    @property
    def is_fully_replicated(self) -> bool:
        return not any(self._dims())

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        sizes = mesh_shape(self.mesh)
        dims = self._dims() + [()] * (len(shape) - len(self.spec))
        return tuple(d // math.prod(sizes[a] for a in axes)
                     for d, axes in zip(shape, dims))

    @property
    def placements(self) -> tuple:
        """One `Shard(d)` or `Replicate()` a mesh dimension."""
        from torch.distributed.tensor import Replicate, Shard

        owner = {a: d for d, axes in enumerate(self._dims()) for a in axes}
        return tuple(Shard(owner[a]) if a in owner else Replicate()
                     for a in self.mesh.mesh_dim_names)

    def local(self, x):
        """This rank's slice of ``x`` (a tensor or a numpy array of the
        global shape); raises on a rank outside the mesh."""
        if self.is_fully_replicated:
            return x
        coord = self.mesh.get_coordinate()
        if coord is None:
            raise RuntimeError(f"this rank is not in {self.mesh}")
        at = dict(zip(self.mesh.mesh_dim_names, coord))
        sizes = mesh_shape(self.mesh)
        index = []
        for d, axes in enumerate(self._dims()):
            n, i = 1, 0
            for a in axes:  # row-major over the axes, as the reference's
                n, i = n * sizes[a], i * sizes[a] + at[a]
            step = x.shape[d] // n
            index.append(slice(i * step, (i + 1) * step))
        return x[tuple(index)]


def logical_sharding(shape: Sequence[int], logical_axes: Sequence[str | None],
                     plan: ShardingPlan | None = None) -> NamedSharding | None:
    plan = plan or current_plan()
    if plan is None:
        return None
    return NamedSharding(plan.mesh, logical_spec(shape, logical_axes, plan))


def shard(x, *logical_axes: str | None):
    """The reference's sharding constraint.  Outside a plan, and on a
    local tensor (what each rank holds of a sharded one), a no-op; a
    `DTensor` whose placements differ from the plan's is redistributed."""
    plan = current_plan()
    if plan is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    want = logical_sharding(tuple(x.shape), logical_axes, plan).placements
    if tuple(x.placements) == want:
        return x
    return x.redistribute(plan.mesh, want)
