"""The collectives that stand in for the reductions XLA's SPMD partitioner
inserts in the reference: explicit calls on a mesh axis's process group.

A data-parallel step splits the batch over the mesh axes of the plan's
``"batch"`` rule (`batch_axes`).  Every reduction over the batch is then
a local reduction followed by a sum over those axes' groups
(`all_reduce_sum`, differentiable: its backward sums the cotangents
over the same groups).  BN's batch statistics read the groups from
`reduce_batch_over`, a context the step opens: outside it
`batch_moments` is the single-device code, unchanged.

A failed collective raises (the process group's timeout); nothing falls
back to a local reduction.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel.axes import (
    P,
    NamedSharding,
    ShardingPlan,
    logical_spec,
    mesh_shape,
)
from repro_torch.parallel.plans import vision_plan_for
from repro_torch.tree import tree_leaves, tree_unflatten

_STATE = threading.local()


def batch_axes(plan: ShardingPlan, size: int | None = None) -> tuple[str, ...]:
    """The mesh axes the plan splits a batch dimension of ``size`` over,
    outermost first (``None``: every batch axis the mesh has)."""
    if size is None:
        rule = plan.mesh_axes_for("batch")
        rule = (rule,) if isinstance(rule, str) else tuple(rule or ())
        sizes = mesh_shape(plan.mesh)
        return tuple(a for a in rule if a in sizes)
    (axes,) = logical_spec((size,), ("batch",), plan)
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_groups(mesh, axes: Sequence[str]) -> tuple:
    """The process group of each mesh axis in ``axes`` that holds this
    rank (outermost first)."""
    return tuple(mesh.get_group(a) for a in axes)


def group_size(groups) -> int:
    return math.prod(dist.get_world_size(g) for g in groups)


class _AllReduceSum(torch.autograd.Function):
    """Sum over every group in turn; the cotangent is summed the same
    way (the sum's Jacobian is all ones across the ranks)."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _sum_(x.detach().clone(memory_format=torch.contiguous_format),
                     groups)

    @staticmethod
    def backward(ctx, grad):
        return _sum_(grad.clone(memory_format=torch.contiguous_format),
                     ctx.groups), None


def _sum_(x: torch.Tensor, groups) -> torch.Tensor:
    for g in groups:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=g)
    return x


def all_reduce_sum(x: torch.Tensor, groups) -> torch.Tensor:
    """``x`` summed over ``groups`` on every rank, differentiable."""
    return _AllReduceSum.apply(x, tuple(groups))


def all_reduce_tree(tree: dict, groups) -> dict:
    """Every leaf of a tree of same-dtype tensors summed over ``groups``
    through one flat buffer: one collective a group, whatever the number
    of leaves."""
    leaves = tree_leaves(tree)
    flat = _sum_(torch.cat([t.reshape(-1) for t in leaves]), groups)
    out, at = [], 0
    for t in leaves:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return tree_unflatten(tree, out)


def all_gather_batch(x: torch.Tensor, groups) -> torch.Tensor:
    """The global batch from each rank's slice of dimension 0, in mesh
    order (the innermost axis varies fastest, as `NamedSharding.local`
    slices)."""
    x = x.contiguous()
    for g in reversed(tuple(groups)):
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(g))]
        dist.all_gather(parts, x, group=g)
        x = torch.cat(parts, dim=0)
    return x


def share_from_mesh(x: torch.Tensor | None, mesh, shape, dtype,
                    device) -> torch.Tensor:
    """A result that the ranks of ``mesh`` computed, on every rank of the
    world: broadcast from the mesh's first rank (ranks outside the mesh
    pass ``None`` and receive).  With a mesh that spans the world, ``x``
    as it is."""
    if mesh.size() == dist.get_world_size():
        return x
    src = int(mesh.mesh.flatten()[0])
    x = (torch.empty(shape, dtype=dtype, device=device) if x is None
         else x.contiguous())
    dist.broadcast(x, src=src)
    return x


class SlotShards:
    """How an engine's slot table of ``n`` rows lies over a data mesh
    that the vision plan splits it over, for an engine that every rank
    of the world drives with the same requests: ``rows`` are the slots
    this rank computes (none outside the mesh; all where the mesh's
    batch axes do not divide ``n``, which then replicates), and `gather`
    returns the whole table's result on every rank of the world."""

    def __init__(self, mesh, n: int):
        plan = vision_plan_for(mesh)
        axes = batch_axes(plan, n)
        self.mesh = mesh
        self.member = mesh.get_coordinate() is not None
        self.rows = (NamedSharding(mesh, P(axes or None)).local(
            np.arange(n)) if self.member else np.arange(0))
        self.groups = axis_groups(mesh, axes) if self.member else ()

    def gather(self, local: torch.Tensor | None, shape, dtype,
               device) -> torch.Tensor:
        """The (n, ...) result from each member's (len(rows), ...) part;
        ranks outside the mesh pass ``None``."""
        full = all_gather_batch(local, self.groups) if self.member else None
        return share_from_mesh(full, self.mesh, shape, dtype, device)


@contextlib.contextmanager
def reduce_batch_over(groups):
    """Within the context, `batch_moments` reduces over ``groups`` too
    (the ranks' slices of one global batch).  ``None``: the local batch
    is the whole batch."""
    prev = getattr(_STATE, "groups", None)
    _STATE.groups = tuple(groups) if groups is not None else None
    try:
        yield
    finally:
        _STATE.groups = prev


def batch_moments(x: torch.Tensor, dims: tuple[int, ...]):
    """(mean, population variance) of ``x`` over ``dims`` and, inside
    `reduce_batch_over`, over the ranks' slices of the batch: the sums
    go through the differentiable all-reduce, so the backward sees the
    global statistics too."""
    groups = getattr(_STATE, "groups", None)
    if groups is None:
        return x.mean(dim=dims), x.var(dim=dims, correction=0)
    n = math.prod(x.shape[d] for d in dims) * group_size(groups)
    keep = [1 if d in dims else s for d, s in enumerate(x.shape)]
    mean = all_reduce_sum(x.sum(dim=dims), groups) / n
    sq = (x - mean.reshape(keep)).square().sum(dim=dims)
    return mean, all_reduce_sum(sq, groups) / n
