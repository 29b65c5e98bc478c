"""The collectives that stand in for the reductions XLA's SPMD partitioner
inserts in the reference: explicit calls on a mesh axis's process group.

A data-parallel step splits the batch over the mesh axes of the plan's
``"batch"`` rule (`batch_axes`).  Every reduction over the batch is then
a local reduction followed by a sum over those axes' groups
(`all_reduce_sum`, differentiable: its backward sums the cotangents
over the same groups).  BN's batch statistics read the groups from
`reduce_batch_over`, a context the step opens: outside it
`batch_moments` is the single-device code, unchanged.

The LM path's tensor, expert and fully-sharded parallelism adds the
model-axis pair of Megatron-LM: `copy_to_model` (*f*: identity forward,
all-reduce backward) where a tensor replicated over the model axis
enters a product sharded over it, and `reduce_from_model` (*g*:
all-reduce forward, identity backward) where the ranks' partial sums
leave it.  Between them every model rank computes the same replicated
activations, so a leaf replicated over the model axis gets the same,
whole gradient on every model rank and nothing sums over that axis.
`gather_from_model` joins the ranks' disjoint slices of a tensor that is
then used alike on every rank (its backward takes the rank's slice);
`gather_for_use` joins slices that each rank then uses in its own way (a
leaf sharded over ``"data"`` under FSDP, KV heads a rank's query heads
need), so its backward reduce-scatters (sums, then takes the slice).
`leaf_axes` reads, from a leaf's `NamedSharding`, the mesh axes each of
its dimensions is sharded over.  The split-KV decode combines its
partial softmaxes with `split_kv_combine`; the vocab-parallel loss and
argmax reduce with `vocab_parallel_nll` and `vocab_parallel_argmax`.

A reduce-scatter is an all-reduce followed by a narrow to the rank's
slice, on every backend (gloo included): the sum is the same on every
rank, so the slices agree bit for bit with those of the forward.

A failed collective raises (the process group's timeout); nothing falls
back to a local reduction.
"""
from __future__ import annotations

import contextlib
import dataclasses
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
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

_STATE = threading.local()


def leaf_axes(sharding: NamedSharding) -> tuple[tuple[str, ...], ...]:
    """The mesh axes each dimension of a leaf is sharded over, outermost
    first, read from its sharding (``()`` for a replicated dimension)."""
    return tuple(() if a is None else (a,) if isinstance(a, str) else tuple(a)
                 for a in sharding.spec)


def sharded_over(sharding: NamedSharding) -> frozenset[str]:
    """Every mesh axis some dimension of the leaf is sharded over."""
    return frozenset(a for axes in leaf_axes(sharding) for a in axes)


def model_dim(sharding: NamedSharding) -> int | None:
    """The dimension of a leaf sharded over the ``"model"`` axis, or None."""
    for d, axes in enumerate(leaf_axes(sharding)):
        if "model" in axes:
            return d
    return None


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The plan's ``"model"`` axis as this rank sees it: its process group
    (as a one-element tuple, the form the collectives take), its size and
    this rank's index on it."""
    groups: tuple
    size: int
    index: int


def model_axis(mesh) -> ModelAxis | None:
    """The ``"model"`` axis of ``mesh`` (a plan's, or the mesh a leaf's
    `NamedSharding` names), or None where the mesh has none: then every
    leaf is whole over it and the single-device code runs.  An axis of
    size 1 runs the tensor-parallel code, its collectives over one rank.
    The models read it from their params' shardings, never from the
    current plan: a remat recompute runs in the autograd engine's
    thread, where the thread-local plan is not set."""
    if "model" not in mesh_shape(mesh):
        return None
    g = mesh.get_group("model")
    return ModelAxis((g,), dist.get_world_size(g), dist.get_rank(group=g))


def whole_tree(tree, shardings):
    """Every leaf whole on every rank: this rank's parts gathered over
    each dimension's axes, outside autograd."""
    def leaf(x, sh):
        for d, axes in enumerate(leaf_axes(sh)):
            if axes:
                x = _gather(x.detach(), axis_groups(sh.mesh, axes), d)
        return x

    return tree_map(leaf, tree, shardings)


def gather_fsdp(tree, shardings):
    """Each leaf of ``tree`` (this rank's parts) whole over every axis but
    ``"model"``: the dimensions FSDP shards over the batch axes are
    gathered for use (`gather_for_use`, whose backward reduce-scatters the
    gradient back to the rank's part).  ``shardings``: the leaves'
    shardings, of the same structure (their mesh names the groups, so a
    remat recompute needs no current plan)."""
    def leaf(x, sh):
        for d, axes in enumerate(leaf_axes(sh)):
            rest = tuple(a for a in axes if a != "model")
            if rest and len(rest) != len(axes):
                raise ValueError(f"dimension {d} of a leaf is sharded over "
                                 f"{axes}: FSDP and the model axis on one "
                                 "dimension is not supported")
            if rest:
                x = gather_for_use(x, axis_groups(sh.mesh, rest), d)
        return x

    return tree_map(leaf, tree, shardings)


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


def group_index(groups) -> tuple[int, int]:
    """(this rank's row-major index over ``groups``, their product)."""
    i, n = 0, 1
    for g in groups:
        size = dist.get_world_size(g)
        i, n = i * size + dist.get_rank(group=g), n * size
    return i, n


def _gather(x: torch.Tensor, groups, dim: int) -> torch.Tensor:
    """The ranks' slices of ``dim`` joined in mesh order (innermost axis
    fastest, as `NamedSharding.local` slices)."""
    x = x.contiguous()
    for g in reversed(tuple(groups)):
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(g))]
        dist.all_gather(parts, x, group=g)
        x = torch.cat(parts, dim=dim)
    return x


def _slice(x: torch.Tensor, groups, dim: int) -> torch.Tensor:
    """This rank's slice of ``dim`` over ``groups``."""
    i, n = group_index(groups)
    step = x.shape[dim] // n
    return x.narrow(dim, i * step, step).contiguous()


def _summed(x: torch.Tensor, groups) -> torch.Tensor:
    return _sum_(x.clone(memory_format=torch.contiguous_format), groups)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.groups), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        return _summed(x.detach(), groups)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, dim):
        ctx.groups, ctx.dim = groups, dim
        return _gather(x.detach(), groups, dim)

    @staticmethod
    def backward(ctx, grad):
        return _slice(grad, ctx.groups, ctx.dim), None, None


class _GatherForUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, dim):
        ctx.groups, ctx.dim = groups, dim
        return _gather(x.detach(), groups, dim)

    @staticmethod
    def backward(ctx, grad):
        return _slice(_summed(grad, ctx.groups), ctx.groups, ctx.dim), \
            None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, dim):
        ctx.groups, ctx.dim = groups, dim
        return _slice(_summed(x.detach(), groups), groups, dim)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.groups, ctx.dim), None, None


def copy_to_model(x: torch.Tensor, groups) -> torch.Tensor:
    """Megatron's *f*: ``x`` (replicated over ``groups``) as it is; its
    cotangent is summed over ``groups``, since each rank's sharded use
    of ``x`` contributes a part of its gradient."""
    return _CopyToModel.apply(x, tuple(groups)) if groups else x


def reduce_from_model(x: torch.Tensor, groups) -> torch.Tensor:
    """Megatron's *g*: the ranks' partial sums added; the cotangent of the
    (replicated) sum passes to each rank's part as it is."""
    return _ReduceFromModel.apply(x, tuple(groups)) if groups else x


def gather_from_model(x: torch.Tensor, groups, dim: int = -1) -> torch.Tensor:
    """The ranks' slices of ``dim`` joined, for a result every rank then
    uses alike; the backward takes the rank's slice of the cotangent."""
    if not groups:
        return x
    return _GatherFromModel.apply(x, tuple(groups), dim % x.ndim)


def gather_for_use(x: torch.Tensor, groups, dim: int) -> torch.Tensor:
    """The ranks' slices of ``dim`` joined, for a result each rank uses in
    its own way (an FSDP leaf on a rank's batch, the KV heads a rank's
    query heads read): the backward reduce-scatters the cotangents."""
    if not groups:
        return x
    return _GatherForUse.apply(x, tuple(groups), dim % x.ndim)


def reduce_scatter(x: torch.Tensor, groups, dim: int = -1) -> torch.Tensor:
    """The ranks' partial sums added, and this rank's slice of ``dim`` of
    the sum; the backward all-gathers the slices' cotangents."""
    if not groups:
        return x
    return _ReduceScatter.apply(x, tuple(groups), dim % x.ndim)


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
    return _gather(x, groups, 0)


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


# ------------------------------------------------------------ LM reductions


def all_reduce_max(x: torch.Tensor, groups) -> torch.Tensor:
    """The elementwise max over ``groups``, outside autograd."""
    x = x.detach().clone(memory_format=torch.contiguous_format)
    for g in groups:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=g)
    return x


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor,
                       start: int, groups) -> torch.Tensor:
    """Each token's −log softmax at its target over logits whose last
    dimension is this rank's vocab columns ``[start, start + V_local)``:
    the max (outside autograd), the sum of exponentials and the target's
    logit (on the rank that holds its column, 0 elsewhere) are reduced
    over ``groups``, the sums by *g*, so each rank's local logits get
    softmax − one-hot of their own columns as their gradient."""
    top = all_reduce_max(logits.amax(dim=-1), groups)
    sumexp = reduce_from_model(
        torch.exp(logits - top[..., None]).sum(dim=-1), groups)
    local = targets.long() - start
    here = (local >= 0) & (local < logits.shape[-1])
    picked = torch.gather(logits, -1,
                          torch.clamp(local, 0, logits.shape[-1] - 1)[..., None])
    true = reduce_from_model(torch.where(here, picked[..., 0], 0.0), groups)
    return torch.log(sumexp) + top - true


def vocab_parallel_argmax(logits: torch.Tensor, start: int,
                          groups) -> torch.Tensor:
    """The argmax over the whole vocab of logits sharded over its columns:
    each rank's (max, global index), the larger max winning and the lower
    index at a tie, as ``jnp.argmax``."""
    value, index = logits.detach().max(dim=-1)
    values = _gather(value[None], groups, 0)  # (ranks, ...) in vocab order
    indices = _gather((index + start)[None], groups, 0)
    best = values.argmax(dim=0, keepdim=True)  # the first rank at a tie
    return torch.gather(indices, 0, best)[0]


def split_kv_combine(top: torch.Tensor, sumexp: torch.Tensor,
                     acc: torch.Tensor, groups) -> torch.Tensor:
    """Attention over a key sequence split over ``groups`` from each
    rank's partial softmax over its slice: ``top`` its running max (...),
    ``sumexp`` Σ exp(s − top) (...) and ``acc`` Σ exp(s − top)·v (...,
    D).  The max is all-reduced, each part rescaled by exp(top − max),
    and the rescaled sums all-reduced (one collective).  A rank whose
    slice is all masked holds ``top`` at the masked score, far below the
    max: its weight is exp of a huge negative, 0, never NaN (a slice of
    −inf would be kept at weight 0 too).  Outside autograd (decode)."""
    best = all_reduce_max(top, groups)
    w = torch.where(torch.isneginf(top), 0.0, torch.exp(top - best))
    parts = torch.cat([(sumexp * w)[..., None], acc * w[..., None]], dim=-1)
    parts = _summed(parts.detach(), groups)
    return parts[..., 1:] / parts[..., :1]
