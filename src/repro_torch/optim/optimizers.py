"""Optimizers, functional over parameter trees; port of
`repro.optim.optimizers` (not `torch.optim`).

SGD with momentum is the paper's training recipe (§5.1, momentum 0.9);
AdamW is the LM-pretraining default.  Optimizer state mirrors the
parameter tree.  ``update_in_place`` is the counterpart of the
reference's donated step (``donate_argnums``): it writes the new moments
and parameters into the state's and the parameters' own tensors, leaf by
leaf, and scales the gradients in place to clip them; its peak is the
resident trees plus a few temporaries of one leaf.  ``update`` returns
new trees and leaves its inputs as they are: it runs ``update_in_place``
on copies, so the two give the same bits.  ``step`` is a host int, and
``lr_fn(step)`` a float.

Unlike `torch.optim.SGD`, `sgd` applies weight decay outside the momentum
buffer, as the reference does.

Under a plan each rank updates its parts of the trees; the clip's global
norm is then the whole tree's (`global_norm` with the leaves'
shardings: each leaf's square-sum all-reduced over the axes it is
sharded over, counted once over those it is replicated over), which the
train step computes and hands to ``update_in_place`` as ``grad_norm``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.parallel import collectives as col
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    #: (grads, state, params, step, grad_norm=None) -> (params, state)
    update: Callable[..., tuple[Any, Any]]
    #: (grads, state, params, step, grad_norm=None) -> None; writes state
    #: and params (``grad_norm``: the gradients' global norm, for the clip)
    update_in_place: Callable[..., None]


def global_norm(tree, shardings=None) -> torch.Tensor:
    """sqrt(Σ leaf²) over every leaf, as a 0-dim float32 tensor.  With
    the leaves' ``shardings`` (this rank's parts under a plan): over the
    whole (global) tree, each leaf's square-sum summed over the ranks of
    the axes it is sharded over (one all-reduce a set of axes), the same
    on every rank."""
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in tree_leaves(tree)]
    if shardings is None:
        return torch.sqrt(torch.sum(torch.stack(leaves)))
    by_axes: dict[tuple, list] = {}
    meshes = {}
    for sq, sh in zip(leaves, tree_leaves(tree_map(lambda _, s: s, tree,
                                                   shardings))):
        axes = tuple(a for a in sh.mesh.mesh_dim_names
                     if a in col.sharded_over(sh))
        by_axes.setdefault(axes, []).append(sq)
        meshes[axes] = sh.mesh
    total = [col.all_reduce_sum(torch.sum(torch.stack(sqs)),
                                col.axis_groups(meshes[axes], axes))
             for axes, sqs in sorted(by_axes.items())]
    return torch.sqrt(torch.sum(torch.stack(total)))


def _copy(tree):
    return tree_map(lambda x: x.detach().clone(), tree)


def clip_by_global_norm_(grads, max_norm: float,
                         norm: torch.Tensor | None = None) -> torch.Tensor:
    """Scale the gradients in place to a global norm of at most
    ``max_norm``; the norm before (``norm``: the norm, when the caller
    has it, as under a plan)."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale)
    return norm


def clip_by_global_norm(grads, max_norm: float):
    """(copies of the grads scaled as `clip_by_global_norm_` scales them,
    the norm)."""
    grads = _copy(grads)
    return grads, clip_by_global_norm_(grads, max_norm)


def _functional(update_in_place: Callable) -> Callable:
    """``update``: `update_in_place` on copies of its inputs."""
    def update(grads, state, params, step, grad_norm=None):
        grads, state, params = _copy(grads), _copy(state), _copy(params)
        update_in_place(grads, state, params, step, grad_norm=grad_norm)
        return params, state
    return update


def _write(p: torch.Tensor, step_: torch.Tensor) -> None:
    """p ← (float32(p) − step_) in p's dtype; ``step_`` is consumed."""
    if p.dtype == torch.float32:
        p.sub_(step_)
    else:
        p.copy_((p.to(torch.float32) - step_).to(p.dtype))


def sgd(lr_fn: Callable, momentum: float = 0.9, clip_norm: float | None = None,
        weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"mu": tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)}

    @torch.no_grad()
    def update_in_place(grads, state, params, step, grad_norm=None):
        if clip_norm is not None:
            clip_by_global_norm_(grads, clip_norm, grad_norm)
        lr = lr_fn(step)

        def leaf(p, m, g):
            m.mul_(momentum).add_(g.to(torch.float32))
            t = p.to(torch.float32) * weight_decay
            _write(p, torch.add(m, t, out=t).mul_(lr))

        tree_map(leaf, params, state["mu"], grads)

    return Optimizer(init, _functional(update_in_place), update_in_place)


def adamw(lr_fn: Callable, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm: float | None = 1.0) -> Optimizer:
    def init(params):
        def z(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    @torch.no_grad()
    def update_in_place(grads, state, params, step, grad_norm=None):
        if clip_norm is not None:
            clip_by_global_norm_(grads, clip_norm, grad_norm)
        lr = lr_fn(step)
        t = float(step) + 1.0
        mh_scale = 1.0 / (1.0 - b1**t)
        vh_scale = 1.0 / (1.0 - b2**t)

        def leaf(p, m, v, g):
            g = g.to(torch.float32)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_(torch.square(g).mul_(1 - b2))
            del g
            den = torch.sqrt(v * vh_scale).add_(eps)
            u = (m * mh_scale).div_(den)
            del den
            u.add_(p.to(torch.float32) * weight_decay)
            _write(p, u.mul_(lr))

        tree_map(leaf, params, state["m"], state["v"], grads)

    return Optimizer(init, _functional(update_in_place), update_in_place)
