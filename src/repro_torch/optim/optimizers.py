"""Optimizers, functional over parameter trees; port of
`repro.optim.optimizers` (not `torch.optim`).

SGD with momentum is the paper's training recipe (§5.1, momentum 0.9);
AdamW is the LM-pretraining default.  Optimizer state mirrors the
parameter tree; updates return new trees and leave their inputs as they
are.  ``step`` is a host int, and ``lr_fn(step)`` a float.

Unlike `torch.optim.SGD`, `sgd` applies weight decay outside the momentum
buffer, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    #: (grads, state, params, step) -> (params, state)
    update: Callable[..., tuple[Any, Any]]


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ leaf²) over every leaf, as a 0-dim float32 tensor."""
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def sgd(lr_fn: Callable, momentum: float = 0.9, clip_norm: float | None = None,
        weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"mu": tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)}

    def update(grads, state, params, step):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        lr = lr_fn(step)
        mu = tree_map(lambda m, g: momentum * m + g.to(torch.float32),
                      state["mu"], grads)
        new_params = tree_map(
            lambda p, m: (p.to(torch.float32) - lr * (
                m + weight_decay * p.to(torch.float32))).to(p.dtype),
            params, mu)
        return new_params, {"mu": mu}

    return Optimizer(init, update)


def adamw(lr_fn: Callable, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm: float | None = 1.0) -> Optimizer:
    def init(params):
        def z(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    def update(grads, state, params, step):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        lr = lr_fn(step)
        t = float(step) + 1.0
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2)
                     * torch.square(g.to(torch.float32)), state["v"], grads)
        mh_scale = 1.0 / (1.0 - b1**t)
        vh_scale = 1.0 / (1.0 - b2**t)

        def upd(p, m_, v_):
            u = (m_ * mh_scale) / (torch.sqrt(v_ * vh_scale) + eps)
            pf = p.to(torch.float32)
            return (pf - lr * (u + weight_decay * pf)).to(p.dtype)

        new_params = tree_map(upd, params, m, v)
        return new_params, {"m": m, "v": v}

    return Optimizer(init, update)
