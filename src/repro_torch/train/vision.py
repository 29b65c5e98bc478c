"""Training step for the paper's VWW pipeline (MobileNetV2 ± P²M stem);
port of `repro.train.vision`.

BN running statistics ride in the train state (the paper trains with
standard BN and SGD with momentum, §5.1).  The step is a plain function
``(state, batch) -> (state, {"loss", "acc"})``: gradients come from
`torch.autograd.grad` over the parameter leaves, the optimizer is
functional (`repro_torch.optim`), and ``state["step"]`` is a host int.
The step runs where the state's tensors live; the P²M stem's conv is the
device's own (`core.p2m_conv._resolve_impl`): on the card the CUDA
forward kernel and the closed-form backward kernels.

Scale-out (DESIGN.md §7): under a data-parallel plan (`parallel.use_plan`
with `parallel.vision_plan_for`) every rank runs the step on its slice of
the global batch (`vww_train_shardings`, `parallel.sharding_utils.
local_tree`) with the state replicated.  Every reduction the reference
leaves to XLA's SPMD partitioner is a collective over the plan's batch
axes (`parallel.collectives`): the BN batch statistics of the backbone
and the P²M stem (a differentiable all-reduce, so the backward sees them
too), the cross-entropy mean and the accuracy over the global batch, and
the gradient, summed to the global batch's *before* int8 error-feedback
compression, so the per-tensor scales are those of the reduced gradient
and equal on every rank.  The update then runs identically on every
rank and the replicated state stays bit for bit equal across ranks.
With no plan the step is the single-device one.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.pixel_model import PixelModel
from repro_torch.models.mobilenetv2 import MNV2Config, apply_mnv2
from repro_torch.optim.optimizers import Optimizer
from repro_torch.parallel.axes import current_plan
from repro_torch.parallel.collectives import (
    all_reduce_sum,
    all_reduce_tree,
    axis_groups,
    batch_axes,
    group_size,
    reduce_batch_over,
)
from repro_torch.parallel.sharding_utils import (
    batch_shardings,
    replicated_tree,
)
from repro_torch.train.compression import compress_grads_int8_ef
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

GRAD_COMPRESSIONS = (None, "int8_ef")


def _check_compression(grad_compression: str | None) -> None:
    if grad_compression not in GRAD_COMPRESSIONS:
        raise ValueError(f"unknown grad_compression {grad_compression!r}")


def vww_train_state(params, bn, opt_state, *, step: int = 0,
                    grad_compression: str | None = None) -> dict:
    """Canonical VWW train-state dict; with compression on, the
    error-feedback accumulator starts as zeros so the state has the same
    structure at every step."""
    _check_compression(grad_compression)
    state = {"params": params, "bn": bn, "opt": opt_state, "step": int(step)}
    if grad_compression == "int8_ef":
        state["extras"] = {"ef_error": tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)}
    return state


def vww_train_shardings(state: dict, batch: dict, plan):
    """(state shardings, batch shardings) of the VWW step under a
    data-parallel plan: every state leaf replicated (the MNV2 stacks are
    small, DESIGN.md §7), dimension 0 of the batch split over the batch
    axes.  A rank's batch is `local_tree` of the global one by the
    second."""
    return replicated_tree(state, plan), batch_shardings(batch, plan)


def _ce_terms(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lse = torch.logsumexp(logits, dim=-1)
    return lse - torch.gather(logits, -1, labels[:, None])[:, 0]


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return _ce_terms(logits, labels).mean()


def _batch_to(batch: dict, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(images, labels int64) of a numpy or tensor batch on ``device``;
    the images keep their floating type, as the reference's do."""
    return (torch.as_tensor(batch["images"]).to(device),
            torch.as_tensor(batch["labels"]).to(device, torch.long))


def vww_value_and_grad(params: dict, bn: dict, batch: dict, cfg: MNV2Config,
                       pixel_model: PixelModel | None = None, *,
                       groups=None):
    """One forward and backward of the train-mode model on ``batch``
    (numpy or tensors; moved to the parameters' device).  Returns (loss,
    accuracy, gradient tree, new BN state), the first two as 0-dim
    tensors.

    ``groups``: the process groups ``batch`` is one rank's slice over
    (`parallel.collectives`); the loss, accuracy, gradient and BN
    statistics are then the global batch's, on every rank."""
    leaves = tree_leaves(params)
    images, labels = _batch_to(batch, leaves[0].device)
    live = [p.detach().requires_grad_(True) for p in leaves]
    with reduce_batch_over(groups):
        logits, new_bn = apply_mnv2(tree_unflatten(params, live), bn,
                                    images, cfg, pixel_model, train=True)
    right = (logits.detach().argmax(-1) == labels).to(torch.float32)
    if groups is None:
        loss = softmax_ce(logits, labels)
        grads = tree_unflatten(params, torch.autograd.grad(loss, live))
        loss, acc = loss.detach(), right.mean()
    else:
        # each rank's share of the global mean; its backward runs the
        # all-reduces of the BN statistics, and the gradient sums
        n = labels.shape[0] * group_size(groups)
        ce = _ce_terms(logits, labels).sum()
        grads = all_reduce_tree(tree_unflatten(
            params, torch.autograd.grad(ce / n, live)), groups)
        sums = all_reduce_sum(torch.stack([ce.detach(), right.sum()]),
                              groups)
        loss, acc = sums[0] / n, sums[1] / n
    return loss, acc, grads, tree_map(torch.Tensor.detach, new_bn)


def make_vww_train_step(cfg: MNV2Config, optimizer: Optimizer,
                        pixel_model: PixelModel | None = None,
                        *, grad_compression: str | None = None) -> Callable:
    """Build the VWW train step.

    grad_compression: None | "int8_ef" — int8 quantization with error
    feedback on the (globally reduced) gradients; the accumulator rides
    in ``state["extras"]["ef_error"]``.  Under a plan the step takes this
    rank's slice of the batch (module docstring).
    """
    _check_compression(grad_compression)

    def step(state: dict, batch: dict):
        plan = current_plan()
        groups = (None if plan is None
                  else axis_groups(plan.mesh, batch_axes(plan)))
        loss, acc, grads, new_bn = vww_value_and_grad(
            state["params"], state["bn"], batch, cfg, pixel_model,
            groups=groups)
        extras = dict(state.get("extras", {}))
        if grad_compression == "int8_ef":
            grads, extras["ef_error"] = compress_grads_int8_ef(
                grads, extras.get("ef_error"))
        new_params, new_opt = optimizer.update(grads, state["opt"],
                                               state["params"], state["step"])
        new_state = {"params": new_params, "bn": new_bn, "opt": new_opt,
                     "step": state["step"] + 1}
        if extras:
            new_state["extras"] = extras
        return new_state, {"loss": loss, "acc": acc}

    return step


def make_vww_eval(cfg: MNV2Config, pixel_model: PixelModel | None = None):
    @torch.no_grad()
    def evaluate(params, bn_state, batch, p2m_deploy=None):
        images, labels = _batch_to(batch, tree_leaves(params)[0].device)
        logits, _ = apply_mnv2(params, bn_state, images, cfg, pixel_model,
                               train=False, p2m_deploy=p2m_deploy)
        return float((logits.argmax(-1) == labels).to(torch.float32).mean())

    return evaluate
