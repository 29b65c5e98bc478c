"""Train-step builder: loss → grad → (optional compression) → optimizer;
port of `repro.train.step`.

The step updates the state it is given in place (the reference donates
it to a jitted step): the parameters and the optimizer state through
``optimizer.update_in_place``, ``step`` and ``extras`` by assignment.
It returns that state and the metrics, 0-dim tensors.  A batch comes
placed, as tensors on the parameters' device (`DataPipeline` places
them with ``device=``), as the reference's step takes placed arrays.
Gradients come
from `torch.autograd.grad` over detached copies of the parameter leaves,
as in `train/vision.py`.  Gradient accumulation sums the micro-batch
gradients from zeros in the reference's order, then divides.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.families import get_family
from repro_torch.optim.optimizers import Optimizer
from repro_torch.train.compression import compress_grads_int8_ef
from repro_torch.train.vision import _check_compression
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def make_train_step(
    cfg: ModelConfig,
    optimizer: Optimizer,
    *,
    accum_steps: int = 1,
    grad_compression: str | None = None,  # None | "int8_ef"
) -> Callable:
    family = get_family(cfg)
    _check_compression(grad_compression)

    def value_and_grad(params, batch):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        loss, metrics = family.loss(tree_unflatten(params, live), batch, cfg)
        grads = torch.autograd.grad(loss, live)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_unflatten(params, list(grads)))

    def train_step(state: dict, batch: dict):
        params = state["params"]
        if accum_steps == 1:
            loss, metrics, grads = value_and_grad(params, batch)
        else:
            micro_batches = {
                k: x.reshape((accum_steps, x.shape[0] // accum_steps)
                             + x.shape[1:]) for k, x in batch.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = 0.0
            for i in range(accum_steps):
                mb = {k: x[i] for k, x in micro_batches.items()}
                l, _, g = value_and_grad(params, mb)
                grads = tree_map(torch.add, grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / accum_steps, grads)
            loss = loss / accum_steps
            metrics = {}

        extras = dict(state.get("extras", {}))
        if grad_compression == "int8_ef":
            grads, extras["ef_error"] = compress_grads_int8_ef(
                grads, extras.get("ef_error"))
        optimizer.update_in_place(grads, state["opt"], params, state["step"])
        del grads
        state["step"] = state["step"] + 1
        if extras:
            state["extras"] = extras
        metrics = dict(metrics)
        metrics["loss"] = loss
        return state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig) -> Callable:
    family = get_family(cfg)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = family.loss(params, batch, cfg)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return metrics

    return eval_step
