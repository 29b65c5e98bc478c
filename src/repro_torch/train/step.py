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

Under a plan (`parallel.use_plan`) every rank runs the step on its parts
of the state (`shardings_for(state, state_logical_axes(...), plan)`,
`sharding_utils.local_tree`) and of the batch (split over the batch
axes), as the reference's sharded jit does.  The loss is the rank's
share (`models/families.py`); the gradient rule: each leaf's gradient is
summed over exactly the batch axes the leaf is *not* sharded over (an
FSDP leaf's gather already reduce-scattered it over the axes it is
sharded over), and over nothing else: the model axis's *f*/*g* pairs
give a leaf replicated over it the same whole gradient on every model
rank.  The clip's global norm and ``int8_ef``'s scales are then taken
over every shard, the reported loss is the shares' sum over the batch
axes, and the update runs leaf by leaf on the rank's parts.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.families import get_family
from repro_torch.optim.optimizers import Optimizer, global_norm
from repro_torch.parallel import collectives as col
from repro_torch.parallel.axes import current_plan
from repro_torch.parallel.sharding_utils import param_shardings
from repro_torch.train.compression import compress_grads_int8_ef
from repro_torch.train.vision import _check_compression
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def reduce_gradients(grads, shardings, plan):
    """The gradient rule under ``plan``: each leaf summed over the batch
    axes its sharding does not split (one flat all-reduce a set of
    axes), and over nothing else."""
    batch = col.batch_axes(plan)
    axes = tree_leaves(tree_map(
        lambda g, sh: tuple(a for a in batch
                            if a not in col.sharded_over(sh)),
        grads, shardings))
    out = tree_leaves(grads)
    buckets: dict[tuple, list[int]] = {}
    for i, a in enumerate(axes):
        if a:
            buckets.setdefault(a, []).append(i)
    for a, idx in buckets.items():
        summed = col.all_reduce_tree({str(i): out[i] for i in idx},
                                     col.axis_groups(plan.mesh, a))
        for i in idx:
            out[i] = summed[str(i)]
    return tree_unflatten(grads, out)


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
        plan = current_plan()
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

        sh = grad_norm = None
        if plan is not None:
            sh = param_shardings(cfg, plan)
            grads = reduce_gradients(grads, sh, plan)
            loss = col.all_reduce_sum(loss, col.axis_groups(
                plan.mesh, col.batch_axes(plan)))
        extras = dict(state.get("extras", {}))
        if grad_compression == "int8_ef":
            grads, extras["ef_error"] = compress_grads_int8_ef(
                grads, extras.get("ef_error"), sh)
        if plan is not None:
            grad_norm = global_norm(grads, sh)
        optimizer.update_in_place(grads, state["opt"], params, state["step"],
                                  grad_norm=grad_norm)
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
        plan = current_plan()
        if plan is not None:  # the shares' sum: the global loss
            loss = col.all_reduce_sum(loss, col.axis_groups(
                plan.mesh, col.batch_axes(plan)))
        metrics = dict(metrics)
        metrics["loss"] = loss
        return metrics

    return eval_step
