"""Training step for the paper's VWW pipeline (MobileNetV2 ± P²M stem);
port of `repro.train.vision` (single device).

BN running statistics ride in the train state (the paper trains with
standard BN and SGD with momentum, §5.1).  The step is a plain function
``(state, batch) -> (state, {"loss", "acc"})``: gradients come from
`torch.autograd.grad` over the parameter leaves, the optimizer is
functional (`repro_torch.optim`), and ``state["step"]`` is a host int.
The step runs where the state's tensors live; the P²M stem's conv is the
device's own (`core.p2m_conv._resolve_impl`): on the card the CUDA
forward kernel and the closed-form backward kernels.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.pixel_model import PixelModel
from repro_torch.models.mobilenetv2 import MNV2Config, apply_mnv2
from repro_torch.optim.optimizers import Optimizer
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


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lse = torch.logsumexp(logits, dim=-1)
    true = torch.gather(logits, -1, labels[:, None])[:, 0]
    return (lse - true).mean()


def _batch_to(batch: dict, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(images, labels int64) of a numpy or tensor batch on ``device``;
    the images keep their floating type, as the reference's do."""
    return (torch.as_tensor(batch["images"]).to(device),
            torch.as_tensor(batch["labels"]).to(device, torch.long))


def vww_value_and_grad(params: dict, bn: dict, batch: dict, cfg: MNV2Config,
                       pixel_model: PixelModel | None = None):
    """One forward and backward of the train-mode model on ``batch``
    (numpy or tensors; moved to the parameters' device).  Returns (loss,
    accuracy, gradient tree, new BN state), the first two as 0-dim
    tensors."""
    leaves = tree_leaves(params)
    images, labels = _batch_to(batch, leaves[0].device)
    live = [p.detach().requires_grad_(True) for p in leaves]
    logits, new_bn = apply_mnv2(tree_unflatten(params, live), bn, images,
                                cfg, pixel_model, train=True)
    loss = softmax_ce(logits, labels)
    grads = torch.autograd.grad(loss, live)
    acc = (logits.detach().argmax(-1) == labels).to(torch.float32).mean()
    return (loss.detach(), acc, tree_unflatten(params, grads),
            tree_map(torch.Tensor.detach, new_bn))


def make_vww_train_step(cfg: MNV2Config, optimizer: Optimizer,
                        pixel_model: PixelModel | None = None,
                        *, grad_compression: str | None = None) -> Callable:
    """Build the VWW train step.

    grad_compression: None | "int8_ef" — int8 quantization with error
    feedback on the gradients; the accumulator rides in
    ``state["extras"]["ef_error"]``.
    """
    _check_compression(grad_compression)

    def step(state: dict, batch: dict):
        loss, acc, grads, new_bn = vww_value_and_grad(
            state["params"], state["bn"], batch, cfg, pixel_model)
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
