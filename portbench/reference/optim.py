"""SGD with momentum (the P²M recipe) and AdamW with a global-norm clip
under a cosine warm-up (the LM recipe), plainly, over lists of tensors."""
from __future__ import annotations

import math

import numpy as np
import torch


def cosine_warmup(opt: dict, step: int) -> float:
    """The learning rate at ``step``: linear from 0 over ``warmup`` steps,
    then a cosine from ``lr`` down to ``floor·lr`` at ``total``, in
    float32."""
    f = np.float32
    lr, warm, total = f(opt["lr"]), opt["warmup"], opt["total"]
    floor = opt.get("floor", 0.1)
    s = f(step)
    if s < warm:
        return float(lr * min(s / f(max(warm, 1)), f(1.0)))
    frac = np.clip((s - f(warm)) / f(max(total - warm, 1)), f(0), f(1))
    return float(f(lr * (f(floor) + f((1 - floor) * 0.5)
                         * (f(1) + np.cos(f(math.pi) * frac)))))


@torch.no_grad()
def sgd_step(params, grads, mom, opt: dict, step: int) -> None:
    """m ← μ·m + g;  p ← p − lr·(m + wd·p)."""
    lr = float(np.float32(opt["lr"]))
    wd = opt.get("weight_decay", 0.0)
    for p, g, m in zip(params, grads, mom):
        m.mul_(opt["momentum"]).add_(g)
        p.sub_((m + wd * p) * lr)


@torch.no_grad()
def adamw_step(params, grads, m, v, opt: dict, step: int) -> None:
    """Clip the gradients to a global norm of ``clip_norm``, then AdamW
    with bias correction at t = step + 1 and decoupled weight decay."""
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    scale = torch.clamp(opt["clip_norm"] / torch.clamp(norm, min=1e-12),
                        max=1.0)
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    t = float(step) + 1.0
    lr = cosine_warmup(opt, step)
    for p, g, mi, vi in zip(params, grads, m, v):
        g = g * scale
        mi.mul_(b1).add_((1 - b1) * g)
        vi.mul_(b2).add_((1 - b2) * g * g)
        upd = (mi / (1 - b1**t)) / (torch.sqrt(vi / (1 - b2**t)) + eps)
        p.sub_(lr * (upd + wd * p))
