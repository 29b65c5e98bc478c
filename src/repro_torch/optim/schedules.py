"""LR schedules; port of `repro.optim.schedules`.  ``step_decay`` is the
paper's recipe (×0.2 at epoch 35 and every 45 thereafter, expressed in
steps by the caller).

The step is a host int and each schedule returns a float, computed in
float32 as the reference computes it.
"""
from __future__ import annotations

import numpy as np


def constant(lr: float):
    return lambda step: float(np.float32(lr))


def step_decay(base_lr: float, boundaries: tuple[int, ...],
               factor: float = 0.2):
    """Paper §5.1: the LR decays by ``factor`` at each boundary step."""

    def fn(step):
        lr = np.float32(base_lr)
        for b in boundaries:
            if step >= b:
                lr = np.float32(lr * np.float32(factor))
        return float(lr)

    return fn


def cosine_warmup(base_lr: float, warmup: int, total: int, floor: float = 0.1):
    f32 = np.float32

    def fn(step):
        step = f32(step)
        if step < warmup:
            return float(f32(base_lr) * min(step / f32(max(warmup, 1)),
                                            f32(1.0)))
        frac = np.clip((step - f32(warmup)) / f32(max(total - warmup, 1)),
                       f32(0.0), f32(1.0))
        cos = f32(base_lr) * (f32(floor) + f32((1 - floor) * 0.5)
                              * (f32(1) + np.cos(f32(np.pi) * frac)))
        return float(f32(cos))

    return fn
