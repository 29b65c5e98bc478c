"""Functional optimizers and LR schedules; port of `repro.optim`."""
from repro_torch.optim.optimizers import (
    Optimizer,
    adamw,
    clip_by_global_norm,
    global_norm,
    sgd,
)
from repro_torch.optim.schedules import constant, cosine_warmup, step_decay

__all__ = ["Optimizer", "adamw", "clip_by_global_norm", "global_norm", "sgd",
           "constant", "cosine_warmup", "step_decay"]
