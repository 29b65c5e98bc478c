"""Mixed-precision policy; port of `repro.common.precision` with torch
dtypes.

Parameters are stored fp32 (master copy in the optimizer), cast to a
compute dtype (bf16) on entry to the forward pass, and reductions (norm
statistics, softmax, losses, ADC accumulation) are kept fp32.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    reduce_dtype: torch.dtype = torch.float32

    def cast_params(self, tree: Any) -> Any:
        return cast_floating(tree, self.compute_dtype)

    def cast_output(self, tree: Any) -> Any:
        return cast_floating(tree, self.param_dtype)


DEFAULT_POLICY = Policy()
FP32_POLICY = Policy(compute_dtype=torch.float32)


def cast_floating(tree: Any, dtype: torch.dtype) -> Any:
    """Cast floating-point leaves to ``dtype``; leave ints and bools alone."""

    def _cast(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x

    return tree_map(_cast, tree)
