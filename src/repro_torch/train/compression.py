"""Gradient compression: int8 quantization with error feedback (EF-SGD);
port of `repro.train.compression`.

Each leaf is quantized to int8 with one scale, dequantized, and the
residual is carried to the next step's gradient, which keeps the
transform unbiased in the long run.  The scale stays a 0-dim tensor on the
gradient's device and every division is by such a tensor: CUDA divides by
a host scalar as a multiply by its reciprocal, which would move
``round()`` at half steps.  ``torch.round`` rounds half to even, like
``jnp.round``.  Under a plan each rank holds its parts of the gradients
and of the error; a leaf's scale is then the max over its shards (an
all-reduce over the axes the leaf is sharded over), so every rank
quantises as the single device does.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.parallel import collectives as col
from repro_torch.tree import tree_map


def _quantize_leaf(g: torch.Tensor, groups=()):
    top = torch.tensor(127.0, dtype=torch.float32, device=g.device)
    amax = col.all_reduce_max(torch.max(torch.abs(g)), groups)
    scale = torch.clamp(amax, min=1e-12) / top
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_grads_int8_ef(grads: Any, error: Any | None, shardings=None):
    """Returns (compressed-dequantized grads, new error accumulator).
    ``shardings``: the leaves' shardings under a plan, whose scales are
    then taken over every shard."""
    if error is None:
        error = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                         grads)
    if shardings is None:
        shardings = tree_map(lambda g: None, grads)

    def leaf(g, e, sh):
        corrected = g.to(torch.float32) + e
        groups = () if sh is None else col.axis_groups(
            sh.mesh, [a for a in sh.mesh.mesh_dim_names
                      if a in col.sharded_over(sh)])
        q, scale = _quantize_leaf(corrected, groups)
        deq = q.to(torch.float32) * scale
        return deq, corrected - deq

    pairs = tree_map(leaf, grads, error, shardings)  # (deq, error) pairs
    return tree_map(lambda t: t[0], pairs), tree_map(lambda t: t[1], pairs)
