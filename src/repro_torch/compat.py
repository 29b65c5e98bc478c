"""Weights carried across from the JAX reference.

`tree_from_reference` turns a reference parameter, BN-state or deploy
tree (nested dicts of numpy arrays, e.g. ``jax.tree.map(np.asarray,
tree)``) into the port's tree of tensors on ``device``:

* a 4-D conv weight ``w`` goes from HWIO to OIHW, so a depthwise
  ``(3, 3, 1, C)`` becomes ``(C, 1, 3, 3)``;
* everything else keeps its layout: the P²M ``theta`` (k, k, C, Co) and
  flat deploy ``w`` (k·k·C, Co) in (kh, kw, C)-fastest order, ``fc``,
  and every BN vector.
"""
from __future__ import annotations

import numpy as np
import torch


def tree_from_reference(tree, *, device):
    """Reference tree (numpy leaves) → port tree (tensors on ``device``)."""
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            if key == "w" and np.ndim(value) == 4:
                out[key] = torch.from_numpy(
                    np.ascontiguousarray(np.transpose(value, (3, 2, 0, 1)))
                ).to(device)
            else:
                out[key] = tree_from_reference(value, device=device)
        return out
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)
