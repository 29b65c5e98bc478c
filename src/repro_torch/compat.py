"""Weights carried across from the JAX reference.

`tree_from_reference` turns a reference parameter, BN-state or deploy
tree (nested dicts of numpy arrays, e.g. ``jax.tree.map(np.asarray,
tree)``) into the port's tree of tensors on ``device``:

* a 4-D conv weight ``w`` goes from HWIO to OIHW, so a depthwise
  ``(3, 3, 1, C)`` becomes ``(C, 1, 3, 3)``;
* everything else keeps its layout: the P²M ``theta`` (k, k, C, Co) and
  flat deploy ``w`` (k·k·C, Co) in (kh, kw, C)-fastest order, ``fc``,
  and every BN vector, and every leaf of an LM's parameter or
  decode-state tree (`repro.models.rwkv6.init_rwkv`, `init_rwkv_state`),
  since ``x @ W`` is ``x @ W`` in both frameworks (the 4-D ``lora_b`` is
  no ``w``).

`train_state_from_reference` carries a whole train state across, a VWW
one or an LM one: ``params``, ``bn`` where present (VWW), the optimizer
state (``mu``, or ``m`` and ``v``, which mirror the parameters and so
take the same layouts), ``extras`` where present (``ef_error``) and
``step`` (a host int).
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


def train_state_from_reference(state: dict, *, device) -> dict:
    """Reference train state (numpy leaves, the structure of
    `repro.train.vision.vww_train_state` or `repro.train.state.TrainState`)
    → the port's, tensors on ``device``."""
    out = {key: tree_from_reference(state[key], device=device)
           for key in ("params", "bn", "opt") if key in state}
    out["step"] = int(np.asarray(state["step"]))
    if "extras" in state:
        out["extras"] = tree_from_reference(state["extras"], device=device)
    return out
