"""Uniform API over model families — the surface the serving loop programs
against; port of `repro.models.families` for the families the port has.

Every family exposes:
  init(generator, cfg)                          → (params, logical_axes)
  loss(params, batch, cfg)                      → (scalar loss, metrics dict)
  init_decode_state(cfg, B, T, abstract, device) → (state, logical_axes)
  decode(params, state, tokens, pos, cfg)       → (logits, new_state)
  batch_keys                                    → input names the family consumes
  prefill (optional)                            → fused multi-token prefill

Families the reference has and the port does not yet raise "not ported
yet".
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.models import rwkv6
from repro_torch.models.config import ModelConfig


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token CE.  logits (B,S,V) fp32; targets (B,S) int."""
    lse = torch.logsumexp(logits, dim=-1)
    true = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = lse - true
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def _accuracy(logits, targets):
    # argmax takes the first index at ties, as jnp.argmax does
    return (logits.argmax(-1) == targets).to(logits.dtype).mean()


def _rwkv_loss(params, batch, cfg: ModelConfig):
    logits, aux, _ = rwkv6.forward(params, batch["tokens"], cfg)
    ce = cross_entropy(logits, batch["targets"])
    return ce + aux, {"ce": ce, "aux": aux,
                      "acc": _accuracy(logits.detach(), batch["targets"])}


def _rwkv_decode_state(cfg, batch, max_len, abstract=False, device=None):
    return rwkv6.init_rwkv_state(cfg, batch, abstract=abstract, device=device)


@dataclasses.dataclass(frozen=True)
class Family:
    init: Callable
    loss: Callable
    decode: Callable
    init_decode_state: Callable
    batch_keys: tuple[str, ...]
    # Optional fused multi-token prefill, (params, state, tokens (B,C),
    # lengths (B,), cfg) → (last_logits (B,V), new_state): advance row b
    # by lengths[b] ∈ [0, C] tokens in one forward, rows at 0 keeping
    # their state bit for bit.  Only valid for positionless recurrent
    # families (the hook takes no positions); serving's chunked prefill
    # prefers it over the masked decode-step scan when present.
    prefill: Callable | None = None


FAMILIES: dict[str, Family] = {
    "rwkv": Family(rwkv6.init_rwkv, _rwkv_loss, rwkv6.decode_step,
                   _rwkv_decode_state, ("tokens", "targets"),
                   prefill=rwkv6.prefill_step),
}
#: The reference's other families, still to port.
NOT_PORTED = ("dense", "moe", "rglru", "vlm", "encdec")


def get_family(cfg: ModelConfig) -> Family:
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet; "
                                  f"the port has {sorted(FAMILIES)}")
    return FAMILIES[cfg.family]


def _leaves_with_path(tree, path=""):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves_with_path(value, f"{path}[{key!r}]")
    else:
        yield path, tree


@functools.lru_cache(maxsize=None)
def validate_slot_layout(cfg: ModelConfig) -> None:
    """Serving's slot table assumes **batch at axis 1** of every
    decode-state leaf (`ServeEngine._reset_slot` zeroes ``a[:, i]``).
    Check that against the family's *declared* state layout (the axes
    tree of ``init_decode_state(..., abstract=True)``) and fail loudly on
    a mismatch."""
    family = get_family(cfg)
    _, axes = family.init_decode_state(cfg, 1, 8, abstract=True)
    bad = [(path, ax) for path, ax in _leaves_with_path(axes)
           if not isinstance(ax, tuple) or len(ax) < 2
           or ax[1] != "cache_batch"]
    if bad:
        detail = ", ".join(f"{p} declares axes {ax}" for p, ax in bad)
        raise ValueError(
            f"family {cfg.family!r} decode state is incompatible with the "
            f"slot engines: every leaf must declare 'cache_batch' at axis "
            f"1, but {detail}. Serving this family needs a state-layout "
            f"adapter, not a silent axis-1 select.")
