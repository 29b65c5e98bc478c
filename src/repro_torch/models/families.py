"""Uniform API over model families — the surface the serving loop programs
against; port of `repro.models.families` for the families the port has.

Every family exposes:
  init(generator, cfg)                          → (params, logical_axes)
  loss(params, batch, cfg)                      → (scalar loss, metrics dict)
  init_decode_state(cfg, B, T, abstract, device) → (state, logical_axes)
  decode(params, state, tokens, pos, cfg)       → (logits, new_state)
  batch_keys                                    → input names the family consumes
  prefill (optional)                            → fused multi-token prefill

Every family of the reference is here; `get_family` of another raises
``KeyError``, as the reference's ``FAMILIES[cfg.family]``.

Under a plan (`parallel.use_plan`) ``loss`` runs on this rank's part of
the batch and of the params and returns the rank's *share* of the
global loss: the cross-entropy summed over its tokens over the global
token count, plus its aux over the number of batch ranks, so the shares
summed over the batch axes are the global loss and their gradients the
global gradient (`train/step.py` sums them so).  The cross-entropy is
vocab-parallel where the logits are the rank's vocab columns, and the
accuracy takes the argmax across the shards.  The metrics are global.
Every family runs tensor- and fully-sharded (the MoE family
expert-parallel too) under any plan `plan_for` makes.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.models import rglru, rwkv6, transformer, vlm, whisper
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import vocab_range
from repro_torch.parallel import collectives as col
from repro_torch.parallel.axes import current_plan
from repro_torch.parallel.sharding_utils import param_shardings


def _nll(logits, targets, vocab=(0, ())):
    start, groups = vocab
    if groups:
        return col.vocab_parallel_nll(logits, targets, start, groups)
    lse = torch.logsumexp(logits, dim=-1)
    return lse - torch.gather(logits, -1, targets[..., None].long())[..., 0]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token CE.  logits (B,S,V) fp32; targets (B,S) int."""
    nll = _nll(logits, targets)
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def _accuracy(logits, targets):
    # argmax takes the first index at ties, as jnp.argmax does
    return (logits.argmax(-1) == targets).to(logits.dtype).mean()


def _embed_vocab(cfg: ModelConfig, sh) -> tuple[int, tuple]:
    return vocab_range(cfg, sh["embed"])


def _loss(logits, aux, batch, cfg: ModelConfig, vocab=_embed_vocab):
    """(loss, metrics) of logits and aux; under a plan the rank's share and
    the global metrics (module docstring).  ``vocab(cfg, shardings)``:
    the (first column, groups) of the rank's logits."""
    targets = batch["targets"]
    plan = current_plan()
    if plan is None:
        ce = cross_entropy(logits, targets)
        return ce + aux, {"ce": ce, "aux": aux,
                          "acc": _accuracy(logits.detach(), targets)}
    vocab = vocab(cfg, param_shardings(cfg, plan))
    groups = col.axis_groups(plan.mesh, col.batch_axes(plan))
    n_ranks = col.group_size(groups)
    n = targets.numel() * n_ranks
    ce = _nll(logits, targets, vocab).sum() / n
    aux = aux / n_ranks
    start, vgroups = vocab
    right = (col.vocab_parallel_argmax(logits, start, vgroups) if vgroups
             else logits.detach().argmax(-1)) == targets
    sums = col.all_reduce_sum(torch.stack([
        ce.detach(), aux.detach(), right.sum().to(torch.float32)]), groups)
    return ce + aux, {"ce": sums[0], "aux": sums[1], "acc": sums[2] / n}


def _lm_loss(params, batch, cfg: ModelConfig):
    logits, aux = transformer.forward(params, batch["tokens"], cfg)
    return _loss(logits, aux, batch, cfg)


def _rwkv_loss(params, batch, cfg: ModelConfig):
    logits, aux, _ = rwkv6.forward(params, batch["tokens"], cfg)
    return _loss(logits, aux, batch, cfg)


def _rglru_loss(params, batch, cfg: ModelConfig):
    logits, aux = rglru.forward(params, batch["tokens"], cfg)
    return _loss(logits, aux, batch, cfg)


def _vlm_loss(params, batch, cfg: ModelConfig):
    logits, aux = vlm.forward(params, batch["tokens"], batch["image_embeds"],
                              cfg)
    return _loss(logits, aux, batch, cfg)


def _encdec_loss(params, batch, cfg: ModelConfig):
    logits, aux = whisper.forward(params, batch["src_embeds"],
                                  batch["tokens"], cfg)
    return _loss(logits, aux, batch, cfg, whisper.vocab_range)


def _lm_decode_state(cfg, batch, max_len, abstract=False, device=None):
    return transformer.init_cache(cfg, batch, max_len, abstract=abstract,
                                  device=device)


def _rwkv_decode_state(cfg, batch, max_len, abstract=False, device=None):
    return rwkv6.init_rwkv_state(cfg, batch, abstract=abstract, device=device)


def _rglru_decode_state(cfg, batch, max_len, abstract=False, device=None):
    return rglru.init_rglru_state(cfg, batch, max_len, abstract=abstract,
                                  device=device)


def _vlm_decode_state(cfg, batch, max_len, abstract=False, device=None):
    return vlm.init_vlm_cache(cfg, batch, max_len, abstract=abstract,
                              device=device)


def _encdec_decode_state(cfg, batch, max_len, abstract=False, device=None):
    return whisper.init_whisper_cache(cfg, batch, max_len, abstract=abstract,
                                      device=device)


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


_DECODER = Family(transformer.init_lm, _lm_loss, transformer.decode_step,
                  _lm_decode_state, ("tokens", "targets"))
FAMILIES: dict[str, Family] = {
    "dense": _DECODER,
    "moe": _DECODER,  # the same transformer, a MoE FFN a layer
    "rwkv": Family(rwkv6.init_rwkv, _rwkv_loss, rwkv6.decode_step,
                   _rwkv_decode_state, ("tokens", "targets"),
                   prefill=rwkv6.prefill_step),
    "rglru": Family(rglru.init_rglru, _rglru_loss, rglru.decode_step,
                    _rglru_decode_state, ("tokens", "targets")),
    "vlm": Family(vlm.init_vlm, _vlm_loss, vlm.decode_step,
                  _vlm_decode_state, ("tokens", "targets", "image_embeds")),
    "encdec": Family(whisper.init_whisper, _encdec_loss, whisper.decode_step,
                     _encdec_decode_state,
                     ("tokens", "targets", "src_embeds")),
}


def get_family(cfg: ModelConfig) -> Family:
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
    decode-state leaf (`ServeEngine._reset_slot` zeroes ``a[:, i]``, the
    masked decode scan's ``keep`` select masks axis 1; the KV cache is
    (L, B, T, K, hd)).
    Check that against the family's *declared* state layout (the axes
    tree of ``init_decode_state(..., abstract=True)``) and fail loudly on
    a mismatch: rglru's grouped ``rec_conv``/``rec_h`` leaves carry batch
    at axis 2, which the slot engines would silently corrupt."""
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
