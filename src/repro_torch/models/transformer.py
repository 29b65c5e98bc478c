"""Decoder-only LM, the dense family (llama, qwen, stablelm); port of
`repro.models.transformer`.

Parameters stay stacked with a leading ``n_layers`` axis; `forward`
unbinds them once and runs the layers in a Python loop (the reference's
``lax.scan``), each under `torch.utils.checkpoint` when ``cfg.remat``
and grad mode is on.  `decode_step` runs one token a slot against the
stacked KV cache (`layers.cached_attention`) and returns a new cache;
the cache it is given is not written.  The MoE branch comes with
`models/moe.py`.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.init_utils import KeyGen, split_tree
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    attention_block,
    cached_attention,
    embed_tokens,
    init_attention,
    init_embedding,
    init_kv_cache,
    init_mlp,
    init_norm,
    lm_head,
)
from repro_torch.tree import tree_map


_NO_MOE = ("family 'moe' is not ported yet: the port's transformer has "
           "the dense MLP only")


def init_lm(generator: torch.Generator, cfg: ModelConfig) -> tuple[dict, dict]:
    """(params, axes), drawn from ``generator`` on its own device."""
    if cfg.family == "moe":
        raise NotImplementedError(_NO_MOE)
    kg = KeyGen(generator)
    dev = kg.device
    L = (cfg.n_layers,)
    layers = {
        "attn_norm": init_norm(cfg, L, device=dev),
        "attn": init_attention(kg, cfg, L),
        "mlp_norm": init_norm(cfg, L, device=dev),
        "mlp": init_mlp(kg, cfg, L),
    }
    tree = {"embed": init_embedding(kg, cfg), "layers": layers}
    return split_tree(tree)


def _ffn(lp: dict, h):
    if "moe" in lp:
        raise NotImplementedError(_NO_MOE)
    return apply_mlp(lp["mlp"], h)


def _layer(x, lp, positions, cfg: ModelConfig, *, impl: str):
    h = apply_norm(lp["attn_norm"], x, cfg)
    x = x + attention_block(lp["attn"], h, positions, cfg,
                            window=cfg.sliding_window, impl=impl)
    h = apply_norm(lp["mlp_norm"], x, cfg)
    return x + _ffn(lp, h)


def _per_layer(params: dict, n_layers: int) -> list[dict]:
    """The stacked layer tree as one tree a layer (one unbind a leaf)."""
    per_leaf = tree_map(lambda a: a.unbind(0), params["layers"])
    return [tree_map(lambda a: a[i], per_leaf) for i in range(n_layers)]


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            positions: torch.Tensor | None = None, *, impl: str = "flash"):
    """tokens: (B, S) → (logits (B, S, V) fp32, aux_loss scalar 0)."""
    b, s = tokens.shape
    device = params["embed"]["table"].device
    if positions is None:
        positions = torch.arange(s, device=device)[None, :].expand(b, s)
    x = embed_tokens(params["embed"], tokens, cfg)
    layer_fn = functools.partial(_layer, positions=positions, cfg=cfg,
                                 impl=impl)
    if cfg.remat and torch.is_grad_enabled():
        # the layer draws no random numbers: no RNG state to keep
        layer_fn = functools.partial(checkpoint, layer_fn, use_reentrant=False,
                                     preserve_rng_state=False)
    for lp in _per_layer(params, cfg.n_layers):
        x = layer_fn(x, lp)
    aux = torch.zeros((), dtype=torch.float32, device=device)
    return lm_head(params["embed"], x, cfg), aux


# ------------------------------------------------------------------ decode


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, abstract=False,
               device=None):
    """Zero KV cache, (cache, axes): ``k`` and ``v`` of (L, B, T, K, hd)."""
    cache = init_kv_cache(cfg, batch, max_len, cfg.n_layers,
                          abstract=abstract, window=cfg.sliding_window,
                          device=device)
    return split_tree(cache)


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                pos: torch.Tensor, cfg: ModelConfig):
    """One-token decode.  tokens: (B, 1); pos: (B,) absolute positions.

    Returns (logits (B, 1, V), new_cache); ``cache`` is not written.
    """
    x = embed_tokens(params["embed"], tokens, cfg)
    new_k, new_v = [], []
    for i, lp in enumerate(_per_layer(params, cfg.n_layers)):
        h = apply_norm(lp["attn_norm"], x, cfg)
        att, nk, nv = cached_attention(lp["attn"], h, cache["k"][i],
                                       cache["v"][i], pos, cfg,
                                       window=cfg.sliding_window)
        x = x + att
        h = apply_norm(lp["mlp_norm"], x, cfg)
        x = x + _ffn(lp, h)
        new_k.append(nk)
        new_v.append(nv)
    new_cache = {"k": torch.stack(new_k), "v": torch.stack(new_v)}
    return lm_head(params["embed"], x, cfg), new_cache
