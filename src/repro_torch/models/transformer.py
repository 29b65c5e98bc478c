"""Decoder-only LM: the dense (llama, qwen, stablelm) and MoE (qwen3-moe,
mixtral) families; port of `repro.models.transformer`.

Parameters stay stacked with a leading ``n_layers`` axis; `forward`
unbinds them once and runs the layers in a Python loop (the reference's
``lax.scan``), each under `torch.utils.checkpoint` when ``cfg.remat``
and grad mode is on.  `decode_step` runs one token a slot against the
stacked KV cache (`layers.cached_attention`) and returns a new cache;
the cache it is given is not written.  A MoE layer's FFN is
`models/moe.py::apply_moe`; `forward` sums its aux losses over the
layers, in layer order, and `decode_step` discards them.
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
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.tree import tree_unstack


def init_lm(generator: torch.Generator, cfg: ModelConfig) -> tuple[dict, dict]:
    """(params, axes), drawn from ``generator`` on its own device."""
    kg = KeyGen(generator)
    dev = kg.device
    L = (cfg.n_layers,)
    layers = {
        "attn_norm": init_norm(cfg, L, device=dev),
        "attn": init_attention(kg, cfg, L),
        "mlp_norm": init_norm(cfg, L, device=dev),
    }
    if cfg.family == "moe":
        layers["moe"] = init_moe(kg, cfg, L)
    else:
        layers["mlp"] = init_mlp(kg, cfg, L)
    tree = {"embed": init_embedding(kg, cfg), "layers": layers}
    return split_tree(tree)


def _layer(x, lp, positions, cfg: ModelConfig, *, impl: str):
    """One layer: (x, aux loss), the aux a float32 0 for the dense MLP."""
    h = apply_norm(lp["attn_norm"], x, cfg)
    x = x + attention_block(lp["attn"], h, positions, cfg,
                            window=cfg.sliding_window, impl=impl)
    h = apply_norm(lp["mlp_norm"], x, cfg)
    if "moe" in lp:
        y, aux = apply_moe(lp["moe"], h, cfg)
    else:
        y = apply_mlp(lp["mlp"], h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            positions: torch.Tensor | None = None, *, impl: str = "flash"):
    """tokens: (B, S) → (logits (B, S, V) fp32, aux_loss scalar)."""
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
    aux = torch.zeros((), dtype=torch.float32, device=device)
    for lp in tree_unstack(params["layers"], cfg.n_layers):
        x, a = layer_fn(x, lp)
        aux = aux + a
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
    for i, lp in enumerate(tree_unstack(params["layers"], cfg.n_layers)):
        h = apply_norm(lp["attn_norm"], x, cfg)
        att, nk, nv = cached_attention(lp["attn"], h, cache["k"][i],
                                       cache["v"][i], pos, cfg,
                                       window=cfg.sliding_window)
        x = x + att
        h = apply_norm(lp["mlp_norm"], x, cfg)
        if "moe" in lp:
            y, _ = apply_moe(lp["moe"], h, cfg)
        else:
            y = apply_mlp(lp["mlp"], h)
        x = x + y
        new_k.append(nk)
        new_v.append(nv)
    new_cache = {"k": torch.stack(new_k), "v": torch.stack(new_v)}
    return lm_head(params["embed"], x, cfg), new_cache
