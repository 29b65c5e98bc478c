"""Llama-3.2-Vision-style VLM backbone: a decoder LM with gated
cross-attention layers to image-patch embeddings every Nth layer; port
of `repro.models.vlm`.

The image embeddings (B, N_img, d_model) are an input: the stub of
precomputed patch embeddings (`launch/train.py` draws them), or the P²M
frontend's tokens (`core/frontend.py`).

Layer stack: groups of (period−1 self layers + 1 gated cross layer).
The self layers' params are stacked twice, (G, n_self, …), the cross
layers' once, (G, …).  `forward` runs the groups and their self layers
in a Python loop (the reference's nested ``lax.scan``), each self layer
and each cross block under `torch.utils.checkpoint` when ``cfg.remat``
and grad mode are on.  The gates ``gate_attn``/``gate_mlp`` are float32
and zero at init, as the reference's: the image path then adds
``tanh(0)·out = 0``.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import dense_attention, gqa_repeat
from repro_torch.models.config import ModelConfig
from repro_torch.models.init_utils import KeyGen, make, split_tree
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
from repro_torch.tree import tree_unstack


def _n_groups(cfg: ModelConfig) -> tuple[int, int]:
    """(groups, self layers a group)."""
    period = cfg.cross_attn_period
    if not (period > 1 and cfg.n_layers % period == 0):
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"cross_attn_period {period} > 1")
    return cfg.n_layers // period, period - 1


def init_vlm(generator: torch.Generator, cfg: ModelConfig) -> tuple[dict, dict]:
    """(params, axes), drawn from ``generator`` on its own device."""
    kg = KeyGen(generator)
    dev = kg.device
    n_groups, n_self = _n_groups(cfg)
    GS = (n_groups, n_self)
    G = (n_groups,)
    self_layers = {
        "attn_norm": init_norm(cfg, GS, ("layers", "layers"), device=dev),
        "attn": init_attention(kg, cfg, GS),
        "mlp_norm": init_norm(cfg, GS, ("layers", "layers"), device=dev),
        "mlp": init_mlp(kg, cfg, GS),
    }
    cross_layers = {
        "norm": init_norm(cfg, G, device=dev),
        "attn": init_attention(kg, cfg, G),
        "gate_attn": make(None, G, ("layers",), init="zeros", device=dev),
        "mlp_norm": init_norm(cfg, G, device=dev),
        "mlp": init_mlp(kg, cfg, G),
        "gate_mlp": make(None, G, ("layers",), init="zeros", device=dev),
    }
    tree = {
        "embed": init_embedding(kg, cfg),
        "self": self_layers,
        "cross": cross_layers,
    }
    return split_tree(tree)


def _cross_kv(p: dict, image_embeds: torch.Tensor, cfg: ModelConfig):
    """Project image embeddings to this cross layer's K/V (no RoPE)."""
    b, n, _ = image_embeds.shape
    hd = cfg.resolved_head_dim
    k = (image_embeds @ p["wk"]).reshape(b, n, cfg.n_kv_heads, hd)
    v = (image_embeds @ p["wv"]).reshape(b, n, cfg.n_kv_heads, hd)
    return k, v


def _gated(gate, y, dtype):
    """``tanh(gate)·y`` cast to ``dtype``.  The product is taken in the
    promoted dtype of both, as JAX promotes a float32 gate against a
    bfloat16 ``y`` (torch would keep bfloat16 for a 0-dim gate)."""
    t = torch.tanh(gate)
    return (t * y.to(torch.promote_types(t.dtype, y.dtype))).to(dtype)


def _cross_block(p: dict, x, image_embeds, cfg: ModelConfig,
                 kv: tuple | None = None):
    """The gated cross layer: x attends (unmasked) to the image's K/V,
    projected from ``image_embeds`` or given as ``kv``."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h = apply_norm(p["norm"], x, cfg)
    q = (h @ p["attn"]["wq"]).reshape(b, s, cfg.n_heads, hd)
    if kv is None:
        k, v = _cross_kv(p["attn"], image_embeds, cfg)
    else:
        k, v = kv
    n_img = k.shape[1]
    kr = gqa_repeat(k, cfg.n_heads)
    vr = gqa_repeat(v, cfg.n_heads)
    qpos = torch.zeros((b, s), dtype=torch.int32, device=x.device)
    kpos = torch.zeros((b, n_img), dtype=torch.int32, device=x.device)
    out = dense_attention(q, kr, vr, qpos, kpos, causal=False)
    out = out.reshape(b, s, cfg.q_dim) @ p["attn"]["wo"]
    x = x + _gated(p["gate_attn"], out, x.dtype)
    h = apply_norm(p["mlp_norm"], x, cfg)
    return x + _gated(p["gate_mlp"], apply_mlp(p["mlp"], h), x.dtype)


def _self_layer(x, lp, positions, cfg: ModelConfig):
    h = apply_norm(lp["attn_norm"], x, cfg)
    x = x + attention_block(lp["attn"], h, positions, cfg)
    h = apply_norm(lp["mlp_norm"], x, cfg)
    return x + apply_mlp(lp["mlp"], h)


def _group(x, sp, cp, image_embeds, positions, cfg: ModelConfig):
    """One group: its ``n_self`` self layers (``sp`` stacked on a leading
    axis), then its cross block ``cp``."""
    _, n_self = _n_groups(cfg)
    self_fn = functools.partial(_self_layer, positions=positions, cfg=cfg)
    cross_fn = functools.partial(_cross_block, image_embeds=image_embeds,
                                 cfg=cfg)
    if cfg.remat and torch.is_grad_enabled():
        # the layers draw no random numbers: no RNG state to keep
        self_fn = functools.partial(checkpoint, self_fn, use_reentrant=False,
                                    preserve_rng_state=False)
        cross_fn = functools.partial(checkpoint, cross_fn,
                                     use_reentrant=False,
                                     preserve_rng_state=False)
    for lp in tree_unstack(sp, n_self):
        x = self_fn(x, lp)
    return cross_fn(cp, x)


def forward(params: dict, tokens: torch.Tensor, image_embeds: torch.Tensor,
            cfg: ModelConfig, positions: torch.Tensor | None = None):
    """tokens (B, S) + image_embeds (B, N_img, d) → (logits (B, S, V)
    fp32, aux=0)."""
    b, s = tokens.shape
    device = params["embed"]["table"].device
    if positions is None:
        positions = torch.arange(s, device=device)[None, :].expand(b, s)
    x = embed_tokens(params["embed"], tokens, cfg)
    image_embeds = image_embeds.to(x.dtype)
    n_groups, _ = _n_groups(cfg)
    groups = zip(tree_unstack(params["self"], n_groups),
                 tree_unstack(params["cross"], n_groups))
    for sp, cp in groups:
        x = _group(x, sp, cp, image_embeds, positions, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=device)
    return lm_head(params["embed"], x, cfg), aux


# ------------------------------------------------------------------ decode


def init_vlm_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                   abstract=False, device=None):
    """(cache, axes): the self layers' KV cache, (G·n_self, B, T, K, hd),
    and the cross layers' K/V, (G, B, n_image_tokens, K, hd), zeros until
    `prefill_cross_kv` fills them."""
    n_groups, n_self = _n_groups(cfg)
    hd = cfg.resolved_head_dim
    self_cache = init_kv_cache(cfg, batch, max_len, n_groups * n_self,
                               abstract=abstract, device=device)
    shape = (n_groups, batch, cfg.n_image_tokens, cfg.n_kv_heads, hd)
    axes = ("layers", "cache_batch", None, "cache_heads", None)
    mk = lambda: make(None, shape, axes, init="zeros",  # noqa: E731
                      dtype=cfg.dtype, abstract=abstract, device=device)
    return split_tree({"self": self_cache, "cross": {"k": mk(), "v": mk()}})


def prefill_cross_kv(params: dict, image_embeds: torch.Tensor,
                     cfg: ModelConfig) -> dict:
    """Precompute the cross-attention K/V once per request (the encoder
    side): ``{"k", "v"}`` of (G, B, N_img, K, hd)."""
    n_groups, _ = _n_groups(cfg)
    ks, vs = [], []
    for cp in tree_unstack(params["cross"], n_groups):
        k, v = _cross_kv(cp["attn"], image_embeds, cfg)
        ks.append(k)
        vs.append(v)
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                pos: torch.Tensor, cfg: ModelConfig):
    """One-token decode.  tokens: (B, 1); pos: (B,) absolute positions.

    Returns (logits (B, 1, V), new_cache); ``cache`` is not written, and
    the new cache holds its cross K/V as they were.
    """
    x = embed_tokens(params["embed"], tokens, cfg)
    n_groups, n_self = _n_groups(cfg)
    ck, cv = cache["self"]["k"], cache["self"]["v"]
    nks, nvs = [], []
    groups = zip(tree_unstack(params["self"], n_groups),
                 tree_unstack(params["cross"], n_groups))
    for g, (sp, cp) in enumerate(groups):
        for i, lp in enumerate(tree_unstack(sp, n_self)):
            li = g * n_self + i
            h = apply_norm(lp["attn_norm"], x, cfg)
            att, nk, nv = cached_attention(lp["attn"], h, ck[li], cv[li],
                                           pos, cfg)
            x = x + att
            h = apply_norm(lp["mlp_norm"], x, cfg)
            x = x + apply_mlp(lp["mlp"], h)
            nks.append(nk)
            nvs.append(nv)
        kv = (cache["cross"]["k"][g], cache["cross"]["v"][g])
        x = _cross_block(cp, x, None, cfg, kv=kv)
    new_cache = {
        "self": {"k": torch.stack(nks), "v": torch.stack(nvs)},
        "cross": cache["cross"],
    }
    return lm_head(params["embed"], x, cfg), new_cache
