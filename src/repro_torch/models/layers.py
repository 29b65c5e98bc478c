"""Shared LM building blocks (params + forward); port of
`repro.models.layers`: norms, the MLP, the attention block, the KV cache
and its one-token decode, the embedding and the LM head.

Per-layer params take a leading ``n_layers`` dim (``L``).  Norms run in
float32 and cast back; attention scores and softmax are float32
(`models/attention.py`); logits are float32.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.attention import (
    PAD_KV_POS,
    apply_rope,
    attend,
    dense_attention,
    gqa_repeat,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.init_utils import KeyGen, make

# ------------------------------------------------------------------ norms


def rms_norm(x, scale, eps: float):
    """RMSNorm in float32, scaled by ``1 + scale``."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x, scale, bias, eps: float):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def init_norm(cfg: ModelConfig, L: tuple, name_axes=None, *,
              device=None, abstract: bool = False) -> dict:
    d = cfg.d_model
    if name_axes is None:
        name_axes = ("layers",) * len(L)
    mk = lambda: make(None, L + (d,), name_axes + ("embed_act",),  # noqa: E731
                      init="zeros", device=device, abstract=abstract)
    tree = {"scale": mk()}
    if cfg.use_layernorm:
        tree["bias"] = mk()
    return tree


def apply_norm(p: dict, x, cfg: ModelConfig):
    if "bias" in p:
        return layer_norm(x, 1.0 + p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


# ------------------------------------------------------------------ MLP


def init_mlp(kg: KeyGen, cfg: ModelConfig, L: tuple, d_ff: int | None = None,
             gated: bool = True) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.dtype
    ls = ("layers",) * len(L)
    tree = {
        "wi": make(kg(), L + (d, ff), ls + ("embed", "mlp"), dtype=dt),
        "wo": make(kg(), L + (ff, d), ls + ("mlp", "embed"), dtype=dt),
    }
    if gated:
        tree["wg"] = make(kg(), L + (d, ff), ls + ("embed", "mlp"), dtype=dt)
    return tree


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def apply_mlp(p: dict, x, activation: str = "silu"):
    h = x @ p["wi"]
    if "wg" in p:
        g = x @ p["wg"]
        act = F.silu(g) if activation == "silu" else _gelu(g)
        h = act * h
    else:
        h = _gelu(h) if activation == "gelu" else F.silu(h)
    return h @ p["wo"]


# ------------------------------------------------------------------ attention block


def init_attention(kg: KeyGen, cfg: ModelConfig, L: tuple) -> dict:
    d, qd, kvd, hd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.resolved_head_dim
    dt, dev = cfg.dtype, kg.device
    ls = ("layers",) * len(L)
    tree = {
        "wq": make(kg(), L + (d, qd), ls + ("embed", "heads"), dtype=dt),
        "wk": make(kg(), L + (d, kvd), ls + ("embed", "kv_heads"), dtype=dt),
        "wv": make(kg(), L + (d, kvd), ls + ("embed", "kv_heads"), dtype=dt),
        "wo": make(kg(), L + (qd, d), ls + ("heads", "embed"), dtype=dt),
    }
    if cfg.qkv_bias:
        for name, n, ax in (("bq", qd, "heads"), ("bk", kvd, "kv_heads"),
                            ("bv", kvd, "kv_heads")):
            tree[name] = make(None, L + (n,), ls + (ax,), init="zeros",
                              dtype=dt, device=dev)
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            tree[name] = make(None, L + (hd,), ls + (None,), init="zeros",
                              device=dev)
    return tree


def _project_qkv(p: dict, x, cfg: ModelConfig, positions, *, rope: bool = True):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(p: dict, x, positions, cfg: ModelConfig, *,
                    window: int | None = None, impl: str = "flash"):
    """Full-sequence causal self-attention (training / prefill)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    k = gqa_repeat(k, cfg.n_heads)
    v = gqa_repeat(v, cfg.n_heads)
    out = attend(q, k, v, positions, positions, causal=True, window=window,
                 impl=impl)
    return out.reshape(b, s, cfg.q_dim) @ p["wo"]


# ------------------------------------------------------------------ KV cache


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                  *, abstract: bool = False, window: int | None = None,
                  device=None) -> dict:
    """Per-layer stacked KV cache, (L, B, T, K, hd), batch at axis 1.
    Sliding-window archs allocate only the window (a rolling buffer)."""
    hd = cfg.resolved_head_dim
    length = min(max_len, window) if window else max_len
    shape = (n_layers, batch, length, cfg.n_kv_heads, hd)
    axes = ("layers", "cache_batch", "cache_seq", "cache_heads", None)
    mk = lambda: make(None, shape, axes, init="zeros",  # noqa: E731
                      dtype=cfg.dtype, abstract=abstract, device=device)
    return {"k": mk(), "v": mk()}


def cached_attention(p: dict, x, cache_k, cache_v, pos, cfg: ModelConfig, *,
                     window: int | None = None, rope: bool = True):
    """Single-token decode with cache update.

    x: (B, 1, d); cache_k/v: (B, T, K, hd); pos: (B,) current index.
    Returns (out (B,1,d), new_k, new_v); the caches given are not
    written.  For rolling (windowed) caches the slot is ``pos % T``;
    positions for RoPE and causality stay absolute.
    """
    b = x.shape[0]
    t = cache_k.shape[1]
    q, k, v = _project_qkv(p, x, cfg, pos[:, None], rope=rope)
    slot = torch.remainder(pos, t)
    rows = torch.arange(b, device=x.device)
    new_k = cache_k.index_put((rows, slot), k[:, 0].to(cache_k.dtype))
    new_v = cache_v.index_put((rows, slot), v[:, 0].to(cache_v.dtype))

    # Absolute positions of cache slots (rolling-aware): slot i holds
    # position  p_i = pos - ((slot - i) mod T)  … valid iff p_i >= 0.
    idx = torch.arange(t, device=x.device)[None, :]
    kv_pos = pos[:, None] - torch.remainder(slot[:, None] - idx, t)
    kv_pos = torch.where(kv_pos < 0, PAD_KV_POS, kv_pos)  # empty slots

    kr = gqa_repeat(new_k, cfg.n_heads)
    vr = gqa_repeat(new_v, cfg.n_heads)
    out = dense_attention(q, kr, vr, pos[:, None], kv_pos, causal=True,
                          window=window)
    return out.reshape(b, 1, cfg.q_dim) @ p["wo"], new_k, new_v


# ------------------------------------------------------------------ embedding / head


def init_embedding(kg: KeyGen, cfg: ModelConfig) -> dict:
    """Embedding table + output head, padded to ``padded_vocab`` (pad
    logits are masked in `lm_head`).  Table init ``d^-1/4``, the head
    fan-in ``d^-1/2``, as in the reference."""
    dt = cfg.dtype
    tree: dict[str, Any] = {
        "table": make(kg(), (cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
                      scale=cfg.d_model**-0.25, dtype=dt),
        "final_norm": init_norm(cfg, (), (), device=kg.device),
    }
    if not cfg.tie_embeddings:
        tree["head"] = make(kg(), (cfg.d_model, cfg.padded_vocab),
                            ("embed", "vocab"), dtype=dt)
    return tree


def embed_tokens(p: dict, tokens, cfg: ModelConfig):
    return p["table"][tokens.long()]


def mask_pad_vocab(logits, cfg: ModelConfig):
    if cfg.padded_vocab == cfg.vocab:
        return logits
    idx = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(idx < cfg.vocab, logits, -1e9)


def lm_head(p: dict, x, cfg: ModelConfig):
    x = apply_norm(p["final_norm"], x, cfg)
    w = p["table"].T if cfg.tie_embeddings else p["head"]
    logits = (x @ w).float()
    return mask_pad_vocab(logits, cfg)
