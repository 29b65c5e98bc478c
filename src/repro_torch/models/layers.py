"""Shared LM building blocks (params + forward); port of
`repro.models.layers`: norms, the MLP, the attention block, the KV cache
and its one-token decode, the embedding and the LM head.

Per-layer params take a leading ``n_layers`` dim (``L``).  Norms run in
float32 and cast back; attention scores and softmax are float32
(`models/attention.py`); logits are float32.

Tensor parallelism (Megatron-LM's, the reference's TP plan run as
``shard_map``): a function given ``sh``, the `NamedSharding` tree of
its params (one layer's), runs on this rank's parts of them.  The
sharding says which products are split over the ``"model"`` axis:
column-parallel Q/K/V over the rank's heads and row-parallel ``wo``,
``wi``/``wg`` over the rank's ``mlp`` columns and ``wo`` over its rows,
the embedding and the head over the rank's vocab rows / columns.  A
tensor replicated over the model axis enters a split product through
`copy_to_model` (*f*) and the partial sums leave through
`reduce_from_model` (*g*); a leaf the plan leaves whole over the model
axis (a dimension the axis does not divide) is used whole, or the slice
a rank needs of it.  ``sh=None`` (no plan) is the single-device code.
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
    partial_attention,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.init_utils import KeyGen, make
from repro_torch.parallel import collectives as col

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


def _tp_axis(sh, name: str):
    """The model axis where ``sh[name]`` is split over it, else None."""
    if sh is None or col.model_dim(sh[name]) is None:
        return None
    return col.model_axis(sh[name].mesh)


def apply_mlp(p: dict, x, activation: str = "silu", *, sh=None):
    """The (gated) MLP; with ``sh``, ``wi``/``wg`` column-parallel and
    ``wo`` row-parallel over the model axis where the plan splits
    ``mlp``."""
    ax = _tp_axis(sh, "wi")
    if ax is not None:
        x = col.copy_to_model(x, ax.groups)
    h = x @ p["wi"]
    if "wg" in p:
        g = x @ p["wg"]
        act = F.silu(g) if activation == "silu" else _gelu(g)
        h = act * h
    else:
        h = _gelu(h) if activation == "gelu" else F.silu(h)
    out = h @ p["wo"]
    return out if ax is None else col.reduce_from_model(out, ax.groups)


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
    # -1: every head, or a rank's where the columns are its part
    q, k, v = (a.reshape(b, s, -1, hd) for a in (q, k, v))
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _local_heads(cfg: ModelConfig, ax) -> int:
    if cfg.n_heads % ax.size:
        raise ValueError(f"{cfg.n_heads} query heads do not split over a "
                         f"model axis of {ax.size}: the plan splits a head")
    return cfg.n_heads // ax.size


def _tp_columns(p: dict, xf, sh, name: str, bias: str, ax):
    """``xf @ p[name]`` (+ bias): the rank's columns where the plan splits
    the leaf over the model axis, all of them where it leaves it whole
    (then *f* on the leaf, whose use here is this rank's part)."""
    split = col.model_dim(sh[name]) is not None
    w = p[name] if split else col.copy_to_model(p[name], ax.groups)
    t = xf @ w
    if bias in p:
        t = t + (p[bias] if split else col.copy_to_model(p[bias], ax.groups))
    return t, split


def _kv_for_heads(t, split: bool, cfg: ModelConfig, ax, hl: int):
    """The KV head of each of this rank's ``hl`` query heads, (B, S, hl,
    hd), from the rank's K or V columns ``t`` (all of them when the leaf
    is whole over the model axis).  Where the rank's columns are whole
    KV heads (``n_kv_heads`` divides over the axis) they are its query
    heads' own; otherwise the columns are gathered (each rank then reads
    the heads it needs: the backward reduce-scatters) and the heads
    picked, rank r's query head j reading KV head j // (H/K)."""
    b, s, _ = t.shape
    hd, kh = cfg.resolved_head_dim, cfg.n_kv_heads
    if split and kh % ax.size == 0:
        return gqa_repeat(t.reshape(b, s, kh // ax.size, hd), hl)
    if split:
        t = col.gather_for_use(t, ax.groups, -1)
    first = ax.index * hl
    heads = torch.arange(first, first + hl, device=t.device) // (
        cfg.n_heads // kh)
    return t.reshape(b, s, kh, hd)[:, :, heads]


def _tp_qkv(p: dict, x, cfg: ModelConfig, positions, sh, ax, *,
            rope: bool = True):
    """q, k, v of this rank's query heads, (B, S, H/m, hd) each (k and v
    repeated to the query heads), from the replicated ``x``."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    hl = _local_heads(cfg, ax)
    xf = col.copy_to_model(x, ax.groups)
    q = (xf @ p["wq"] + p["bq"] if "bq" in p else xf @ p["wq"])
    q = q.reshape(b, s, hl, hd)
    k, ks = _tp_columns(p, xf, sh, "wk", "bk", ax)
    v, vs = _tp_columns(p, xf, sh, "wv", "bv", ax)
    k = _kv_for_heads(k, ks, cfg, ax, hl)
    v = _kv_for_heads(v, vs, cfg, ax, hl)
    if "q_norm" in p:
        q = rms_norm(q, col.copy_to_model(p["q_norm"], ax.groups),
                     cfg.norm_eps)
        k = rms_norm(k, col.copy_to_model(p["k_norm"], ax.groups),
                     cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(p: dict, x, positions, cfg: ModelConfig, *,
                    window: int | None = None, impl: str = "flash", sh=None):
    """Full-sequence causal self-attention (training / prefill).  With
    ``sh`` splitting the heads: this rank's query heads, its share of
    ``wo``'s rows, and one `reduce_from_model`."""
    b, s, _ = x.shape
    ax = _tp_axis(sh, "wq")
    if ax is not None:
        q, k, v = _tp_qkv(p, x, cfg, positions, sh, ax)
        out = attend(q, k, v, positions, positions, causal=True,
                     window=window, impl=impl)
        out = out.reshape(b, s, -1) @ p["wo"]
        return col.reduce_from_model(out, ax.groups)
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
                     window: int | None = None, rope: bool = True, sh=None,
                     cache_sh=None):
    """Single-token decode with cache update.

    x: (B, 1, d); cache_k/v: (B, T, K, hd); pos: (B,) current index.
    Returns (out (B,1,d), new_k, new_v); the caches given are not
    written.  For rolling (windowed) caches the slot is ``pos % T``;
    positions for RoPE and causality stay absolute.

    Under a plan (``sh``: the layer's param shardings, ``cache_sh``: the
    cache leaf's of one layer) every argument is this rank's part.  A
    cache whose heads split over the model axis (``cache_heads``) holds
    the rank's KV heads: the code below runs on the rank's query heads
    (column-parallel) and ``wo``'s rows, and one `reduce_from_model`
    adds the parts.  Otherwise `_split_kv_attention`.
    """
    ax = None
    if sh is not None:
        head_axes = col.leaf_axes(cache_sh)[2]
        if not head_axes:
            return _split_kv_attention(p, x, cache_k, cache_v, pos, cfg, sh,
                                       cache_sh, window=window, rope=rope)
        ax = _tp_axis(sh, "wq")
        if head_axes != ("model",) or ax is None:
            raise ValueError(f"a decode cache whose heads split over "
                             f"{head_axes} needs the query heads split over "
                             "the model axis too")
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

    heads = q.shape[2]  # every query head, or the rank's
    kr = gqa_repeat(new_k, heads)
    vr = gqa_repeat(new_v, heads)
    out = dense_attention(q, kr, vr, pos[:, None], kv_pos, causal=True,
                          window=window)
    out = out.reshape(b, 1, -1) @ p["wo"]
    if ax is not None:
        out = col.reduce_from_model(out, ax.groups)
    return out, new_k, new_v


def _whole_heads(p: dict, x, sh, name: str, bias: str, ax):
    """``x @ p[name]`` (+ bias) over every head: the ranks' columns
    gathered where the plan splits the leaf over the model axis."""
    t = x @ p[name]
    if bias in p:
        t = t + p[bias]
    if ax is not None and col.model_dim(sh[name]) is not None:
        t = col.gather_from_model(t, ax.groups, -1)
    return t


def _split_kv_attention(p, x, cache_k, cache_v, pos, cfg, sh, cache_sh, *,
                        window, rope):
    """Decode under a plan whose cache keeps every head (``cache_seq``
    split over some axes, split-KV, or the cache whole), on this rank's
    parts: every head's q, k and v (the ranks' columns gathered, B × 1 ×
    q_dim a layer), the new row written only where this rank owns slot
    ``pos % T``, attention over the rank's slice of the sequence with its
    absolute ``kv_pos`` masked, the ranks' partial softmaxes combined
    (`split_kv_combine`), and the rank's heads taken for the
    row-parallel ``wo``."""
    b = x.shape[0]
    hd, nh = cfg.resolved_head_dim, cfg.n_heads
    mesh = cache_sh.mesh
    ax = col.model_axis(mesh)
    seq_axes = col.leaf_axes(cache_sh)[1]
    rows = torch.arange(b, device=x.device)
    q = _whole_heads(p, x, sh, "wq", "bq", ax).reshape(b, 1, nh, hd)
    k = _whole_heads(p, x, sh, "wk", "bk", ax).reshape(
        b, 1, cfg.n_kv_heads, hd)
    v = _whole_heads(p, x, sh, "wv", "bv", ax).reshape(
        b, 1, cfg.n_kv_heads, hd)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)

    groups = col.axis_groups(mesh, seq_axes)
    part, n = col.group_index(groups)
    t_local = cache_k.shape[1]
    t = t_local * n
    slot = torch.remainder(pos, t)
    mine = (slot // t_local == part)[:, None, None]
    local = torch.clamp(slot - part * t_local, 0, t_local - 1)

    def write(cache, new):
        row = torch.where(mine, new[:, 0].to(cache.dtype), cache[rows, local])
        return cache.index_put((rows, local), row)

    new_k, new_v = write(cache_k, k), write(cache_v, v)
    idx = part * t_local + torch.arange(t_local, device=x.device)[None, :]
    kv_pos = pos[:, None] - torch.remainder(slot[:, None] - idx, t)
    kv_pos = torch.where(kv_pos < 0, PAD_KV_POS, kv_pos)
    parts = partial_attention(q, gqa_repeat(new_k, nh), gqa_repeat(new_v, nh),
                              pos[:, None], kv_pos, causal=True,
                              window=window)
    out = col.split_kv_combine(*parts, groups)  # (B, H, 1, hd)
    out = out.transpose(1, 2).to(new_v.dtype)  # (B, 1, H, hd)
    if ax is None or col.model_dim(sh["wo"]) is None:
        return out.reshape(b, 1, cfg.q_dim) @ p["wo"], new_k, new_v
    hl = _local_heads(cfg, ax)
    mine_heads = out[:, :, ax.index * hl:(ax.index + 1) * hl]
    out = mine_heads.reshape(b, 1, hl * hd) @ p["wo"]
    return col.reduce_from_model(out, ax.groups), new_k, new_v


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


def embed_tokens(p: dict, tokens, cfg: ModelConfig, *, sh=None):
    """The embedding rows of ``tokens``.  With ``sh`` splitting the table's
    vocab rows over the model axis: each rank looks up the tokens in its
    range, the rest are 0, and the rows are summed over the axis (*g*)."""
    ax = _tp_axis(sh, "table")
    if ax is None:
        return p["table"][tokens.long()]
    table = p["table"]
    vl = table.shape[0]
    local = torch.remainder(tokens.long(), cfg.padded_vocab) - ax.index * vl
    here = ((local >= 0) & (local < vl))[..., None]
    x = torch.where(here, table[torch.clamp(local, 0, vl - 1)], 0.0)
    return col.reduce_from_model(x.to(table.dtype), ax.groups)


def mask_pad_vocab(logits, cfg: ModelConfig, start: int = 0):
    """Padded vocab columns to −1e9; ``start``: the global index of the
    first column of ``logits`` (a rank's vocab shard)."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    idx = torch.arange(logits.shape[-1], device=logits.device) + start
    return torch.where(idx < cfg.vocab, logits, -1e9)


def vocab_range(cfg: ModelConfig, sh=None) -> tuple[int, tuple]:
    """(global index of this rank's first logit column, the groups its
    logits are split over) for `lm_head`'s output under the embedding
    shardings ``sh``; (0, ()) where the logits are whole."""
    ax = _tp_axis(sh, "table" if cfg.tie_embeddings else "head")
    if ax is None:
        return 0, ()
    return ax.index * (cfg.padded_vocab // ax.size), ax.groups


def lm_head(p: dict, x, cfg: ModelConfig, *, sh=None):
    """float32 logits, the padded columns masked.  With ``sh`` splitting
    the vocab over the model axis: this rank's columns (tied: the rows of
    its table shard), padded columns masked in its own range."""
    x = apply_norm(p["final_norm"], x, cfg)
    w = p["table"].T if cfg.tie_embeddings else p["head"]
    start, groups = vocab_range(cfg, sh)
    logits = (col.copy_to_model(x, groups) @ w).float()
    return mask_pad_vocab(logits, cfg, start)
