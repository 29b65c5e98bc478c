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

Under a plan (`parallel.use_plan`) every rank runs on its parts of the
params, read from their shardings (`param_shardings`): FSDP leaves are
gathered a layer at a time, the self layers run tensor-parallel as the
dense family's, the gated cross block splits by heads (its query heads
and the image K/V projected from the replicated embeddings; 8 KV heads
gathered for use where the model axis does not divide them, as
`layers._tp_qkv` does) with ``wo`` row-parallel, the MLPs column/row
split, the embedding and head vocab-parallel.  The gates are replicated
and scale the reduced (replicated) outputs, ``tanh(gate)`` promoted as
`_gated` does.  Decode takes the cache's shardings: the self cache as
the dense family's, the cached image K/V split by heads where they
divide.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.init_utils import KeyGen, make, split_tree
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    attention_block,
    cached_attention,
    cross_attention,
    cross_kv,
    embed_tokens,
    init_attention,
    init_embedding,
    init_kv_cache,
    init_mlp,
    init_norm,
    lm_head,
)
from repro_torch.parallel import collectives as col
from repro_torch.parallel.axes import current_plan
from repro_torch.parallel.sharding_utils import param_shardings, per_layer
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


def _sub(sh, key):
    return None if sh is None else sh[key]


def _gated(gate, y, dtype):
    """``tanh(gate)·y`` cast to ``dtype``.  The product is taken in the
    promoted dtype of both, as JAX promotes a float32 gate against a
    bfloat16 ``y`` (torch would keep bfloat16 for a 0-dim gate)."""
    t = torch.tanh(gate)
    return (t * y.to(torch.promote_types(t.dtype, y.dtype))).to(dtype)


def _cross_block(p: dict, x, image_embeds, cfg: ModelConfig,
                 kv: tuple | None = None, sh=None, kv_sh=None):
    """The gated cross layer: x attends (unmasked) to the image's K/V,
    projected from ``image_embeds`` or given as ``kv`` (a decode cache's,
    ``kv_sh`` its sharding under a plan).  ``sh``: the layer's param
    shardings under a plan (FSDP leaves gathered here)."""
    if sh is not None:
        p = col.gather_fsdp(p, sh)
    h = apply_norm(p["norm"], x, cfg)
    out = cross_attention(p["attn"], h, cfg, src=image_embeds, kv=kv,
                          sh=_sub(sh, "attn"), kv_sh=kv_sh)
    x = x + _gated(p["gate_attn"], out, x.dtype)
    h = apply_norm(p["mlp_norm"], x, cfg)
    return x + _gated(p["gate_mlp"], apply_mlp(p["mlp"], h,
                                               sh=_sub(sh, "mlp")), x.dtype)


def _self_layer(x, lp, positions, cfg: ModelConfig, sh=None):
    if sh is not None:
        lp = col.gather_fsdp(lp, sh)
    h = apply_norm(lp["attn_norm"], x, cfg)
    x = x + attention_block(lp["attn"], h, positions, cfg,
                            sh=_sub(sh, "attn"))
    h = apply_norm(lp["mlp_norm"], x, cfg)
    return x + apply_mlp(lp["mlp"], h, sh=_sub(sh, "mlp"))


def _group(x, sp, cp, image_embeds, positions, cfg: ModelConfig, sh=None):
    """One group: its ``n_self`` self layers (``sp`` stacked on a leading
    axis), then its cross block ``cp``.  ``sh``: (the self layers', the
    cross layer's) shardings of one group under a plan."""
    _, n_self = _n_groups(cfg)
    self_sh, cross_sh = sh if sh is not None else (None, None)
    self_fn = functools.partial(
        _self_layer, positions=positions, cfg=cfg,
        sh=None if self_sh is None else per_layer(self_sh))
    cross_fn = functools.partial(_cross_block, image_embeds=image_embeds,
                                 cfg=cfg, sh=cross_sh)
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


def _plan_shardings(cfg: ModelConfig):
    plan = current_plan()
    return None if plan is None else param_shardings(cfg, plan)


def forward(params: dict, tokens: torch.Tensor, image_embeds: torch.Tensor,
            cfg: ModelConfig, positions: torch.Tensor | None = None):
    """tokens (B, S) + image_embeds (B, N_img, d) → (logits (B, S, V)
    fp32, aux=0)."""
    b, s = tokens.shape
    device = params["embed"]["table"].device
    if positions is None:
        positions = torch.arange(s, device=device)[None, :].expand(b, s)
    sh = _plan_shardings(cfg)
    emb = params["embed"]
    if sh is not None:
        emb = col.gather_fsdp(emb, sh["embed"])
    x = embed_tokens(emb, tokens, cfg, sh=_sub(sh, "embed"))
    image_embeds = image_embeds.to(x.dtype)
    n_groups, _ = _n_groups(cfg)
    group_sh = None if sh is None else (per_layer(sh["self"]),
                                        per_layer(sh["cross"]))
    groups = zip(tree_unstack(params["self"], n_groups),
                 tree_unstack(params["cross"], n_groups))
    for sp, cp in groups:
        x = _group(x, sp, cp, image_embeds, positions, cfg, group_sh)
    aux = torch.zeros((), dtype=torch.float32, device=device)
    return lm_head(emb, x, cfg, sh=_sub(sh, "embed")), aux


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
    side): ``{"k", "v"}`` of (G, B, N_img, K, hd); under a plan this
    rank's part of them, as the cache's shardings place it
    (`layers.cross_kv`)."""
    n_groups, _ = _n_groups(cfg)
    sh = _plan_shardings(cfg)
    cross_sh = None if sh is None else per_layer(sh["cross"])
    ks, vs = [], []
    for cp in tree_unstack(params["cross"], n_groups):
        if cross_sh is not None:
            cp = col.gather_fsdp(cp, cross_sh)
        k, v = cross_kv(cp["attn"], image_embeds, cfg,
                        sh=_sub(cross_sh, "attn"))
        ks.append(k)
        vs.append(v)
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                pos: torch.Tensor, cfg: ModelConfig, *, cache_shardings=None):
    """One-token decode.  tokens: (B, 1); pos: (B,) absolute positions.

    Returns (logits (B, 1, V), new_cache); ``cache`` is not written, and
    the new cache holds its cross K/V as they were.  Under a plan every
    argument is this rank's part, ``cache_shardings`` the cache's
    `NamedSharding` tree, and the logits are the rank's vocab columns.
    """
    sh = _plan_shardings(cfg)
    emb = params["embed"]
    self_sh = cross_sh = cache_self = cache_cross = None
    if sh is not None:
        if cache_shardings is None:
            raise ValueError("decode under a plan needs the cache's "
                             "shardings (cache_shardings=)")
        emb = col.gather_fsdp(emb, sh["embed"])
        self_sh = per_layer(per_layer(sh["self"]))
        cross_sh = per_layer(sh["cross"])
        cache_self = per_layer(cache_shardings["self"])["k"]
        cache_cross = per_layer(cache_shardings["cross"])["k"]
    x = embed_tokens(emb, tokens, cfg, sh=_sub(sh, "embed"))
    n_groups, n_self = _n_groups(cfg)
    ck, cv = cache["self"]["k"], cache["self"]["v"]
    nks, nvs = [], []
    groups = zip(tree_unstack(params["self"], n_groups),
                 tree_unstack(params["cross"], n_groups))
    for g, (sp, cp) in enumerate(groups):
        for i, lp in enumerate(tree_unstack(sp, n_self)):
            li = g * n_self + i
            if self_sh is not None:
                lp = col.gather_fsdp(lp, self_sh)
            h = apply_norm(lp["attn_norm"], x, cfg)
            att, nk, nv = cached_attention(lp["attn"], h, ck[li], cv[li],
                                           pos, cfg, sh=_sub(self_sh, "attn"),
                                           cache_sh=cache_self)
            x = x + att
            h = apply_norm(lp["mlp_norm"], x, cfg)
            x = x + apply_mlp(lp["mlp"], h, sh=_sub(self_sh, "mlp"))
            nks.append(nk)
            nvs.append(nv)
        kv = (cache["cross"]["k"][g], cache["cross"]["v"][g])
        x = _cross_block(cp, x, None, cfg, kv=kv, sh=cross_sh,
                         kv_sh=cache_cross)
    new_cache = {
        "self": {"k": torch.stack(nks), "v": torch.stack(nvs)},
        "cross": cache["cross"],
    }
    return lm_head(emb, x, cfg, sh=_sub(sh, "embed")), new_cache
