"""Whisper-style encoder-decoder audio backbone (arXiv:2212.04356); port of
`repro.models.whisper`.

The conv frame frontend is a stub: the input is precomputed frame
embeddings (B, S_src, d_model) (`launch/train.py` draws them).  Encoder:
bidirectional pre-norm transformer with sinusoidal positions.  Decoder:
causal self-attention (no RoPE), cross-attention to the encoder output,
learned positions (clipped at ``MAX_DECODER_POSITIONS`` − 1 in decode),
a tied softmax head.  The MLPs are ungated GELU in tanh form.  Layers run
in a Python loop (the reference's ``lax.scan``), each under
`torch.utils.checkpoint` when ``cfg.remat`` and grad mode are on.

Under a plan (`parallel.use_plan`) every rank runs on its parts of the
params, read from their shardings (`param_shardings`), as the dense
family does: FSDP leaves gathered a layer at a time (inside its
recompute), the self- and cross-attention tensor-parallel over the
rank's heads (every head, gathered, where they do not divide the model
axis: Whisper-tiny's 6 over 4, `layers._tp_qkv`), the MLPs column/row
split, the token embedding and the tied head vocab-parallel (the logits
are the rank's vocab columns).  Decode takes the cache's shardings: the
self cache as the dense family's, the cross K/V split by heads where
they divide (`layers.cross_attention`).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.init_utils import KeyGen, make, split_tree
from repro_torch.models.layers import (
    _tp_axis,
    apply_mlp,
    apply_norm,
    attention_block,
    cached_attention,
    cross_attention,
    cross_kv,
    embed_tokens,
    init_attention,
    init_kv_cache,
    init_mlp,
    init_norm,
    mask_pad_vocab,
)
from repro_torch.parallel import collectives as col
from repro_torch.parallel.axes import current_plan
from repro_torch.parallel.sharding_utils import param_shardings, per_layer
from repro_torch.tree import tree_unstack

MAX_DECODER_POSITIONS = 448


def _sinusoid(length: int, d: int, *, device=None) -> torch.Tensor:
    """(length, d) sinusoidal positions, [sin | cos], in float32: the
    constant log(10000) is a float32 operand, as in the reference."""
    pos = torch.arange(length, device=device)[:, None].to(torch.float32)
    dim = torch.arange(d // 2, device=device)[None, :].to(torch.float32)
    log_base = torch.log(torch.tensor(10000.0, dtype=torch.float32,
                                      device=device))
    inv = torch.exp(-dim * log_base / (d // 2 - 1))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_whisper(generator: torch.Generator,
                 cfg: ModelConfig) -> tuple[dict, dict]:
    """(params, axes), drawn from ``generator`` on its own device."""
    kg = KeyGen(generator)
    dev = kg.device
    Le = (cfg.n_encoder_layers,)
    Ld = (cfg.n_layers,)
    d = cfg.d_model
    enc = {
        "attn_norm": init_norm(cfg, Le, device=dev),
        "attn": init_attention(kg, cfg, Le),
        "mlp_norm": init_norm(cfg, Le, device=dev),
        "mlp": init_mlp(kg, cfg, Le, gated=False),
    }
    dec = {
        "self_norm": init_norm(cfg, Ld, device=dev),
        "self_attn": init_attention(kg, cfg, Ld),
        "cross_norm": init_norm(cfg, Ld, device=dev),
        "cross_attn": init_attention(kg, cfg, Ld),
        "mlp_norm": init_norm(cfg, Ld, device=dev),
        "mlp": init_mlp(kg, cfg, Ld, gated=False),
    }
    tree = {
        "token_embed": make(kg(), (cfg.padded_vocab, d), ("vocab", "embed"),
                            scale=d**-0.5, dtype=cfg.dtype),
        "pos_embed": make(kg(), (MAX_DECODER_POSITIONS, d), (None, "embed"),
                          scale=0.01, dtype=cfg.dtype),
        "enc": enc,
        "enc_final_norm": init_norm(cfg, (), device=dev),
        "dec": dec,
        "dec_final_norm": init_norm(cfg, (), device=dev),
    }
    return split_tree(tree)


def _remat(fn, cfg: ModelConfig):
    if cfg.remat and torch.is_grad_enabled():
        # the layers draw no random numbers: no RNG state to keep
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 preserve_rng_state=False)
    return fn


_DECODER_TOP = ("token_embed", "pos_embed", "dec_final_norm")


def _sharded(params: dict, cfg: ModelConfig, keys=_DECODER_TOP):
    """(the top-level leaves ``keys``, gathered where FSDP splits them,
    and every param's shardings) under a plan; (those leaves, None)
    outside one."""
    top = {k: params[k] for k in keys}
    plan = current_plan()
    if plan is None:
        return top, None
    sh = param_shardings(cfg, plan)
    return col.gather_fsdp(top, {k: sh[k] for k in keys}), sh


def _table_sh(sh):
    return None if sh is None else {"table": sh["token_embed"]}


def _sub(sh, key):
    return None if sh is None else sh[key]


def _encoder_layer(x, lp, positions, cfg: ModelConfig, sh=None):
    if sh is not None:
        lp = col.gather_fsdp(lp, sh)
    h = apply_norm(lp["attn_norm"], x, cfg)
    x = x + attention_block(lp["attn"], h, positions, cfg, causal=False,
                            rope=False, sh=_sub(sh, "attn"))
    h = apply_norm(lp["mlp_norm"], x, cfg)
    return x + apply_mlp(lp["mlp"], h, activation="gelu",
                         sh=_sub(sh, "mlp"))


def encode(params: dict, src_embeds: torch.Tensor, cfg: ModelConfig):
    """(B, S_src, d) stub frame embeddings → encoder states."""
    b, s, d = src_embeds.shape
    top, sh = _sharded(params, cfg, ("enc_final_norm",))
    x = src_embeds.to(cfg.dtype) \
        + _sinusoid(s, d, device=src_embeds.device).to(cfg.dtype)[None]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    layer = _remat(functools.partial(
        _encoder_layer, positions=positions, cfg=cfg,
        sh=None if sh is None else per_layer(sh["enc"])), cfg)
    for lp in tree_unstack(params["enc"], cfg.n_encoder_layers):
        x = layer(x, lp)
    return apply_norm(top["enc_final_norm"], x, cfg)


def _decoder_layer(x, lp, enc_out, positions, cfg: ModelConfig, sh=None):
    if sh is not None:
        lp = col.gather_fsdp(lp, sh)
    h = apply_norm(lp["self_norm"], x, cfg)
    x = x + attention_block(lp["self_attn"], h, positions, cfg, rope=False,
                            sh=_sub(sh, "self_attn"))
    h = apply_norm(lp["cross_norm"], x, cfg)
    x = x + cross_attention(lp["cross_attn"], h, cfg, src=enc_out,
                            sh=_sub(sh, "cross_attn"))
    h = apply_norm(lp["mlp_norm"], x, cfg)
    return x + apply_mlp(lp["mlp"], h, activation="gelu",
                         sh=_sub(sh, "mlp"))


def _logits(top: dict, x, cfg: ModelConfig, sh=None):
    """float32 logits of the tied head: the rank's vocab columns where the
    plan splits the table's rows over the model axis."""
    x = apply_norm(top["dec_final_norm"], x, cfg)
    ax = _tp_axis(_table_sh(sh), "table")
    if ax is None:
        return mask_pad_vocab((x @ top["token_embed"].T).float(), cfg)
    start = ax.index * (cfg.padded_vocab // ax.size)
    logits = (col.copy_to_model(x, ax.groups) @ top["token_embed"].T).float()
    return mask_pad_vocab(logits, cfg, start)


def vocab_range(cfg: ModelConfig, sh=None) -> tuple[int, tuple]:
    """(global index of this rank's first logit column, the groups the
    logits are split over), as `layers.vocab_range` for the tied head."""
    ax = _tp_axis(_table_sh(sh), "table")
    if ax is None:
        return 0, ()
    return ax.index * (cfg.padded_vocab // ax.size), ax.groups


def _embed(top: dict, tokens, cfg: ModelConfig, sh):
    return embed_tokens({"table": top["token_embed"]}, tokens, cfg,
                        sh=_table_sh(sh))


def forward(params: dict, src_embeds: torch.Tensor, tokens: torch.Tensor,
            cfg: ModelConfig):
    """Teacher-forced enc-dec forward → (logits (B, S_dec, V) fp32,
    aux=0)."""
    enc_out = encode(params, src_embeds, cfg)
    top, sh = _sharded(params, cfg)
    b, s = tokens.shape
    x = _embed(top, tokens, cfg, sh)
    x = x + top["pos_embed"][:s][None]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    layer = _remat(functools.partial(
        _decoder_layer, enc_out=enc_out, positions=positions, cfg=cfg,
        sh=None if sh is None else per_layer(sh["dec"])), cfg)
    for lp in tree_unstack(params["dec"], cfg.n_layers):
        x = layer(x, lp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(top, x, cfg, sh), aux


# ------------------------------------------------------------------ decode


def init_whisper_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                       abstract=False, device=None):
    """(cache, axes): the decoder's self-attention KV cache, (L, B, T, K,
    hd), and its cross K/V, (L, B, max_source_positions, K, hd), zeros
    until `prefill_cross_kv` fills them."""
    hd = cfg.resolved_head_dim
    self_cache = init_kv_cache(cfg, batch, max_len, cfg.n_layers,
                               abstract=abstract, device=device)
    shape = (cfg.n_layers, batch, cfg.max_source_positions, cfg.n_kv_heads,
             hd)
    axes = ("layers", "cache_batch", None, "cache_heads", None)
    mk = lambda: make(None, shape, axes, init="zeros",  # noqa: E731
                      dtype=cfg.dtype, abstract=abstract, device=device)
    return split_tree({"self": self_cache, "cross": {"k": mk(), "v": mk()}})


def prefill_cross_kv(params: dict, src_embeds: torch.Tensor,
                     cfg: ModelConfig) -> dict:
    """Encode once per request and project every decoder layer's cross
    K/V: ``{"k", "v"}`` of (L, B, S_src, K, hd); under a plan this rank's
    part of them, as the cache's shardings place it (`layers.cross_kv`)."""
    enc_out = encode(params, src_embeds, cfg)
    _, sh = _sharded(params, cfg, ())
    layer_sh = None if sh is None else per_layer(sh["dec"])
    ks, vs = [], []
    for lp in tree_unstack(params["dec"], cfg.n_layers):
        if layer_sh is not None:
            lp = col.gather_fsdp(lp, layer_sh)
        k, v = cross_kv(lp["cross_attn"], enc_out, cfg,
                        sh=_sub(layer_sh, "cross_attn"))
        ks.append(k)
        vs.append(v)
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                pos: torch.Tensor, cfg: ModelConfig, *, cache_shardings=None):
    """One-token decode.  tokens: (B, 1); pos: (B,) absolute positions,
    the learned position clipped at ``MAX_DECODER_POSITIONS`` − 1.

    Returns (logits (B, 1, V), new_cache); ``cache`` is not written.
    Under a plan every argument is this rank's part, ``cache_shardings``
    the cache's `NamedSharding` tree, and the logits are the rank's vocab
    columns.
    """
    top, sh = _sharded(params, cfg)
    layer_sh = self_sh = cross_sh = None
    if sh is not None:
        if cache_shardings is None:
            raise ValueError("decode under a plan needs the cache's "
                             "shardings (cache_shardings=)")
        layer_sh = per_layer(sh["dec"])
        self_sh = per_layer(cache_shardings["self"])["k"]
        cross_sh = per_layer(cache_shardings["cross"])["k"]
    x = _embed(top, tokens, cfg, sh)
    pos_clip = torch.clamp(pos, max=MAX_DECODER_POSITIONS - 1)
    x = x + top["pos_embed"][pos_clip.long()][:, None, :]
    nks, nvs = [], []
    for i, lp in enumerate(tree_unstack(params["dec"], cfg.n_layers)):
        if layer_sh is not None:
            lp = col.gather_fsdp(lp, layer_sh)
        h = apply_norm(lp["self_norm"], x, cfg)
        att, nk, nv = cached_attention(lp["self_attn"], h,
                                       cache["self"]["k"][i],
                                       cache["self"]["v"][i], pos, cfg,
                                       rope=False,
                                       sh=_sub(layer_sh, "self_attn"),
                                       cache_sh=self_sh)
        x = x + att
        h = apply_norm(lp["cross_norm"], x, cfg)
        x = x + cross_attention(lp["cross_attn"], h, cfg,
                                kv=(cache["cross"]["k"][i],
                                    cache["cross"]["v"][i]),
                                sh=_sub(layer_sh, "cross_attn"),
                                kv_sh=cross_sh)
        h = apply_norm(lp["mlp_norm"], x, cfg)
        x = x + apply_mlp(lp["mlp"], h, activation="gelu",
                          sh=_sub(layer_sh, "mlp"))
        nks.append(nk)
        nvs.append(nv)
    new_cache = {"self": {"k": torch.stack(nks), "v": torch.stack(nvs)},
                 "cross": cache["cross"]}
    return _logits(top, x, cfg, sh), new_cache
