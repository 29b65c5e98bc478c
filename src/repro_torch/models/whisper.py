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
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import attend, dense_attention, gqa_repeat
from repro_torch.models.config import ModelConfig
from repro_torch.models.init_utils import KeyGen, make, split_tree
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    cached_attention,
    init_attention,
    init_kv_cache,
    init_mlp,
    init_norm,
    mask_pad_vocab,
)
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


def _qkv(p: dict, h, cfg: ModelConfig):
    b, s, _ = h.shape
    hd = cfg.resolved_head_dim
    q = (h @ p["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = (h @ p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (h @ p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    return q, k, v


def _encoder_layer(x, lp, positions, cfg: ModelConfig):
    b, s, _ = x.shape
    h = apply_norm(lp["attn_norm"], x, cfg)
    q, k, v = _qkv(lp["attn"], h, cfg)
    out = attend(q, gqa_repeat(k, cfg.n_heads), gqa_repeat(v, cfg.n_heads),
                 positions, positions, causal=False)
    x = x + out.reshape(b, s, cfg.q_dim) @ lp["attn"]["wo"]
    h = apply_norm(lp["mlp_norm"], x, cfg)
    return x + apply_mlp(lp["mlp"], h, activation="gelu")


def encode(params: dict, src_embeds: torch.Tensor, cfg: ModelConfig):
    """(B, S_src, d) stub frame embeddings → encoder states."""
    b, s, d = src_embeds.shape
    x = src_embeds.to(cfg.dtype) \
        + _sinusoid(s, d, device=src_embeds.device).to(cfg.dtype)[None]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    layer = _remat(functools.partial(_encoder_layer, positions=positions,
                                     cfg=cfg), cfg)
    for lp in tree_unstack(params["enc"], cfg.n_encoder_layers):
        x = layer(x, lp)
    return apply_norm(params["enc_final_norm"], x, cfg)


def _decoder_cross(lp, x, enc_k, enc_v, cfg: ModelConfig):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h = apply_norm(lp["cross_norm"], x, cfg)
    q = (h @ lp["cross_attn"]["wq"]).reshape(b, s, cfg.n_heads, hd)
    n_src = enc_k.shape[1]
    qpos = torch.zeros((b, s), dtype=torch.int32, device=x.device)
    kpos = torch.zeros((b, n_src), dtype=torch.int32, device=x.device)
    out = dense_attention(q, gqa_repeat(enc_k, cfg.n_heads),
                          gqa_repeat(enc_v, cfg.n_heads), qpos, kpos,
                          causal=False)
    return x + out.reshape(b, s, cfg.q_dim) @ lp["cross_attn"]["wo"]


def _cross_kv(lp, enc_out, cfg: ModelConfig):
    b, n, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = (enc_out @ lp["cross_attn"]["wk"]).reshape(b, n, cfg.n_kv_heads, hd)
    v = (enc_out @ lp["cross_attn"]["wv"]).reshape(b, n, cfg.n_kv_heads, hd)
    return k, v


def _decoder_layer(x, lp, enc_out, positions, cfg: ModelConfig):
    b, s, _ = x.shape
    h = apply_norm(lp["self_norm"], x, cfg)
    q, k, v = _qkv(lp["self_attn"], h, cfg)
    out = attend(q, gqa_repeat(k, cfg.n_heads), gqa_repeat(v, cfg.n_heads),
                 positions, positions, causal=True)
    x = x + out.reshape(b, s, cfg.q_dim) @ lp["self_attn"]["wo"]
    x = _decoder_cross(lp, x, *_cross_kv(lp, enc_out, cfg), cfg)
    h = apply_norm(lp["mlp_norm"], x, cfg)
    return x + apply_mlp(lp["mlp"], h, activation="gelu")


def _logits(params: dict, x, cfg: ModelConfig):
    x = apply_norm(params["dec_final_norm"], x, cfg)
    return mask_pad_vocab((x @ params["token_embed"].T).float(), cfg)


def forward(params: dict, src_embeds: torch.Tensor, tokens: torch.Tensor,
            cfg: ModelConfig):
    """Teacher-forced enc-dec forward → (logits (B, S_dec, V) fp32,
    aux=0)."""
    enc_out = encode(params, src_embeds, cfg)
    b, s = tokens.shape
    x = params["token_embed"][tokens.long()]
    x = x + params["pos_embed"][:s][None]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    layer = _remat(functools.partial(_decoder_layer, enc_out=enc_out,
                                     positions=positions, cfg=cfg), cfg)
    for lp in tree_unstack(params["dec"], cfg.n_layers):
        x = layer(x, lp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(params, x, cfg), aux


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
    K/V: ``{"k", "v"}`` of (L, B, S_src, K, hd)."""
    enc_out = encode(params, src_embeds, cfg)
    ks, vs = [], []
    for lp in tree_unstack(params["dec"], cfg.n_layers):
        k, v = _cross_kv(lp, enc_out, cfg)
        ks.append(k)
        vs.append(v)
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                pos: torch.Tensor, cfg: ModelConfig):
    """One-token decode.  tokens: (B, 1); pos: (B,) absolute positions,
    the learned position clipped at ``MAX_DECODER_POSITIONS`` − 1.

    Returns (logits (B, 1, V), new_cache); ``cache`` is not written.
    """
    x = params["token_embed"][tokens.long()]
    pos_clip = torch.clamp(pos, max=MAX_DECODER_POSITIONS - 1)
    x = x + params["pos_embed"][pos_clip.long()][:, None, :]
    nks, nvs = [], []
    for i, lp in enumerate(tree_unstack(params["dec"], cfg.n_layers)):
        h = apply_norm(lp["self_norm"], x, cfg)
        att, nk, nv = cached_attention(lp["self_attn"], h,
                                       cache["self"]["k"][i],
                                       cache["self"]["v"][i], pos, cfg,
                                       rope=False)
        x = x + att
        x = _decoder_cross(lp, x, cache["cross"]["k"][i],
                           cache["cross"]["v"][i], cfg)
        h = apply_norm(lp["mlp_norm"], x, cfg)
        x = x + apply_mlp(lp["mlp"], h, activation="gelu")
        nks.append(nk)
        nvs.append(nv)
    new_cache = {"self": {"k": torch.stack(nks), "v": torch.stack(nvs)},
                 "cross": cache["cross"]}
    return _logits(params, x, cfg), new_cache
