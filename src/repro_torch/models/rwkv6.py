"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free LM with
data-dependent per-channel decay; port of `repro.models.rwkv6`.

Time-mix: token-shift ddlerp (static μ + low-rank data-dependent mix),
projections r/k/v/g, data-dependent decay ``w_t = exp(−exp(ω_t))`` with
``ω_t = ω₀ + tanh(x @ A) @ B``, matrix-valued WKV state per head
(dk × dv), "bonus" u on the diagonal term, per-head GroupNorm, output
gating.  Channel-mix: token-shifted squared-ReLU FFN with sigmoid
receptance.

The chunked forward (prefill) runs the chunk-parallel WKV, per
``cfg.wkv_impl``: the CUDA kernel B7 on the card (`kernels/rwkv_wkv`).
Decode carries O(1) state, (token-shift vector, WKV matrix) per layer,
and runs the per-token scan over its one token, in plain PyTorch as the
reference runs it in XLA.  Parameters stay stacked with a leading
``n_layers`` axis; `forward` loops over the layers and indexes ``[i]``.
State leaves keep batch at axis 1.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv_wkv import ops as wkv_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.init_utils import KeyGen, make, split_tree
from repro_torch.models.layers import (
    apply_norm,
    embed_tokens,
    init_embedding,
    init_norm,
    lm_head,
)
from repro_torch.tree import tree_map

LOG_DECAY_MIN = -5.0  # clamp on per-token log decay (numerical guard)
WKV_CHUNK = 16


def _mix_params(kg: KeyGen, cfg: ModelConfig, L: tuple, n_streams: int) -> dict:
    d, r = cfg.d_model, cfg.rwkv_lora_dim
    return {
        "mu": make(None, L + (n_streams, d), ("layers", None, "embed_act"),
                   init="zeros", device=kg.device),
        "lora_a": make(kg(), L + (d, n_streams * r), ("layers", "embed", None),
                       dtype=cfg.dtype),
        "lora_b": make(kg(), L + (n_streams, r, d), ("layers", None, None, "embed"),
                       scale=0.01, dtype=cfg.dtype),
    }


def init_rwkv(generator: torch.Generator, cfg: ModelConfig) -> tuple[dict, dict]:
    """(params, axes), drawn from ``generator`` on its own device."""
    kg = KeyGen(generator)
    dev = kg.device
    L = (cfg.n_layers,)
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    h = cfg.n_rwkv_heads
    r = cfg.rwkv_lora_dim
    dt = cfg.dtype
    layers: dict[str, Any] = {
        "att_norm": init_norm(cfg, L, device=dev),
        "ffn_norm": init_norm(cfg, L, device=dev),
        "att": {
            "mix": _mix_params(kg, cfg, L, 5),  # r,k,v,g,w streams
            "wr": make(kg(), L + (d, d), ("layers", "embed", "heads"), dtype=dt),
            "wk": make(kg(), L + (d, d), ("layers", "embed", "heads"), dtype=dt),
            "wv": make(kg(), L + (d, d), ("layers", "embed", "heads"), dtype=dt),
            "wg": make(kg(), L + (d, d), ("layers", "embed", "heads"), dtype=dt),
            "wo": make(kg(), L + (d, d), ("layers", "heads", "embed"), dtype=dt),
            "w0": make(None, L + (h, hd), ("layers", "state", None),
                       init="constant", scale=-0.6, device=dev),
            "w_lora_a": make(kg(), L + (d, r), ("layers", "embed", None), dtype=dt),
            "w_lora_b": make(kg(), L + (r, d), ("layers", None, "heads"),
                             scale=0.01, dtype=dt),
            "u": make(None, L + (h, hd), ("layers", "state", None),
                      init="constant", scale=0.5, device=dev),
            "gn_scale": make(None, L + (h, hd), ("layers", "state", None),
                             init="ones", device=dev),
            "gn_bias": make(None, L + (h, hd), ("layers", "state", None),
                            init="zeros", device=dev),
        },
        "ffn": {
            "mix": _mix_params(kg, cfg, L, 2),  # r,k streams
            "wk": make(kg(), L + (d, cfg.d_ff), ("layers", "embed", "mlp"), dtype=dt),
            "wv": make(kg(), L + (cfg.d_ff, d), ("layers", "mlp", "embed"), dtype=dt),
            "wr": make(kg(), L + (d, d), ("layers", "embed", "heads"), dtype=dt),
        },
    }
    tree = {"embed": init_embedding(kg, cfg), "layers": layers}
    return split_tree(tree)


def _token_shift(x, prev):
    """Shift right by one: (B, S, d) with prev (B, d) as token −1."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _ddlerp(p: dict, x, xx, cfg: ModelConfig):
    """Data-dependent lerp between x and shifted xx → one stream per μ row."""
    n = p["mu"].shape[0]
    r = cfg.rwkv_lora_dim
    dx = xx - x
    lo = torch.tanh(x @ p["lora_a"])  # (B, S, n·r)
    lo = lo.reshape(x.shape[0], x.shape[1], n, r)
    adj = torch.einsum("bsnr,nrd->bsnd", lo, p["lora_b"])
    mix = p["mu"][None, None] + adj  # (B, S, n, d)
    return x[:, :, None, :] + dx[:, :, None, :] * mix  # (B, S, n, d)


# ------------------------------------------------------------------ WKV


def wkv_naive(r, k, v, lw, u, state):
    """Per-token scan reference.  r/k/v/lw: (B, S, H, D); state (B, H, D, D).

    Returns (y (B,S,H,D), final state).  lw = log decay ≤ 0.
    """
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, lwt = r[:, t], k[:, t], v[:, t], lw[:, t]  # (B, H, D)
        kv = torch.einsum("bhd,bhe->bhde", kt, vt)
        ys.append(torch.einsum("bhd,bhde->bhe", rt,
                               state + u[None, :, :, None] * kv))
        state = torch.exp(lwt)[..., None] * state + kv
    return torch.stack(ys, dim=1), state


def wkv_chunked(r, k, v, lw, u, state, chunk: int = WKV_CHUNK,
                impl: str = "cuda"):
    """Chunk-parallel WKV (exact vs `wkv_naive` up to fp error, output and
    final state).  ``impl`` = `ModelConfig.wkv_impl`: "cuda" runs the
    kernel B7 for CUDA tensors (its plain twin for CPU tensors), "plain"
    the plain chunked twin, "naive" the per-token scan."""
    if impl == "naive":
        return wkv_naive(r, k, v, lw, u, state)
    return wkv_ops.wkv(r, k, v, lw, u, state, chunk=chunk, impl=impl)


def _last_active(x, lengths, prev_tok):
    """Per-row shift state for a masked prefix: row b's last *active*
    position (lengths[b] − 1), keeping the previous shift state when the
    row advanced zero tokens."""
    b, s = x.shape[:2]
    idx = torch.clamp(lengths - 1, 0, s - 1)
    gathered = x[torch.arange(b, device=x.device), idx]
    return torch.where((lengths > 0)[:, None], gathered, prev_tok)


def _time_mix(p: dict, x, prev_tok, wkv_state, cfg: ModelConfig, *,
              chunked: bool = True, lengths=None):
    b, s, d = x.shape
    h, hd = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    xx = _token_shift(x, prev_tok)
    streams = _ddlerp(p["mix"], x, xx, cfg)  # (B, S, 5, d)
    xr, xk, xv, xg, xw = [streams[:, :, i] for i in range(5)]
    r = (xr @ p["wr"]).reshape(b, s, h, hd)
    k = (xk @ p["wk"]).reshape(b, s, h, hd)
    v = (xv @ p["wv"]).reshape(b, s, h, hd)
    g = F.silu(xg @ p["wg"])
    omega = p["w0"].reshape(1, 1, h, hd) + (torch.tanh(xw @ p["w_lora_a"])
                                            @ p["w_lora_b"]).reshape(b, s, h, hd)
    lw = torch.clamp(-torch.exp(omega.float()), LOG_DECAY_MIN, -1e-6)

    rf, kf, vf = (a.float() for a in (r, k, v))
    if lengths is not None:
        # Masked prefix (chunked serving prefill): positions ≥ lengths[b]
        # carry lw = 0 (identity decay) and k = 0 (no kv update), so the
        # WKV state update is exactly the identity there — inactive rows
        # and the tail beyond a row's prompt leave the state untouched.
        active = (torch.arange(s, device=x.device)[None]
                  < lengths[:, None])[..., None, None]
        lw = torch.where(active, lw, 0.0)
        kf = torch.where(active, kf, 0.0)
    u = p["u"].float()
    if chunked:
        y, wkv_state = wkv_chunked(rf, kf, vf, lw, u, wkv_state,
                                   impl=cfg.wkv_impl)
    else:
        y, wkv_state = wkv_naive(rf, kf, vf, lw, u, wkv_state)

    # per-head GroupNorm (population variance, as jnp.var)
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mu) * torch.rsqrt(var + 64e-5)
    y = y * p["gn_scale"][None, None] + p["gn_bias"][None, None]
    y = y.reshape(b, s, d).to(x.dtype) * g
    shift = (x[:, -1, :] if lengths is None
             else _last_active(x, lengths, prev_tok))
    return y @ p["wo"], shift, wkv_state


def _channel_mix(p: dict, x, prev_tok, cfg: ModelConfig, *, lengths=None):
    xx = _token_shift(x, prev_tok)
    streams = _ddlerp(p["mix"], x, xx, cfg)
    xr, xk = streams[:, :, 0], streams[:, :, 1]
    kk = torch.square(torch.relu(xk @ p["wk"]))
    rr = torch.sigmoid(xr @ p["wr"])
    shift = (x[:, -1, :] if lengths is None
             else _last_active(x, lengths, prev_tok))
    return rr * (kk @ p["wv"]), shift


def init_rwkv_state(cfg: ModelConfig, batch: int, *, abstract=False,
                    device=None):
    """Zero decode state, (state, axes): per layer the two token-shift
    vectors and the WKV matrix, batch at axis 1."""
    h, hd, d = cfg.n_rwkv_heads, cfg.rwkv_head_dim, cfg.d_model
    L = (cfg.n_layers,)
    kw = dict(init="zeros", abstract=abstract, device=device)
    tree = {
        "att_shift": make(None, L + (batch, d),
                          ("layers", "cache_batch", "embed_act"),
                          dtype=cfg.dtype, **kw),
        "ffn_shift": make(None, L + (batch, d),
                          ("layers", "cache_batch", "embed_act"),
                          dtype=cfg.dtype, **kw),
        "wkv": make(None, L + (batch, h, hd, hd),
                    ("layers", "cache_batch", "state", None, None),
                    dtype=torch.float32, **kw),
    }
    return split_tree(tree)


def _layer(x, lp, state, cfg: ModelConfig, *, chunked=True, lengths=None):
    h = apply_norm(lp["att_norm"], x, cfg)
    att, att_shift, wkv = _time_mix(lp["att"], h, state["att_shift"],
                                    state["wkv"], cfg, chunked=chunked,
                                    lengths=lengths)
    x = x + att.to(x.dtype)
    h = apply_norm(lp["ffn_norm"], x, cfg)
    ffn, ffn_shift = _channel_mix(lp["ffn"], h, state["ffn_shift"], cfg,
                                  lengths=lengths)
    x = x + ffn.to(x.dtype)
    new_state = {"att_shift": att_shift.to(cfg.dtype),
                 "ffn_shift": ffn_shift.to(cfg.dtype),
                 "wkv": wkv.float()}
    return x, new_state


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            state: dict | None = None, *, chunked: bool = True,
            lengths: torch.Tensor | None = None):
    """tokens (B,S) → (logits, aux=0, final_state).

    ``lengths`` (B,) masks each row to an active prefix: positions ≥
    lengths[b] are identity on the recurrent state (see `_time_mix`),
    and the token-shift states advance to the last *active* position —
    the masked-prefix contract `prefill_step` serves to the engine."""
    b, _ = tokens.shape
    device = params["embed"]["table"].device
    if state is None:
        state, _ = init_rwkv_state(cfg, b, device=device)
    x = embed_tokens(params["embed"], tokens, cfg)
    sts = []
    for i in range(cfg.n_layers):
        lp = tree_map(lambda a: a[i], params["layers"])
        st = tree_map(lambda a: a[i], state)
        x, ns = _layer(x, lp, st, cfg, chunked=chunked, lengths=lengths)
        sts.append(ns)
    new_states = {key: torch.stack([ns[key] for ns in sts]) for key in sts[0]}
    logits = lm_head(params["embed"], x, cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=device), \
        new_states


def decode_step(params: dict, state: dict, tokens: torch.Tensor,
                pos: torch.Tensor, cfg: ModelConfig):
    """One-token decode with O(1) state (pos unused — state is positionless)."""
    logits, _, new_state = forward(params, tokens, cfg, state, chunked=False)
    return logits, new_state


def prefill_step(params: dict, state: dict, tokens: torch.Tensor,
                 lengths: torch.Tensor, cfg: ModelConfig):
    """Fused chunked prefill: advance row b by ``lengths[b] ∈ [0, C]``
    tokens in ONE chunked forward (the family ``prefill`` hook serving's
    chunk step prefers over C masked decode steps — valid because rwkv
    state is positionless).  Rows with lengths[b] = 0 keep their state
    bit for bit (identity masking, see `forward`).

    Returns (last_logits (B, V) — each row's logits at its last active
    position — and the advanced state)."""
    b, c = tokens.shape
    logits, _, new_state = forward(params, tokens, cfg, state, chunked=True,
                                   lengths=lengths)
    idx = torch.clamp(lengths - 1, 0, c - 1)
    last = logits[torch.arange(b, device=logits.device), idx]
    return last, new_state
