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
The WKV is differentiable (`kernels/rwkv_wkv/ops.py`: B7 forward, the
closed-form backward), so `forward` trains; with ``cfg.remat`` each layer
runs under `torch.utils.checkpoint` when grad mode is on, as the
reference's ``jax.checkpoint`` (which saves the dots; here the whole
layer is recomputed, with the same values).
Decode carries O(1) state, (token-shift vector, WKV matrix) per layer,
and runs the per-token scan over its one token, in plain PyTorch as the
reference runs it in XLA.  Parameters stay stacked with a leading
``n_layers`` axis; `forward` unbinds them once and loops over the layers
(one unbind, so a backward stacks each leaf's gradient once instead of
adding a full-size zero tensor a layer).  State leaves keep batch at
axis 1.

Tensor parallelism under a plan (`parallel.use_plan`; the shardings from
`param_shardings`): time-mix's ``wr``/``wk``/``wv``/``wg`` and
``w_lora_b`` are column-parallel over the rank's heads, and so are
``w0``, ``u`` and the GroupNorm (axis ``"state"``), so the WKV runs on
the rank's H/m heads (B7 on the card, through `ops.wkv`), the per-head
GroupNorm stays local and ``wo`` is row-parallel.  Channel-mix's ``wk``
is column-parallel over ``mlp`` and ``wv`` row-parallel; its receptance
``wr`` is column-parallel over ``heads``, so the rank holds only its
slice of ``rr``: the partial ``kk @ wv`` is reduce-scattered to that
slice (rather than all-reduced and sliced, whose backward would hand the
rank's partial only its slice's cotangent), multiplied, and the slices
gathered.  Token shift and ``_ddlerp`` act on the replicated ``x``;
every replicated tensor entering a split product goes through *f*
(`parallel.collectives.copy_to_model`).  The decode state's ``wkv``
leaf (``"state"`` → model) holds the rank's heads, so decode under a
plan is TP decode through the same `_time_mix`.  Where the model axis
divides the columns but not the heads (RWKV-6 3B's 2560 columns and 40
heads over 16 ranks: 160 columns, 2.5 heads a rank), ``w0``, ``u``, the
GroupNorm and the state stay whole: each rank gathers r, k, v and the
decay's columns for use (`gather_for_use`, whose backward
reduce-scatters), runs the WKV on all 40 heads (B7 at (B, S, 40, 64) on
every rank), takes its 160 columns of the normed output into its gate
and the row-split ``wo``, and the whole head leaves pass *f* (their
gradients summed over the ranks' columns).  FSDP leaves are
gathered a layer at a time, inside the layer's recompute.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.adc import clip
from repro_torch.kernels.rwkv_wkv import ops as wkv_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.init_utils import KeyGen, make, split_tree
from repro_torch.models.layers import (
    _tp_axis,
    apply_norm,
    embed_tokens,
    init_embedding,
    init_norm,
    lm_head,
)
from repro_torch.parallel import collectives as col
from repro_torch.parallel.axes import current_plan
from repro_torch.parallel.sharding_utils import param_shardings, per_layer
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


def _dot(a, w):
    """``a @ w`` in the promoted dtype of both, as JAX promotes a float32
    stream (the μ mix is float32) against a bfloat16 weight; a no-op cast
    in a float32 model."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


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
              chunked: bool = True, lengths=None, sh=None):
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    h = cfg.n_rwkv_heads
    ax = _tp_axis(sh, "wr")
    # the plan splits the columns but not the heads (40 over 16): every
    # rank gathers r, k, v and the decay's columns and runs every head
    every = ax is not None and col.model_dim(sh["w0"]) is None
    if ax is not None and not every:
        h //= ax.size
    xx = _token_shift(x, prev_tok)
    streams = _ddlerp(p["mix"], x, xx, cfg)  # (B, S, 5, d)
    xr, xk, xv, xg, xw = [streams[:, :, i] for i in range(5)]
    lo = torch.tanh(_dot(xw, p["w_lora_a"]))
    if ax is not None:
        xr, xk, xv, xg, lo = (col.copy_to_model(a, ax.groups)
                              for a in (xr, xk, xv, xg, lo))
    r, k, v, wl = (_dot(xr, p["wr"]), _dot(xk, p["wk"]), _dot(xv, p["wv"]),
                  _dot(lo, p["w_lora_b"]))
    g = F.silu(_dot(xg, p["wg"]))
    head = {n: p[n] for n in ("w0", "u", "gn_scale", "gn_bias")}
    if every:
        r, k, v, wl = (col.gather_for_use(a, ax.groups, -1)
                       for a in (r, k, v, wl))
        # replicated leaves used alike on every rank, each rank's output
        # columns only its own: *f* sums their gradients
        head = {n: col.copy_to_model(t, ax.groups) for n, t in head.items()}
    r, k, v = (a.reshape(b, s, h, hd) for a in (r, k, v))
    omega = head["w0"].reshape(1, 1, h, hd) + wl.reshape(b, s, h, hd)
    # `clip`, not `torch.clamp`: the reference's gradient at a tie
    lw = clip(-torch.exp(omega.float()), LOG_DECAY_MIN, -1e-6)

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
    u = head["u"].float()
    if chunked:
        y, wkv_state = wkv_chunked(rf, kf, vf, lw, u, wkv_state,
                                   impl=cfg.wkv_impl)
    else:
        y, wkv_state = wkv_naive(rf, kf, vf, lw, u, wkv_state)

    # per-head GroupNorm (population variance, as jnp.var)
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mu) * torch.rsqrt(var + 64e-5)
    y = y * head["gn_scale"][None, None] + head["gn_bias"][None, None]
    y = y.reshape(b, s, h * hd)
    if every:  # this rank's columns, into the row-split wo
        n = g.shape[-1]
        y = y[..., ax.index * n:(ax.index + 1) * n]
    y = y.to(x.dtype) * g
    shift = (x[:, -1, :] if lengths is None
             else _last_active(x, lengths, prev_tok))
    out = _dot(y, p["wo"])
    if ax is not None:
        out = col.reduce_from_model(out, ax.groups)
    return out, shift, wkv_state


def _channel_mix(p: dict, x, prev_tok, cfg: ModelConfig, *, lengths=None,
                 sh=None):
    xx = _token_shift(x, prev_tok)
    streams = _ddlerp(p["mix"], x, xx, cfg)
    xr, xk = streams[:, :, 0], streams[:, :, 1]
    shift = (x[:, -1, :] if lengths is None
             else _last_active(x, lengths, prev_tok))
    axk, axr = _tp_axis(sh, "wk"), _tp_axis(sh, "wr")
    if axk is None and axr is None:
        kk = torch.square(torch.relu(_dot(xk, p["wk"])))
        rr = torch.sigmoid(_dot(xr, p["wr"]))
        return rr * _dot(kk, p["wv"]), shift
    if axk is not None:
        xk = col.copy_to_model(xk, axk.groups)
    kv = _dot(torch.square(torch.relu(_dot(xk, p["wk"]))), p["wv"])  # partial if axk
    if axr is None:
        return torch.sigmoid(_dot(xr, p["wr"])) * col.reduce_from_model(
            kv, axk.groups), shift
    rr = torch.sigmoid(_dot(col.copy_to_model(xr, axr.groups), p["wr"]))
    if axk is not None:
        kv = col.reduce_scatter(kv, axr.groups, -1)
    else:  # whole kv, of which this rank uses its slice
        n = rr.shape[-1]
        kv = col.copy_to_model(kv, axr.groups)[..., axr.index * n:
                                                (axr.index + 1) * n]
    return col.gather_from_model(rr * kv, axr.groups, -1), shift


def init_rwkv_state(cfg: ModelConfig, batch: int, *, abstract=False,
                    device=None, heads: int | None = None):
    """Zero decode state, (state, axes): per layer the two token-shift
    vectors and the WKV matrix, batch at axis 1.  ``heads``: the WKV
    heads it holds (default all; a rank's under tensor parallelism)."""
    h, hd, d = heads or cfg.n_rwkv_heads, cfg.rwkv_head_dim, cfg.d_model
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


def _layer(x, lp, state, cfg: ModelConfig, *, chunked=True, lengths=None,
           sh=None):
    if sh is not None:
        lp = col.gather_fsdp(lp, sh)
    h = apply_norm(lp["att_norm"], x, cfg)
    att, att_shift, wkv = _time_mix(lp["att"], h, state["att_shift"],
                                    state["wkv"], cfg, chunked=chunked,
                                    lengths=lengths,
                                    sh=None if sh is None else sh["att"])
    x = x + att.to(x.dtype)
    h = apply_norm(lp["ffn_norm"], x, cfg)
    ffn, ffn_shift = _channel_mix(lp["ffn"], h, state["ffn_shift"], cfg,
                                  lengths=lengths,
                                  sh=None if sh is None else sh["ffn"])
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
        state, _ = init_rwkv_state(
            cfg, b, device=device,
            heads=params["layers"]["att"]["w0"].shape[1])
    plan = current_plan()
    sh = None if plan is None else param_shardings(cfg, plan)
    emb = params["embed"]
    if sh is not None:
        emb = col.gather_fsdp(emb, sh["embed"])
    x = embed_tokens(emb, tokens, cfg,
                     sh=None if sh is None else sh["embed"])
    layer_fn = functools.partial(
        _layer, cfg=cfg, chunked=chunked, lengths=lengths,
        sh=None if sh is None else per_layer(sh["layers"]))
    if cfg.remat and torch.is_grad_enabled():
        # the layer draws no random numbers: no RNG state to keep
        layer_fn = functools.partial(checkpoint, layer_fn, use_reentrant=False,
                                     preserve_rng_state=False)
    unbound = tree_map(lambda a: a.unbind(0), params["layers"])
    sts = []
    for i in range(cfg.n_layers):
        lp = tree_map(lambda a: a[i], unbound)
        st = tree_map(lambda a: a[i], state)
        x, ns = layer_fn(x, lp, st)
        sts.append(ns)
    new_states = {key: torch.stack([ns[key] for ns in sts]) for key in sts[0]}
    logits = lm_head(emb, x, cfg, sh=None if sh is None else sh["embed"])
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
