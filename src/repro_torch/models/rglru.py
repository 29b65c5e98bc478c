"""RecurrentGemma / Griffin (arXiv:2402.19427): RG-LRU recurrent blocks
interleaved 2:1 with local (sliding-window, MQA) attention; port of
`repro.models.rglru`.

Recurrent block: dual linear branches (signal + gate), short causal
depthwise conv1d, RG-LRU gated diagonal recurrence

    r_t = σ(x W_a + b_a);  i_t = σ(x W_x + b_x)
    a_t = exp(−c · softplus(Λ) · r_t)            (c = 8)
    h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

in float32, GeGLU MLP after every block.  The reference scans the
recurrence with ``jax.lax.associative_scan``; `_rglru_scan` runs the
same combine as a log-depth (Hillis–Steele) scan, which rounds apart
from it only in the order of its products.  Decode carries (conv tail,
h) per recurrent layer plus a rolling window cache per attention layer.

Layer stack: ``n_groups = n_layers // len(pattern)`` stacked groups of
(rec, rec, attn) + an all-recurrent tail for the remainder (38 = 12×3 +
2).  The decode state keeps batch at axis 2 of its grouped recurrent
leaves, so the slot engines refuse this family
(`families.validate_slot_layout`), as the reference's do.

Under a plan (`parallel.use_plan`) every rank runs on its parts of the
params, read from their shardings (`param_shardings`): FSDP leaves are
gathered a block at a time (inside a group's recompute); the recurrent
block's width splits over the model axis (``wx``/``wgate`` column-split,
the conv, ``ba``/``bi``/``lam`` and the decode state's channels the
rank's), and the conv and the RG-LRU are per channel, so they run on
the rank's channels; ``wa``/``wi`` split by rows, so their partial
products are reduce-scattered to the rank's columns, and ``wo`` is
row-parallel.  The MQA attention block runs as the dense family's (its
one KV head gathered for use), the MLPs column/row split, the embedding
and head vocab-parallel.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.init_utils import KeyGen, make, split_tree
from repro_torch.models.layers import (
    _gelu,
    _tp_axis,
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
from repro_torch.parallel import collectives as col
from repro_torch.parallel.axes import current_plan
from repro_torch.parallel.sharding_utils import param_shardings, per_layer
from repro_torch.tree import tree_leaves, tree_unstack

RGLRU_C = 8.0


def _init_rec_block(kg: KeyGen, cfg: ModelConfig, L: tuple) -> dict:
    d, dr = cfg.d_model, cfg.d_rnn or cfg.d_model
    dt, dev = cfg.dtype, kg.device
    return {
        "wx": make(kg(), L + (d, dr), ("layers", "embed", "heads"), dtype=dt),
        "wgate": make(kg(), L + (d, dr), ("layers", "embed", "heads"),
                      dtype=dt),
        "conv": make(kg(), L + (cfg.conv_width, dr),
                     ("layers", "conv", "heads"), scale=0.1, dtype=dt),
        "wa": make(kg(), L + (dr, dr), ("layers", "heads", "heads"), dtype=dt),
        "ba": make(None, L + (dr,), ("layers", "heads"), init="zeros",
                   device=dev),
        "wi": make(kg(), L + (dr, dr), ("layers", "heads", "heads"), dtype=dt),
        "bi": make(None, L + (dr,), ("layers", "heads"), init="zeros",
                   device=dev),
        "lam": make(None, L + (dr,), ("layers", "heads"), init="constant",
                    scale=0.7, device=dev),
        "wo": make(kg(), L + (dr, d), ("layers", "heads", "embed"), dtype=dt),
        "norm": init_norm(cfg, L, device=dev),
        "mlp_norm": init_norm(cfg, L, device=dev),
        "mlp": init_mlp(kg, cfg, L),
    }


def _init_attn_block(kg: KeyGen, cfg: ModelConfig, L: tuple) -> dict:
    return {
        "norm": init_norm(cfg, L, device=kg.device),
        "attn": init_attention(kg, cfg, L),
        "mlp_norm": init_norm(cfg, L, device=kg.device),
        "mlp": init_mlp(kg, cfg, L),
    }


def _pattern_split(cfg: ModelConfig) -> tuple[int, int]:
    p = len(cfg.block_pattern)
    return cfg.n_layers // p, cfg.n_layers % p


def init_rglru(generator: torch.Generator,
               cfg: ModelConfig) -> tuple[dict, dict]:
    """(params, axes), drawn from ``generator`` on its own device."""
    kg = KeyGen(generator)
    n_groups, rem = _pattern_split(cfg)
    if not all(b == "rec" for b in cfg.block_pattern[:rem]):
        raise ValueError(f"{cfg.name}: the tail of {rem} layers must be "
                         f"recurrent, pattern {cfg.block_pattern}")
    G = (n_groups,)
    groups: dict[str, Any] = {}
    for i, kind in enumerate(cfg.block_pattern):
        groups[f"b{i}"] = (_init_rec_block(kg, cfg, G) if kind == "rec"
                           else _init_attn_block(kg, cfg, G))
    tree: dict[str, Any] = {"embed": init_embedding(kg, cfg), "groups": groups}
    if rem:
        tree["tail"] = _init_rec_block(kg, cfg, (rem,))
    return split_tree(tree)


# ------------------------------------------------------------------ RG-LRU


def _rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """h_t = a_t ⊙ h_{t−1} + b_t over axis 1, given h0 (B, D): every
    h_t.  h0 folds into step 0 as ``b_0 + a_0·h0``; then log2(S) rounds
    of the reference's combine ``(a_l·a_r, b_l·a_r + b_r)`` at offsets
    1, 2, 4, … (at S = 1 the fold is the whole scan)."""
    b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    step = 1
    while step < a.shape[1]:
        b = torch.cat([b[:, :step], b[:, :-step] * a[:, step:]
                       + b[:, step:]], dim=1)
        a = torch.cat([a[:, :step], a[:, :-step] * a[:, step:]], dim=1)
        step *= 2
    return b


def _softplus(x):
    """``jax.nn.softplus``, log(1 + eˣ) with no threshold
    (`F.softplus` returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _sub(sh, key):
    return None if sh is None else sh[key]


def _rec_block(p: dict, x, state, cfg: ModelConfig, sh=None):
    """x: (B, S, d); state: {conv (B, W−1, dr), h (B, dr)} or None (the
    rank's channels under a plan).  Returns (x, new state).  ``sh``: the
    block's param shardings under a plan (FSDP leaves gathered here)."""
    if sh is not None:
        p = col.gather_fsdp(p, sh)
    b, s, _ = x.shape
    w = cfg.conv_width
    ax = _tp_axis(sh, "wx")
    h_in = apply_norm(p["norm"], x, cfg)
    if ax is not None:
        h_in = col.copy_to_model(h_in, ax.groups)
    xb = h_in @ p["wx"]
    gate = h_in @ p["wgate"]
    dr = xb.shape[-1]  # every channel, or the rank's

    conv_tail = state["conv"] if state is not None else torch.zeros(
        (b, w - 1, dr), dtype=xb.dtype, device=xb.device)
    xc = torch.cat([conv_tail.to(xb.dtype), xb], dim=1)
    # causal depthwise conv1d, width w: the reference's Python sum from 0
    y = sum(xc[:, i:i + s, :] * p["conv"][i][None, None, :] for i in range(w))
    new_conv_tail = xc[:, -(w - 1):, :] if w > 1 else conv_tail

    ra, ri = y @ p["wa"], y @ p["wi"]
    if ax is not None:  # row-split: the rank's columns of the sums
        ra = col.reduce_scatter(ra, ax.groups, -1)
        ri = col.reduce_scatter(ri, ax.groups, -1)
    r = torch.sigmoid(ra + p["ba"])
    i = torch.sigmoid(ri + p["bi"])
    log_a = (-RGLRU_C * _softplus(p["lam"]) * r).float()
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))
    bt = beta * (i * y).float()
    h0 = state["h"] if state is not None else torch.zeros(
        (b, dr), dtype=torch.float32, device=x.device)
    h = _rglru_scan(a, bt, h0)
    new_state = {"conv": new_conv_tail, "h": h[:, -1]}
    out = (_gelu(gate) * h.to(x.dtype)) @ p["wo"]
    if ax is not None:
        out = col.reduce_from_model(out, ax.groups)
    x = x + out
    h2 = apply_norm(p["mlp_norm"], x, cfg)
    return x + apply_mlp(p["mlp"], h2, activation="gelu",
                         sh=_sub(sh, "mlp")), new_state


def _attn_block(p: dict, x, positions, cfg: ModelConfig, sh=None):
    if sh is not None:
        p = col.gather_fsdp(p, sh)
    h = apply_norm(p["norm"], x, cfg)
    x = x + attention_block(p["attn"], h, positions, cfg,
                            window=cfg.sliding_window, sh=_sub(sh, "attn"))
    h = apply_norm(p["mlp_norm"], x, cfg)
    return x + apply_mlp(p["mlp"], h, activation="gelu", sh=_sub(sh, "mlp"))


def _group(x, gp: dict, positions, cfg: ModelConfig, sh=None):
    """One group of ``cfg.block_pattern`` over the whole sequence, no
    state."""
    for i, kind in enumerate(cfg.block_pattern):
        if kind == "rec":
            x, _ = _rec_block(gp[f"b{i}"], x, None, cfg, _sub(sh, f"b{i}"))
        else:
            x = _attn_block(gp[f"b{i}"], x, positions, cfg, _sub(sh, f"b{i}"))
    return x


def _plan_shardings(cfg: ModelConfig):
    plan = current_plan()
    return None if plan is None else param_shardings(cfg, plan)


def init_rglru_state(cfg: ModelConfig, batch: int, max_len: int, *,
                     abstract=False, device=None):
    """Decode state, (state, axes): the recurrent (conv, h) of each
    group's rec layers, batch at axis 2; a rolling attention cache over
    the groups' attn layers; the tail's (conv, h), batch at axis 1."""
    n_groups, rem = _pattern_split(cfg)
    dr = cfg.d_rnn or cfg.d_model
    n_rec = sum(1 for b in cfg.block_pattern if b == "rec")
    n_attn = len(cfg.block_pattern) - n_rec
    window = cfg.sliding_window or max_len
    kw = dict(init="zeros", abstract=abstract, device=device)
    tree: dict[str, Any] = {
        "rec_conv": make(None, (n_groups, n_rec, batch, cfg.conv_width - 1,
                                dr),
                         ("layers", None, "cache_batch", None, "state"),
                         dtype=cfg.dtype, **kw),
        "rec_h": make(None, (n_groups, n_rec, batch, dr),
                      ("layers", None, "cache_batch", "state"),
                      dtype=torch.float32, **kw),
        "attn": init_kv_cache(cfg, batch, min(window, max_len),
                              n_groups * n_attn, abstract=abstract,
                              window=cfg.sliding_window, device=device),
    }
    if rem:
        tree["tail_conv"] = make(None, (rem, batch, cfg.conv_width - 1, dr),
                                 ("layers", "cache_batch", None, "state"),
                                 dtype=cfg.dtype, **kw)
        tree["tail_h"] = make(None, (rem, batch, dr),
                              ("layers", "cache_batch", "state"),
                              dtype=torch.float32, **kw)
    return split_tree(tree)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            positions: torch.Tensor | None = None):
    """tokens (B, S) → (logits (B, S, V) fp32, aux = 0)."""
    b, s = tokens.shape
    device = params["embed"]["table"].device
    if positions is None:
        positions = torch.arange(s, device=device)[None, :].expand(b, s)
    sh = _plan_shardings(cfg)
    emb = params["embed"]
    if sh is not None:
        emb = col.gather_fsdp(emb, sh["embed"])
    x = embed_tokens(emb, tokens, cfg, sh=_sub(sh, "embed"))
    group_fn = functools.partial(
        _group, positions=positions, cfg=cfg,
        sh=None if sh is None else per_layer(sh["groups"]))
    if cfg.remat and torch.is_grad_enabled():
        group_fn = functools.partial(checkpoint, group_fn, use_reentrant=False,
                                     preserve_rng_state=False)
    n_groups, _ = _pattern_split(cfg)
    for gp in tree_unstack(params["groups"], n_groups):
        x = group_fn(x, gp)
    if "tail" in params:
        rem = tree_leaves(params["tail"])[0].shape[0]
        tail_sh = None if sh is None else per_layer(sh["tail"])
        for tp in tree_unstack(params["tail"], rem):
            x, _ = _rec_block(tp, x, None, cfg, tail_sh)
    aux = torch.zeros((), dtype=torch.float32, device=device)
    return lm_head(emb, x, cfg, sh=_sub(sh, "embed")), aux


def decode_step(params: dict, state: dict, tokens: torch.Tensor,
                pos: torch.Tensor, cfg: ModelConfig, *, cache_shardings=None):
    """One-token decode.  tokens (B, 1); pos (B,).  Returns (logits
    (B, 1, V), new_state); ``state`` is not written.  Under a plan every
    argument is this rank's part (the recurrent state's channels, the
    attention cache as the dense family's), ``cache_shardings`` the
    state's `NamedSharding` tree, and the logits the rank's vocab
    columns."""
    sh = _plan_shardings(cfg)
    emb = params["embed"]
    group_sh = tail_sh = cache_sh = None
    if sh is not None:
        if cache_shardings is None:
            raise ValueError("decode under a plan needs the state's "
                             "shardings (cache_shardings=)")
        emb = col.gather_fsdp(emb, sh["embed"])
        group_sh = per_layer(sh["groups"])
        tail_sh = per_layer(sh["tail"]) if "tail" in sh else None
        cache_sh = per_layer(cache_shardings["attn"])["k"]
    x = embed_tokens(emb, tokens, cfg, sh=_sub(sh, "embed"))
    n_groups, rem = _pattern_split(cfg)
    new_state = dict(state)

    rec_conv, rec_h = state["rec_conv"], state["rec_h"]
    ck, cv = state["attn"]["k"], state["attn"]["v"]
    nrc, nrh, nck, ncv = [], [], [], []
    for g, gp in enumerate(tree_unstack(params["groups"], n_groups)):
        ri = ai = 0
        for i, kind in enumerate(cfg.block_pattern):
            bsh = _sub(group_sh, f"b{i}")
            if kind == "rec":
                st = {"conv": rec_conv[g, ri], "h": rec_h[g, ri]}
                x, ns = _rec_block(gp[f"b{i}"], x, st, cfg, bsh)
                nrc.append(ns["conv"])
                nrh.append(ns["h"])
                ri += 1
            else:
                li = g * 1 + ai  # the reference's index: one attn a group
                p = gp[f"b{i}"]
                if bsh is not None:
                    p = col.gather_fsdp(p, bsh)
                h = apply_norm(p["norm"], x, cfg)
                att, nk, nv = cached_attention(p["attn"], h, ck[li], cv[li],
                                               pos, cfg,
                                               window=cfg.sliding_window,
                                               sh=_sub(bsh, "attn"),
                                               cache_sh=cache_sh)
                x = x + att
                h = apply_norm(p["mlp_norm"], x, cfg)
                x = x + apply_mlp(p["mlp"], h, activation="gelu",
                                  sh=_sub(bsh, "mlp"))
                nck.append(nk)
                ncv.append(nv)
                ai += 1
    new_state["rec_conv"] = torch.stack(nrc).reshape(rec_conv.shape)
    new_state["rec_h"] = torch.stack(nrh).reshape(rec_h.shape)
    new_state["attn"] = {"k": torch.stack(nck), "v": torch.stack(ncv)}
    if rem:
        ntc, nth = [], []
        for i, tp in enumerate(tree_unstack(params["tail"], rem)):
            st = {"conv": state["tail_conv"][i], "h": state["tail_h"][i]}
            x, ns = _rec_block(tp, x, st, cfg, tail_sh)
            ntc.append(ns["conv"])
            nth.append(ns["h"])
        new_state["tail_conv"] = torch.stack(ntc)
        new_state["tail_h"] = torch.stack(nth)
    return lm_head(emb, x, cfg, sh=_sub(sh, "embed")), new_state
