"""Mixture-of-Experts FFN: top-k routing, capacity-based scatter dispatch,
experts as one product batched over E; port of `repro.models.moe` (the
single-device path, ``_apply_moe_xla``).

Tokens are scattered into a per-group (E, C, d) buffer by an
accumulating indexed add (positions from a within-group cumsum in slot
order), every expert runs over its whole buffer in one product batched
over E, and the results gather back with the router's combine weights.
A token beyond an expert's capacity drops: it adds ``x · 0`` at the last
position and its combine weight is 0 (capacity-factor semantics); the
Switch aux loss keeps the load flat.

The reference's expert-parallel ``apply_moe_shard_map`` (local experts
on a mesh's model axis) is part of the LM path's scale-out, which is not
ported yet (ROADMAP A12b); the port has the mesh and the plans
(`launch.mesh`, `parallel`).  With no mesh the reference takes the path
below whatever ``cfg.moe_impl`` says, and so does the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.init_utils import KeyGen, make


def init_moe(kg: KeyGen, cfg: ModelConfig, L: tuple) -> dict:
    """Router (float32, as the reference's) and the stacked experts'
    SwiGLU weights, (L, E, d, ff) / (L, E, ff, d)."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.dtype
    return {
        "router": make(kg(), L + (d, e), ("layers", "embed", None),
                       dtype=torch.float32),
        "wi": make(kg(), L + (e, d, ff), ("layers", "expert", "embed", "mlp"),
                   dtype=dt),
        "wg": make(kg(), L + (e, d, ff), ("layers", "expert", "embed", "mlp"),
                   dtype=dt),
        "wo": make(kg(), L + (e, ff, d), ("layers", "expert", "mlp", "embed"),
                   dtype=dt),
    }


def capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    """Slots an expert has in a group: the reference's float expression,
    truncated, rounded up to a multiple of 8, at least ``top_k``."""
    c = int(tokens_per_group * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(cfg.top_k, -(-c // 8) * 8)


def route(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Router probabilities (G, S, E) in float32 and the top-k (values
    renormalized, expert ids), (G, S, K) each.  Among equal
    probabilities the lower expert id comes first, as `jax.lax.top_k`
    orders them: the first k of a stable descending sort (the order of
    `torch.topk` at ties is unspecified)."""
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    top_vals, top_idx = torch.sort(probs, dim=-1, descending=True,
                                   stable=True)
    top_vals, top_idx = top_vals[..., :cfg.top_k], top_idx[..., :cfg.top_k]
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True),
                                      min=1e-9)
    return probs, top_vals, top_idx


def positions(top_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each (token, choice) slot's position in its expert's buffer,
    (G, S·K): the within-group count of earlier slots that chose the
    same expert, slots in token-major order."""
    g = top_idx.shape[0]
    flat_e = top_idx.reshape(g, -1)
    cum = torch.cumsum(F.one_hot(flat_e, n_experts), dim=1)
    return torch.gather(cum, -1, flat_e[..., None])[..., 0] - 1


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x: (G, S, d), G the group (batch) dim.  Returns (y, aux loss ·
    ``router_aux_weight``)."""
    g, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(cfg, s)
    dev = x.device

    probs, top_vals, top_idx = route(p, x, cfg)

    # Switch aux loss: E · Σ_e f_e · P_e  (f: token fraction, P: mean prob).
    flat_e = top_idx.reshape(g, s * k)
    token_frac = torch.zeros((g, e), dtype=torch.float32, device=dev) \
        .scatter_add(1, flat_e, torch.ones((g, s * k), dtype=torch.float32,
                                           device=dev))
    token_frac = token_frac / torch.tensor(float(s * k), device=dev)
    aux = e * torch.mean(torch.sum(token_frac * probs.mean(dim=1), dim=-1))

    pos = positions(top_idx, e)
    keep = (pos < c).to(x.dtype)  # capacity drop mask

    # Scatter tokens into (G, E, C, d) expert buffers.  A dropped slot
    # adds x·0 at position c − 1 (an accumulate, as `.at[].add`), so a
    # signed zero or a NaN in a dropped row acts as in the reference.
    x_rep = torch.repeat_interleave(x, k, dim=1)  # token t: slots tk..tk+k-1
    pos_c = torch.clamp(pos, 0, c - 1)
    rows = torch.arange(g, device=dev)[:, None].expand(g, s * k)
    buf = torch.zeros((g, e, c, d), dtype=x.dtype, device=dev).index_put(
        (rows, flat_e, pos_c), x_rep * keep[..., None], accumulate=True)

    # Expert SwiGLU, batched over E.
    h = torch.einsum("gecd,edf->gecf", buf, p["wi"])
    gate = torch.einsum("gecd,edf->gecf", buf, p["wg"])
    h = F.silu(gate) * h
    out = torch.einsum("gecf,efd->gecd", h, p["wo"])

    # Gather back with combine weights.
    y_flat = out[rows, flat_e, pos_c]  # (G, S·K, d)
    w_comb = (top_vals.reshape(g, s * k) * keep.float()).to(x.dtype)
    y = (y_flat * w_comb[..., None]).reshape(g, s, k, d).sum(dim=2)
    return y, aux * cfg.router_aux_weight
