"""Public WKV op; port of `repro.kernels.rwkv_wkv.ops`: the kernel's
forward and the reference's closed-form chunked backward.

``impl="cuda"`` runs `WKVFunction`: its forward is `kernel.wkv_fused`
(the CUDA kernel B7 for CUDA tensors, its plain twin for CPU tensors),
its backward `wkv_backward`, the reference's closed-form adjoints
(`_wkv_bwd`, in XLA there) in plain PyTorch.  The residuals are just the
inputs: the backward recomputes each chunk's entry state with a cheap
state-only forward scan and carries the state adjoint G = ∂L/∂S_C back
over the chunks; the per-chunk terms below then run batched over all
the chunks at once (each op of a Python loop over chunks would cost a
launch and its host time).  ``impl="plain"`` runs the plain chunked twin on
any device, differentiable through autograd: the yardstick of the
closed form.

Per chunk (e_prev = e^{L_{t-1}}, e_kd = e^{L_C−L_s}, e_qd = e^{L_{t-1}−L_C},
Pm = strictly-masked dy·vᵀ):

    dv = scoresᵀ@dy + (r·u∘k · dy)            + kd@G
    dr = (dy@S0ᵀ)∘e_prev + (Pm@kd)∘e_qd       + (v·dy) u∘k
    dk = ((Pmᵀ@qd) + v@Gᵀ)∘e_kd               + (v·dy) u∘r
    du = Σ_t (v_t·dy_t) r_t∘k_t
    dS0 = qᵀ@dy + e^{L_C}∘G                    (→ carry to previous chunk)

and the log-decay gradient through L_j = Σ_{i≤j} lw_i: the per-position
sensitivity g[j] is the r-side e^{+L_j} terms (shifted: they pair with
r_{j+1}) minus the k-side e^{−L_j} terms, plus Σ_e S_C∘G at j = C−1 (the
e^{+L_C} state decay); dlw_i = Σ_{j≥i} g[j], a reversed cumsum.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv_wkv.kernel import wkv_fused
from repro_torch.kernels.rwkv_wkv.ref import WKV_CHUNK, wkv_chunked_plain


def _heads_first(a, chunk: int):
    """(B, S, H, D), S a multiple of ``chunk`` → (N, B, H, C, D)."""
    b, s, h, d = a.shape
    return a.reshape(b, s // chunk, chunk, h, d).permute(1, 0, 3, 2, 4)


def wkv_backward(r, k, v, lw, u, state, dy, dstate, chunk: int = WKV_CHUNK):
    """The closed-form VJP of the chunked WKV at (r, k, v, lw, u, state)
    for the cotangents ``dy`` (B,S,H,D) and ``dstate`` (B,H,D,D), either
    of which may be None (zeros).  Returns (dr, dk, dv, dlw, du, dstate0).

    The chunks are laid out (N, B, H, C, D), so every product is a
    batched matmul over the last two dims.  Only the entry states (a
    forward scan) and the state adjoints (a reverse scan) go chunk after
    chunk; every other term is one op over all the chunks, with the
    reference's per-chunk arithmetic."""
    b, s, h, d = r.shape
    if dy is None:
        dy = torch.zeros_like(r)
    if dstate is None:
        dstate = torch.zeros_like(state)
    n = -(-s // chunk)
    if n == 0:
        zero = torch.zeros_like(r)
        return zero, zero, zero, zero, torch.zeros_like(u), dstate
    pad = n * chunk - s
    rc, kc, vc, lwc, dyc = (
        _heads_first(F.pad(a, (0, 0, 0, 0, 0, pad)) if pad else a, chunk)
        for a in (r, k, v, lw, dy))
    cum = torch.cumsum(lwc, dim=-2)  # L_t
    cum_prev = cum - lwc  # L_{t-1}
    total = cum[..., -1:, :]  # L_C
    e_prev = torch.exp(cum_prev)
    e_kd = torch.exp(total - cum)
    e_qd = torch.exp(cum_prev - total)
    decay = torch.exp(total).transpose(-1, -2)  # e^{L_C}, (N,B,H,D,1)
    kd = kc * e_kd
    qd = rc * e_qd
    q = rc * e_prev
    # the entry state S_0 of each chunk and its exit state S_C (forward),
    # then the state adjoint G = ∂L/∂S_C of each exit state (backward);
    # G0 leaves for the initial state
    kv = kd.transpose(-1, -2) @ vc  # Σ_s kd_s v_sᵀ, (N,B,H,D,D)
    s0s, s_news = [], []
    st = state
    for i in range(n):
        s0s.append(st)
        st = decay[i] * st + kv[i]
        s_news.append(st)
    qdy = q.transpose(-1, -2) @ dyc  # Σ_t q_t dy_tᵀ
    G = dstate
    gs = [None] * n
    for i in reversed(range(n)):
        gs[i] = G
        G = qdy[i] + decay[i] * G
    G0, G = G, torch.stack(gs)
    s0s, s_new = torch.stack(s0s), torch.stack(s_news)
    strict = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=r.device), -1)
    scores = torch.where(strict, qd @ kd.transpose(-1, -2), 0.0)  # (t, s)
    # pairwise/diagonal v·dy products
    Pm = torch.where(strict, dyc @ vc.transpose(-1, -2), 0.0)  # (t, s)
    diagP = (dyc * vc).sum(-1, keepdim=True)
    uh = u[:, None, :]  # (H, 1, D)
    diag = (rc * uh * kc).sum(-1, keepdim=True)
    # dv: intra + diagonal + state kv
    dv = scores.transpose(-1, -2) @ dyc + diag * dyc + kd @ G
    # dr: inter + intra + diagonal
    dr_exp = (dyc @ s0s.transpose(-1, -2)) * e_prev + (Pm @ kd) * e_qd
    dr = dr_exp + diagP * uh * kc
    # dk: intra + state kv (both through kd) + diagonal
    dk_exp = (Pm.transpose(-1, -2) @ qd + vc @ G.transpose(-1, -2)) * e_kd
    dk = dk_exp + diagP * uh * rc
    # dlw: g[j] = (r-side, shifted) − (k-side) + the e^{+L_C} state-decay
    # term at j = C−1; dlw = reversed cumsum
    gl_r = rc * dr_exp
    g = torch.cat([gl_r[..., 1:, :], torch.zeros_like(gl_r[..., :1, :])],
                  dim=-2) - kc * dk_exp
    g[..., -1, :] += (s_new * G).sum(-1)
    dlw = g.flip(-2).cumsum(-2).flip(-2)
    # du, summed over batch and time a chunk, then over the chunks
    du = (diagP * rc * kc).sum(dim=(1, 3)).sum(0)

    def back(a):  # (N, B, H, C, D) → (B, S, H, D)
        return a.permute(1, 0, 3, 2, 4).reshape(b, n * chunk, h, d)[:, :s]

    return back(dr), back(dk), back(dv), back(dlw), du, G0


class WKVFunction(torch.autograd.Function):
    """The chunked WKV with the kernel's forward and the closed-form
    backward.  Inside ``forward`` grad mode is off, so `wkv_fused` takes
    inputs that require grad (its refusal guards direct calls)."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u, state, chunk: int):
        y, s_new = wkv_fused(r, k, v, lw, u, state, chunk=chunk)
        ctx.save_for_backward(r, k, v, lw, u, state)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, s_new

    @staticmethod
    def backward(ctx, dy, dstate):
        grads = wkv_backward(*ctx.saved_tensors, dy, dstate, ctx.chunk)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None)


def wkv(r, k, v, lw, u, state, *, chunk: int = WKV_CHUNK,
        impl: str = "cuda"):
    """Chunked WKV, (y, final state); see the module docstring."""
    if impl == "cuda":
        return WKVFunction.apply(r, k, v, lw, u, state, chunk)
    if impl == "plain":
        return wkv_chunked_plain(r, k, v, lw, u, state, chunk)
    raise ValueError(f"unknown WKV impl {impl!r} (want cuda|plain)")
