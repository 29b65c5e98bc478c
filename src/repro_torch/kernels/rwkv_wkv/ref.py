"""Plain PyTorch twin of the chunked WKV kernel; port of
`repro.kernels.rwkv_wkv.ref`.

The RWKV-6 recurrence per head (state S is dk × dv, lw = log decay ≤ 0):

    S_t = diag(exp(lw_t)) S_{t-1} + k_t v_tᵀ
    y_t = r_tᵀ (S_{t-1} + diag(u) k_t v_tᵀ)

Chunk-parallel form: within a chunk of C tokens with cumulative log
decays L_t = Σ_{i≤t} lw_i,

    y_t = (r_t ∘ e^{L_{t-1}}) @ S_0                       (inter-chunk)
        + Σ_{s<t} (r_t · e^{L_{t-1}-L_s} ∘ k_s) v_s       (intra, masked)
        + (r_t · u ∘ k_t) v_t                             (bonus diagonal)
    S_C = e^{L_C} ∘ S_0 + Σ_s (e^{L_C-L_s} ∘ k_s) v_sᵀ

Chunks of ≤ 16 keep every exp argument within fp32 range (|ΔL| ≤ 16·5 =
80 < 88).  Zero padding of the sequence tail is exact: padded positions
carry lw = 0 (decay e⁰ = 1) and r = k = v = 0, so the final state of a
padded sequence equals that of the unpadded one.

`wkv_chunked_plain` is the plain twin of the CUDA kernel B7
(`kernel.py::wkv_fused`): the wrapper runs it for CPU tensors, and the
tests and `chip_smoke.py` hold the kernel to it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

WKV_CHUNK = 16  # |ΔL| ≤ 16·|LOG_DECAY_MIN| = 80 < 88 ⇒ exp stays finite


def chunk_inputs(r, k, v, lw, chunk: int):
    """Zero-pad S to a chunk multiple and reshape (B,S,H,D) inputs to
    per-chunk operands (N, B, C, H, D).  Returns the operands plus
    (n_chunks, pad)."""
    b, s, h, d = r.shape
    pad = (-s) % chunk
    if pad:
        z = lambda a: F.pad(a, (0, 0, 0, 0, 0, pad))  # noqa: E731
        r, k, v, lw = z(r), z(k), z(v), z(lw)
    n = r.shape[1] // chunk
    resh = lambda a: a.reshape(b, n, chunk, h, d).transpose(0, 1)  # noqa: E731
    return resh(r), resh(k), resh(v), resh(lw), n, pad


def unchunk(a, b: int, s: int, h: int, d: int, chunk: int):
    """(N, B, C, H, D) per-chunk outputs back to (B, S, H, D), tail sliced."""
    n = a.shape[0]
    return a.transpose(0, 1).reshape(b, n * chunk, h, d)[:, :s]


def chunk_fwd(s0, rt, kt, vt, lwt, u):
    """One chunk of the chunk-parallel WKV.  rt/kt/vt/lwt (B,C,H,D),
    s0 (B,H,D,D), u (H,D) → (S_C, y (B,C,H,D))."""
    cum = torch.cumsum(lwt, dim=1)  # L_t (inclusive)
    cum_prev = cum - lwt  # L_{t-1}
    total = cum[:, -1:]  # L_C
    # inter: y_t += (r_t · exp(L_{t-1})) @ S0
    q = rt * torch.exp(cum_prev)
    y = torch.einsum("bchd,bhde->bche", q, s0)
    # intra: A[t,s] = Σ_d r_t exp(L_{t-1} − L_s) k_s  (s < t)
    kd = kt * torch.exp(total - cum)  # k_s · exp(L_C − L_s)
    qd = rt * torch.exp(cum_prev - total)  # r_t · exp(L_{t-1} − L_C)
    scores = torch.einsum("bthd,bshd->bhts", qd, kd)
    c = rt.shape[1]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                 device=rt.device), -1)
    scores = torch.where(mask[None, None], scores, 0.0)
    y = y + torch.einsum("bhts,bshe->bthe", scores, vt)
    # diagonal (bonus u)
    diag = torch.einsum("bthd,hd,bthd->bth", rt, u, kt)
    y = y + diag[..., None] * vt
    # state: S_C = exp(L_C)·S0 + Σ_s exp(L_C − L_s) k_s v_s
    s_new = torch.exp(total[:, 0])[..., None] * s0 + torch.einsum(
        "bshd,bshe->bhde", kd, vt)
    return s_new, y


def wkv_chunked_plain(r, k, v, lw, u, state, chunk: int = WKV_CHUNK):
    """Chunk-parallel WKV in plain PyTorch (exact vs the per-token scan up
    to fp reassociation).  r/k/v/lw (B,S,H,D) f32; u (H,D);
    state (B,H,D,D) → (y (B,S,H,D), final state)."""
    b, s, h, d = r.shape
    rc, kc, vc, lwc, n, _ = chunk_inputs(r, k, v, lw, chunk)
    ys = []
    for i in range(n):
        state, y = chunk_fwd(state, rc[i], kc[i], vc[i], lwc[i], u)
        ys.append(y)
    if not ys:
        return r.new_zeros((b, s, h, d)), state
    return unchunk(torch.stack(ys), b, s, h, d, chunk), state


def chunk_start_states(k, v, lw, state, chunk: int):
    """Every chunk's *entry* state by a state-only forward scan (the
    residual of the reference's closed-form backward; `ops.wkv_backward`
    forms the same states from its batched k·vᵀ).  Returns (final state,
    per-chunk entry states (N,B,H,D,D))."""
    _, kc, vc, lwc, n, _ = chunk_inputs(k, k, v, lw, chunk)
    starts = []
    for i in range(n):
        starts.append(state)
        cum = torch.cumsum(lwc[i], dim=1)
        total = cum[:, -1:]
        kd = kc[i] * torch.exp(total - cum)
        state = torch.exp(total[:, 0])[..., None] * state + torch.einsum(
            "bshd,bshe->bhde", kd, vc[i])
    b, _, h, d = k.shape
    return state, (torch.stack(starts) if starts
                   else k.new_zeros((0, b, h, d, d)))
