"""Attention: GQA with RoPE/qk-norm/SWA, the flash-chunked training and
prefill path and the dense decode path; port of `repro.models.attention`.

The reference computes its "flash" attention in plain jnp, outside any
Pallas kernel, so this module is plain PyTorch in the reference's order
of operations (no `scaled_dot_product_attention`): an outer loop over
query chunks and an inner loop over KV chunks with an fp32 running max,
denominator and accumulator, so peak score memory is q_chunk × kv_chunk
whatever the sequence length.  Decode (S_q == 1) takes the dense path
over the KV cache.  Scores and softmax are float32 (the reference's
``preferred_element_type=jnp.float32``): products of low-precision
inputs are taken in float32, where a bfloat16 product is exact.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
PAD_KV_POS = 2**30  # sentinel for empty/padded KV slots — always masked


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D) with D even; positions: (B, S) absolute indices.
    Angles in float32, as the reference (θ stays a float32 operand)."""
    half = x.shape[-1] // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exps)
    angles = positions[:, :, None].float() * freqs[None, None, :]
    cos = torch.cos(angles)[:, :, None, :]  # (B, S, 1, half)
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _mask(q_pos, kv_pos, *, causal: bool, window: int | None, kv_len=None):
    """(..., Sq, Skv) additive float32 mask from position grids."""
    qp = q_pos[..., :, None]
    kp = kv_pos[..., None, :]
    m = torch.zeros(torch.broadcast_shapes(qp.shape, kp.shape),
                    dtype=torch.float32, device=q_pos.device)
    m = torch.where(kp >= PAD_KV_POS, NEG_INF, m)  # padded/empty slots
    if causal:
        m = torch.where(kp > qp, NEG_INF, m)
    if window is not None:
        m = torch.where(kp <= qp - window, NEG_INF, m)
    if kv_len is not None:
        m = torch.where(kp >= kv_len[..., None, None], NEG_INF, m)
    return m


def dense_attention(q, k, v, q_pos, kv_pos, *, causal=True, window=None,
                    kv_len=None, scale=None):
    """Unchunked reference/decode path. q: (B,Sq,H,D); k,v: (B,Skv,H,D)."""
    d = q.shape[-1]
    scale = scale or d**-0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _mask(q_pos[:, None], kv_pos[:, None], causal=causal,
                 window=window,
                 kv_len=kv_len[:, None] if kv_len is not None else None)
    scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def partial_attention(q, k, v, q_pos, kv_pos, *, causal=True, window=None,
                      scale=None):
    """One part of a key sequence split over ranks (split-KV decode):
    (max, Σ exp(s − max), Σ exp(s − max)·v) over this part's keys, the
    scores as in `dense_attention`; `parallel.collectives.
    split_kv_combine` joins the parts.  q: (B,Sq,H,D); k,v: (B,Skv,H,D);
    returns (B,H,Sq), (B,H,Sq), (B,H,Sq,D) in float32."""
    d = q.shape[-1]
    scale = scale or d**-0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    scores = scores + _mask(q_pos[:, None], kv_pos[:, None], causal=causal,
                            window=window)
    top = scores.amax(dim=-1)
    e = torch.exp(scores - top[..., None])
    acc = torch.einsum("bhqk,bkhd->bhqd", e.to(v.dtype), v).float()
    return top, e.sum(dim=-1), acc


def flash_attention(q, k, v, q_pos, kv_pos, *, causal=True, window=None,
                    kv_len=None, scale=None, q_chunk=1024, kv_chunk=1024):
    """Online-softmax chunked attention.

    Peak intermediate: (B, H, q_chunk, kv_chunk) scores, independent of
    sequence length.  Exact up to rounding (fp32 running max and
    denominator).  Sequence dims are padded to chunk multiples and the
    padding masked through the positions (query −1, key `PAD_KV_POS`).
    """
    b, sq, h, d = q.shape
    skv = k.shape[1]
    scale = scale or d**-0.5
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    pq = (-sq) % q_chunk
    pkv = (-skv) % kv_chunk
    if pq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pq))
        q_pos = torch.nn.functional.pad(q_pos, (0, pq), value=-1)
    if pkv:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pkv))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pkv))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pkv), value=PAD_KV_POS)
    kvl = kv_len[:, None] if kv_len is not None else None
    outs = []
    for i in range(0, q.shape[1], q_chunk):
        qc, qpc = q[:, i:i + q_chunk], q_pos[:, i:i + q_chunk]
        m_run = torch.full((b, h, q_chunk), NEG_INF, dtype=torch.float32,
                           device=q.device)
        l_run = torch.zeros((b, h, q_chunk), dtype=torch.float32,
                            device=q.device)
        acc = torch.zeros((b, h, q_chunk, d), dtype=torch.float32,
                          device=q.device)
        for j in range(0, k.shape[1], kv_chunk):
            kc, vc = k[:, j:j + kv_chunk], v[:, j:j + kv_chunk]
            kpc = kv_pos[:, j:j + kv_chunk]
            s = torch.einsum("bqhd,bkhd->bhqk", qc.float(), kc.float()) * scale
            s = s + _mask(qpc[:, None], kpc[:, None], causal=causal,
                          window=window, kv_len=kvl)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(s - m_new[..., None])
            l_run = l_run * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(vc.dtype).float(), vc.float())
            m_run = m_new
        out = acc / torch.clamp(l_run, min=1e-30)[..., None]
        outs.append(out.transpose(1, 2))  # (B, qc, H, D)
    return torch.cat(outs, dim=1)[:, :sq].to(q.dtype)


def gqa_repeat(kv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, K, D) → (B, S, H, D), each KV head repeated H/K times in
    head order."""
    b, s, k, d = kv.shape
    if k == n_heads:
        return kv
    reps = n_heads // k
    return kv[:, :, :, None, :].expand(b, s, k, reps, d).reshape(
        b, s, n_heads, d)


def attend(q, k, v, q_pos, kv_pos, *, causal=True, window=None, kv_len=None,
           impl="flash", q_chunk=1024, kv_chunk=1024):
    """Dispatch full-attention math; q (B,Sq,H,D), k/v already H heads."""
    if impl == "dense" or q.shape[1] == 1:
        return dense_attention(q, k, v, q_pos, kv_pos, causal=causal,
                               window=window, kv_len=kv_len)
    return flash_attention(q, k, v, q_pos, kv_pos, causal=causal,
                           window=window, kv_len=kv_len, q_chunk=q_chunk,
                           kv_chunk=kv_chunk)
