"""Public WKV op; port of `repro.kernels.rwkv_wkv.ops`, forward only.

``impl="cuda"`` runs `kernel.wkv_fused` (the CUDA kernel B7 for CUDA
tensors, its plain twin for CPU tensors); ``impl="plain"`` the plain
chunked twin on any device.  The reference's closed-form backward
(`_wkv_bwd`, XLA in the reference) comes with LM training, as a
`torch.autograd.Function` in plain PyTorch.
"""
from __future__ import annotations

from repro_torch.kernels.rwkv_wkv.kernel import wkv_fused
from repro_torch.kernels.rwkv_wkv.ref import WKV_CHUNK, wkv_chunked_plain


def wkv(r, k, v, lw, u, state, *, chunk: int = WKV_CHUNK,
        impl: str = "cuda"):
    """Chunked WKV forward, (y, final state); see the module docstring."""
    if impl == "cuda":
        return wkv_fused(r, k, v, lw, u, state, chunk=chunk)
    if impl == "plain":
        return wkv_chunked_plain(r, k, v, lw, u, state, chunk)
    raise ValueError(f"unknown WKV impl {impl!r} (want cuda|plain)")
