"""The chunked RWKV-6 WKV forward as a hand-written CUDA kernel (B7);
replaces the TPU kernel `repro.kernels.rwkv_wkv.kernel.wkv_pallas`.

`wkv_fused` is the wrapper of ``csrc/wkv.cu``: for CUDA tensors it
launches the kernel or raises (a wrong dtype, device or shape, a
non-contiguous input, a head dim or a chunk the kernel does not take, a
build failure or a launch error); for tensors on the CPU it runs
`ref.wkv_chunked_plain`, the kernel's plain twin.  There is no fallback
from the one to the other.  ``wkv_fused.launches`` counts kernel launches.
The launch geometry follows from (B, H, D) by one rule in the source
(`launch_geometry` reports it).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import load_library, refuse_grad
from repro_torch.kernels.rwkv_wkv.ref import WKV_CHUNK, wkv_chunked_plain

_SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv.cu"


@functools.cache
def _library():
    lib = load_library("wkv", _SOURCE)
    lib.wkv_chunked_forward.restype = ctypes.c_int
    lib.wkv_chunked_forward.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.wkv_launch_geometry.restype = None
    lib.wkv_launch_geometry.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.wkv_max_head_dim.restype = ctypes.c_int
    lib.wkv_max_head_dim.argtypes = []
    lib.wkv_chunk.restype = ctypes.c_int
    lib.wkv_chunk.argtypes = []
    return lib


def build_wkv() -> None:
    """Compile (or load the cached build of) the CUDA kernel now."""
    _library()


def launch_geometry(b: int, h: int, d: int) -> dict:
    """The launch `wkv_fused` makes at (B, ·, H, D), by the one rule in
    ``csrc/wkv.cu``: blocks, threads a block, dynamic shared memory
    (bytes) and the depth of the chunk ring."""
    out = (ctypes.c_int * 4)()
    _library().wkv_launch_geometry(b, h, d, out)
    return dict(zip(("blocks", "threads", "smem_bytes", "stages"), out))


def _check_launch(r, k, v, lw, u, state, chunk: int):
    """Validate what the kernel takes; returns (lib, (B, S, H, D))."""
    if not r.is_cuda:
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got r on "
                         f"{r.device}")
    named = {"r": r, "k": k, "v": v, "lw": lw, "u": u, "state": state}
    for name, t in named.items():
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if r.dim() != 4:
        raise ValueError(f"r must be (B, S, H, D), got {tuple(r.shape)}")
    b, s, h, d = r.shape
    for name in ("k", "v", "lw"):
        if named[name].shape != r.shape:
            raise ValueError(f"{name} {tuple(named[name].shape)} is not r's "
                             f"{tuple(r.shape)}")
    if u.shape != (h, d):
        raise ValueError(f"u {tuple(u.shape)} is not ({h}, {d})")
    if state.shape != (b, h, d, d):
        raise ValueError(f"state {tuple(state.shape)} is not "
                         f"({b}, {h}, {d}, {d})")
    lib = _library()
    if chunk != lib.wkv_chunk():
        raise ValueError(f"the CUDA kernel takes chunk {lib.wkv_chunk()}, "
                         f"got {chunk}")
    if not 1 <= d <= lib.wkv_max_head_dim():
        raise ValueError(f"head dim {d} outside the kernel's range "
                         f"1..{lib.wkv_max_head_dim()}")
    return lib, (b, s, h, d)


def _launch_cuda(r, k, v, lw, u, state, chunk):
    refuse_grad("wkv_fused", r, k, v, lw, u, state)
    lib, (b, s, h, d) = _check_launch(r, k, v, lw, u, state, chunk)
    y = torch.empty_like(r)
    s_out = torch.empty_like(state)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wkv_chunked_forward(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            u.data_ptr(), state.data_ptr(), y.data_ptr(), s_out.data_ptr(),
            b, s, h, d, stream)
    if err != 0:
        raise RuntimeError(f"wkv CUDA launch failed: cudaError {err}")
    wkv_fused.launches += 1
    return y, s_out


def wkv_fused(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              lw: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
              chunk: int = WKV_CHUNK):
    """Chunked WKV forward.  r/k/v/lw (B,S,H,D) float32, u (H,D), state
    (B,H,D,D) float32 → (y (B,S,H,D), final state (B,H,D,D)).

    A CUDA tensor goes to the CUDA kernel; a CPU tensor to
    `wkv_chunked_plain` (module docstring).  The kernel has no backward
    yet: on the card, an input that requires grad under grad mode raises
    (`_build.refuse_grad`)."""
    if r.is_cuda:
        return _launch_cuda(r, k, v, lw, u, state, chunk)
    return wkv_chunked_plain(r, k, v, lw, u, state, chunk)


wkv_fused.launches = 0
