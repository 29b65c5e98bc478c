"""Patch-level P²M product (B6); port of `repro.kernels.p2m_conv.kernel`.

With the pixel transfer fit as ``g(w,x) = Σ_{i,j≥1} a_ij w^i x^j``, the
P²M im2col product

    out[m,n] = epilogue(Σ_k sign(W[k,n]) · g(|W[k,n]|, X[m,k]) + shift)

factorizes into ``Σ_ij a_ij · (X^∘j) @ (sign(W) ⊙ |W|^∘i)``.  Zero
padding is exact: every basis term carries a ``w^i x^j`` factor with
i, j ≥ 1.

`p2m_matmul_fused` is the wrapper of the hand-written CUDA kernel
(``csrc/p2m_matmul.cu``) that replaces the TPU kernel
`p2m_matmul_pallas`: for a CUDA tensor it launches the kernel or raises;
for a tensor on the CPU it runs `p2m_matmul_raw_plain` and the epilogue,
the plain twin that `ops.p2m_matmul_plain` also is.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import load_library, refuse_grad
from repro_torch.kernels.p2m_conv.conv import (
    _CHUNK,
    _MODES,
    SMEM_MAX,
    _epilogue_values,
    ceil_to,
)

_SOURCE = Path(__file__).resolve().parent / "csrc" / "p2m_matmul.cu"
#: Most rows (threads) a block takes, most outputs a thread keeps live
#: (csrc kMaxThreads, kMaxTileChunks · kChunk).
MATMUL_MAX_ROWS = 256
MATMUL_MAX_TILE = 32
#: (block_m, block_n, block_k) when none are given.
MATMUL_DEFAULT_BLOCKS = (128, 32, 64)


def p2m_matmul_raw_plain(x: torch.Tensor, w: torch.Tensor,
                         coeffs) -> torch.Tensor:
    """Pre-epilogue basis sum (M, N) in fp32: dw·dx products of the
    powered operands, the reference's order (`p2m_matmul_jnp`)."""
    dw, dx = len(coeffs), len(coeffs[0])
    x32 = x.to(torch.float32)
    sgn = torch.sign(w).to(torch.float32)
    aw = torch.abs(w).to(torch.float32)
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    wp = aw
    for i in range(1, dw + 1):
        wsig = sgn * wp
        xp = x32
        for j in range(1, dx + 1):
            a_ij = float(coeffs[i - 1][j - 1])
            if a_ij != 0.0:
                acc = acc + a_ij * (xp @ wsig)
            if j < dx:
                xp = xp * x32
        if i < dw:
            wp = wp * aw
    return acc


def matmul_tile(n: int, block_n: int | None) -> int:
    """Outputs a block computes: ``block_n`` (all of N by default) in
    whole register chunks, at most `MATMUL_MAX_TILE`."""
    want = n if block_n is None else min(n, block_n)
    return min(ceil_to(want, _CHUNK), MATMUL_MAX_TILE)


def matmul_smem_bytes(block_m: int, block_k: int, dx: int,
                      n_tile: int) -> int:
    """Shared memory of one block (csrc ``matmul_smem``): ``block_m`` rows
    of x a K tile at a time (rows padded by one float) and the premixed
    dx × ``block_k`` × ``n_tile`` slab of W̃."""
    return 4 * (ceil_to(block_m * (block_k + 1), 4)
                + dx * block_k * ceil_to(n_tile, _CHUNK))


@functools.cache
def _library():
    lib = load_library("p2m_matmul", _SOURCE)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.p2m_matmul_forward.restype = i32
    lib.p2m_matmul_forward.argtypes = (
        [vp] * 5 + [ctypes.c_longlong] + [i32] * 4 + [vp] + [i32] * 4
        + [ctypes.c_float, i32, ctypes.c_float, vp])
    lib.p2m_matmul_max_degree.restype = i32
    lib.p2m_matmul_max_degree.argtypes = []
    return lib


def build_p2m_matmul() -> None:
    """Compile (or load the cached build of) the CUDA kernel now."""
    _library()


def _check_launch(x, w, shift, *, coeffs, mode, block_m, block_k, n_tile):
    """Validate what the kernel takes; returns the library."""
    for name, t in (("x", x), ("w", w), ("shift", shift)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] \
            or x.shape[0] < 1:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)}: expected "
                         f"(M, K), (K, N)")
    if shift.shape != (w.shape[1],):
        raise ValueError(f"shift {tuple(shift.shape)} is not "
                         f"({w.shape[1]},)")
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if not 1 <= block_m <= MATMUL_MAX_ROWS or block_k < 1:
        raise ValueError(f"block_m={block_m} outside 1..{MATMUL_MAX_ROWS} "
                         f"or block_k={block_k} < 1")
    lib = _library()
    top = lib.p2m_matmul_max_degree()
    dw, dx = len(coeffs), len(coeffs[0])
    for name, degree in (("dw", dw), ("dx", dx)):
        if not 1 <= degree <= top:
            raise ValueError(f"{name}={degree} outside the kernel's "
                             f"compiled range 1..{top}")
    smem = matmul_smem_bytes(block_m, block_k, dx, n_tile)
    if smem > SMEM_MAX:
        raise ValueError(f"blocks ({block_m}, {n_tile}, {block_k}) need "
                         f"{smem} bytes of shared memory, more than a block "
                         f"has ({SMEM_MAX})")
    return lib


def _launch_cuda(x, w, shift, *, coeffs, mode, v_lsb, max_count, want_raw,
                 block_m, block_n, block_k):
    refuse_grad("p2m_matmul_fused", x, w, shift)
    dm, dn, dk = MATMUL_DEFAULT_BLOCKS
    m, k = x.shape
    n = w.shape[1]
    block_m = block_m or dm
    block_k = min(block_k or dk, k)
    n_tile = matmul_tile(n, block_n or dn)
    lib = _check_launch(x, w, shift, coeffs=coeffs, mode=mode,
                        block_m=block_m, block_k=block_k, n_tile=n_tile)
    dw, dx = len(coeffs), len(coeffs[0])
    flat = (ctypes.c_float * (dw * dx))(
        *[float(coeffs[i][j]) for i in range(dw) for j in range(dx)])
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    raw = torch.empty_like(out) if want_raw else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.p2m_matmul_forward(
            x.data_ptr(), w.data_ptr(), shift.data_ptr(), out.data_ptr(),
            raw.data_ptr() if want_raw else None, m, k, n, dw, dx, flat,
            block_m, n_tile, block_k, _MODES[mode], v_lsb, max_count,
            max_count * v_lsb, stream)
    if err != 0:
        raise RuntimeError(f"p2m_matmul CUDA launch failed: cudaError {err}")
    p2m_matmul_fused.launches += 1
    return (out, raw) if want_raw else out


def p2m_matmul_fused(x: torch.Tensor, w: torch.Tensor, shift: torch.Tensor,
                     *, coeffs, mode: str = "relu",
                     v_lsb: float = 1.0 / 255.0, max_count: int = 255,
                     want_raw: bool = False, block_m: int | None = None,
                     block_n: int | None = None,
                     block_k: int | None = None):
    """P²M product: x (M, K) in [0, 1], signed w (K, N), shift (N,) volts,
    all float32 → (M, N) through the ``mode`` epilogue, plus the
    pre-epilogue accumulation when ``want_raw``.

    Blocks (the tuner's `get_matmul_blocks`; `MATMUL_DEFAULT_BLOCKS` when
    None): ``block_m`` rows of x a block (one thread a row, ≤ 256),
    ``block_n`` outputs a block (≤ 32), ``block_k`` rows of K staged at a
    time.

    A CUDA tensor goes to the CUDA kernel, which raises on a wrong dtype,
    device, shape or layout, a degree above its compiled maximum, blocks
    it does not take, and an input that requires grad under grad mode
    (`_build.refuse_grad`).  A CPU tensor goes to the plain twin.
    ``p2m_matmul_fused.launches`` counts kernel launches.
    """
    if x.is_cuda:
        return _launch_cuda(x, w, shift, coeffs=coeffs, mode=mode,
                            v_lsb=v_lsb, max_count=max_count,
                            want_raw=want_raw, block_m=block_m,
                            block_n=block_n, block_k=block_k)
    raw = p2m_matmul_raw_plain(x, w, coeffs)
    out = _epilogue_values(raw, shift.to(torch.float32), mode=mode,
                           v_lsb=v_lsb, max_count=max_count)
    return (out, raw) if want_raw else out


p2m_matmul_fused.launches = 0
