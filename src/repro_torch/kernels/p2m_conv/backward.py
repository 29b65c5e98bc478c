"""Closed-form backward of the P²M basis sum; port of
`repro.kernels.p2m_conv.backward` (DESIGN.md §4).

The VJP of the premixed accumulation ``raw = Σ_j (X^∘j) @ W̃_j`` is a
short sum of products against powered operands:

    dX = Σ_j j·X^∘(j-1) ⊙ (G @ W̃_jᵀ)
    dW = Σ_{i,j} a_ij · i·|W|^∘(i-1) ⊙ T_j,   T_j = (X^∘j)ᵀ @ G

X is the (M, K) im2col matrix, G the (M, N) cotangent with the epilogue
mask (`epilogue_mask`) already applied by the caller.

`p2m_bwd_dx` and `p2m_bwd_dw` are the wrappers of the hand-written CUDA
kernels (``csrc/p2m_bwd.cu``) that replace the TPU kernels
`p2m_bwd_dx_pallas` and `p2m_bwd_dw_pallas`: for a CUDA tensor each
launches its kernel or raises; for a tensor on the CPU it runs its plain
PyTorch twin (`p2m_bwd_dx_plain`, `p2m_bwd_dw_plain`).  The closed form
uses ``i·|w|^(i-1)``, which at exactly ``w = 0`` differs from autodiff
through ``sign(w)·|w|^i``; the plain twins follow the closed form, like
the kernels.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import load_library, refuse_grad
from repro_torch.kernels.p2m_conv.conv import ceil_to, premix_weights

_SOURCE = Path(__file__).resolve().parent / "csrc" / "p2m_bwd.cu"
#: Shared memory a block may use on an H100 (227 KB), opted in above 48 KB.
_SMEM_MAX = 232_448
#: Blocks of B4's first pass aim at this many; rows per block are whole
#: staging tiles (csrc kDwTileRows), so the split depends on M alone.
_DW_BLOCKS = 1024
_DW_TILE_ROWS = 32


def _compute_dtype(*tensors) -> torch.dtype:
    dtype = torch.float32
    for t in tensors:
        dtype = torch.promote_types(dtype, t.dtype)
    return dtype


# ------------------------------------------------------------ plain twins


def p2m_bwd_dx_plain(g: torch.Tensor, wmix: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """dX (M, K) from g (M, N), premixed ``wmix`` (dx, K, N) and x (M, K),
    in the inputs' dtype (at least float32), the reference's order."""
    dtype = _compute_dtype(g, wmix, x)
    g, wmix, x = g.to(dtype), wmix.to(dtype), x.to(dtype)
    dx = wmix.shape[0]
    gx = torch.zeros_like(x)
    xpow = torch.ones_like(x)
    for j in range(1, dx + 1):
        gx = gx + float(j) * xpow * (g @ wmix[j - 1].T)
        if j < dx:
            xpow = xpow * x
    return gx


def p2m_bwd_dw_plain(g: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
                     coeffs) -> torch.Tensor:
    """dW (K, N) from g (M, N), the clipped weights w (K, N) and x (M, K),
    in the inputs' dtype (at least float32), the reference's order."""
    dtype = _compute_dtype(g, w, x)
    g, w, x = g.to(dtype), w.to(dtype), x.to(dtype)
    dw = len(coeffs)
    dx = len(coeffs[0])
    t_list = []
    xp = x
    for j in range(1, dx + 1):
        t_list.append(xp.T @ g)  # T_j (K, N)
        if j < dx:
            xp = xp * x
    aw = torch.abs(w)
    gw = torch.zeros_like(w)
    wpow = torch.ones_like(aw)
    for i in range(1, dw + 1):
        u_i = torch.zeros_like(w)
        for j in range(1, dx + 1):
            a_ij = float(coeffs[i - 1][j - 1])
            if a_ij != 0.0:
                u_i = u_i + a_ij * t_list[j - 1]
        gw = gw + float(i) * wpow * u_i
        if i < dw:
            wpow = wpow * aw
    return gw


def p2m_backward_plain(g: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
                       coeffs) -> tuple[torch.Tensor, torch.Tensor]:
    """Closed-form (dX, dW) of the raw basis sum in plain PyTorch: the
    port of `p2m_backward_jnp`."""
    wmix = premix_weights(w, coeffs)
    return p2m_bwd_dx_plain(g, wmix, x), p2m_bwd_dw_plain(g, w, x, coeffs)


def epilogue_mask(raw: torch.Tensor, shift: torch.Tensor, *, mode: str,
                  full_scale: float) -> torch.Tensor:
    """d out / d raw of the CDS/ADC epilogue, elementwise.

    "raw" passes gradients through; "relu" masks the clamp's saturated
    regions; "quant" uses the straight-through estimator, the gradient of
    the soft-clipped ("relu") path.
    """
    if mode == "raw":
        return torch.ones_like(raw)
    v = raw + shift.to(torch.float32)
    return ((v > 0.0) & (v < full_scale)).to(torch.float32)


# ------------------------------------------------------------ CUDA kernels


@functools.cache
def _library():
    lib = load_library("p2m_bwd", _SOURCE)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.p2m_bwd_dx.restype = i32
    lib.p2m_bwd_dx.argtypes = [vp] * 4 + [i64, i32, i32, i32, vp]
    lib.p2m_bwd_dw.restype = i32
    lib.p2m_bwd_dw.argtypes = ([vp] * 5 + [i64, i32, i32, i32, i32, vp, i32,
                                          i64, vp])
    lib.p2m_bwd_max_degree.restype = i32
    lib.p2m_bwd_max_degree.argtypes = []
    for fn in (lib.p2m_bwd_dx_smem, lib.p2m_bwd_dw_smem):
        fn.restype = i64
        fn.argtypes = [i32, i32, i32]
    return lib


def build_p2m_bwd() -> None:
    """Compile (or load the cached build of) the CUDA kernels now."""
    _library()


def _check_cuda(device: torch.device, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, g on {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_shapes(g, w, x) -> tuple[int, int, int]:
    if g.dim() != 2 or x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"g {tuple(g.shape)}, w {tuple(w.shape)}, x "
                         f"{tuple(x.shape)}: expected (M, N), (K, N), (M, K)")
    m, n = g.shape
    k = x.shape[1]
    if x.shape[0] != m or w.shape != (k, n) or m < 1:
        raise ValueError(f"g {tuple(g.shape)}, w {tuple(w.shape)}, x "
                         f"{tuple(x.shape)}: expected (M, N), (K, N), (M, K)")
    return m, k, n


def _check_degree(lib, name: str, degree: int) -> None:
    top = lib.p2m_bwd_max_degree()
    if not 1 <= degree <= top:
        raise ValueError(f"{name}={degree} outside the kernels' compiled "
                         f"range 1..{top}")


def _check_smem(nbytes: int, what: str) -> None:
    if nbytes > _SMEM_MAX:
        raise ValueError(f"{what} needs {nbytes} bytes of shared memory, "
                         f"more than a block has ({_SMEM_MAX})")


def _launch_dx(g, wmix, x):
    refuse_grad("p2m_bwd_dx", g, wmix, x)
    if wmix.dim() != 3:
        raise ValueError(f"wmix {tuple(wmix.shape)} is not (dx, K, N)")
    m, k, n = _check_shapes(g, wmix[0], x)
    _check_cuda(g.device, g=g, wmix=wmix, x=x)
    lib = _library()
    dx = wmix.shape[0]
    _check_degree(lib, "dx", dx)
    _check_smem(lib.p2m_bwd_dx_smem(dx, k, n), "dX")
    out = torch.empty_like(x)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.p2m_bwd_dx(g.data_ptr(), wmix.data_ptr(), x.data_ptr(),
                             out.data_ptr(), m, k, n, dx, stream)
    if err != 0:
        raise RuntimeError(f"p2m_bwd_dx CUDA launch failed: cudaError {err}")
    p2m_bwd_dx.launches += 1
    return out


def dw_split(m: int) -> tuple[int, int]:
    """(blocks, rows per block) of B4's first pass for M rows: about
    ``_DW_BLOCKS`` blocks of whole staging tiles, a function of M alone."""
    rows = ceil_to(max(1, -(-m // _DW_BLOCKS)), _DW_TILE_ROWS)
    return -(-m // rows), rows


def _launch_dw(g, w, x, coeffs):
    refuse_grad("p2m_bwd_dw", g, w, x)
    m, k, n = _check_shapes(g, w, x)
    _check_cuda(g.device, g=g, w=w, x=x)
    lib = _library()
    dw, dx = len(coeffs), len(coeffs[0])
    _check_degree(lib, "dw", dw)
    _check_degree(lib, "dx", dx)
    _check_smem(lib.p2m_bwd_dw_smem(dx, k, n), "dW")
    blocks, rows = dw_split(m)
    flat = (ctypes.c_float * (dw * dx))(
        *[float(coeffs[i][j]) for i in range(dw) for j in range(dx)])
    partial = torch.empty((blocks, dx, k, n), dtype=torch.float32,
                          device=g.device)
    out = torch.empty_like(w)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.p2m_bwd_dw(x.data_ptr(), g.data_ptr(), w.data_ptr(),
                             partial.data_ptr(), out.data_ptr(), m, k, n, dx,
                             dw, flat, blocks, rows, stream)
    if err != 0:
        raise RuntimeError(f"p2m_bwd_dw CUDA launch failed: cudaError {err}")
    p2m_bwd_dw.launches += 1
    return out


def p2m_bwd_dx(g: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
               coeffs) -> torch.Tensor:
    """dX (M, K) of the raw basis sum: g (M, N) masked cotangent, ``w``
    the (K, N) weights or their premix W̃ (dx, K, N) from
    `premix_weights`, x (M, K) the im2col matrix.

    A CUDA tensor goes to the CUDA kernel, which raises on a wrong dtype,
    a non-contiguous input, a device mismatch, dx outside 1..4 and an
    input that requires grad under grad mode (`_build.refuse_grad`).  A
    CPU tensor goes to `p2m_bwd_dx_plain`.  ``p2m_bwd_dx.launches`` counts
    kernel launches.
    """
    wmix = w if w.dim() == 3 else premix_weights(w, coeffs)
    if g.is_cuda:
        return _launch_dx(g, wmix, x)
    return p2m_bwd_dx_plain(g, wmix, x)


def p2m_bwd_dw(g: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
               coeffs) -> torch.Tensor:
    """dW (K, N) of the raw basis sum: g (M, N) masked cotangent, w (K, N)
    clipped weights, x (M, K) the im2col matrix.

    A CUDA tensor goes to the CUDA kernels (a split-M pass and a fixed-order
    sum, no atomics), which raise on a wrong dtype, a non-contiguous input,
    a device mismatch, a degree outside 1..4 and an input that requires
    grad under grad mode (`_build.refuse_grad`).  A CPU tensor goes to
    `p2m_bwd_dw_plain`.  ``p2m_bwd_dw.launches`` counts kernel launches
    (one per call, for the pair of passes).
    """
    if g.is_cuda:
        return _launch_dw(g, w, x, coeffs)
    return p2m_bwd_dw_plain(g, w, x, coeffs)


p2m_bwd_dx.launches = 0
p2m_bwd_dw.launches = 0
