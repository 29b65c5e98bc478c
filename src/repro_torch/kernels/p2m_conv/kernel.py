"""Patch-level P²M product (B6); port of `repro.kernels.p2m_conv.kernel`.

With the pixel transfer fit as ``g(w,x) = Σ_{i,j≥1} a_ij w^i x^j``, the
P²M im2col product

    out[m,n] = epilogue(Σ_k sign(W[k,n]) · g(|W[k,n]|, X[m,k]) + shift)

factorizes into ``Σ_ij a_ij · (X^∘j) @ (sign(W) ⊙ |W|^∘i)``.  Zero
padding is exact: every basis term carries a ``w^i x^j`` factor with
i, j ≥ 1.

`p2m_matmul_fused` is the wrapper of the hand-written CUDA kernel
(``csrc/p2m_matmul.cu``) that replaces the TPU kernel
`p2m_matmul_pallas`: persistent blocks over row tiles of x, each tile
copied while the one before computes (`matmul_tiling` is its one launch
rule, `matmul_launch` reports it).  For a CUDA tensor it launches the
kernel or raises; for a tensor on the CPU it runs `p2m_matmul_raw_plain`
and the epilogue, the plain twin that `ops.p2m_matmul_plain` also is.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import load_library, refuse_grad
from repro_torch.kernels.p2m_conv.conv import (
    _CHUNK,
    _GEOMETRY_KEYS,
    _MODES,
    SMEM_MAX,
    _epilogue_values,
    blocks_per_sm,
    ceil_to,
    one_wave_grid,
)

_SOURCE = Path(__file__).resolve().parent / "csrc" / "p2m_matmul.cu"
#: Most rows a tile takes, most outputs a thread keeps live, rows a thread
#: computes at an N tile of one register chunk, most ring slots (csrc
#: kMaxRows, kMaxTileChunks · kChunk, kRowsPerThread, kMaxSlots).
MATMUL_MAX_ROWS = 256
MATMUL_MAX_TILE = 32
MATMUL_ROWS_PER_THREAD = 2
MATMUL_MAX_SLOTS = 2
#: Registers a thread at most: the launch bounds, two blocks of 256
#: threads an SM.
MATMUL_REGISTERS = 128
#: (block_m, block_n, block_k) when none are given: 128-row tiles, all of
#: N up to 32, and all of K up to 128 (a tile one span: one bulk copy).
MATMUL_DEFAULT_BLOCKS = (128, 32, 128)


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


def matmul_smem_bytes(block_m: int, block_k: int, dx: int, n_tile: int,
                      k: int, slots: int | None = None) -> int:
    """Shared memory of one block (csrc ``matmul_smem``) at ``slots`` ring
    slots (by default `matmul_slots`): where ``block_k`` ≥ K, the premixed
    dx × K × ``n_tile`` W̃ once and each slot ``block_m`` rows of K floats;
    else each slot ``block_m`` rows of ``block_k | 1`` floats (odd: no
    bank conflict) and that K tile's dx × ``block_k`` × ``n_tile`` W̃.
    A slot's x is padded to 16 bytes."""
    if slots is None:
        slots = matmul_slots(block_m, block_k, dx, n_tile, k)
    tile = ceil_to(n_tile, _CHUNK)
    ld = k if block_k >= k else block_k | 1
    xs = ceil_to(block_m * ld, 4)
    if block_k >= k:
        return 4 * (dx * k * tile + slots * xs)
    return 4 * slots * (xs + dx * block_k * tile)


def matmul_slots(block_m: int, block_k: int, dx: int, n_tile: int,
                 k: int) -> int:
    """Ring slots of a block: two where they fit a block's shared memory
    (`SMEM_MAX`), so the next tile's copy flies while one computes, else
    one."""
    fits = matmul_smem_bytes(block_m, block_k, dx, n_tile, k,
                             slots=MATMUL_MAX_SLOTS) <= SMEM_MAX
    return MATMUL_MAX_SLOTS if fits else 1


def matmul_tiling(m: int, k: int, n: int, dx: int, *, block_m: int,
                  block_n: int | None, block_k: int) -> dict:
    """B6's one launch rule, from the shape and the blocks alone: the N
    tile (`matmul_tile`), ``block_k`` at most K, the ring slots
    (`matmul_slots`), the row tiles of ``block_m`` rows, threads (a
    thread for each `MATMUL_ROWS_PER_THREAD` rows at an N tile of 8, one
    at wider tiles, in whole warps), the N tiles in y, and the persistent
    blocks in x: one wave of the card (`conv.one_wave_grid`), each block
    a contiguous run of row tiles, the first ``tiles % blocks_x`` one
    more.  At (100,352, 75, 8) and the default blocks: 784 tiles of 128
    rows (each one 38,400-byte span), 64 threads, 84,000 bytes, two
    blocks an SM, 264 blocks.  Raises `ValueError` where one slot does
    not fit a block."""
    if not 1 <= block_m <= MATMUL_MAX_ROWS or block_k < 1:
        raise ValueError(f"block_m={block_m} outside 1..{MATMUL_MAX_ROWS} "
                         f"or block_k={block_k} < 1")
    n_tile = matmul_tile(n, block_n)
    block_k = min(block_k, k)
    slots = matmul_slots(block_m, block_k, dx, n_tile, k)
    smem = matmul_smem_bytes(block_m, block_k, dx, n_tile, k, slots=slots)
    if smem > SMEM_MAX:
        raise ValueError(f"blocks ({block_m}, {n_tile}, {block_k}) need "
                         f"{smem} bytes of shared memory, more than a block "
                         f"has ({SMEM_MAX})")
    per_thread = MATMUL_ROWS_PER_THREAD if n_tile <= _CHUNK else 1
    threads = ceil_to(-(-block_m // per_thread), 32)
    tiles = -(-m // block_m)
    blocks_y = -(-n // n_tile)
    per_sm = blocks_per_sm(smem, threads, MATMUL_REGISTERS)
    return {"block_m": block_m, "n_tile": n_tile, "block_k": block_k,
            "slots": slots, "tiles": tiles, "threads": threads,
            "smem_bytes": smem, "blocks_per_sm": per_sm,
            "blocks_x": one_wave_grid(tiles, per_sm, blocks_y),
            "blocks_y": blocks_y}


def matmul_launch(m: int, k: int, n: int, dx: int, *,
                  block_m: int | None = None, block_n: int | None = None,
                  block_k: int | None = None) -> dict:
    """The launch `p2m_matmul_fused` makes at these sizes and blocks
    (`MATMUL_DEFAULT_BLOCKS` where None): `matmul_tiling`'s tiles and ring
    slots, and the C entry's report: blocks in x and y, threads, dynamic
    shared memory, rows a thread, registers and local memory (spills) a
    thread, blocks an SM (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`).
    Launches nothing; needs the card."""
    dm, dn, dk = MATMUL_DEFAULT_BLOCKS
    t = matmul_tiling(m, k, n, dx, block_m=block_m or dm,
                      block_n=block_n or dn, block_k=block_k or dk)
    out = (ctypes.c_int * len(_GEOMETRY_KEYS))()
    err = _library().p2m_matmul_geometry(
        m, k, n, dx, t["block_m"], t["n_tile"], t["block_k"], t["blocks_x"],
        t["slots"], out)
    if err != 0:
        raise RuntimeError(f"p2m_matmul_geometry: cudaError {err}")
    geo = dict(zip(_GEOMETRY_KEYS, out))
    geo["rows_per_thread"] = geo.pop("pixels_per_thread")
    return {"block_m": t["block_m"], "n_tile": t["n_tile"],
            "block_k": t["block_k"], "slots": t["slots"],
            "tiles": t["tiles"], **geo}


@functools.cache
def _library():
    lib = load_library("p2m_matmul", _SOURCE)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.p2m_matmul_forward.restype = i32
    lib.p2m_matmul_forward.argtypes = (
        [vp] * 5 + [ctypes.c_longlong] + [i32] * 4 + [vp] + [i32] * 6
        + [ctypes.c_float, i32, ctypes.c_float, vp])
    lib.p2m_matmul_geometry.restype = i32
    lib.p2m_matmul_geometry.argtypes = (
        [ctypes.c_longlong] + [i32] * 8 + [ctypes.POINTER(i32)])
    lib.p2m_matmul_max_degree.restype = i32
    lib.p2m_matmul_max_degree.argtypes = []
    return lib


def build_p2m_matmul() -> None:
    """Compile (or load the cached build of) the CUDA kernel now."""
    _library()


def _check_launch(x, w, shift, *, coeffs, mode, blocks):
    """Validate what the kernel takes; returns the library and the
    tiling (`matmul_tiling`)."""
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
    block_m, block_n, block_k = blocks
    lib = _library()
    top = lib.p2m_matmul_max_degree()
    dw, dx = len(coeffs), len(coeffs[0])
    for name, degree in (("dw", dw), ("dx", dx)):
        if not 1 <= degree <= top:
            raise ValueError(f"{name}={degree} outside the kernel's "
                             f"compiled range 1..{top}")
    (m, k), n = x.shape, w.shape[1]
    return lib, matmul_tiling(m, k, n, dx, block_m=block_m, block_n=block_n,
                              block_k=block_k)


def _launch_cuda(x, w, shift, *, coeffs, mode, v_lsb, max_count, want_raw,
                 block_m, block_n, block_k):
    refuse_grad("p2m_matmul_fused", x, w, shift)
    dm, dn, dk = MATMUL_DEFAULT_BLOCKS
    m, k = x.shape
    n = w.shape[1]
    lib, t = _check_launch(x, w, shift, coeffs=coeffs, mode=mode,
                           blocks=(block_m or dm, block_n or dn,
                                   block_k or dk))
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
            t["block_m"], t["n_tile"], t["block_k"], t["blocks_x"],
            t["slots"], _MODES[mode], v_lsb, max_count, max_count * v_lsb,
            stream)
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
    None): ``block_m`` rows of x a tile (≤ 256; a persistent block walks
    several), ``block_n`` outputs a block (≤ 32), ``block_k`` rows of K
    copied at a time.

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
