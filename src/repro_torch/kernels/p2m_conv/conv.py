"""Fused implicit-im2col P²M convolution; port of
`repro.kernels.p2m_conv.conv`.

With ``g(w,x) = Σ_ij a_ij w^i x^j`` the conv accumulation is

    raw = Σ_j (X^∘j) @ W̃_j,   W̃_j := Σ_i a_ij · sign(W) ⊙ |W|^∘i

W̃ is weight-sized and computed outside the kernel (`premix_weights`,
`premix_rows`), once per weight tree.  Per kernel row ``ki`` the conv is
one contraction ``[x, x², …] @ W̃[ki]`` over that row's k·C patch values,
then the CDS/ADC epilogue (BN pre-load shift, counter ReLU clamp,
optional integer-exact quantization).  No patch tensor is formed.

`p2m_conv_fused` is the wrapper of the hand-written CUDA kernel
(``csrc/p2m_conv.cu``) that replaces the TPU kernel `p2m_conv_pallas`:
for a CUDA tensor it launches the kernel or raises; for a tensor on the
CPU it runs `p2m_conv_premixed_plain`, the kernel's plain PyTorch twin.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import load_library

_SOURCE = Path(__file__).resolve().parent / "csrc" / "p2m_conv.cu"
_MODES = {"raw": 0, "relu": 1, "quant": 2}
#: Shared memory a block may use for its N range of W̃ without opting in.
_SMEM_BYTES = 48 * 1024
_CHUNK = 8  # outputs a thread keeps in registers at a time (csrc kChunk)


def conv_out_spatial(size: int, kernel: int, stride: int) -> int:
    """VALID conv output extent."""
    return (size - kernel) // stride + 1


def ceil_to(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m``."""
    return -(-x // m) * m


def premix_weights(w: torch.Tensor, coeffs) -> torch.Tensor:
    """Fold the pixel-polynomial w-powers into the weights.

    w: (K, N) signed weights; coeffs: (dw, dx) nested floats.  Returns W̃
    of shape (dx, K, N) with ``W̃[j-1] = Σ_i a_ij sign(w)|w|^i``.
    """
    w = w.to(torch.float32)
    dw = len(coeffs)
    dx = len(coeffs[0])
    sgn = torch.sign(w)
    aw = torch.abs(w)
    pow_i = []  # sign(w)·|w|^i for i = 1..dw
    wp = aw
    for i in range(1, dw + 1):
        pow_i.append(sgn * wp)
        if i < dw:
            wp = wp * aw
    return torch.stack(
        [sum(float(coeffs[i][j]) * pow_i[i] for i in range(dw))
         for j in range(dx)],
        dim=0,
    )


def premix_rows(w: torch.Tensor, coeffs, kernel: int) -> torch.Tensor:
    """W̃ in the per-kernel-row layout the conv takes: (k, dx·k·C, N),
    rows ordered (j, kw, c) to match the power-concat column order."""
    wmix = premix_weights(w, coeffs)  # (dx, K, N)
    dx, kk, n = wmix.shape
    kc = kk // kernel
    return (wmix.reshape(dx, kernel, kc, n).permute(1, 0, 2, 3)
            .reshape(kernel, dx * kc, n).contiguous())


def _power_concat(x: torch.Tensor, dx: int) -> torch.Tensor:
    """[x, x∘x, …, x^∘dx] along the last axis."""
    xs = [x]
    xp = x
    for _ in range(dx - 1):
        xp = xp * x
        xs.append(xp)
    return torch.cat(xs, dim=-1) if dx > 1 else x


def _epilogue_values(raw: torch.Tensor, shift: torch.Tensor, *, mode: str,
                     v_lsb: float, max_count: int) -> torch.Tensor:
    """Shared CDS/ADC epilogue on an fp32 accumulation."""
    if mode == "raw":
        return raw + shift
    if mode == "relu":
        return torch.clamp(raw + shift, 0.0, max_count * v_lsb)
    if mode == "quant":
        # Divide by a tensor on raw's device: CUDA turns division by a
        # host scalar into a multiply by its reciprocal.
        lsb = torch.tensor(v_lsb, dtype=torch.float32, device=raw.device)
        counts = torch.round(raw / lsb) + torch.round(shift / lsb)
        return torch.clamp(counts, 0.0, float(max_count)) * v_lsb
    raise ValueError(f"unknown mode {mode!r}")


def im2col_slices(images: torch.Tensor, kernel: int, stride: int):
    """Per-kernel-row im2col slices: yields k tensors of shape (M, k·C),
    (kw, C) fastest-varying, without forming the patch tensor."""
    b, h, w_dim, c = images.shape
    k, s = kernel, stride
    ho = conv_out_spatial(h, k, s)
    wo = conv_out_spatial(w_dim, k, s)
    m = b * ho * wo
    if s == k:
        a = images[:, : ho * k, : wo * k, :].reshape(b * ho, k, wo, k * c)
        for dh in range(k):
            yield a[:, dh].reshape(m, k * c)
        return
    for dh in range(k):
        rows = images[:, dh: dh + (ho - 1) * s + 1: s, :, :]  # (B,Ho,W,C)
        # window (ow, dw) starts at column ow·s + dw: (B, Ho, Wo, k, C)
        x = rows.unfold(2, k, s)[:, :, :wo].permute(0, 1, 2, 4, 3)
        yield x.reshape(m, k * c)


def im2col_matrix(images: torch.Tensor, kernel: int,
                  stride: int) -> torch.Tensor:
    """Materialized (M, k·k·C) im2col matrix, (kh, kw, C) fastest-varying."""
    return torch.cat(list(im2col_slices(images, kernel, stride)), dim=1)


def p2m_conv_premixed_plain(images: torch.Tensor, wrows: torch.Tensor,
                            shift: torch.Tensor, *, kernel: int, stride: int,
                            mode: str = "relu", v_lsb: float = 1.0 / 255.0,
                            max_count: int = 255, want_raw: bool = False):
    """Plain PyTorch twin of the CUDA kernel, with its exact contract:
    premixed ``wrows`` (k, dx·kC, N) in, (B, Ho, Wo, N) out (and the
    pre-epilogue accumulation as well when ``want_raw``)."""
    b, h, w_dim, c = images.shape
    k = kernel
    n = wrows.shape[-1]
    dx = wrows.shape[1] // (k * c)
    ho = conv_out_spatial(h, k, stride)
    wo = conv_out_spatial(w_dim, k, stride)
    raw = None
    for dh, x in enumerate(im2col_slices(images, kernel, stride)):
        xcat = _power_concat(x.to(torch.float32), dx)
        term = xcat @ wrows[dh]
        raw = term if raw is None else raw + term
    out = _epilogue_values(raw, shift.to(torch.float32), mode=mode,
                           v_lsb=v_lsb, max_count=max_count)
    out = out.reshape(b, ho, wo, n)
    if want_raw:
        return out, raw.reshape(b, ho, wo, n)
    return out


def p2m_conv_raw_plain(images: torch.Tensor, w: torch.Tensor, *, kernel: int,
                       stride: int, coeffs) -> torch.Tensor:
    """Pre-epilogue conv accumulation (M, N), premix included."""
    wrows = premix_rows(w, coeffs, kernel)
    zero = torch.zeros(w.shape[1], dtype=torch.float32, device=w.device)
    _, raw = p2m_conv_premixed_plain(images, wrows, zero, kernel=kernel,
                                     stride=stride, mode="raw", want_raw=True)
    return raw.reshape(-1, w.shape[1])


def p2m_conv_plain(images: torch.Tensor, w: torch.Tensor, shift: torch.Tensor,
                   *, kernel: int, stride: int, coeffs, mode: str = "relu",
                   v_lsb: float = 1.0 / 255.0,
                   max_count: int = 255) -> torch.Tensor:
    """Fused conv in plain PyTorch: the contract of the reference's
    `p2m_conv_jnp` — flat weights (k·k·C, N) in, (B, Ho, Wo, N) out."""
    return p2m_conv_premixed_plain(
        images, premix_rows(w, coeffs, kernel), shift, kernel=kernel,
        stride=stride, mode=mode, v_lsb=v_lsb, max_count=max_count)


# ------------------------------------------------------------ CUDA kernel


@functools.cache
def _library():
    lib = load_library("p2m_conv", _SOURCE)
    lib.p2m_conv_forward.restype = ctypes.c_int
    lib.p2m_conv_forward.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
        + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    lib.p2m_conv_max_dx.restype = ctypes.c_int
    lib.p2m_conv_max_dx.argtypes = []
    return lib


def build_p2m_conv() -> None:
    """Compile (or load the cached build of) the CUDA kernel now."""
    _library()


def _n_tile(n: int, rows: int) -> int:
    """Outputs per block: all of N when its W̃ fits the shared-memory
    budget, else the largest whole number of register chunks that does."""
    if rows * ceil_to(n, _CHUNK) * 4 <= _SMEM_BYTES:
        return n
    tile = (_SMEM_BYTES // (rows * 4 * _CHUNK)) * _CHUNK
    if tile < _CHUNK:
        raise ValueError(f"W̃ of {rows} rows does not fit shared memory "
                         f"even for {_CHUNK} outputs")
    return tile


def _launch_cuda(images, wrows, shift, *, kernel, stride, mode, v_lsb,
                 max_count, want_raw):
    if not images.is_cuda:
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got images "
                         f"on {images.device}")
    for name, t in (("images", images), ("wrows", wrows), ("shift", shift)):
        if t.device != images.device:
            raise ValueError(f"{name} is on {t.device}, images on "
                             f"{images.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    b, h, w_dim, c = images.shape
    k, s = kernel, stride
    if h < k or w_dim < k or k < 1 or s < 1:
        raise ValueError(f"image {h}x{w_dim} smaller than kernel {k}")
    kc = k * c
    if wrows.dim() != 3 or wrows.shape[0] != k or wrows.shape[1] % kc:
        raise ValueError(f"wrows {tuple(wrows.shape)} is not (k, dx·kC, N) "
                         f"for k={k}, C={c}")
    n = wrows.shape[2]
    dx = wrows.shape[1] // kc
    if shift.shape != (n,):
        raise ValueError(f"shift {tuple(shift.shape)} is not ({n},)")
    lib = _library()
    if not 1 <= dx <= lib.p2m_conv_max_dx():
        raise ValueError(f"dx={dx} outside the kernel's compiled range "
                         f"1..{lib.p2m_conv_max_dx()}")
    ho = conv_out_spatial(h, k, s)
    wo = conv_out_spatial(w_dim, k, s)
    out = torch.empty((b, ho, wo, n), dtype=torch.float32,
                      device=images.device)
    raw = torch.empty_like(out) if want_raw else None
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.p2m_conv_forward(
            images.data_ptr(), wrows.data_ptr(), shift.data_ptr(),
            out.data_ptr(), raw.data_ptr() if want_raw else None,
            b, h, w_dim, c, k, s, n, dx, _n_tile(n, k * dx * kc),
            _MODES[mode], v_lsb, max_count, max_count * v_lsb, stream)
    if err != 0:
        raise RuntimeError(f"p2m_conv CUDA launch failed: cudaError {err}")
    p2m_conv_fused.launches += 1
    return (out, raw) if want_raw else out


def p2m_conv_fused(images: torch.Tensor, wrows: torch.Tensor,
                   shift: torch.Tensor, *, kernel: int, stride: int,
                   mode: str = "relu", v_lsb: float = 1.0 / 255.0,
                   max_count: int = 255, want_raw: bool = False):
    """Fused P²M conv: NHWC images (B, H, W, C) in [0, 1], premixed
    ``wrows`` (k, dx·k·C, N) from `premix_rows`, ``shift`` (N,) BN counter
    pre-load in volts → (B, Ho, Wo, N), plus the pre-epilogue accumulation
    when ``want_raw``.

    A CUDA tensor goes to the CUDA kernel, which raises on a wrong dtype,
    a non-contiguous input or a dx above its compiled maximum.  A CPU
    tensor goes to `p2m_conv_premixed_plain`.  ``p2m_conv_fused.launches``
    counts kernel launches.
    """
    if images.is_cuda:
        return _launch_cuda(images, wrows, shift, kernel=kernel,
                            stride=stride, mode=mode, v_lsb=v_lsb,
                            max_count=max_count, want_raw=want_raw)
    return p2m_conv_premixed_plain(images, wrows, shift, kernel=kernel,
                                   stride=stride, mode=mode, v_lsb=v_lsb,
                                   max_count=max_count, want_raw=want_raw)


p2m_conv_fused.launches = 0


def quant_disagreement(out: torch.Tensor, ref_out: torch.Tensor,
                       ref_raw: torch.Tensor, v_lsb: float) -> dict:
    """Compare a quant-mode output with its reference in counts.

    Two correct implementations may round ``raw / v_lsb`` differently only
    where it lies at a half count.  Returns the number and share of
    elements whose counts differ, the largest difference, and whether
    every differing element's reference ``raw / v_lsb`` lies within 1e-3
    of a half count.
    """
    counts = torch.round(out.double() / v_lsb)
    ref_counts = torch.round(ref_out.double() / v_lsb)
    diff = (counts - ref_counts).abs()
    bad = diff > 0
    frac = (ref_raw.double() / v_lsb)[bad]
    near_half = ((frac - torch.floor(frac)) - 0.5).abs() <= 1e-3
    n_diff = int(bad.sum())
    return {"n_diff": n_diff,
            "share": n_diff / max(1, out.numel()),
            "max_count_diff": float(diff.max()) if diff.numel() else 0.0,
            "all_near_half": bool(near_half.all())}
