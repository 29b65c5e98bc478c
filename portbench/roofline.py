"""Peaks of one NVIDIA H100 SXM and the least time of each kernel's call,
counted from the call's shapes: each input read once, each output
written once, and the operations the mathematics needs, whatever
implements it.

The peak for products is the dense TF32 tensor-core rate: the highest
rate at which the card multiplies float32 inputs at all, so no share of
a float32 program can honestly pass it.  (The card's 67 TFLOP/s without
the tensor cores would be passed by a product run as 3xTF32.)"""
from __future__ import annotations

PEAK_FLOPS = 495e12  # dense TF32, H100 SXM data sheet, at 700 W
PEAK_BYTES_PER_S = 3.35e12  # HBM3
F32 = 4


def least_s(nbytes: float, flops: float) -> float:
    """The least time of a call: the larger of its bytes at the memory
    rate and its operations at the peak."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS)


def stem_forward(b: int, h: int, w: int, c: int, n: int, k: int, s: int,
                 dx: int) -> tuple[int, int]:
    """(bytes, FLOPs) of the P²M conv forward (B1 or B2): the images in,
    the weights premixed by the pixel polynomial's x-degree ``dx`` (dx·K
    rows of N) and the shift in, (B, Ho, Wo, N) out; the powers of x and
    the dx·K-deep product a pixel output."""
    ho, wo = (h - k) // s + 1, (w - k) // s + 1
    m, kk = b * ho * wo, k * k * c
    nbytes = F32 * (b * h * w * c + dx * kk * n + n + m * n)
    flops = 2 * m * dx * kk * n + m * kk * (dx - 1)
    return nbytes, flops


def stem_backward_dx(m: int, kk: int, n: int, dx: int) -> tuple[int, int]:
    """(bytes, FLOPs) of B3, the patches' gradient: g (M, N), x (M, K) and
    the premixed weights in, (M, K) out; the dx products of g with the
    weights and the polynomial's derivative in x."""
    nbytes = F32 * (m * n + m * kk + dx * kk * n + m * kk)
    flops = 2 * m * kk * n * dx + 2 * m * kk * dx
    return nbytes, flops


def stem_backward_dw(m: int, kk: int, n: int, dx: int) -> tuple[int, int]:
    """(bytes, FLOPs) of B4, the weights' gradient: x (M, K), g (M, N) and
    w (K, N) in, (K, N) out; the powers of x and the M-deep products."""
    nbytes = F32 * (m * kk + m * n + 2 * kk * n)
    flops = 2 * m * kk * n * dx + m * kk * (dx - 1)
    return nbytes, flops


def wkv(b: int, s: int, h: int, d: int) -> tuple[int, int]:
    """(bytes, FLOPs) of the WKV (B7) at (B, S, H, D): r, k, v and the log
    decay in, u and the state (B, H, D, D) in, y and the state out; a
    token and head: the outer product kᵀv (D²), the state's decay and
    update (2D²), the read r(S + u·kᵀv) (2D²) and the bonus (4D)."""
    nbytes = F32 * (5 * b * s * h * d + h * d + 2 * b * h * d * d)
    flops = b * s * h * (5 * d * d + 4 * d)
    return nbytes, flops


def share_pct(least_total_s: float, device_s: float) -> float | None:
    """A roofline share in %: least time over measured time; None where
    nothing was measured."""
    if device_s <= 0.0 or least_total_s <= 0.0:
        return None
    return 100.0 * least_total_s / device_s
