"""Elementwise oracle for the P²M inner product; port of
`repro.kernels.p2m_conv.ref`.

The faithful formulation — what the paper's own PyTorch framework
computes (§4.1): every multiply of the im2col product is the pixel
function ``g``, with the CDS sign split per weight, then the ADC
epilogue:

    out[m, n] = epilogue( Σ_k  sign(W[k,n]) · g(|W[k,n]|, X[m,k]) )

It forms a (chunk, K, N) broadcast product, so it is the slow oracle for
correctness only; `kernel.py` and `ops.py` hold the basis-decomposed
versions.
"""
from __future__ import annotations

import torch

from repro_torch.core.adc import (
    ADCConfig,
    adc_counts,
    adc_dequant,
    shifted_relu,
)
from repro_torch.core.pixel_model import PixelModel


def _g_poly(coeffs: torch.Tensor, w: torch.Tensor,
            x: torch.Tensor) -> torch.Tensor:
    """Elementwise ``g(w,x) = Σ_{i,j≥1} a_ij w^i x^j`` in fp32."""
    acc = torch.zeros(torch.broadcast_shapes(w.shape, x.shape),
                      dtype=torch.float32, device=w.device)
    dw, dx = coeffs.shape
    for i in range(1, dw + 1):
        for j in range(1, dx + 1):
            acc = acc + coeffs[i - 1, j - 1] * (w ** i) * (x ** j)
    return acc


def p2m_matmul_ref(x, w, model: PixelModel, shift=None,
                   adc: ADCConfig | None = None, *, quantize: bool = False,
                   chunk: int = 128) -> torch.Tensor:
    """Oracle P²M inner product.

    x: (M, K) im2col patches in [0, 1]; w: (K, N) signed weights;
    ``shift``: optional (N,) BN shift in volts (None ⇒ 0); ``adc``: the
    epilogue's ADC (None ⇒ the raw accumulation, plus the shift when
    given); ``quantize``: the integer-exact counter path; ``chunk``: rows
    of x per broadcast block.  Returns (M, N) float32.
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    w = torch.as_tensor(w, dtype=torch.float32, device=x.device)
    coeffs = torch.as_tensor(model.coeffs, dtype=torch.float32,
                             device=x.device)
    sgn = torch.sign(w)
    aw = torch.abs(w)
    outs = []
    for m0 in range(0, x.shape[0], chunk):
        xb = x[m0:m0 + chunk]  # (c, K)
        # (c, K, N): g(|w|, x) per (patch element, channel), signed
        prod = sgn[None] * _g_poly(coeffs, aw[None], xb[:, :, None])
        outs.append(prod.sum(dim=1))
    raw = torch.cat(outs, dim=0)
    if shift is not None:
        shift = torch.as_tensor(shift, dtype=torch.float32, device=x.device)
    if adc is None:
        return raw if shift is None else raw + shift
    if shift is None:
        shift = torch.zeros(w.shape[1], dtype=torch.float32, device=x.device)
    if quantize:
        lsb = torch.tensor(adc.v_lsb, dtype=torch.float32, device=x.device)
        preset = torch.round(shift / lsb).to(torch.int32)
        return adc_dequant(adc_counts(raw, adc, preset_counts=preset), adc)
    return shifted_relu(raw, shift, adc)
