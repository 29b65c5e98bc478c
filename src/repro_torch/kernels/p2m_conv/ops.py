"""The P²M inner product and the fused P²M conv as ops; port of
`repro.kernels.p2m_conv.ops`.

* :func:`p2m_matmul_plain` — basis-decomposed product (dw·dx matmuls) on
  pre-extracted im2col patches; the "patches" reference path.
* :func:`p2m_conv` — the fused implicit-im2col convolution, differentiable
  through `P2MConvFunction` (the reference's ``custom_vjp``): forward by
  the conv kernel B1 with ``want_raw``, backward by the closed-form
  kernels B3 (dX) and B4 (dW) after the epilogue mask, then the col2im
  scatter.  For a CUDA tensor every wrapper launches its kernel; for a
  CPU tensor each runs its plain twin.
* mode="quant" uses an STE backward (gradient of the soft-clipped path).
"""
from __future__ import annotations

import torch

from repro_torch.core.adc import ADCConfig
from repro_torch.core.pixel_model import PixelModel
from repro_torch.kernels.p2m_conv.backward import (
    epilogue_mask,
    p2m_bwd_dw,
    p2m_bwd_dx,
)
from repro_torch.kernels.p2m_conv.conv import (
    _epilogue_values,
    im2col_matrix,
    p2m_conv_fused,
    premix_weights,
    rows_from_premix,
)

_DEFAULT_ADC = ADCConfig()


def _coeff_tuple(model: PixelModel) -> tuple:
    return tuple(tuple(float(v) for v in row) for row in model.coeffs)


def p2m_matmul_plain(x: torch.Tensor, w: torch.Tensor, shift,
                     model: PixelModel, adc: ADCConfig | None = None,
                     mode: str = "relu") -> torch.Tensor:
    """Basis-decomposed P²M product: x (M, K) in [0,1], w (K, N) signed,
    shift (N,) volts → (M, N) through the ``mode`` epilogue."""
    adc = adc or _DEFAULT_ADC
    coeffs = model.coeffs
    dw, dx = coeffs.shape
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
            a_ij = float(coeffs[i - 1, j - 1])
            if a_ij != 0.0:
                acc = acc + a_ij * (xp @ wsig)
            if j < dx:
                xp = xp * x32
        if i < dw:
            wp = wp * aw
    shift = torch.as_tensor(shift, dtype=torch.float32, device=x.device)
    return _epilogue_values(acc, shift, mode=mode, v_lsb=adc.v_lsb,
                            max_count=adc.max_count)


class P2MConvFunction(torch.autograd.Function):
    """The fused conv with the closed-form backward (`ops.py:183-286` of
    the reference).  Images (B, H, W, C), flat weights w (K, N) and shift
    (N,) in; gradients for all three out, as the reference's ``custom_vjp``
    returns them."""

    @staticmethod
    def forward(ctx, images, w, shift, coeffs, kernel, stride, mode, v_lsb,
                max_count):
        wmix = premix_weights(w, coeffs)  # (dx, K, N), kept for dX
        shift = shift.to(torch.float32).contiguous()
        out, raw = p2m_conv_fused(images.contiguous(),
                                  rows_from_premix(wmix, kernel), shift,
                                  kernel=kernel, stride=stride, mode=mode,
                                  v_lsb=v_lsb, max_count=max_count,
                                  want_raw=True)
        # raw feeds only the mask of the clamping modes.
        ctx.save_for_backward(images, w, wmix, shift,
                              None if mode == "raw" else raw)
        ctx.conf = (coeffs, kernel, stride, mode, max_count * v_lsb)
        return out

    @staticmethod
    def backward(ctx, g):
        images, w, wmix, shift, raw = ctx.saved_tensors
        coeffs, kernel, stride, mode, full_scale = ctx.conf
        n = w.shape[1]
        g_eff = g.reshape(-1, n).to(torch.float32)
        if raw is not None:
            g_eff = g_eff * epilogue_mask(raw.reshape(-1, n), shift,
                                          mode=mode, full_scale=full_scale)
        g_eff = g_eff.contiguous()
        # The patch matrix, materialized once (training-only cost), and
        # its VJP: a reshape at stride == kernel, a scatter-add below it.
        with torch.enable_grad():
            im = images.detach().requires_grad_(True)
            x = im2col_matrix(im, kernel, stride)
        xd = x.detach()
        gx = p2m_bwd_dx(g_eff, wmix, xd, coeffs)
        gw = p2m_bwd_dw(g_eff, w.to(torch.float32).contiguous(), xd, coeffs)
        (gimages,) = torch.autograd.grad(x, im, gx)  # col2im
        gshift = g_eff.sum(dim=0)
        return (gimages.to(images.dtype), gw.to(w.dtype), gshift,
                None, None, None, None, None, None)


def p2m_conv(images: torch.Tensor, w: torch.Tensor, shift: torch.Tensor,
             model: PixelModel, adc: ADCConfig | None = None,
             mode: str = "relu", kernel: int = 5,
             stride: int = 5) -> torch.Tensor:
    """Fused P²M convolution: (B, H, W, C) images → (B, Ho, Wo, N), with
    ``w`` the flat (k·k·C, N) weight; differentiable in images, w and
    shift through `P2MConvFunction`."""
    adc = adc or _DEFAULT_ADC
    return P2MConvFunction.apply(images, w, shift, _coeff_tuple(model),
                                 kernel, stride, mode, adc.v_lsb,
                                 adc.max_count)
