"""The P²M inner product and the fused P²M conv as ops; port of
`repro.kernels.p2m_conv.ops`.

* :func:`p2m_matmul_plain` — basis-decomposed product (dw·dx matmuls) on
  pre-extracted im2col patches; the "patches" reference path, and the
  plain twin of the product kernel B6.
* :func:`p2m_matmul` — the product differentiable through
  `P2MMatmulFunction` (the reference's ``custom_vjp``): forward by B6
  with ``want_raw``, backward by the closed-form kernels B3 (dX) and B4
  (dW) after the epilogue mask.
* :func:`p2m_conv` — the fused implicit-im2col convolution, differentiable
  through `P2MConvFunction`: forward by the conv kernel the tuner picks
  (B1, or B2's ring; `tune.get_conv_blocks`) with ``want_raw``, backward
  by B3 and B4 after the epilogue mask, then the col2im scatter.
* For a CUDA tensor every wrapper launches its kernel; for a CPU tensor
  each runs its plain twin.  mode="quant" uses an STE backward (the
  gradient of the soft-clipped path).
"""
from __future__ import annotations

import torch

from repro_torch.core.adc import ADCConfig
from repro_torch.core.pixel_model import PixelModel
from repro_torch.kernels.p2m_conv import tune
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
from repro_torch.kernels.p2m_conv.kernel import (
    p2m_matmul_fused,
    p2m_matmul_raw_plain,
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
    acc = p2m_matmul_raw_plain(x, w, _coeff_tuple(model))
    shift = torch.as_tensor(shift, dtype=torch.float32, device=x.device)
    return _epilogue_values(acc, shift, mode=mode, v_lsb=adc.v_lsb,
                            max_count=adc.max_count)


def _masked(g, raw, shift, mode, full_scale):
    """The cotangent of ``raw``: ``g`` through the epilogue's mask."""
    g_eff = g.to(torch.float32)
    if raw is not None:
        g_eff = g_eff * epilogue_mask(raw, shift, mode=mode,
                                      full_scale=full_scale)
    return g_eff.contiguous()


class P2MMatmulFunction(torch.autograd.Function):
    """The P²M product with the closed-form backward (`ops.py:140-175` of
    the reference): x (M, K), w (K, N) and shift (N,) in, gradients for
    all three out.  x, w and shift are cast to float32 for the kernels
    (the reference takes bfloat16 x as well); the gradients come back in
    the inputs' dtypes."""

    @staticmethod
    def forward(ctx, x, w, shift, coeffs, mode, v_lsb, max_count, blocks):
        x32 = x.to(torch.float32).contiguous()
        w32 = w.to(torch.float32).contiguous()
        s32 = shift.to(torch.float32).contiguous()
        bm, bn, bk = blocks
        out, raw = p2m_matmul_fused(x32, w32, s32, coeffs=coeffs, mode=mode,
                                    v_lsb=v_lsb, max_count=max_count,
                                    want_raw=True, block_m=bm, block_n=bn,
                                    block_k=bk)
        # raw feeds only the mask of the clamping modes.
        ctx.save_for_backward(x32, w32, s32, None if mode == "raw" else raw)
        ctx.conf = (coeffs, mode, max_count * v_lsb, x.dtype, w.dtype,
                    shift.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, shift, raw = ctx.saved_tensors
        coeffs, mode, full_scale, x_dt, w_dt, s_dt = ctx.conf
        g_eff = _masked(g, raw, shift, mode, full_scale)
        gx = p2m_bwd_dx(g_eff, w, x, coeffs)
        gw = p2m_bwd_dw(g_eff, w, x, coeffs)
        return (gx.to(x_dt), gw.to(w_dt), g_eff.sum(dim=0).to(s_dt),
                None, None, None, None, None)


def p2m_matmul(x: torch.Tensor, w: torch.Tensor, shift: torch.Tensor,
               model: PixelModel, adc: ADCConfig | None = None,
               mode: str = "relu") -> torch.Tensor:
    """P²M product by the kernel B6: x (M, K) in [0, 1], w (K, N) signed,
    shift (N,) volts → (M, N) float32; differentiable in x, w and shift
    through `P2MMatmulFunction`, with blocks from the tuner
    (`tune.get_matmul_blocks`)."""
    adc = adc or _DEFAULT_ADC
    coeffs = _coeff_tuple(model)
    blocks = tune.get_matmul_blocks(x.shape[0], x.shape[1], w.shape[1],
                                    coeffs, mode, device=x.device)
    return P2MMatmulFunction.apply(x, w, shift, coeffs, mode, adc.v_lsb,
                                   adc.max_count, blocks)


class P2MConvFunction(torch.autograd.Function):
    """The fused conv with the closed-form backward (`ops.py:183-286` of
    the reference).  Images (B, H, W, C), flat weights w (K, N) and shift
    (N,) in, with the forward kernel's ``(block_h, block_n,
    pipeline_depth)``; gradients for images, w and shift out, as the
    reference's ``custom_vjp`` returns them.  B1 and B2 give the same raw
    bit for bit, so the gradients do not depend on the blocks."""

    @staticmethod
    def forward(ctx, images, w, shift, coeffs, kernel, stride, mode, v_lsb,
                max_count, blocks):
        wmix = premix_weights(w, coeffs)  # (dx, K, N), kept for dX
        shift = shift.to(torch.float32).contiguous()
        bh, bn, depth = blocks
        out, raw = p2m_conv_fused(images.contiguous(),
                                  rows_from_premix(wmix, kernel), shift,
                                  kernel=kernel, stride=stride, mode=mode,
                                  v_lsb=v_lsb, max_count=max_count,
                                  want_raw=True, block_h=bh, block_n=bn,
                                  pipeline_depth=depth)
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
        g_eff = _masked(g.reshape(-1, n),
                        None if raw is None else raw.reshape(-1, n), shift,
                        mode, full_scale)
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
                None, None, None, None, None, None, None)


def p2m_conv(images: torch.Tensor, w: torch.Tensor, shift: torch.Tensor,
             model: PixelModel, adc: ADCConfig | None = None,
             mode: str = "relu", kernel: int = 5, stride: int = 5,
             pipeline_depth: int | None = None) -> torch.Tensor:
    """Fused P²M convolution: (B, H, W, C) images → (B, Ho, Wo, N), with
    ``w`` the flat (k·k·C, N) weight; differentiable in images, w and
    shift through `P2MConvFunction`.

    The forward kernel's blocks and depth come from the tuner
    (`tune.get_conv_blocks`; on the CPU its defaults), as the reference's
    ``_conv_fwd_only`` asks for them.  ``pipeline_depth`` overrides the
    tuned depth: 0 forces B1, ≥ 2 B2's ring; 1 and negative raise."""
    adc = adc or _DEFAULT_ADC
    coeffs = _coeff_tuple(model)
    b, h, w_dim, c = images.shape
    bh, bn, depth = tune.get_conv_blocks(b, h, w_dim, c, w.shape[1], kernel,
                                         stride, coeffs, mode,
                                         device=images.device)
    if pipeline_depth is not None:
        depth = pipeline_depth
    return P2MConvFunction.apply(images, w, shift, coeffs, kernel, stride,
                                 mode, adc.v_lsb, adc.max_count,
                                 (bh, bn, depth))
