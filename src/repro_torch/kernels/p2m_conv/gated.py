"""Delta-gated P²M stem; port of `repro.kernels.p2m_conv.gated`.

The streaming-video engine's delta gate (`video/delta.py`) decides per
slot whether this tick's frame needs the stem re-run.  The gated stem
computes the P²M conv only for the slots that re-run and returns the
cached stem for the rest, in one launch:

    out[b] = B1(images[b])  if rerun[b]  else  cached[b]

`p2m_conv_fused_gated` is the wrapper of the hand-written CUDA kernel
that replaces the TPU kernel `p2m_conv_pallas_gated`: the
``p2m_conv_gated_forward`` entry of ``csrc/p2m_conv.cu``, B1's own
kernel body instantiated with the gate, so computed slots equal B1 bit
for bit and skipped slots copy the cache bit for bit.  For a CUDA tensor
it launches the kernel or raises; for a tensor on the CPU it runs
`p2m_conv_gated_plain`, B1's plain twin followed by ``torch.where``.
Inference only: the serving path never differentiates through the gate.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import refuse_grad
from repro_torch.kernels.p2m_conv.conv import (
    _MODES,
    _check_launch,
    _n_tile,
    conv_out_spatial,
    p2m_conv_premixed_plain,
)


def p2m_conv_gated_plain(images: torch.Tensor, wrows: torch.Tensor,
                         shift: torch.Tensor, cached: torch.Tensor,
                         rerun: torch.Tensor, *, kernel: int, stride: int,
                         mode: str = "relu", v_lsb: float = 1.0 / 255.0,
                         max_count: int = 255) -> torch.Tensor:
    """Plain PyTorch twin of the gated kernel: the stem of every slot,
    then the select.  ``rerun`` (B,) bool or int."""
    stem = p2m_conv_premixed_plain(images, wrows, shift, kernel=kernel,
                                   stride=stride, mode=mode, v_lsb=v_lsb,
                                   max_count=max_count)
    return torch.where(rerun.to(torch.bool)[:, None, None, None], stem,
                       cached.to(torch.float32))


def _launch_gated(images, wrows, shift, cached, rerun, *, kernel, stride,
                  mode, v_lsb, max_count):
    refuse_grad("p2m_conv_fused_gated", images, wrows, shift, cached)
    lib, (b, h, w_dim, c), n, dx = _check_launch(
        {"images": images, "wrows": wrows, "shift": shift,
         "cached": cached}, kernel=kernel, stride=stride, mode=mode)
    n_tile = _n_tile(n, kernel * dx * kernel * c)
    ho = conv_out_spatial(h, kernel, stride)
    wo = conv_out_spatial(w_dim, kernel, stride)
    if cached.shape != (b, ho, wo, n):
        raise ValueError(f"cached {tuple(cached.shape)} is not "
                         f"{(b, ho, wo, n)}")
    if rerun.shape != (b,):
        raise ValueError(f"rerun {tuple(rerun.shape)} is not ({b},)")
    if rerun.device != images.device:
        raise ValueError(f"rerun is on {rerun.device}, images on "
                         f"{images.device}")
    if rerun.dtype not in (torch.bool, torch.int32):
        raise TypeError(f"rerun must be bool or int32, got {rerun.dtype}")
    mask = rerun.to(torch.int32).contiguous()  # on the device: no sync
    out = torch.empty_like(cached)
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.p2m_conv_gated_forward(
            images.data_ptr(), wrows.data_ptr(), shift.data_ptr(),
            cached.data_ptr(), mask.data_ptr(), out.data_ptr(),
            b, h, w_dim, c, kernel, stride, n, dx, n_tile, _MODES[mode],
            v_lsb, max_count, max_count * v_lsb, stream)
    if err != 0:
        raise RuntimeError(f"p2m_conv_gated CUDA launch failed: "
                           f"cudaError {err}")
    p2m_conv_fused_gated.launches += 1
    return out


def p2m_conv_fused_gated(images: torch.Tensor, wrows: torch.Tensor,
                         shift: torch.Tensor, cached: torch.Tensor,
                         rerun: torch.Tensor, *, kernel: int, stride: int,
                         mode: str = "relu", v_lsb: float = 1.0 / 255.0,
                         max_count: int = 255) -> torch.Tensor:
    """Delta-gated fused P²M conv: NHWC images (B, H, W, C), premixed
    ``wrows`` and ``shift`` as `p2m_conv_fused`, the slot-resident stem
    ``cached`` (B, Ho, Wo, N) float32 and ``rerun`` (B,) bool or int32 →
    (B, Ho, Wo, N): the conv where ``rerun``, ``cached`` elsewhere.

    A CUDA tensor goes to the CUDA kernel, which raises on a wrong dtype,
    device or contiguity, a ``cached`` or ``rerun`` of the wrong shape, or
    a dx above its compiled maximum, and on an input that requires grad
    under grad mode (`_build.refuse_grad`).  A CPU tensor goes to
    `p2m_conv_gated_plain`.  ``p2m_conv_fused_gated.launches`` counts
    kernel launches.
    """
    kw = dict(kernel=kernel, stride=stride, mode=mode, v_lsb=v_lsb,
              max_count=max_count)
    if images.is_cuda:
        return _launch_gated(images, wrows, shift, cached, rerun, **kw)
    return p2m_conv_gated_plain(images, wrows, shift, cached, rerun, **kw)


p2m_conv_fused_gated.launches = 0
