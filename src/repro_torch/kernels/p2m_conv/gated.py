"""Delta-gated P²M stem; port of `repro.kernels.p2m_conv.gated`.

The streaming-video engine's delta gate (`video/delta.py`) decides per
slot whether this tick's frame needs the stem re-run.  The gated stem
computes the P²M conv only for the slots that re-run and returns the
cached stem for the rest, in one launch:

    out[b] = B1(images[b])  if rerun[b]  else  cached[b]

`p2m_conv_fused_gated` is the wrapper of the hand-written CUDA kernel
that replaces the TPU kernel `p2m_conv_pallas_gated`: the
``p2m_conv_gated_forward`` entry of ``csrc/p2m_conv.cu``.  Its blocks
choose its body as `conv.p2m_conv_fused`'s choose between B1 and B2:
``pipeline_depth`` ≥ 2 runs the gated instance of B2's ring, with
``block_h`` clamped to a divisor of Ho (`aligned_block_h`) so that no
block straddles two slots; 0 runs the gated instance of B1's body.
Either way computed slots equal B1 bit for bit and skipped slots copy
the cache bit for bit.  For a CUDA tensor it launches the kernel or
raises; for a tensor on the CPU it runs `p2m_conv_gated_plain`, B1's
plain twin followed by ``torch.where``.  Inference only: the serving
path never differentiates through the gate.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import refuse_grad
from repro_torch.kernels.p2m_conv.conv import (
    _MODES,
    _check_launch,
    _pipelined_blocks,
    b1_tiling,
    check_pipeline_depth,
    conv_out_spatial,
    default_block_h,
    p2m_conv_premixed_plain,
    ring_geometry,
)


def aligned_block_h(ho: int, bh: int) -> int:
    """Largest divisor of ``ho`` that is ≤ ``bh`` — the slot-aligned row
    tile: with ``bh | Ho`` a tile's rows all belong to one image, so the
    per-slot mask is uniform across the tile and a skip skips the whole
    tile's FLOPs."""
    bh = max(1, min(bh, ho))
    while ho % bh:
        bh -= 1
    return bh


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


def gated_blocks(b: int, ho: int, wo: int, n: int, c: int, k: int, s: int,
                 dx: int, block_h: int | None, block_n: int | None,
                 depth: int) -> tuple[int, int, int]:
    """The ring body's ``(block_h, N tile, ring slots)``: B2's blocks
    (`conv._pipelined_blocks`) with ``block_h`` (B2's default when None)
    clamped to a divisor of Ho."""
    bh = aligned_block_h(ho, block_h or default_block_h(b * ho, wo))
    return _pipelined_blocks(b, ho, wo, n, c, k, s, dx, bh, block_n, depth)


def gated_launch(shape: tuple, n: int, dx: int, *, kernel: int, stride: int,
                 block_h: int | None = None, block_n: int | None = None,
                 pipeline_depth: int = 2) -> dict:
    """The launch `p2m_conv_fused_gated` makes on its ring body for images
    of ``shape`` (B, H, W, C), as `conv.pipelined_launch` reports B2's:
    blocks, threads, shared memory, pixels a thread, registers, local
    bytes and blocks an SM of the gated instantiation.  Launches nothing;
    needs the card."""
    if pipeline_depth < 2:
        raise ValueError(f"the ring body runs at pipeline_depth >= 2, got "
                         f"{pipeline_depth}")
    b, h, w_dim, c = shape
    blocks = gated_blocks(b, conv_out_spatial(h, kernel, stride),
                          conv_out_spatial(w_dim, kernel, stride), n, c,
                          kernel, stride, dx, block_h, block_n,
                          pipeline_depth)
    return ring_geometry(shape, n, dx, kernel, stride, blocks, gated=True)


def _launch_gated(images, wrows, shift, cached, rerun, *, kernel, stride,
                  mode, v_lsb, max_count, block_h, block_n, pipeline_depth):
    refuse_grad("p2m_conv_fused_gated", images, wrows, shift, cached)
    lib, (b, h, w_dim, c), n, dx = _check_launch(
        {"images": images, "wrows": wrows, "shift": shift,
         "cached": cached}, kernel=kernel, stride=stride, mode=mode)
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
    ring = pipeline_depth >= 2
    tile_px = blocks_x = 0  # B1's tiling, not read by the ring
    if ring:
        bh, n_tile, nbuf = gated_blocks(b, ho, wo, n, c, kernel, stride, dx,
                                        block_h, block_n, pipeline_depth)
    else:  # B1's body, with B1's tiling
        bh, nbuf = 0, 0
        tiling = b1_tiling((b, h, w_dim, c), n, dx, kernel=kernel,
                           stride=stride, block_n=block_n)
        n_tile, tile_px, blocks_x = (tiling[key] for key in (
            "n_tile", "tile_px", "blocks_x"))
    mask = rerun.to(torch.int32).contiguous()  # on the device: no sync
    out = torch.empty_like(cached)
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.p2m_conv_gated_forward(
            images.data_ptr(), wrows.data_ptr(), shift.data_ptr(),
            cached.data_ptr(), mask.data_ptr(), out.data_ptr(),
            b, h, w_dim, c, kernel, stride, n, dx, n_tile, bh, nbuf,
            tile_px, blocks_x, _MODES[mode], v_lsb, max_count,
            max_count * v_lsb, stream)
    if err != 0:
        raise RuntimeError(f"p2m_conv_gated CUDA launch failed "
                           f"({'ring' if ring else 'B1 body'}): "
                           f"cudaError {err}")
    if ring:
        p2m_conv_fused_gated.launches_pipelined += 1
    else:
        p2m_conv_fused_gated.launches += 1
    return out


def p2m_conv_fused_gated(images: torch.Tensor, wrows: torch.Tensor,
                         shift: torch.Tensor, cached: torch.Tensor,
                         rerun: torch.Tensor, *, kernel: int, stride: int,
                         mode: str = "relu", v_lsb: float = 1.0 / 255.0,
                         max_count: int = 255, block_h: int | None = None,
                         block_n: int | None = None,
                         pipeline_depth: int = 0) -> torch.Tensor:
    """Delta-gated fused P²M conv: NHWC images (B, H, W, C), premixed
    ``wrows`` and ``shift`` as `p2m_conv_fused`, the slot-resident stem
    ``cached`` (B, Ho, Wo, N) float32 and ``rerun`` (B,) bool or int32 →
    (B, Ho, Wo, N): the conv where ``rerun``, ``cached`` elsewhere.

    ``block_h``, ``block_n`` and ``pipeline_depth`` mean what they mean
    to `p2m_conv_fused`: depth 0 runs B1's gated body, ≥ 2 the gated ring
    of ``min(pipeline_depth, kernel)`` slots, with ``block_h`` clamped to
    its largest divisor of Ho (`aligned_block_h`); 1 and negative depths
    raise `ValueError` on every device.  The result does not depend on
    any of the three, bit for bit.

    A CUDA tensor goes to the CUDA kernel, which raises on a wrong dtype,
    device or contiguity, a ``cached`` or ``rerun`` of the wrong shape, a
    dx above its compiled maximum, blocks it does not take, and an input
    that requires grad under grad mode (`_build.refuse_grad`).  A CPU
    tensor goes to `p2m_conv_gated_plain`.  ``p2m_conv_fused_gated
    .launches`` counts launches of B1's gated body,
    ``.launches_pipelined`` those of the ring.
    """
    check_pipeline_depth(pipeline_depth)
    kw = dict(kernel=kernel, stride=stride, mode=mode, v_lsb=v_lsb,
              max_count=max_count)
    if images.is_cuda:
        return _launch_gated(images, wrows, shift, cached, rerun,
                             block_h=block_h, block_n=block_n,
                             pipeline_depth=pipeline_depth, **kw)
    return p2m_conv_gated_plain(images, wrows, shift, cached, rerun, **kw)


p2m_conv_fused_gated.launches = 0
p2m_conv_fused_gated.launches_pipelined = 0
