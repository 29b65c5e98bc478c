"""P²M conv: plain building blocks, the CUDA kernel's wrapper, the ops."""
from repro_torch.kernels.p2m_conv.conv import (
    build_p2m_conv,
    im2col_matrix,
    im2col_slices,
    p2m_conv_fused,
    p2m_conv_plain,
    p2m_conv_premixed_plain,
    p2m_conv_raw_plain,
    premix_rows,
    premix_weights,
)
from repro_torch.kernels.p2m_conv.ops import p2m_conv, p2m_matmul_plain

__all__ = ["build_p2m_conv", "im2col_matrix", "im2col_slices",
           "p2m_conv_fused", "p2m_conv_plain", "p2m_conv_premixed_plain",
           "p2m_conv_raw_plain", "premix_rows", "premix_weights",
           "p2m_conv", "p2m_matmul_plain"]
