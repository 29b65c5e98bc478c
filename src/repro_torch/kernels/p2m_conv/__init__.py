"""P²M conv: plain building blocks, the CUDA kernels' wrappers, the ops."""
from repro_torch.kernels.p2m_conv.backward import (
    build_p2m_bwd,
    epilogue_mask,
    p2m_backward_plain,
    p2m_bwd_dw,
    p2m_bwd_dw_plain,
    p2m_bwd_dx,
    p2m_bwd_dx_plain,
)
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
    rows_from_premix,
)
from repro_torch.kernels.p2m_conv.gated import (
    p2m_conv_fused_gated,
    p2m_conv_gated_plain,
)
from repro_torch.kernels.p2m_conv.ops import (
    P2MConvFunction,
    p2m_conv,
    p2m_matmul_plain,
)

__all__ = ["build_p2m_bwd", "epilogue_mask", "p2m_backward_plain",
           "p2m_bwd_dw", "p2m_bwd_dw_plain", "p2m_bwd_dx", "p2m_bwd_dx_plain",
           "build_p2m_conv", "im2col_matrix", "im2col_slices",
           "p2m_conv_fused", "p2m_conv_fused_gated", "p2m_conv_gated_plain",
           "p2m_conv_plain", "p2m_conv_premixed_plain",
           "p2m_conv_raw_plain", "premix_rows", "premix_weights",
           "rows_from_premix", "P2MConvFunction", "p2m_conv",
           "p2m_matmul_plain"]
