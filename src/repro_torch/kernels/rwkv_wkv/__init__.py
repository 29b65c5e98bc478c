"""Chunked RWKV-6 WKV; port of `repro.kernels.rwkv_wkv`.

* :func:`ref.wkv_chunked_plain`: the chunk-parallel plain PyTorch twin.
* :func:`kernel.wkv_fused`: the hand-written CUDA kernel B7
  (``csrc/wkv.cu``) for CUDA tensors, the plain twin for CPU tensors.
* :func:`ops.wkv`: the public op, differentiable: B7's forward and the
  closed-form backward (:class:`ops.WKVFunction`).
"""
from repro_torch.kernels.rwkv_wkv.kernel import wkv_fused
from repro_torch.kernels.rwkv_wkv.ops import wkv
from repro_torch.kernels.rwkv_wkv.ref import wkv_chunked_plain

__all__ = ["wkv", "wkv_chunked_plain", "wkv_fused"]
