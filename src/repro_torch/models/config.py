"""Shared model configuration of the language models; port of
`repro.models.config` with a torch dtype.

``wkv_impl`` picks the chunked WKV of the RWKV family: ``"cuda"`` (the
hand-written kernel for a CUDA tensor, its plain twin for a CPU tensor),
``"plain"`` (the plain chunked twin on any device) or ``"naive"`` (the
per-token scan).  ``remat`` recomputes each layer in the backward
(`torch.utils.checkpoint`, when grad mode is on).  ``scan_layers`` is
kept as a field so a reference config reads the same; it means nothing
here (the layers run in a Python loop).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | rwkv | rglru | vlm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None  # None → d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    tie_embeddings: bool = False
    use_layernorm: bool = False  # stablelm-style LN instead of RMSNorm
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    sliding_window: int | None = None  # SWA / local-attention window
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_impl: str = "xla"
    # VLM (cross-attention image layers)
    cross_attn_period: int = 0
    n_image_tokens: int = 0
    # enc-dec (whisper)
    n_encoder_layers: int = 0
    max_source_positions: int = 0
    # rglru hybrid (recurrentgemma)
    block_pattern: tuple[str, ...] = ()
    d_rnn: int = 0
    conv_width: int = 4
    # rwkv
    rwkv_head_dim: int = 64
    rwkv_lora_dim: int = 64
    chunk_size: int = 128
    # chunked-WKV backend: "cuda" | "plain" | "naive" (module docstring)
    wkv_impl: str = "cuda"
    # execution
    dtype: Any = torch.bfloat16
    scan_layers: bool = True
    remat: bool = True
    vocab_pad_multiple: int = 128  # embedding/logits padded to a multiple

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab // m) * m if m else self.vocab

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
