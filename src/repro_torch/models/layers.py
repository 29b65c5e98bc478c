"""Shared LM building blocks (params + forward); port of the part of
`repro.models.layers` the RWKV family needs: norms, embedding and the LM
head.  Attention and the MLP come with the dense families.

Per-layer params take a leading ``n_layers`` dim (``L``).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.init_utils import KeyGen, make

# ------------------------------------------------------------------ norms


def rms_norm(x, scale, eps: float):
    """RMSNorm in float32, scaled by ``1 + scale``."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x, scale, bias, eps: float):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def init_norm(cfg: ModelConfig, L: tuple, name_axes=None, *,
              device=None, abstract: bool = False) -> dict:
    d = cfg.d_model
    if name_axes is None:
        name_axes = ("layers",) * len(L)
    mk = lambda: make(None, L + (d,), name_axes + ("embed_act",),  # noqa: E731
                      init="zeros", device=device, abstract=abstract)
    tree = {"scale": mk()}
    if cfg.use_layernorm:
        tree["bias"] = mk()
    return tree


def apply_norm(p: dict, x, cfg: ModelConfig):
    if "bias" in p:
        return layer_norm(x, 1.0 + p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


# ------------------------------------------------------------------ embedding / head


def init_embedding(kg: KeyGen, cfg: ModelConfig) -> dict:
    """Embedding table + output head, padded to ``padded_vocab`` (pad
    logits are masked in `lm_head`).  Table init ``d^-1/4``, the head
    fan-in ``d^-1/2``, as in the reference."""
    dt = cfg.dtype
    tree: dict[str, Any] = {
        "table": make(kg(), (cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
                      scale=cfg.d_model**-0.25, dtype=dt),
        "final_norm": init_norm(cfg, (), (), device=kg.device),
    }
    if not cfg.tie_embeddings:
        tree["head"] = make(kg(), (cfg.d_model, cfg.padded_vocab),
                            ("embed", "vocab"), dtype=dt)
    return tree


def embed_tokens(p: dict, tokens, cfg: ModelConfig):
    return p["table"][tokens.long()]


def mask_pad_vocab(logits, cfg: ModelConfig):
    if cfg.padded_vocab == cfg.vocab:
        return logits
    idx = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(idx < cfg.vocab, logits, -1e9)


def lm_head(p: dict, x, cfg: ModelConfig):
    x = apply_norm(p["final_norm"], x, cfg)
    w = p["table"].T if cfg.tie_embeddings else p["head"]
    logits = (x @ w).float()
    return mask_pad_vocab(logits, cfg)
