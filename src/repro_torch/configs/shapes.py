"""Assigned input-shape set (per-arch cells) + applicability rules; port
of `repro.configs.shapes` (as it is)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# long_500k runs only for sub-quadratic archs (SSM / hybrid / SWA);
# pure full-attention archs skip it (DESIGN.md §Arch-applicability).
LONG_CONTEXT_ARCHS = {"rwkv6-3b", "recurrentgemma-9b", "mixtral-8x22b"}


def applicable(arch_name: str, family: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch_name in LONG_CONTEXT_ARCHS
    return True


def cells(arch_name: str, family: str) -> list[str]:
    return [s for s in SHAPES if applicable(arch_name, family, s)]
