"""Model configurations of the port: the paper's P²M-VWW model
(`configs/p2m_vww.py`) and every language, vision-language and
encoder-decoder model of the reference.

``get_config(name)`` / ``get_smoke_config(name)`` mirror the reference's
registry; an architecture it does not know raises ``KeyError``.  The
reference's cell shapes (`configs.shapes`) come with them.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable, cells

#: The reference's architecture ids (`repro.configs.ARCH_IDS`).
ARCH_IDS = [
    "qwen3-32b",
    "stablelm-1.6b",
    "qwen2-72b",
    "llama3.2-1b",
    "qwen3-moe-30b-a3b",
    "mixtral-8x22b",
    "rwkv6-3b",
    "llama-3.2-vision-11b",
    "recurrentgemma-9b",
    "whisper-tiny",
]
#: Those the port has a module for: all of them.
PORTED = tuple(ARCH_IDS)


def _load(name: str):
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_IDS)}")
    module = name.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{module}")


def get_config(name: str):
    return _load(name).CONFIG


def get_smoke_config(name: str):
    return _load(name).SMOKE


__all__ = ["ARCH_IDS", "PORTED", "SHAPES", "ShapeSpec", "applicable", "cells",
           "get_config", "get_smoke_config"]
