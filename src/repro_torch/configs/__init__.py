"""Model configurations of the port: the paper's P²M-VWW model
(`configs/p2m_vww.py`) and the language models ported so far.

``get_config(name)`` / ``get_smoke_config(name)`` mirror the reference's
registry for the architectures the port has; any other architecture the
reference knows raises "not ported yet".
"""
from __future__ import annotations

import importlib

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
#: Those the port has a module for.
PORTED = ("qwen3-32b", "stablelm-1.6b", "qwen2-72b", "llama3.2-1b",
          "qwen3-moe-30b-a3b", "mixtral-8x22b", "rwkv6-3b",
          "recurrentgemma-9b")


def _load(name: str):
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_IDS)}")
    if name not in PORTED:
        raise NotImplementedError(f"arch {name!r} is not ported yet; the "
                                  f"port has {list(PORTED)}")
    module = name.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{module}")


def get_config(name: str):
    return _load(name).CONFIG


def get_smoke_config(name: str):
    return _load(name).SMOKE


__all__ = ["ARCH_IDS", "PORTED", "get_config", "get_smoke_config"]
