"""Build a CUDA source of this package into a shared library and load it.

Each kernel source under ``csrc/`` exposes a plain C entry point; it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into ``kernels/.build/``
at first use and loaded with `ctypes`.  The library's file name carries
a hash of the source and the flags, so an edited source is rebuilt and
an unchanged one is loaded as it is.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parent / ".build"

#: No ``--use_fast_math``: the quant epilogue needs IEEE division and
#: round-half-to-even to agree with the reference at half-count boundaries.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}
#: name -> (seconds nvcc took, or 0.0 for a cached library; ptxas report)
BUILD_INFO: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built with the CUDA toolkit at first use")
    return str(path)


def load_library(name: str, source: Path) -> ctypes.CDLL:
    """Compile ``source`` (once per content) and return the loaded library."""
    if name in _LOADED:
        return _LOADED[name]
    text = source.read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        BUILD_INFO[name] = (0.0, "")
    else:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {source.name} "
                               f"(exit {proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)  # atomic: concurrent builds agree
        BUILD_INFO[name] = (seconds, proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(lib_path))
    _LOADED[name] = lib
    return lib


def refuse_grad(name: str, *tensors) -> None:
    """Raise when autograd would record a kernel launch.

    A kernel writes its outputs through ctypes, outside the autograd
    graph, so its result would carry no gradient without a word, while
    the plain twin on the CPU is differentiable.  Each wrapper calls this
    on its CUDA path: with grad mode on, an input that requires grad is
    an error.  Differentiate through the op's autograd Function
    (`P2MConvFunction`, `p2m_matmul`, `WKVFunction`), or call the
    wrapper under `torch.no_grad` as the engines do."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward of its own and an "
            f"input requires grad; call it through its autograd Function "
            f"or under torch.no_grad()")
