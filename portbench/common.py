"""What every cell shares: paths, the files found by name, the clock of
the process, the card's description, the precision both sides run in,
and the import check."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: Top-level module names the process may not hold once the window has
#: closed: JAX, its libraries, and the JAX package the port was made from.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def log(*parts) -> None:
    """One line of the run's record, on standard error."""
    print(*parts, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: dict | None = None) -> dict:
    """The workload entry of ``BENCHMARK.json`` called ``name``."""
    bench = bench or benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic_file(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def cell_file(name: str) -> dict:
    return load_json(HERE / "workloads" / f"{name}.json")


def process_age_s() -> float:
    """Seconds since this process was started, from the kernel's record
    of its start (10 ms ticks), so interpreter start and imports count."""
    with open("/proc/self/stat") as f:
        stat = f.read()
    start_ticks = int(stat.rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def set_cache_dirs() -> None:
    """Every kernel cache the program could write, at fixed paths inside
    the checkout.  The port builds its CUDA kernels into
    ``src/repro_torch/kernels/.build/`` of the checkout by itself."""
    base = ROOT / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")


def one_thread() -> None:
    """One host thread for the CPU libraries (OpenMP, BLAS): the run's
    host work is one Python thread driving the card, and idle worker
    threads spinning beside it only add noise.  Set before torch is
    imported."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def set_float32(torch, tf32: bool = False) -> None:
    """float32 products in float32 (``tf32=False``, both sides of every
    cell), or in TF32 (the control)."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def nvidia_smi(fields: str) -> str:
    """``nvidia-smi --query-gpu=<fields>`` for card 0, or the error."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"unavailable ({type(exc).__name__})"
    return (proc.stdout or proc.stderr).strip()


def card_line() -> str:
    return nvidia_smi("name,power.limit")


def clocks_line() -> str:
    return nvidia_smi("clocks.sm,clocks.mem,power.draw,temperature.gpu")


def forbidden_loaded(modules=None) -> list[str]:
    """Forbidden top-level names among ``modules`` (default: this
    process's ``sys.modules``), compared whole: ``repro_torch`` is not
    ``repro``."""
    tops = {name.split(".", 1)[0]
            for name in list(sys.modules if modules is None else modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))
