"""One run of one cell: what the drivers fill in, and the helpers they
share."""
from __future__ import annotations

import dataclasses
import gc
import math
import time

import torch

from portbench import common
from portbench.trace import Profiler


@dataclasses.dataclass
class Run:
    cell: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    setup_s: float | None = None
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    #: end-to-end values by metric name (setup_s is added by `open_window`)
    e2e: dict = dataclasses.field(default_factory=dict)
    #: what the per-layer readers read: counters, spans, FLOPs, shapes
    layer: dict = dataclasses.field(default_factory=dict)
    #: numbers compared: name → (value, limit)
    checks: dict = dataclasses.field(default_factory=dict)
    profiler: Profiler | None = None
    #: also read the control (TF32 in the reference) and the planted
    #: faults, into ``readings`` (the limit-setting tool; never the runs)
    control: bool = False
    readings: dict = dataclasses.field(default_factory=dict)

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def warm_profiler(self) -> None:
        """Start CUPTI in set-up, where a traced run will trace."""
        if self.trace and self.cuda:
            self.profiler = Profiler(torch)
            self.profiler.warm()

    def traced(self):
        """The traced sub-window's context (`warm_profiler` ran)."""
        return self.profiler.window()

    def open_window(self) -> float:
        """Mark the window's start: set-up ends here.  Returns the host
        clock's reading."""
        self.sync()
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        gc.collect()
        gc.freeze()  # set-up's objects: no collection in the window walks them
        self.setup_s = common.process_age_s()
        self.e2e["setup_s"] = self.setup_s
        common.log(f"[setup] {self.setup_s:.3f} s to the window's start")
        return time.perf_counter()

    def close_window(self) -> None:
        """Read the peak memory of the window, before any reference runs."""
        self.sync()
        if self.cuda:
            self.memory_peak_bytes = int(
                torch.cuda.max_memory_allocated(self.device))
            common.log(f"[memory] max_memory_allocated "
                       f"{self.memory_peak_bytes} bytes")
            common.log(f"[card] {common.card_line()}; clocks.sm, clocks.mem, "
                       f"power.draw, temperature after the window: "
                       f"{common.clocks_line()}")

    def check(self, name: str, value: float) -> None:
        """Record a number compared, beside its limit (none: ``inf``)."""
        self.checks[name] = (float(value),
                             float(self.limits.get(name, math.inf)))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for v, lim in self.checks.values())


def free() -> None:
    """Give the program's freed memory back before the reference runs."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def model_flops(fn, *args) -> int:
    """FLOPs of ``fn(*args)`` by `torch.utils.flop_counter` (products and
    convolutions), run on ``meta`` tensors: shapes only."""
    from torch.utils.flop_counter import FlopCounterMode

    def meta(x):
        if isinstance(x, torch.Tensor):
            return torch.empty_like(x, device="meta")
        if isinstance(x, dict):
            return {k: meta(v) for k, v in x.items()}
        return x

    with FlopCounterMode(display=False) as counter:
        fn(*[meta(a) for a in args])
    return int(counter.get_total_flops())


def percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile; ``inf`` entries count as the slowest."""
    vals = sorted(values)
    if not vals:
        return math.inf
    return vals[max(0, math.ceil(q / 100.0 * len(vals)) - 1)]


class tf32:
    """TF32 on for float32 products inside the block (the control)."""

    def __enter__(self):
        common.set_float32(torch, tf32=True)

    def __exit__(self, *exc):
        common.set_float32(torch, tf32=False)
        return False


def train_gaps(prog: dict, ref: dict) -> dict:
    """A training cell's numbers from two runs' readings: ``losses`` a
    step, and leaf norms (path → norm) of the first gradient (``grad1``),
    of the parameters' change over the steps (``change``) and, where both
    have them, of the first step's change of the parameters (``change1``)
    and of the BN running statistics (``bn1``).  Returned: the loss gap
    over the reference's loss (the worst step's, and the first step's),
    and each tree's gap by the worst leaf (``<tree>_gap``) and by the
    median leaf (``<tree>_gap_median``), under ``where`` what they were
    read at.  Leaves whose reference gradient is under a thousandth of
    the median leaf's move by round-off alone and are left out of the
    parameters' change.  A cell's limits file names the numbers it
    compares."""
    r_grad1 = ref["grad1"]
    med = sorted(r_grad1.values())[len(r_grad1) // 2]
    still = {k for k, g in r_grad1.items() if g < 1e-3 * med}
    steps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                 ref["losses"])]
    out = {"loss_gap": max(steps), "loss_gap_step1": steps[0]}
    where = {"loss_steps": steps, "left_out": sorted(still)}
    for tree in ("grad1", "change1", "bn1", "change"):
        if tree not in prog or tree not in ref:
            continue
        skip = still if tree.startswith("change") else ()
        name = "grad" if tree == "grad1" else tree
        out[f"{name}_gap"], where[name] = leaf_gap(prog[tree], ref[tree],
                                                   skip)
        out[f"{name}_gap_median"] = median_leaf_gap(prog[tree], ref[tree],
                                                    skip)
    out["where"] = where
    return out


def median_leaf_gap(prog: dict, ref: dict, skip=()) -> float:
    """The median over leaves of |‖p‖ − ‖r‖| / ‖r‖."""
    gaps = sorted(abs(prog[k] - ref[k]) / max(ref[k], 1e-30)
                  for k in ref if k not in skip)
    return gaps[len(gaps) // 2]


def leaf_gap(prog: dict, ref: dict, skip=()) -> tuple[float, str]:
    """Worst leaf of the gap between two trees' per-leaf norms: |‖p‖ − ‖r‖|
    over the larger of the reference leaf's norm and the median leaf's.
    ``prog`` and ``ref``: path → norm.  ``skip``: paths left out."""
    keys = [k for k in ref if k not in skip]
    med = sorted(ref[k] for k in ref)[len(ref) // 2]
    worst, where = 0.0, ""
    for k in keys:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if gap > worst:
            worst, where = gap, k
    return worst, where
