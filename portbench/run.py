"""Run one cell of the benchmark of `repro_torch` and print its result.

    python3 portbench/run.py --workload rwkv-serve --seed 7 --seconds 30 \
        --trace 0

The cell (``--workload``) is an entry of ``BENCHMARK.json``; its
configuration, traffic mix, limits, driver and per-layer readers are
found by name under `portbench/`.  With ``--trace 0`` the result holds
the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones,
read from a traced sub-window.  The last line of standard output is the
result, one JSON object; the numbers compared with the reference, each
beside its limit, are the last lines of standard error and the result's
last key.  Exits 2, printing no result, without the chips the cell needs,
and 3 where the process holds JAX or the JAX package."""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import common  # noqa: E402


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = common.HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether ``metric`` is reported in ``cell``: where it lists its
    cells, in those; else an end-to-end metric in every cell, a per-layer
    one in every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def make_run(cell: str, config: str, traffic: str, limits: dict, seed: int,
             seconds: float, trace: bool, device):
    """A `session.Run` of ``config`` under ``traffic``, its files found by
    name."""
    from portbench import session

    return session.Run(cell=cell, config=common.config_file(config),
                       traffic=common.traffic_file(traffic), limits=limits,
                       seed=seed, seconds=seconds, trace=trace, device=device)


def cell_run(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device):
    """The `session.Run` of the cell ``name`` of ``BENCHMARK.json``."""
    w = common.cell(name, bench)
    return make_run(name, w["config"], w["traffic"],
                    common.cell_file(name)["limits"], seed, seconds, trace,
                    device)


def driver(run):
    return importlib.import_module(
        f"portbench.drivers.{run.config['family']}_{run.traffic['mode']}")


def metrics(bench: dict, run) -> dict:
    """The cell's end-to-end metrics (untraced) or per-layer ones (traced)
    that the run has something to read for."""
    e2e = [m for m in bench["end_to_end"] if applies(m, run.cell, set())]
    out = {}
    if not run.trace:
        for m in e2e:
            out[m["name"]] = {"value": float(run.e2e[m["name"]]),
                              "unit": m["unit"]}
        return out
    names = {m["name"] for m in e2e}
    for m in bench["per_layer"]:
        if applies(m, run.cell, names):
            value = reader(m["name"])(run)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = _parse(sys.argv[1:] if argv is None else argv)
    common.set_cache_dirs()
    common.one_thread()
    bench = common.benchmark()
    w = common.cell(args.workload, bench)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(w["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        common.log(f"no result: {args.workload} needs {w['chips']} CUDA "
                   f"device(s), this machine has {have}")
        return 2
    common.set_float32(torch, tf32=False)
    run = cell_run(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda", 0))
    driver(run).run(run)
    values = metrics(bench, run)
    bad = [k for k, m in values.items() if not math.isfinite(m["value"])]
    if bad:
        common.log(f"no result: {', '.join(bad)} not finite")
        return 4
    found = common.forbidden_loaded()
    if found:
        common.log(f"no result: the process holds {', '.join(found)}")
        return 3
    result = {"correct": run.correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": values,
              "device": {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0), "count": 1,
                         "memory_peak_bytes": run.memory_peak_bytes}}
    trace = None if run.profiler is None else run.profiler.trace
    if trace is not None:
        result["device"]["busy_s"] = trace.busy_s
        result["device"]["window_s"] = trace.window_s
        result["breakdown"] = trace.breakdown()
    result["checks"] = {k: {"value": v if math.isfinite(v) else str(v),
                            "limit": lim}
                        for k, (v, lim) in run.checks.items()}
    for k, (v, lim) in run.checks.items():
        common.log(f"check {k}: {v!r} (limit {lim!r}) "
                   f"{'ok' if v <= lim else 'OVER'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
