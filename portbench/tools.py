"""Chip-side tools for setting the benchmark's numbers; the benchmark's
runs never call them.

    python3 portbench/tools.py sweep --rates 200 250 300 --seconds 10
    python3 portbench/tools.py readings --workload vww-train --seeds 1 2 3 \\
        --seconds 10 [--control] [--set sample=16]

``sweep`` serves ``--config`` (p2m-vww) under ``--traffic``
(poisson-frames) at each rate in one process and
prints, a rate a line, the frames due, missing, the backlog at the
close and the tail: the knee is the highest rate at which nothing is
evicted and the backlog does not grow.  ``readings`` runs a cell on each
seed in one process and prints, a seed a line, the numbers compared
with the reference, and with ``--control`` the control's (the reference
with TF32) and, for training cells, the reference with half of each
batch left out."""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent.parent),
                str(Path(__file__).resolve().parent.parent / "src")]

from portbench import common  # noqa: E402
from portbench.run import cell_run, driver, make_run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("sweep", "readings"))
    ap.add_argument("--workload", default="vww-train")
    ap.add_argument("--config", default="p2m-vww")
    ap.add_argument("--traffic", default="poisson-frames")
    ap.add_argument("--rates", type=float, nargs="*", default=())
    ap.add_argument("--seeds", type=int, nargs="*", default=(1,))
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--set", nargs="*", default=(), metavar="KEY=VALUE",
                    help="traffic keys to override (JSON values)")
    args = ap.parse_args(argv)
    overrides = {k: json.loads(v) for k, v in
                 (kv.split("=", 1) for kv in args.set)}
    common.set_cache_dirs()
    common.one_thread()
    import torch

    if not torch.cuda.is_available():
        common.log("no CUDA device")
        return 2
    common.set_float32(torch, tf32=False)
    common.log(f"[card] {common.card_line()}")
    bench = common.benchmark()
    dev = torch.device("cuda", 0)
    if args.what == "sweep":
        for rate in args.rates:
            r = make_run("sweep", args.config, args.traffic, {},
                         args.seeds[0], args.seconds, False, dev)
            r.traffic.update(overrides, rate_per_s=rate)
            driver(r).run(r)
            print(json.dumps({"rate": rate, "due": r.attempted,
                              "missing": r.failed,
                              "backlog_at_close": r.layer["backlog_at_close"],
                              "evictions": r.layer["evictions"],
                              "launch_ms": r.layer["launch_ms"],
                              "launches": r.layer["launches"],
                              "frame_p95_ms": r.e2e["frame_p95_ms"],
                              "checks": r.checks}), flush=True)
        return 0
    for seed in args.seeds:
        r = cell_run(bench, args.workload, seed, args.seconds, False, dev)
        r.traffic.update(overrides)
        r.control = args.control
        driver(r).run(r)
        print(json.dumps({"seed": seed, "checks": r.checks, "e2e": r.e2e,
                          "readings": r.readings,
                          "memory_peak_bytes": r.memory_peak_bytes},
                         default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
