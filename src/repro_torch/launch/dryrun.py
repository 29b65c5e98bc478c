"""Multi-pod dry-run census: every (arch × shape × mesh) cell's step run
once on ``meta`` tensors as one rank; port of `repro.launch.dryrun`.

For each cell this builds the abstract params, optimizer state, cache
and inputs (`launch/specs.py`: ``meta`` tensors, no allocation), takes
rank 0's parts of them by the plan's shardings, runs the train, prefill
or serve step on them under a fake process group of the mesh's size
(``torch.testing._internal.distributed.fake_pg``: every collective is
issued, none moves data) and records:

* ``memory.argument_size_in_bytes``: the rank's bytes by the plan's
  shard shapes (every rank holds as much: sanitized specs split evenly),
  and whether they fit an H100's 80 GB (``fits_h100``);
* ``memory.temp_size_in_bytes``: the peak of live ``meta`` bytes the
  step allocates;
* ``flops_per_device`` (loop-aware, B7's by its formula) and
  ``flopcounter_flops_bodyonce``, collective bytes by op
  (`launch/op_analysis.py`, the counterpart of `hlo_analysis`);
* ``model_flops`` (6·N·D train / 2·N·D inference) and ``param_count``,
  as the reference computes them;
* ``roofline``: the step's least time by each of the card's rates, from
  `launch/mesh.py`'s H100 constants.

A cell that raises is recorded with its message and traceback
(``status: "error"``), never skipped.  These are counts, not times on the
card.  Meshes: the reference's ``pod`` (16, 16) and ``multipod``
(2, 16, 16), and the port's ``host`` mesh, `make_production_mesh` with a
model axis of 8 (an 8-card H100 host), (32, 8).  Each mesh's cells run
in processes of their own (``--jobs`` of them), each a fake world of the
mesh's size whose rank 0 is this process; the group is destroyed when
the process's cells are done.

Results go to ``dryrun_out/<arch>__<shape>__<mesh>.json`` at the root of
the checkout (``--out`` to change); re-runs skip cached cells unless
``--force``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh all \\
      --jobs 4
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --smoke --out /tmp/census   # SMOKE configs on worlds of 8
"""
from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, applicable, get_config
from repro_torch.configs import get_smoke_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import op_analysis

RESULTS_DIR = Path(__file__).resolve().parents[3] / "dryrun_out"
H100_BYTES = 80e9

# mesh name → (world size, make_production_mesh keywords)
MESHES = {
    "pod": (256, {"model": 16}),
    "multipod": (512, {"model": 16, "multi_pod": True}),
    "host": (256, {"model": 8}),
}
# the same three layouts on worlds of 8: (4, 2), (2, 2, 2), (2, 4)
SMOKE_MESHES = {
    "pod": (8, {"model": 2}),
    "multipod": (8, {"model": 2, "multi_pod": True}),
    "host": (8, {"model": 4}),
}
MESH_CHOICES = {"pod": ["pod"], "multipod": ["multipod"], "host": ["host"],
                "both": ["pod", "multipod"],
                "all": ["pod", "multipod", "host"]}


def model_flops(cfg, spec) -> float:
    n = cfg.param_count_estimate()
    if spec.kind == "train":
        return 6.0 * n * spec.global_batch * spec.seq_len
    if spec.kind == "prefill":
        return 2.0 * n * spec.global_batch * spec.seq_len
    return 2.0 * n * spec.global_batch  # decode: one token per sequence


@contextlib.contextmanager
def fake_world(size: int, rank: int = 0):
    """A fake process group of ``size`` ranks in which this process is
    ``rank``: collectives are issued and move nothing.  Destroyed on
    exit, so it does not outlive the census."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _peak_flops(cfg) -> float:
    return (mesh_lib.PEAK_FLOPS_FP32 if cfg.dtype == torch.float32
            else mesh_lib.PEAK_FLOPS_BF16)


def _roofline(record: dict, cfg) -> dict:
    """The step's least time by each rate of one H100 (`launch/mesh.py`):
    its FLOPs at the peak for the config's dtype, its argument and temp
    bytes read once from HBM, its collective bytes over NVLink."""
    mem = record["memory"]
    return {
        "compute_s": record["flops_per_device"] / _peak_flops(cfg),
        "memory_s": (mem["argument_size_in_bytes"]
                     + mem["temp_size_in_bytes"]) / mesh_lib.HBM_BW,
        "collective_s": (record["collectives"]["total_bytes"]
                         / mesh_lib.NVLINK_BW),
    }


def _build(cfg, spec, plan):
    """(step, args, shardings) of the cell: rank 0's parts of the
    abstract values as the step takes them."""
    from repro_torch.launch.specs import (
        build_decode_cell,
        build_prefill_cell,
        build_train_cell,
    )
    from repro_torch.parallel.sharding_utils import local_tree

    build = {"train": build_train_cell, "prefill": build_prefill_cell,
             "decode": build_decode_cell}[spec.kind]
    step, abstract, shardings = build(cfg, spec, plan)
    if spec.kind == "train":
        (state, inputs), (state_sh, input_sh) = abstract, shardings
        local = {k: v for k, v in state.items() if k != "step"}
        local = local_tree(local, {k: state_sh[k] for k in local})
        local["step"] = state["step"]
        return step, (local, local_tree(inputs, input_sh)), abstract, \
            shardings
    return step, tuple(local_tree(a, s) for a, s in zip(abstract, shardings)), \
        abstract, shardings


def run_cell(arch: str, shape: str, multi_pod: bool = False, *,
             force: bool = False, plan_overrides: dict | None = None,
             tag: str = "", cfg_overrides: dict | None = None,
             mesh: str | None = None, smoke: bool = False,
             out_dir: Path | None = None, spec=None) -> dict:
    """One cell on this process's process group (whose size must be the
    mesh's; `main` starts the fake worlds).  ``mesh``: "pod", "multipod"
    or "host" (default: ``multi_pod`` picks between the reference's
    two).  ``spec``: a `ShapeSpec` in place of ``SHAPES[shape]``.
    Returns the record, also written as JSON."""
    from repro_torch.launch.specs import plan_for_cell

    mesh_name = mesh or ("multipod" if multi_pod else "pod")
    out_dir = Path(out_dir) if out_dir is not None else RESULTS_DIR
    out_path = out_dir / f"{arch}__{shape}__{mesh_name}{tag}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    spec = spec or SHAPES[shape]
    _, kw = (SMOKE_MESHES if smoke else MESHES)[mesh_name]
    mesh = mesh_lib.make_production_mesh(device="cpu", **kw)
    record = {
        "arch": arch, "shape": shape, "mesh": mesh_name,
        "mesh_shape": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "chips": mesh_lib.mesh_chips(mesh), "kind": spec.kind,
        "status": "error", "tag": tag, "smoke": smoke,
        "model_flops": model_flops(cfg, spec),
        "param_count": cfg.param_count_estimate(),
    }
    t0 = time.time()
    try:
        plan = plan_for_cell(cfg, spec, mesh, overrides=plan_overrides)
        step, local, abstract, shardings = _build(cfg, spec, plan)
        record["build_s"] = round(time.time() - t0, 2)
        counts = op_analysis.count_step(step, *local)
        record["count_s"] = round(time.time() - t0 - record["build_s"], 2)
        args = op_analysis.argument_bytes(abstract, shardings)
        record["memory"] = {"argument_size_in_bytes": args,
                            "temp_size_in_bytes": counts["temp_bytes"]}
        record["fits_h100"] = args <= H100_BYTES
        record["flops_per_device"] = counts["flops"]
        record["wkv_flops_per_device"] = counts["wkv_flops"]
        record["flopcounter_flops_bodyonce"] = counts["flops_bodyonce"]
        record["collectives"] = counts["collectives"]
        record["roofline"] = _roofline(record, cfg)
        record["status"] = "ok"
    except Exception as e:  # record failures — they are faults to fix
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    record["wall_s"] = round(time.time() - t0, 2)

    out_dir.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(record, indent=1))
    extra = ("" if record["status"] == "ok"
             else f"  {record.get('error', '')[:120]}")
    print(f"[dryrun] {arch:22s} {shape:12s} {mesh_name:8s} "
          f"{record['status']} {record['wall_s']:.1f}s{extra}", flush=True)
    return record


def _run_cells(mesh_name: str, cells: list, smoke: bool, force: bool,
               out_dir: str) -> list[dict]:
    """A process's share of one mesh's cells, in a fake world of the
    mesh's size (rank 0)."""
    torch.set_num_threads(1)
    size, _ = (SMOKE_MESHES if smoke else MESHES)[mesh_name]
    with fake_world(size):
        return [run_cell(arch, shape, mesh=mesh_name, smoke=smoke,
                         force=force, out_dir=Path(out_dir))
                for arch, shape in cells]


def census(archs, shapes, meshes, *, smoke=False, force=False, jobs=1,
           out_dir=RESULTS_DIR) -> list[dict]:
    """Every applicable (arch, shape) cell on every mesh, each mesh's
    cells over ``jobs`` spawned processes (none shares a process group
    with this one); the records in (mesh, arch, shape) order."""
    cells = [(a, s) for a in archs for s in shapes
             if applicable(a, get_config(a).family, s)]
    tasks = [(m, cells[i::jobs], smoke, force, str(out_dir))
             for m in meshes for i in range(jobs) if cells[i::jobs]]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(jobs, len(tasks))) as pool:
        parts = pool.starmap(_run_cells, tasks)
    order = {(m, a, s): i for i, (m, (a, s)) in enumerate(
        (m, c) for m in meshes for c in cells)}
    records = [r for part in parts for r in part]
    return sorted(records, key=lambda r: order[(r["mesh"], r["arch"],
                                                r["shape"])])


def summary(records: list[dict]) -> list[str]:
    """A line a mesh: cells ok and failed, the largest per-rank argument
    bytes (and its cell), and the cells whose argument bytes exceed one
    H100's 80 GB."""
    lines = []
    for mesh in dict.fromkeys(r["mesh"] for r in records):
        rs = [r for r in records if r["mesh"] == mesh]
        ok = [r for r in rs if r["status"] == "ok"]
        line = (f"[dryrun] {mesh} {rs[0]['mesh_shape']}: {len(ok)} ok, "
                f"{len(rs) - len(ok)} failed")
        if ok:
            big = max(ok, key=lambda r: r["memory"]["argument_size_in_bytes"])
            over = [f"{r['arch']}/{r['shape']} "
                    f"{r['memory']['argument_size_in_bytes'] / 1e9:.2f} GB"
                    for r in ok if not r["fits_h100"]]
            line += (f"; largest per-rank arguments "
                     f"{big['memory']['argument_size_in_bytes'] / 1e9:.2f} "
                     f"GB ({big['arch']}/{big['shape']}); over 80 GB: "
                     f"{', '.join(over) or 'none'}")
        lines.append(line)
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=list(MESH_CHOICES), default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="SMOKE configs on worlds of 8")
    ap.add_argument("--jobs", type=int, default=1,
                    help="processes a mesh's cells are spread over")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = [args.shape] if args.shape else list(SHAPES)
    n_skip = sum(1 for a in archs for s in shapes
                 if not applicable(a, get_config(a).family, s)) \
        * len(MESH_CHOICES[args.mesh])
    t0 = time.time()
    records = census(archs, shapes, MESH_CHOICES[args.mesh], smoke=args.smoke,
                     force=args.force, jobs=args.jobs, out_dir=args.out)
    for line in summary(records):
        print(line)
    n_ok = sum(r["status"] == "ok" for r in records)
    n_fail = len(records) - n_ok
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed, {n_skip} skipped "
          f"(inapplicable cells) in {time.time() - t0:.1f} s")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
