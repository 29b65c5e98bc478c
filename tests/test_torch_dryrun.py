"""The port's dry-run census (`repro_torch.launch.dryrun`,
`launch/op_analysis.py`) against the reference's compiled cells
(`repro.launch.dryrun`'s ``memory_analysis`` and `hlo_analysis`).

The reference compiles its SMOKE cells in a subprocess with 8 virtual
XLA devices over a ``jax.sharding.Mesh`` (2, 4) built by the caller:
its axes are Auto, which ``with_sharding_constraint`` needs under JAX
0.9 (``jax.make_mesh``, which the reference's own `make_production_mesh`
calls, makes Explicit axes that it refuses).  The port runs the same
cells as rank 0 of a fake world of 8 over its mesh (2, 4), on ``meta``
tensors.  Per cell (prefill and train at 8 × 64 for the dense, MoE,
RWKV, RG-LRU, VLM and encoder-decoder SMOKE configs):

* the rank's argument bytes equal the reference's
  ``argument_size_in_bytes``, which counts the train state's int32
  ``step`` (4 B) that the port keeps as a host int;
* ``param_count`` and ``model_flops`` equal;
* the prefill FLOPs are within 2 % of `hlo_analysis.analyze`'s dot count
  where no WKV runs (they agree to the FLOP; the WKV's work is counted
  by the port's formula and by XLA's loops otherwise);
* collective bytes are printed side by side, not asserted: XLA picks its
  own gathers and reductions.

Then the CLI: ``--all --mesh both --smoke`` over the SMOKE configs on
fake (4, 2) and (2, 2, 2) worlds refuses no cell, and no fake process
group outlives a census in the test's process.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, SHAPES, applicable, get_config
from repro_torch.configs import get_smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
ARCHS = {"dense": "llama3.2-1b", "moe": "qwen3-moe-30b-a3b",
         "rwkv": "rwkv6-3b", "rglru": "recurrentgemma-9b",
         "vlm": "llama-3.2-vision-11b", "encdec": "whisper-tiny"}
KINDS = ("prefill", "train")
BATCH, SEQ = 8, 64
STEP_BYTES = 4  # the reference's int32 train step
FLOPS_RTOL = 0.02

REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import numpy as np
from repro.configs import get_smoke_config
from repro.configs.shapes import ShapeSpec
from repro.launch.hlo_analysis import analyze
from repro.launch.specs import (build_prefill_cell, build_train_cell,
                                plan_for_cell)
from repro.parallel import use_plan

mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(2, 4),
                         ("data", "model"))
out = {}
for arch in sys.argv[1].split(","):
    for kind in ("prefill", "train"):
        cfg = get_smoke_config(arch)
        spec = ShapeSpec(kind, kind, int(sys.argv[3]), int(sys.argv[2]))
        plan = plan_for_cell(cfg, spec, mesh)
        with use_plan(plan), mesh:
            if kind == "train":
                step, abstract, sh = build_train_cell(cfg, spec, plan)
                jitted = jax.jit(step, in_shardings=sh,
                                 out_shardings=(sh[0], None))
            else:
                step, abstract, sh = build_prefill_cell(cfg, spec, plan)
                jitted = jax.jit(step, in_shardings=sh)
            compiled = jitted.lower(*abstract).compile()
        ana = analyze(compiled.as_text())
        out[arch + "/" + kind] = {
            "argument_bytes":
                int(compiled.memory_analysis().argument_size_in_bytes),
            "flops": ana["flops"], "collectives": ana["collectives"],
            "param_count": cfg.param_count_estimate(),
            # repro.launch.dryrun.model_flops (importing that module sets
            # XLA_FLAGS and a compilation cache of its own)
            "model_flops": (6.0 if kind == "train" else 2.0)
            * cfg.param_count_estimate() * spec.global_batch
            * spec.seq_len}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """(the reference's records, the port's) by "arch/kind"."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, ",".join(ARCHS.values()),
         str(BATCH), str(SEQ)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    out = tmp_path_factory.mktemp("census")
    port = {}
    try:
        with dryrun.fake_world(8):
            for arch in ARCHS.values():
                for kind in KINDS:
                    port[f"{arch}/{kind}"] = dryrun.run_cell(
                        arch, kind, mesh="host", smoke=True, force=True,
                        out_dir=out, spec=ShapeSpec(kind, kind, SEQ, BATCH))
    finally:
        stdout, stderr = ref.communicate(timeout=600)
    assert ref.returncode == 0, stderr[-4000:]
    return json.loads(stdout.strip().splitlines()[-1]), port


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small shapes: one intra-op thread (parallel test workers share the
    host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids():
    return [f"{family}-{kind}" for family in ARCHS for kind in KINDS]


@pytest.mark.parametrize("family,kind", [(f, k) for f in ARCHS for k in KINDS],
                         ids=_ids())
def test_census_matches_the_reference_compile(cells, family, kind):
    ref, port = cells
    key = f"{ARCHS[family]}/{kind}"
    want, got = ref[key], port[key]
    assert got["status"] == "ok", got.get("traceback")
    assert got["mesh_shape"] == {"data": 2, "model": 4}
    extra = STEP_BYTES if kind == "train" else 0
    assert got["memory"]["argument_size_in_bytes"] + extra == \
        want["argument_bytes"]
    assert got["param_count"] == want["param_count"]
    assert got["model_flops"] == want["model_flops"]
    if kind == "prefill" and family != "rwkv":
        assert got["flops_per_device"] == pytest.approx(want["flops"],
                                                        rel=FLOPS_RTOL)
    if family == "rwkv":
        assert got["wkv_flops_per_device"] > 0
    print(f"{key}: collective bytes port "
          f"{got['collectives']['total_bytes']} vs XLA "
          f"{want['collectives']['total_bytes']}; FLOPs port "
          f"{got['flops_per_device']} vs XLA {want['flops']}")


def test_census_records_a_failing_cell_with_its_traceback(tmp_path):
    """A cell that raises is data: its record says error, with the
    message and the traceback, and the group is gone after the census."""
    with dryrun.fake_world(8):
        rec = dryrun.run_cell("llama3.2-1b", "prefill_32k", mesh="pod",
                              smoke=True, force=True, out_dir=tmp_path,
                              cfg_overrides={"family": "no-such-family"})
    assert rec["status"] == "error"
    assert rec["error"] and "Traceback" in rec["traceback"]
    assert json.loads((tmp_path / "llama3.2-1b__prefill_32k__pod.json")
                      .read_text())["status"] == "error"
    assert not dist.is_initialized()


def test_cli_runs_every_smoke_cell_on_both_meshes(tmp_path, capsys):
    dryrun.main(["--all", "--mesh", "both", "--smoke", "--jobs", "3",
                 "--out", str(tmp_path)])
    names = sorted(p.name for p in tmp_path.glob("*.json"))
    want = sorted(f"{a}__{s}__{m}.json" for a in ARCH_IDS for s in SHAPES
                  if applicable(a, get_config(a).family, s)
                  for m in ("pod", "multipod"))
    assert names == want
    records = [json.loads((tmp_path / n).read_text()) for n in names]
    assert all(r["status"] == "ok" for r in records), [
        (r["arch"], r["shape"], r["mesh"], r.get("error")) for r in records
        if r["status"] != "ok"]
    shapes = {r["mesh"]: r["mesh_shape"] for r in records}
    assert shapes == {"pod": {"data": 4, "model": 2},
                      "multipod": {"pod": 2, "data": 2, "model": 2}}
    for r in records:
        assert r["fits_h100"] and r["memory"]["argument_size_in_bytes"] > 0
        assert r["collectives"]["total_bytes"] >= 0
    assert "0 failed" in capsys.readouterr().out
    assert not dist.is_initialized()


def test_no_fake_group_leaks_into_the_next_test():
    """The census's groups live in its own processes or end with it."""
    assert not dist.is_initialized()
    assert torch.distributed.is_available()


def test_model_flops_is_the_references_rule():
    cfg = get_smoke_config("llama3.2-1b")
    n = cfg.param_count_estimate()
    train, prefill, decode = (SHAPES[s] for s in ("train_4k", "prefill_32k",
                                                  "decode_32k"))
    assert dryrun.model_flops(cfg, train) == 6.0 * n * 256 * 4096
    assert dryrun.model_flops(cfg, prefill) == 2.0 * n * 32 * 32768
    assert dryrun.model_flops(cfg, decode) == 2.0 * n * 128
