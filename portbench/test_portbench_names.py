"""The benchmark's files: every name in ``BENCHMARK.json`` resolves, the
file keeps to its form, and nothing in `portbench/` imports JAX or the
JAX package (nor the reference the program)."""
from __future__ import annotations

import ast
import importlib
import re

import pytest

from portbench import common, run

BENCH = common.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def _one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_by_name(cell):
    w = common.cell(cell)
    cfg = common.config_file(w["config"])
    tr = common.traffic_file(w["traffic"])
    limits = common.cell_file(cell)["limits"]
    mod = importlib.import_module(
        f"portbench.drivers.{cfg['family']}_{tr['mode']}")
    assert callable(mod.run)
    assert limits and all(v > 0 for v in limits.values())
    e2e = {m["name"] for m in BENCH["end_to_end"]
           if run.applies(m, cell, set())}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in BENCH["per_layer"] if run.applies(m, cell, e2e)]
    assert layer and all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_resolves_by_name(metric):
    assert callable(run.reader(metric))


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file_is_under_paths(config):
    c = next(c for c in BENCH["configs"] if c["name"] == config)
    assert c["file"] == f"portbench/configs/{config}.json"
    assert common.config_file(config)["family"]
    assert c["reduced"] == []


def test_benchmark_json_keeps_its_form():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1].startswith("portbench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    n_cells = len(BENCH["workloads"])
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in BENCH[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _one_line(c["source"]) and _one_line(c["why"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _one_line(w["why"])
        assert NAME.match(w["traffic"]) and (w["config"], w["traffic"]) \
            not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert n_cells >= 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _one_line(m["layer"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def _imports(path) -> set[str]:
    """Top-level module names a file imports (absolute imports)."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".", 1)[0])
    return out


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(common.HERE.rglob("*.py"))
    assert files
    for path in files:
        found = _imports(path) & set(common.FORBIDDEN_MODULES)
        assert not found, f"{path} imports {found}"


def test_reference_imports_nothing_of_the_program():
    for path in sorted((common.HERE / "reference").rglob("*.py")):
        assert "repro_torch" not in _imports(path), path


def test_import_check_compares_whole_names():
    assert common.forbidden_loaded(["repro_torch", "repro_torch.serving",
                                    "jaxtyping", "flaxen", "torch"]) == []
    assert common.forbidden_loaded(["repro_torch", "repro.core", "jax.numpy",
                                    "jaxlib", "flax"]) == [
        "flax", "jax", "jaxlib", "repro"]
