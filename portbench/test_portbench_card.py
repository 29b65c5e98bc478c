"""On the card (``python -m pytest -m cuda portbench/``): each cell at its
own size, on three seeds, with a short window: the program's numbers lie
within their limits, and the control (the reference with TF32 put in the
program's place) fails at least one of them, as does each fault a
training cell plants in the reference (its driver's ``FAULTS``)."""
from __future__ import annotations

import json

import pytest
import torch

from portbench import common
from portbench.run import cell_run, driver

#: Window a cell's reading needs: serving long enough to finish the mix's
#: longest request, training none (its numbers are read in set-up).
SECONDS = {"vww-serve": 5.0, "rwkv-serve": 15.0, "vww-train": 2.0}
CASES = [(w["name"], seed) for w in common.benchmark()["workloads"]
         for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    common.set_float32(torch, tf32=False)
    return torch.device("cuda", 0)


def _fails(readings: dict, limits: dict) -> bool:
    return any(readings.get(k, 0.0) > lim for k, lim in limits.items())


@pytest.mark.cuda
@pytest.mark.parametrize("cell, seed", CASES)
def test_control_fails_where_the_program_holds(card, cell, seed):
    r = cell_run(common.benchmark(), cell, seed, SECONDS.get(cell, 10.0),
                 False, card)
    r.control = True
    driver(r).run(r)
    common.log(f"[readings] {cell} {seed} {json.dumps(r.readings, default=str)}")
    assert r.correct, r.checks
    assert _fails(r.readings["control"], r.limits), r.readings
    for fault in getattr(driver(r), "FAULTS", ()):
        assert _fails(r.readings[fault], r.limits), (fault, r.readings)
