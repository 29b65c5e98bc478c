"""The port's conv tuner (`repro_torch.kernels.p2m_conv.tune`) and the
pipelined conv's contract (`conv.p2m_conv_fused` and `ops.p2m_conv` with
``pipeline_depth``) on the CPU, against the JAX package.

Mirrors `tests/test_p2m_conv_pipelined.py`: the forward and gradient
parity over random geometries (`:79-133`), the depth checks (`:136-160`)
and the tuner satellites (`:304-348`).  On the CPU the wrapper runs its
plain twin whatever the depth, so depth 2 equals depth 0 bit for bit here
by construction; the kernel B2 itself is held to B1 bit for bit in
`tests/test_torch_cuda.py`, on a GPU.  Against the reference's Pallas
kernel in interpret mode: raw and relu rtol/atol 1e-5 (fp32 sums in
another order; the reference's own tolerance against its XLA twin), quant
by the count rule of `tests/test_torch_p2m_conv.py`; gradients rtol 1e-4,
atol 1e-5, as the reference holds its own.
"""
import json
import logging

import jax
import numpy as np
import pytest
import torch

from repro.core.adc import ADCConfig as JADCConfig
from repro.core.pixel_model import default_pixel_model as j_default_model
from repro.kernels.p2m_conv import p2m_conv as j_p2m_conv
from repro.kernels.p2m_conv import p2m_conv_pallas
from repro.kernels.p2m_conv.ops import _coeff_tuple as j_coeff_tuple
from repro_torch.core.adc import ADCConfig
from repro_torch.core.pixel_model import default_pixel_model
from repro_torch.kernels.p2m_conv import conv, kernel, ops, tune
from repro_torch.obs.metrics import default_registry

MODEL = default_pixel_model()
COEFFS = ops._coeff_tuple(MODEL)
ADC = ADCConfig()
J_MODEL = j_default_model()
J_COEFFS = j_coeff_tuple(J_MODEL)
MODES = ("raw", "relu", "quant")
N_OUT = 5  # off the lane quantum, as the reference's tests draw it
CPU = torch.device("cpu")


def _data(b, h, w, c, k, n=N_OUT, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.random((b, h, w, c)).astype(np.float32)
    scale = (3.0 / (k * k * c)) ** 0.5  # the model's init scale
    wt = (rng.uniform(-1, 1, (k * k * c, n)) * scale).astype(np.float32)
    sh = rng.uniform(-0.2, 0.2, (n,)).astype(np.float32)
    return imgs, wt, sh


def _port_fused(imgs, wt, sh, k, s, mode, depth, want_raw=False):
    wrows = conv.premix_rows(torch.from_numpy(wt), COEFFS, k)
    return conv.p2m_conv_fused(
        torch.from_numpy(imgs), wrows, torch.from_numpy(sh), kernel=k,
        stride=s, mode=mode, want_raw=want_raw, pipeline_depth=depth)


def _ref_pallas(imgs, wt, sh, k, s, mode, depth):
    return np.asarray(p2m_conv_pallas(
        imgs, wt, sh, kernel=k, stride=s, coeffs=J_COEFFS, mode=mode,
        pipeline_depth=depth, interpret=True))


def _geometries(n, seed):
    """(h, w, c, k, s, depth, mode) draws like the reference's property
    test: s == k for the fast path or 1 ≤ s < k, depth 2 or 3."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(2, 6))
        h, w = max(int(rng.integers(4, 15)), k), max(int(rng.integers(4, 15)),
                                                       k)
        s = k if i % 3 == 0 else int(rng.integers(1, k))
        out.append((h, w, int(rng.integers(1, 4)), k, s,
                    (2, 3)[i % 2], MODES[i % 3]))
    return out


# ------------------------------------------------------ depth contract


@pytest.mark.parametrize("h,w,c,k,s,depth,mode", _geometries(9, seed=16))
def test_pipelined_forward_parity_random_geometry(h, w, c, k, s, depth,
                                                  mode):
    imgs, wt, sh = _data(2, h, w, c, k, seed=h * 31 + w * 7 + k + s)
    grid, raw = _port_fused(imgs, wt, sh, k, s, mode, 0, want_raw=True)
    pipe, pipe_raw = _port_fused(imgs, wt, sh, k, s, mode, depth,
                                 want_raw=True)
    assert torch.equal(grid, pipe) and torch.equal(raw, pipe_raw)
    ref = _ref_pallas(imgs, wt, sh, k, s, mode, depth)
    if mode == "quant":
        rep = conv.quant_disagreement(torch.from_numpy(ref), pipe, raw,
                                      ADC.v_lsb)
        assert rep["max_count_diff"] <= 1 and rep["all_near_half"], rep
        assert rep["n_diff"] <= max(1, 1e-4 * ref.size), rep
    else:
        np.testing.assert_allclose(pipe.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,c,k,s,depth", [(12, 2, 4, 4, 2), (9, 1, 3, 2, 3),
                                           (10, 2, 2, 1, 2)])
def test_pipelined_grad_parity_random_geometry(h, c, k, s, depth):
    """Gradients through `ops.p2m_conv` with depth 2/3 equal those with
    depth 0 bit for bit, and the reference's custom VJP (pipelined
    forward, Pallas backward in interpret mode) to tolerance."""
    imgs, wt, sh = _data(2, h, h, c, k, seed=h * 13 + c + k * s)

    def grads(depth_):
        ins = [torch.from_numpy(a).requires_grad_(True)
               for a in (imgs, wt, sh)]
        out = ops.p2m_conv(*ins, MODEL, ADC, "relu", k, s,
                           pipeline_depth=depth_)
        return torch.autograd.grad((out ** 2).sum(), ins)

    g_grid, g_pipe = grads(0), grads(depth)
    for a, b in zip(g_grid, g_pipe):
        assert torch.equal(a, b)

    def loss(im, ww, ss):
        out = j_p2m_conv(im, ww, ss, J_MODEL, JADCConfig(), "relu", k, s,
                         True, "pallas", depth)
        return (out ** 2).sum()

    g_ref = jax.grad(loss, argnums=(0, 1, 2))(imgs, wt, sh)
    for a, b in zip(g_pipe, g_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("bad", [1, -2])
def test_pipeline_depth_one_rejected(bad):
    imgs, wt, sh = _data(1, 10, 10, 3, 5, seed=0)
    with pytest.raises(ValueError):  # the reference refuses it too
        _ref_pallas(imgs, wt, sh, 5, 5, "relu", bad)
    with pytest.raises(ValueError, match="pipeline_depth"):
        _port_fused(imgs, wt, sh, 5, 5, "relu", bad)
    with pytest.raises(ValueError, match="pipeline_depth"):
        ops.p2m_conv(torch.from_numpy(imgs), torch.from_numpy(wt),
                     torch.from_numpy(sh), MODEL, pipeline_depth=bad)


def test_pipeline_depth_deeper_than_k_clamps():
    imgs, wt, sh = _data(1, 15, 15, 3, 5, seed=4)
    grid = _port_fused(imgs, wt, sh, 5, 5, "relu", 0)
    deep = _port_fused(imgs, wt, sh, 5, 5, "relu", 8)
    assert torch.equal(grid, deep)
    np.testing.assert_allclose(deep.numpy(),
                               _ref_pallas(imgs, wt, sh, 5, 5, "relu", 8),
                               rtol=1e-5, atol=1e-5)
    cands = tune.conv_candidates(1, 3, 3, 8, 15, kernel=5, stride=5,
                                 depths=(0, 8))
    assert {c[2] for c in cands} == {0, 5}  # the ring has at most k slots


# ------------------------------------------------------ tuner


@pytest.fixture
def clean_tuner():
    tune.cache_clear()
    tune._DISABLED_LOGGED.clear()
    yield
    tune.cache_clear()
    tune._DISABLED_LOGGED.clear()


def test_conv_cache_key_distinguishes_depth_menu_and_device(clean_tuner,
                                                            monkeypatch):
    args = (1, 12, 12, 3, 8, 3, 3, COEFFS, "relu")
    tune.get_conv_blocks(*args, device=CPU, enable=True, iters=1,
                         depths=(0,))
    tune.get_conv_blocks(*args, device=CPU, enable=True, iters=1,
                         depths=(0, 2))
    keys = [k for k in tune._CACHE if k[0] == "conv"]
    assert len(keys) == 2  # distinct depth menus, distinct entries
    for key in keys:
        assert key[-3:-1] == ("cpu", "cpu")  # device type and name
    assert {key[-1] for key in keys} == {(0,), (0, 2)}
    (only_b1,) = [tune._CACHE[k]["best"] for k in keys if k[-1] == (0,)]
    assert only_b1[2] == 0
    # another card's name is another signature
    monkeypatch.setattr(tune, "_device_name", lambda device: "other card")
    tune.get_conv_blocks(*args, device=CPU, enable=True, iters=1,
                         depths=(0,))
    assert len([k for k in tune._CACHE if k[0] == "conv"]) == 3


def test_autotune_disabled_logs_defaults_once(clean_tuner, caplog):
    counter = default_registry().counter("autotune.disabled_default")
    before = counter.value
    with caplog.at_level(logging.INFO, logger=tune.logger.name):
        assert tune.get_conv_blocks(1, 12, 12, 3, 8, 3, 3, COEFFS, "relu",
                                    device=CPU) == (None, None, 0)
        tune.get_conv_blocks(2, 16, 16, 3, 8, 5, 5, COEFFS, "quant",
                             device=CPU, enable=False)  # no second log
    msgs = [r.message for r in caplog.records
            if "p2m_autotune_disabled_defaults" in r.message]
    assert len(msgs) == 1
    payload = json.loads(msgs[0])
    assert payload["kind"] == "conv"
    assert payload["device"] == "cpu"
    assert payload["default"] == [None, None, 0]
    assert counter.value == before + 2
    assert not tune._CACHE


def test_enabled_on_cuda_or_by_switch(monkeypatch):
    monkeypatch.delenv("REPRO_P2M_AUTOTUNE", raising=False)
    assert not tune.enabled(CPU)
    assert tune.enabled(torch.device("cuda"))
    assert tune.enabled(CPU, enable=True)
    assert not tune.enabled(torch.device("cuda"), enable=False)
    monkeypatch.setenv("REPRO_P2M_AUTOTUNE", "1")
    assert tune.enabled(CPU)


@pytest.mark.parametrize("b,h,w,c,n,k,s", [
    (8, 560, 560, 3, 8, 5, 5),  # serving
    (32, 560, 560, 3, 8, 5, 5),  # training
    (4, 560, 560, 3, 8, 5, 5),  # streaming
    (2, 64, 64, 3, 40, 5, 3),  # s < k, two N tiles
    (1, 9, 9, 1, 16, 4, 4),
    (1, 30, 4000, 3, 8, 5, 5),  # Wo = 799: B1 only
    (1, 60, 60, 3, 8, 15, 15),  # B1's W̃ exceeds its 48 KB: B2 only
])
@pytest.mark.parametrize("budget", [tune.SMEM_BUDGET_BYTES, 16 * 1024])
def test_conv_candidates_respect_the_budget(b, h, w, c, n, k, s, budget):
    ho, wo = conv.conv_out_spatial(h, k, s), conv.conv_out_spatial(w, k, s)
    dx = len(COEFFS[0])
    cands = tune.conv_candidates(b, ho, wo, n, k * c, kernel=k, stride=s,
                                 dx=dx, budget=budget)
    assert cands and len(set(cands)) == len(cands)
    if k * dx * k * c * conv._CHUNK * 4 <= 48 * 1024:
        assert (None, conv._n_tile(n, k * dx * k * c), 0) in cands  # B1
    else:
        assert all(d >= 2 for *_, d in cands)
    for bh, bn, depth in cands:
        smem = tune.conv_smem_bytes((bh, bn, depth), wo=wo, c=c, kernel=k,
                                    stride=s, dx=dx)
        if depth == 0:
            assert bh is None and smem <= 48 * 1024
        else:
            assert smem <= budget
            assert 2 <= depth <= k and bh * wo <= conv.PIPE_THREADS
            assert bh <= b * ho and bn <= conv.PIPE_MAX_TILE
    if wo > conv.PIPE_THREADS:
        assert all(d == 0 for *_, d in cands)


def test_matmul_candidates_respect_the_budget():
    for m, k, n in ((100_352, 75, 8), (4096, 147, 32), (8, 1, 1)):
        cands = tune.matmul_candidates(m, k, n, dx=3)
        assert cands and len(set(cands)) == len(cands)
        for bm, bn, bk in cands:
            assert tune.matmul_smem_bytes((bm, bn, bk), dx=3) \
                <= tune.SMEM_BUDGET_BYTES
            assert bm <= kernel.MATMUL_MAX_ROWS and bk <= k
            assert bn == kernel.matmul_tile(n, bn)


def test_autotune_enabled_on_the_cpu_exercises_the_machinery(clean_tuner,
                                                             tmp_path):
    hits = default_registry().counter("autotune.cache_hit")
    counts = (conv.p2m_conv_fused.launches,
              conv.p2m_conv_fused.launches_pipelined,
              kernel.p2m_matmul_fused.launches)
    args = (2, 13, 13, 3, 8, 5, 3, COEFFS, "quant")
    best = tune.get_conv_blocks(*args, device=CPU, enable=True, iters=2)
    (rec,) = tune.decision_records()
    assert rec["kind"] == "conv" and rec["n_failed"] == 0
    assert list(best) == rec["best"]
    assert rec["candidates"] == [list(c) for c in tune.conv_candidates(
        2, 3, 3, 8, 15, kernel=5, stride=3, dx=3)]
    assert all(t is not None and t >= 0 for t in rec["times_s"])
    assert len(rec["smem_bytes"]) == len(rec["candidates"])
    before = hits.value
    assert tune.get_conv_blocks(*args, device=CPU) == best  # cached
    assert hits.value == before + 1
    mm = tune.get_matmul_blocks(64, 27, 8, COEFFS, "relu", device=CPU,
                                enable=True, iters=1)
    assert mm in tune.matmul_candidates(64, 27, 8, dx=3)
    assert counts == (conv.p2m_conv_fused.launches,
                      conv.p2m_conv_fused.launches_pipelined,
                      kernel.p2m_matmul_fused.launches)
    path = tmp_path / "tune.json"
    tune.cache_dump(str(path))
    dumped = json.loads(path.read_text())
    assert [d["best"] for d in dumped] == [list(best), list(mm)]
    assert len(tune.cache_info()) == 2


def test_autotune_records_a_failed_candidate(clean_tuner):
    failed = default_registry().counter("autotune.candidate_failed")
    before = failed.value

    def run(cand):
        if cand == "bad":
            raise RuntimeError("refused")
        return cand

    res = tune.autotune(("conv", "toy"), lambda: (["bad", "good"], run),
                        CPU, iters=1, smem=lambda c: 0)
    assert res["best"] == "good"
    rec = res["decision"]
    assert rec["n_failed"] == 1 and rec["n_viable"] == 1
    assert rec["errors"][0] == "RuntimeError: refused"
    assert rec["times_s"][0] is None and rec["errors"][1] is None
    assert failed.value == before + 1
    with pytest.raises(RuntimeError, match="no viable candidate"):
        tune.autotune(("conv", "none"), lambda: (["bad"], run), CPU,
                      iters=1)


def test_set_winner_serves_the_chosen_blocks(clean_tuner):
    hits = default_registry().counter("autotune.cache_hit")
    args = (1, 12, 12, 3, 8, 3, 3, COEFFS, "relu")
    best = tune.get_conv_blocks(*args, device=CPU, enable=True, iters=1)
    (rec,) = tune.decision_records()
    other = next(tuple(c) for c in rec["candidates"] if tuple(c) != best)
    tune.set_winner(rec["key"], other)
    before = hits.value
    # served while tuning is off, as a cached winner is
    assert tune.get_conv_blocks(*args, device=CPU, enable=False) == other
    assert hits.value == before + 1
    assert tune.decision_records() == [rec]  # the record stays
    with pytest.raises(ValueError):
        tune.set_winner("('conv', 'untuned')", best)


def test_matmul_blocks_default_when_disabled(clean_tuner):
    assert tune.get_matmul_blocks(100, 75, 8, COEFFS, "relu",
                                  device=CPU) == kernel.MATMUL_DEFAULT_BLOCKS
    assert not tune._CACHE
