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
        if depth == 0:  # B1 keeps itself within its own budget
            tiling = conv.b1_tiling((b, h, w, c), n, dx, kernel=k, stride=s,
                                    block_n=bn)
            assert bh is None and smem == tiling["smem_bytes"]
            assert smem <= conv.B1_SMEM_BYTES <= tune.SMEM_BUDGET_BYTES
        else:
            assert smem <= budget
            assert 2 <= depth <= k and bh * wo <= conv.PIPE_THREADS
            assert bh <= b * ho and bn <= conv.PIPE_MAX_TILE
    if wo > conv.PIPE_THREADS:
        assert all(d == 0 for *_, d in cands)


@pytest.mark.parametrize("m,k,n", [(100_352, 75, 8), (4096, 147, 32),
                                   (8, 1, 1)])
def test_matmul_candidates_respect_the_budget(m, k, n):
    cands = tune.matmul_candidates(m, k, n, dx=3)
    assert cands and len(set(cands)) == len(cands)
    for bm, bn, bk in cands:
        smem = tune.matmul_smem_bytes((bm, bn, bk), dx=3, k=k)
        assert smem <= tune.SMEM_BUDGET_BYTES
        tiling = kernel.matmul_tiling(m, k, n, 3, block_m=bm, block_n=bn,
                                      block_k=bk)
        assert smem == tiling["smem_bytes"]
        assert bm <= kernel.MATMUL_MAX_ROWS and bk <= k
        assert bn == kernel.matmul_tile(n, bn)


# ------------------------------------------------- B1's and B6's tilings


def _block_tiles(tiles, blocks, i):
    """Block i's tiles, as ``csrc`` deals them: contiguous runs, the first
    ``tiles % blocks`` blocks one more."""
    per, extra = divmod(tiles, blocks)
    t0 = i * per + min(i, extra)
    return range(t0, t0 + per + (1 if i < extra else 0))


#: (B, H, W, C, k, s, N, dx, block_n): the serving, stream and training
#: stems; s < k; Wo = 799 (a row cut into tiles, the last partial); k =
#: 15; N = 32 over N tiles of 8; a tile count that does not divide
#: evenly over the grid (Ho·B = 9); odd W.
B1_SHAPES = [
    (8, 560, 560, 3, 8, 5, 5, 3, None),
    (4, 560, 560, 3, 8, 5, 5, 3, None),
    (32, 560, 560, 3, 8, 5, 5, 3, None),
    (2, 64, 64, 3, 40, 5, 3, 3, None),
    (1, 30, 4000, 3, 8, 5, 5, 3, None),
    (2, 45, 45, 3, 8, 15, 15, 1, None),
    (2, 40, 40, 3, 32, 5, 5, 3, 8),
    (1, 45, 50, 3, 8, 5, 5, 3, None),
    (3, 17, 23, 2, 5, 3, 2, 4, None),
]


@pytest.mark.parametrize("b,h,w,c,n,k,s,dx,block_n", B1_SHAPES)
def test_b1_tiling_covers_each_pixel_once_within_one_image(
        b, h, w, c, n, k, s, dx, block_n):
    t = conv.b1_tiling((b, h, w, c), n, dx, kernel=k, stride=s,
                       block_n=block_n)
    ho, wo = conv.conv_out_spatial(h, k, s), conv.conv_out_spatial(w, k, s)
    assert t["pieces"] == -(-wo // t["tile_px"]) and t["tile_px"] <= wo
    assert t["tiles"] == b * ho * t["pieces"]
    groups = min(k, conv.B1_GROUPS)  # a row group for each kernel row
    assert t["threads"] % (32 * groups) == 0
    assert t["threads"] // groups * conv.B1_PIXELS >= t["tile_px"]
    assert t["threads"] <= conv.B1_GROUPS * conv.B1_GROUP_THREADS
    seen = np.zeros(b * ho * wo, np.int64)
    sizes = []
    for i in range(t["blocks_x"]):
        run = _block_tiles(t["tiles"], t["blocks_x"], i)
        sizes.append(len(run))
        for tile in run:
            row, piece = divmod(tile, t["pieces"])
            ow0 = piece * t["tile_px"]
            tp = min(t["tile_px"], wo - ow0)
            assert tp >= 1  # a tile lies in one output row, one image
            seen[row * wo + ow0: row * wo + ow0 + tp] += 1
    assert (seen == 1).all()
    assert max(sizes) - min(sizes) <= 1  # balanced within one tile
    assert t["smem_bytes"] <= conv.B1_SMEM_BYTES <= tune.SMEM_BUDGET_BYTES
    assert t["smem_bytes"] == conv.b1_smem_bytes(t["tile_px"], c, k, s, dx,
                                                 t["n_tile"])
    assert t["blocks_y"] == -(-n // t["n_tile"])
    # one wave: every block resident at once
    assert t["blocks_x"] * t["blocks_y"] <= conv.H100_SMS * t["blocks_per_sm"]


@pytest.mark.parametrize("b", [8, 4, 32])
def test_b1_tiling_at_the_stem_is_whole_rows_in_one_wave(b):
    """A tile is a whole 112-pixel output row, its band one contiguous
    33,600-byte span; two slots and W̃ take 74,400 bytes (the parts go
    into the band rows); blocks of 5 row groups of 64 threads, two an SM
    by the launch bounds; the grid fills one wave (264 blocks) or has a
    block a tile."""
    t = conv.b1_tiling((b, 560, 560, 3), 8, 3, kernel=5, stride=5)
    assert (t["tile_px"], t["pieces"], t["threads"]) == (112, 1, 320)
    assert t["smem_bytes"] == 74_400 and t["blocks_per_sm"] == 2
    assert t["tiles"] == b * 112
    assert t["blocks_x"] == min(264, b * 112) and t["blocks_y"] == 1


def test_b1_tiling_cuts_tiles_below_a_warp_and_raises_as_before():
    """Where a warp's bands do not fit (k = s = 15, C = 3: 64 pixels' two
    bands take 345,600 bytes), tiles hold fewer pixels and B1 still runs;
    where W̃ does not fit its 48 KB (dx = 3) it raises, as it always did."""
    t = conv.b1_tiling((1, 15, 1500, 3), 8, 1, kernel=15, stride=15)
    assert t["tile_px"] < 32 * conv.B1_PIXELS and t["threads"] == 5 * 32
    assert t["smem_bytes"] <= conv.B1_SMEM_BYTES
    with pytest.raises(ValueError, match="does not fit"):
        conv.b1_tiling((1, 15, 1500, 3), 8, 3, kernel=15, stride=15)


#: (M, K, N, dx, blocks): the benchmark's shape at the default and other
#: blocks, a partial last tile, several N tiles, K tiles, one slot.
B6_SHAPES = [
    (100_352, 75, 8, 3, None),
    (100_352, 75, 8, 3, (112, 8, 128)),
    (100_352, 75, 8, 3, (64, 8, 32)),
    (4096, 147, 32, 3, (256, 32, 128)),
    (130, 33, 5, 3, None),
    (300, 300, 40, 4, (256, 32, 128)),
    (8, 1, 1, 2, (1, 16, 7)),
]


@pytest.mark.parametrize("m,k,n,dx,blocks", B6_SHAPES)
def test_matmul_tiling_covers_each_row_once(m, k, n, dx, blocks):
    bm, bn, bk = blocks or kernel.MATMUL_DEFAULT_BLOCKS
    t = kernel.matmul_tiling(m, k, n, dx, block_m=bm, block_n=bn,
                             block_k=bk)
    assert t["tiles"] == -(-m // bm) and t["block_k"] == min(bk, k)
    assert t["threads"] % 32 == 0
    per_thread = kernel.MATMUL_ROWS_PER_THREAD if t["n_tile"] <= 8 else 1
    assert t["threads"] * per_thread >= bm
    seen = np.zeros(m, np.int64)
    sizes = []
    for i in range(t["blocks_x"]):
        run = _block_tiles(t["tiles"], t["blocks_x"], i)
        sizes.append(len(run))
        for tile in run:
            seen[tile * bm: min(m, (tile + 1) * bm)] += 1
    assert (seen == 1).all()
    assert max(sizes) - min(sizes) <= 1
    assert t["smem_bytes"] <= conv.SMEM_MAX
    assert t["slots"] in (1, 2)
    assert t["blocks_x"] * t["blocks_y"] <= conv.H100_SMS * t["blocks_per_sm"]


def test_matmul_tiling_at_the_benchmark_shape():
    """128-row tiles of the 100,352 x 75 patches: 784 tiles, each one
    38,400-byte span; W̃ once (7,200 bytes) and two slots, 84,000 bytes,
    two blocks an SM, 264 blocks of 64 threads (two rows a thread), about
    3 tiles a block;
    the default blocks fit the tuner's budget.  Where two slots do not
    fit a block, one does."""
    t = kernel.matmul_tiling(100_352, 75, 8, 3, block_m=128, block_n=32,
                             block_k=128)
    assert (t["tiles"], t["slots"], t["smem_bytes"]) == (784, 2, 84_000)
    assert (t["blocks_per_sm"], t["blocks_x"], t["threads"]) == (2, 264, 64)
    assert t["smem_bytes"] <= tune.SMEM_BUDGET_BYTES
    one = kernel.matmul_tiling(300, 300, 40, 4, block_m=256, block_n=32,
                               block_k=128)
    assert one["slots"] == 1
    with pytest.raises(ValueError, match="block_m"):
        kernel.matmul_tiling(100, 75, 8, 3, block_m=512, block_n=8,
                             block_k=75)


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


@pytest.mark.parametrize("needed,holds", [
    (1, [1]), (4, [1, 2, 4]), (None, [1, 2, 4, 8])])
def test_time_once_holds_the_card_once_a_candidate(monkeypatch, needed,
                                                   holds):
    """On a CUDA device a candidate's three timed groups follow one spin
    of `_HOLD_CYCLES`; where the spin had ended before the host was done
    (the first event already reached), they are timed again with twice
    the spin, up to `_HOLD_MAX` times.  ``needed``: the spin (in units of
    `_HOLD_CYCLES`) that outlasts the host, None for never.  CUDA is
    replaced by a clock that moves 1 ms a recorded event."""
    unit = tune._HOLD_CYCLES
    sleeps, calls, clock = [], [], [0.0]

    class Event:
        def __init__(self, enable_timing):
            assert enable_timing

        def record(self):
            self.t = clock[0]
            clock[0] += 1.0

        def query(self):
            return needed is None or sleeps[-1] < needed * unit

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return other.t - self.t

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "_sleep", sleeps.append)
    seconds = tune._time_once(calls.append, "cand", torch.device("cuda"),
                              iters=5)
    assert sleeps == [h * unit for h in holds]
    assert holds[-1] == (needed or tune._HOLD_MAX)
    assert len(calls) == 1 + 3 * 5 * len(holds)  # one warm-up run
    assert seconds == pytest.approx(1e-3 / 5)


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
