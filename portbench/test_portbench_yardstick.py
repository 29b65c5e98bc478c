"""The yardstick's arithmetic: the generators are pure functions of the
seed, the roofline counts match hand counts, and the trace reader adds up
busy and idle time."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import common, data, roofline, traffic, weights
from portbench.trace import SPAN_PREFIX, Trace

BIG_SEED = 2**31 + 12345


def test_open_loop_is_a_function_of_the_seed():
    tr = common.traffic_file("poisson-frames")
    a = traffic.open_loop(tr, BIG_SEED, 5.0)
    assert a == traffic.open_loop(tr, BIG_SEED, 5.0)
    assert a != traffic.open_loop(tr, BIG_SEED + 1, 5.0)
    due = [t for t, _ in a]
    assert due == sorted(due) and 0 <= due[0] and due[-1] < 5.0
    expected = tr["rate_per_s"] * 5.0
    assert abs(len(a) - expected) < 6 * expected ** 0.5
    assert all(0 <= i < tr["pool"] for _, i in a)


def test_closed_loop_gives_every_seed_the_same_sizes():
    tr = common.traffic_file("long-prompts")
    a = traffic.closed_loop(tr, BIG_SEED)
    b = traffic.closed_loop(tr, 7)
    assert a == traffic.closed_loop(tr, BIG_SEED) and a != b
    n = tr["block"]
    assert len(a) == tr["requests"] and tr["requests"] % n == 0
    for key in ("prompt_len", "new_tokens"):
        # every block of requests holds the same sizes, for every seed
        for i in range(0, len(a), n):
            assert sorted(x[key] for x in a[i:i + n]) == \
                sorted(x[key] for x in b[:n])
    assert min(x["prompt_len"] for x in a) >= tr["prompt_min"]
    assert max(x["prompt_len"] for x in a) <= tr["prompt_max"]
    assert {x["new_tokens"] for x in a} <= set(range(tr["new_min"],
                                                     tr["new_max"] + 1))


def test_sample_holds_the_one_asked_for():
    s = traffic.sample(8, BIG_SEED, 40, always=39)
    assert len(s) == 8 and 39 in s and s == traffic.sample(8, BIG_SEED, 40,
                                                            always=39)


def test_inputs_are_functions_of_the_seed():
    a, la = data.vww_images(BIG_SEED, 3, 2, 40, "cpu")
    b, lb = data.vww_images(BIG_SEED, 3, 2, 40, "cpu")
    assert np.array_equal(a, b) and np.array_equal(la, lb)
    assert a.shape == (2, 40, 40, 3) and 0.0 <= a.min() and a.max() <= 1.0
    t = data.lm_tokens(BIG_SEED, 0, 3, 50, 512)
    assert np.array_equal(t, data.lm_tokens(BIG_SEED, 0, 3, 50, 512))
    assert t.min() >= 0 and t.max() < 512
    batch = data.LMBatches(BIG_SEED, 2, 16, 512).batch_at(1)
    assert np.array_equal(batch["tokens"][:, 1:], batch["targets"][:, :-1])


def test_weights_are_functions_of_the_seed():
    cfg = dict(common.config_file("rwkv6-3b"), n_layers=1, d_model=32,
               n_heads=2, head_dim=16, d_ff=64, vocab=128, lora_dim=4)
    a, b = weights.rwkv6(BIG_SEED, cfg, "cpu"), weights.rwkv6(BIG_SEED, cfg,
                                                              "cpu")
    for (ka, x), (kb, y) in zip(weights.leaves(a), weights.leaves(b)):
        assert ka == kb and torch.equal(x, y)
    assert not torch.equal(weights.rwkv6(3, cfg, "cpu")["embed"]["table"],
                           a["embed"]["table"])


def test_full_size_parameter_count():
    """RWKV-6 3B as configured: 3,146,795,520 parameters (counted from
    shapes on ``meta``)."""
    cfg = common.config_file("rwkv6-3b")
    tree = weights.rwkv6(0, cfg, "meta")
    assert weights.n_params(tree) == cfg["n_params"]


@pytest.mark.parametrize("fn, args, nbytes, least_ms", [
    # B1/B2 deploy stem at serving: 8 × 560² × 3 images, 8 outputs
    (roofline.stem_forward, (8, 560, 560, 3, 8, 5, 5, 3), 33_324_096, 0.0099),
    # B4 at the training step's M = 32 · 112², K = 75, N = 8
    (roofline.stem_backward_dw, (401_408, 75, 8, 3), 133_272_256, 0.0398),
    # B3 at the same shape
    (roofline.stem_backward_dx, (401_408, 75, 8, 3), 253_697_056, 0.0757),
    # B7 at (8, 64, 40, 64): 36.7 MB
    (roofline.wkv, (8, 64, 40, 64), 36_710_400, 0.0110),
])
def test_roofline_hand_counts(fn, args, nbytes, least_ms):
    b, f = fn(*args)
    assert b == nbytes
    assert roofline.least_s(b, f) * 1e3 == pytest.approx(least_ms, abs=5e-5)
    assert f / roofline.PEAK_FLOPS < b / roofline.PEAK_BYTES_PER_S


def test_wkv_flops_hand_count():
    # a token and head: 5·64² + 4·64 = 20,736; 8·64·40 of them
    assert roofline.wkv(8, 64, 40, 64)[1] == 8 * 64 * 40 * 20_736


def test_share_is_none_without_a_reading():
    assert roofline.share_pct(1e-5, 0.0) is None
    assert roofline.share_pct(1e-5, 2e-5) == pytest.approx(50.0)


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_reader_adds_busy_and_idle_time():
    events = [
        _x("user_annotation", SPAN_PREFIX + "engine.step", 0, 1000),
        _x("cpu_op", "aten::copy_", 100, 200),
        _x("kernel", "void p2m_conv_kernel<3>(float*)", 10, 40),
        _x("kernel", "wkv_chunked_kernel", 30, 30),  # overlaps: busy 10..60
        _x("gpu_memcpy", "Memcpy HtoD", 400, 100),
        _x("kernel", "wkv_chunked_kernel", 503, 7),  # a 3 us gap before
    ]
    t = Trace(1e-3, events)
    assert t.busy_s == pytest.approx((50 + 100 + 7) * 1e-6)
    assert t.kernel_time("wkv_chunked_kernel") == (2, pytest.approx(37e-6))
    assert t.kernel_time("p2m_conv_kernel")[0] == 1
    assert t.idle["engine.step/aten::copy_"] == pytest.approx(340e-6)
    assert t.idle["gaps under 10 us"] == pytest.approx(3e-6)
    assert sum(t.idle.values()) + t.busy_s == pytest.approx(1000e-6)
    bd = t.breakdown()
    assert bd["device_ops"][0][0] == "void p2m_conv_kernel<3>(float*)"
    assert len(bd["idle_gaps"]) <= 10
