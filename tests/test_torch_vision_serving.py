"""The port's `VisionEngine` (`repro_torch.serving.vision`) against the JAX
reference engine, on the CPU at a small size, with the reference's
weights carried across by `repro_torch.compat`.

The same requests and arrival ticks must give the same completion order,
queue/serve ticks and evictions; probabilities within 1e-4 (fp32 through
the network, sums in another order), labels equal wherever the top-2
margin exceeds 1e-3.  Also mirrors the single-device tests of
`tests/test_vision_serving.py`, and holds the rules: no GPU ⇒ the default
engine raises; a failing launch surfaces as failed requests.
"""
import jax
import numpy as np
import pytest
import torch

from repro.data import SyntheticVWW
from repro.models.mobilenetv2 import MNV2Config as JMNV2Config
from repro.models.mobilenetv2 import init_mnv2 as j_init_mnv2
from repro.serving import VisionEngine as JVisionEngine
from repro.serving import VisionRequest as JVisionRequest
from repro_torch import compat
from repro_torch.core.bn_fold import deploy_params
from repro_torch.core.quant import QuantSpec, quantize_deploy
from repro_torch.models.mobilenetv2 import MNV2Config, apply_mnv2
from repro_torch.serving import VisionEngine, VisionRequest, drive

SIZE = 20
JCFG = JMNV2Config(variant="p2m", image_size=SIZE, width=0.25,
                   head_channels=16)
CFG = MNV2Config(variant="p2m", image_size=SIZE, width=0.25, head_channels=16)
BASE_JCFG = JMNV2Config(variant="baseline", image_size=SIZE, width=0.25,
                        head_channels=16)
BASE_CFG = MNV2Config(variant="baseline", image_size=SIZE, width=0.25,
                      head_channels=16)
TOL = 1e-4


def _models(jcfg=JCFG, seed=0):
    """Reference trees (JAX) and the same weights in the port's trees."""
    params, bn = j_init_mnv2(jax.random.PRNGKey(seed), jcfg)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return ((params, bn),
            (compat.tree_from_reference(np_tree(params), device="cpu"),
             compat.tree_from_reference(np_tree(bn), device="cpu")))


def _images(n, seed=0):
    return SyntheticVWW(image_size=SIZE, batch=n, seed=seed).batch_at(0)[
        "images"]


def _engine(tp, tb, cfg=CFG, **kw):
    return VisionEngine(tp, tb, cfg, device="cpu", **kw)


def _ledger(reqs):
    return [(r.uid, r.submitted_tick, r.served_tick, r.finished_tick,
             r.queue_ticks, r.serve_ticks, r.evicted) for r in reqs]


def _assert_probs_match(done, ref_done):
    for a, b in zip(done, ref_done):
        assert a.uid == b.uid
        np.testing.assert_allclose(a.probs, b.probs, rtol=TOL, atol=TOL)
        top2 = np.sort(b.probs)[-2:]
        if top2[1] - top2[0] > 1e-3:
            assert a.label == b.label


@pytest.mark.parametrize("max_batch,max_queue,arrivals", [
    (2, 64, [0, 0, 0, 2, 2, 5, 5]),
    (4, 64, [0] * 5 + [1, 1, 3]),
    (2, 3, [0] * 6 + [4, 4, 4, 4]),
])
def test_engine_matches_reference_engine(max_batch, max_queue, arrivals):
    (jp, jb), (tp, tb) = _models()
    imgs = _images(len(arrivals))
    ref = JVisionEngine(jp, jb, JCFG, max_batch=max_batch,
                        max_queue=max_queue)
    eng = _engine(tp, tb, max_batch=max_batch, max_queue=max_queue)
    ref_reqs = [JVisionRequest(uid=i, image=imgs[i], arrival_tick=t)
                for i, t in enumerate(arrivals)]
    reqs = [VisionRequest(uid=i, image=imgs[i], arrival_tick=t)
            for i, t in enumerate(arrivals)]
    ref_done = ref.run(ref_reqs, on_undrained="raise")
    done = eng.run(reqs, on_undrained="raise")
    assert _ledger(done) == _ledger(ref_done)
    assert _ledger(eng.evicted) == _ledger(ref.evicted)
    assert eng.tick == ref.tick
    assert eng.stats["launches"] == ref.stats["launches"]
    _assert_probs_match(done, ref_done)


def test_engine_matches_direct_deploy_forward():
    """Microbatching (incl. zero-padded free slots) does not change
    results: per-request probs equal the direct deploy-folded forward."""
    _, (tp, tb) = _models()
    imgs = _images(5)
    engine = _engine(tp, tb, max_batch=2)
    for uid in range(5):
        engine.submit(VisionRequest(uid=uid, image=imgs[uid]))
    done = engine.run()
    assert len(done) == 5
    dep = quantize_deploy(deploy_params(tp["stem"], tb["stem"], CFG.p2m),
                          QuantSpec(8, 8))
    logits, _ = apply_mnv2(tp, tb, torch.from_numpy(imgs), CFG,
                           p2m_deploy=dep)
    probs_ref = torch.softmax(logits, dim=-1).numpy()
    for req in done:
        np.testing.assert_allclose(req.probs, probs_ref[req.uid], rtol=1e-5,
                                   atol=1e-6)
        assert req.label == int(probs_ref[req.uid].argmax())


def test_engine_fifo_ordering_variable_arrival():
    _, (tp, tb) = _models()
    imgs = _images(7)
    reqs = [VisionRequest(uid=i, image=imgs[i],
                          arrival_tick=[0, 0, 0, 2, 2, 5, 5][i])
            for i in range(7)]
    done = _engine(tp, tb, max_batch=2).run(reqs)
    assert [r.uid for r in done] == list(range(7))
    assert all(r.served_tick > r.arrival_tick for r in done)


def test_engine_bounded_queue_evicts_oldest():
    _, (tp, tb) = _models()
    imgs = _images(6)
    engine = _engine(tp, tb, max_batch=2, max_queue=3)
    for uid in range(6):
        engine.submit(VisionRequest(uid=uid, image=imgs[uid]))
    assert [r.uid for r in engine.evicted] == [0, 1, 2]
    done = engine.run()
    assert [r.uid for r in done] == [3, 4, 5]
    assert engine.latency_summary()["evictions"] == 3


def test_engine_latency_counters():
    _, (tp, tb) = _models()
    imgs = _images(5)
    engine = _engine(tp, tb, max_batch=4)
    done = engine.run([VisionRequest(uid=i, image=imgs[i]) for i in range(5)])
    assert [r.queue_ticks for r in done] == [1, 1, 1, 1, 2]
    assert all(r.batch_wall_us > 0 for r in done)
    s = engine.latency_summary()
    assert s["served"] == 5 and s["launches"] == 2
    assert s["utilization"] == pytest.approx(5 / 8)
    assert s["mean_queue_ticks"] == pytest.approx(6 / 5)


def test_engine_idle_ticks_advance_to_future_arrivals():
    _, (tp, tb) = _models()
    imgs = _images(1)
    engine = _engine(tp, tb, max_batch=2)
    drive(engine, [VisionRequest(uid=0, image=imgs[0], arrival_tick=4)],
          on_undrained="raise")
    assert len(engine.completed) == 1
    assert engine.completed[0].served_tick > 4


def test_engine_baseline_variant_matches_reference_engine():
    (jp, jb), (tp, tb) = _models(BASE_JCFG, seed=1)
    imgs = _images(3, seed=1)
    ref = JVisionEngine(jp, jb, BASE_JCFG, max_batch=4)
    eng = _engine(tp, tb, BASE_CFG, max_batch=4)
    ref_done = ref.run([JVisionRequest(uid=i, image=imgs[i])
                        for i in range(3)])
    done = eng.run([VisionRequest(uid=i, image=imgs[i]) for i in range(3)])
    assert _ledger(done) == _ledger(ref_done)
    _assert_probs_match(done, ref_done)


def test_engine_without_device_needs_a_gpu(monkeypatch):
    """The default device is the GPU; without one the engine raises and
    never carries on on the CPU by itself."""
    _, (tp, tb) = _models()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        VisionEngine(tp, tb, CFG)


def test_failed_launch_surfaces_as_failed_requests(monkeypatch):
    """No degradation ladder: a launch that keeps failing is retried, then
    its requests are quarantined onto the failed ledger — no answer comes
    from another conv path."""
    _, (tp, tb) = _models()
    imgs = _images(3)
    engine = _engine(tp, tb, max_batch=4, launch_retries=1)
    calls = []

    def broken(images, p2m_impl=None):
        calls.append(p2m_impl)
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(engine, "forward", broken)
    engine.run([VisionRequest(uid=i, image=imgs[i]) for i in range(3)],
               on_undrained="raise")
    assert engine.completed == []
    assert [(r.uid, r.failure) for r in engine.failed] == [
        (0, "launch"), (1, "launch"), (2, "launch")]
    assert calls == [None, None]  # one try, one retry, same path
    assert engine.health()["degraded"] is None
