"""The port's `StreamEngine` (`repro_torch.video.engine`) against the JAX
reference engine, on the CPU at a small size (40², width 0.25), with the
reference's weights carried across by `repro_torch.compat`.

The same streams and arrival ticks must give the same completion order,
scheduler ledger, evictions, frames done, skip counts and measured bits,
exactly; boxes and scores within 1e-4 (fp32 through the network, sums
in another order).  Tracks are compared frame by frame for as long as
every score of the stream so far lies further than 1e-3 from
``score_thresh`` (nearer, the two trackers may see different inputs).
Both of the port's stem paths are held to the reference's; on the CPU
the gated path runs the gated kernel's plain twin.

Also mirrors the single-device tests of `tests/test_video_stream.py` and
the gated-engine tests of `tests/test_p2m_conv_pipelined.py`, and holds
the port's rules: no GPU ⇒ the default engine raises; a failing launch
yields failed requests and no change of stem path; a non-finite cache
forces a re-run and drops that stream's gate to dense.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bandwidth import frame_output_bits as j_frame_output_bits
from repro.models.mobilenetv2 import MNV2Config as JMNV2Config
from repro.models.mobilenetv2 import init_mnv2 as j_init_mnv2
from repro.video import DeltaGateConfig as JDeltaGateConfig
from repro.video import DetectConfig as JDetectConfig
from repro.video import StreamEngine as JStreamEngine
from repro.video import StreamRequest as JStreamRequest
from repro.video import init_detect_head as j_init_detect_head
from repro_torch import compat
from repro_torch.core.bandwidth import frame_output_bits
from repro_torch.core.pixel_model import default_pixel_model
from repro_torch.kernels.p2m_conv import conv, gated, tune
from repro_torch.kernels.p2m_conv.ops import _coeff_tuple
from repro_torch.models.mobilenetv2 import MNV2Config, init_mnv2
from repro_torch.video import (
    DeltaGateConfig,
    DetectConfig,
    StreamEngine,
    StreamRequest,
    SyntheticVideo,
    init_detect_head,
)
from repro_torch.video import engine as engine_module
from repro_torch.video.engine import _stream_forward_for

SIZE = 40
JCFG = JMNV2Config(variant="p2m", image_size=SIZE, width=0.25,
                   head_channels=16)
CFG = MNV2Config(variant="p2m", image_size=SIZE, width=0.25, head_channels=16)
DCFG = DetectConfig(head_channels=8, max_dets=4)
JDCFG = JDetectConfig(head_channels=8, max_dets=4)
# A head whose scores straddle its threshold, so that tracks form.
TRACK_KW = dict(head_channels=8, max_dets=4, prior_logit=0.0,
                score_thresh=0.5)
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These shapes are small: one intra-op thread runs them about ten
    times faster than eight, and the suite's parallel workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """Reference trees (JAX) and the same weights in the port's trees:
    (params, bn, det, track det)."""
    params, bn = j_init_mnv2(jax.random.PRNGKey(0), JCFG)
    det = j_init_detect_head(jax.random.PRNGKey(1), 16, JDCFG)
    det_t = j_init_detect_head(jax.random.PRNGKey(2), 16,
                               JDetectConfig(**TRACK_KW))
    ref = (params, bn, det, det_t)
    return ref, tuple(
        compat.tree_from_reference(jax.tree.map(np.asarray, t), device="cpu")
        for t in ref)


def _frames(lengths, hold=2, noises=None, seed0=0):
    noises = noises or [0.0] * len(lengths)
    return [SyntheticVideo(image_size=SIZE, n_frames=n, hold=hold,
                           seed=seed0 + i, noise=z).frames()
            for i, (n, z) in enumerate(zip(lengths, noises))]


def _engine(port, track=False, threshold=0.0, **kw):
    params, bn, det, det_t = port
    kw.setdefault("max_streams", 2)
    return StreamEngine(params, bn, CFG, det_t if track else det,
                        det_cfg=DetectConfig(**TRACK_KW) if track else DCFG,
                        gate=DeltaGateConfig(threshold=threshold),
                        device="cpu", **kw)


def _streams(frames, arrivals=None, cls=StreamRequest):
    arrivals = arrivals or [0] * len(frames)
    return [cls(uid=i, frames=f, arrival_tick=t)
            for i, (f, t) in enumerate(zip(frames, arrivals))]


def _ledger(reqs):
    return [(r.uid, r.submitted_tick, r.served_tick, r.finished_tick,
             r.queue_ticks, r.serve_ticks, r.evicted, r.frames_done,
             r.skip_count, r.bits) for r in reqs]


SCENARIOS = {  # name: (engine kwargs, lengths, noises, arrivals)
    "mixed lengths": (dict(max_streams=2), [6, 3, 5], [0, 0, 0.02],
                      [0, 0, 1]),
    "dense gate": (dict(max_streams=2, threshold=None), [4, 4], None, None),
    "tolerant gate": (dict(max_streams=3, threshold=0.05), [5, 5, 4],
                      [0.01, 0.0, 0.01], [0, 1, 1]),
    "queue evicts newest": (dict(max_streams=1, max_queue=1), [3, 2, 3],
                            None, [0, 0, 0]),
    "tracks": (dict(max_streams=2, track=True), [6, 5, 4], None, [0, 0, 2]),
}
_REF_DONE: dict = {}


def _reference_run(models, name):
    if name not in _REF_DONE:
        (params, bn, det, det_t), _ = models
        kw, lengths, noises, arrivals = SCENARIOS[name]
        kw = dict(kw)
        track = kw.pop("track", False)
        threshold = kw.pop("threshold", 0.0)
        ref = JStreamEngine(
            params, bn, JCFG, det_t if track else det,
            det_cfg=JDetectConfig(**TRACK_KW) if track else JDCFG,
            gate=JDeltaGateConfig(threshold=threshold), **kw)
        done = ref.run(_streams(_frames(lengths, noises=noises), arrivals,
                                JStreamRequest), on_undrained="raise")
        _REF_DONE[name] = (ref, done)
    return _REF_DONE[name]


def _assert_tracks_match(done, ref_done, thresh):
    for a, b in zip(done, ref_done):
        for tr_a, tr_b, (_, scores) in zip(a.tracks, b.tracks,
                                           b.frame_outputs):
            if np.abs(scores - thresh).min() <= 1e-3:
                break  # the trackers may see different inputs from here
            assert [t[0] for t in tr_a] == [t[0] for t in tr_b]
            for (_, box_a, s_a), (_, box_b, s_b) in zip(tr_a, tr_b):
                np.testing.assert_allclose(box_a, box_b, rtol=TOL, atol=TOL)
                assert s_a == pytest.approx(s_b, rel=TOL, abs=TOL)


@pytest.mark.parametrize("stem_path", ["where", "gated"])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_matches_reference_engine(models, name, stem_path):
    ref, ref_done = _reference_run(models, name)
    kw, lengths, noises, arrivals = SCENARIOS[name]
    eng = _engine(models[1], stem_path=stem_path, **kw)
    done = eng.run(_streams(_frames(lengths, noises=noises), arrivals),
                   on_undrained="raise")
    assert _ledger(done) == _ledger(ref_done)
    assert _ledger(eng.evicted) == _ledger(ref.evicted)
    assert eng.tick == ref.tick
    assert eng.stats["launches"] == ref.stats["launches"]
    for a, b in zip(done, ref_done):
        assert a.ledger.summary() == b.ledger.summary()
        for (ba, sa), (bb, sb) in zip(a.frame_outputs, b.frame_outputs):
            np.testing.assert_allclose(ba, bb, rtol=TOL, atol=TOL)
            np.testing.assert_allclose(sa, sb, rtol=TOL, atol=TOL)
    _assert_tracks_match(done, ref_done, eng.det_cfg.score_thresh)
    got, want = eng.stream_summary(), ref.stream_summary()
    assert got.keys() == want.keys()
    for key in ("streams", "frames", "stem_skip_rate", "bits_per_frame",
                "dense_bits_per_frame", "measured_reduction_vs_dense"):
        assert got[key] == want[key]
    assert eng.health().keys() == ref.health().keys()


def test_tracks_form_in_the_track_scenario(models):
    """The track comparison above is not vacuous: tracks form, and at
    least the first frames are compared."""
    _, ref_done = _reference_run(models, "tracks")
    assert sum(len(fr) for r in ref_done for fr in r.tracks) > 0
    assert np.abs(ref_done[0].frame_outputs[0][1] - 0.5).min() > 1e-3


def test_nonfinite_cache_matches_reference(models):
    """A NaN in one slot's cache: that slot re-runs, its gate drops to
    dense, the other slot is untouched — as in the reference."""
    (params, bn, det, _), port = models
    frames = _frames([6, 6])
    ref = JStreamEngine(params, bn, JCFG, det, det_cfg=JDCFG, max_streams=2)
    eng = _engine(port)
    for e, cls in ((ref, JStreamRequest), (eng, StreamRequest)):
        for r in _streams(frames, cls=cls):
            e.submit(r)
        e.step()  # frame 0 re-runs everywhere
    ref._cached_stem = ref._cached_stem.at[0].set(jnp.nan)
    eng._cached_stem[0] = float("nan")
    for e in (ref, eng):
        e.run(on_undrained="raise")
    assert _ledger(eng.completed) == _ledger(ref.completed)
    assert eng.health()["gate_faults"] == ref.health()["gate_faults"] == 1
    assert eng._gates[0].disabled and ref._gates[0].disabled
    a, b = eng.completed
    assert a.skip_count == 0 and b.skip_count == 3  # slot 0 reran 1..5
    for r, rr in zip(eng.completed, ref.completed):
        for (ba, sa), (bb, sb) in zip(r.frame_outputs, rr.frame_outputs):
            assert np.isfinite(ba).all() and np.isfinite(sa).all()
            np.testing.assert_allclose(sa, sb, rtol=TOL, atol=TOL)


# ------------------------------------- mirrored: tests/test_video_stream.py


@pytest.mark.parametrize("stem_path", ["where", "gated"])
def test_gated_threshold_zero_exactly_matches_dense(models, stem_path):
    gated_e = _engine(models[1], threshold=0.0, stem_path=stem_path)
    dense = _engine(models[1], threshold=None, stem_path=stem_path)
    done_g = gated_e.run(_streams(_frames([6, 6, 6])))
    done_d = dense.run(_streams(_frames([6, 6, 6])))
    assert [r.uid for r in done_g] == [r.uid for r in done_d]
    assert sum(r.skip_count for r in done_g) > 0
    assert all(r.skip_count == 0 for r in done_d)
    for g, d in zip(done_g, done_d):
        assert g.frames_done == d.frames_done
        for (bg, sg), (bd, sd) in zip(g.frame_outputs, d.frame_outputs):
            np.testing.assert_array_equal(bg, bd)
            np.testing.assert_array_equal(sg, sd)


def test_measured_bits_below_dense_baseline(models):
    eng = _engine(models[1])
    done = eng.run(_streams(_frames([8, 8])))
    dense_bits = frame_output_bits(eng.geom)
    assert dense_bits == j_frame_output_bits(eng.geom)
    for r in done:
        assert r.skip_rate == pytest.approx(0.5)
        assert r.bits_per_frame < dense_bits
        assert r.reduction_vs_dense > 1.5
        reruns = r.frames_done - r.skip_count
        assert r.bits == reruns * dense_bits + r.frames_done
    s = eng.stream_summary()
    assert s["stem_skip_rate"] == pytest.approx(0.5)
    assert s["bits_per_frame"] < s["dense_bits_per_frame"]
    assert s["measured_reduction_vs_dense"] > 1.5


def test_noisy_streams_never_skip(models):
    eng = _engine(models[1])
    done = eng.run(_streams(_frames([6, 6], noises=[0.02, 0.02])))
    for r in done:
        assert r.skip_count == 0
        assert r.bits == r.frames_done * (frame_output_bits(eng.geom) + 1)


def test_first_frame_always_reruns(models):
    eng = _engine(models[1], max_streams=1)
    (r,) = eng.run(_streams(_frames([4], hold=8)))
    assert r.skip_count == 3
    assert r.frames_done == 4


def test_mixed_length_streams_occupy_slots_for_their_lifetime(models):
    eng = _engine(models[1], max_streams=2)
    lens = [6, 2, 3]
    done = eng.run(_streams(_frames(lens, hold=1)))
    assert [r.uid for r in done] == [1, 2, 0]
    by = {r.uid: r for r in done}
    for i, n in enumerate(lens):
        assert by[i].serve_ticks == n
        assert by[i].frames_done == n
    assert by[2].served_tick == 3
    assert eng.stats["busy_slot_ticks"] == sum(lens)


@pytest.mark.parametrize("stem_path", ["where", "gated"])
def test_slot_state_isolation_across_recycled_streams(models, stem_path):
    """Also the gated-path isolation test of
    `tests/test_p2m_conv_pipelined.py`."""
    eng = _engine(models[1], max_streams=1, stem_path=stem_path)
    vid = SyntheticVideo(image_size=SIZE, n_frames=5, hold=2, seed=3)
    done = eng.run([StreamRequest(uid=0, frames=vid.frames()),
                    StreamRequest(uid=1, frames=vid.frames())])
    assert [r.uid for r in done] == [0, 1]
    ra, rb = done
    assert ra.skip_count == rb.skip_count
    assert rb.frame_outputs and ra.frames_done == rb.frames_done
    for (ba, sa), (bb, sb) in zip(ra.frame_outputs, rb.frame_outputs):
        np.testing.assert_array_equal(ba, bb)
        np.testing.assert_array_equal(sa, sb)
    ids_a = {tid for fr in ra.tracks for tid, _, _ in fr}
    ids_b = {tid for fr in rb.tracks for tid, _, _ in fr}
    assert ids_a == ids_b


def test_latency_ledger_multi_tick_streams(models):
    eng = _engine(models[1], max_streams=1)
    done = eng.run(_streams(_frames([3, 3])))
    assert [r.queue_ticks for r in done] == [1, 4]
    assert all(r.serve_ticks == 3 for r in done)
    assert all(r.frame_latency_us > 0 for r in done)


def test_stream_engine_rejects_empty_stream(models):
    eng = _engine(models[1], max_streams=1)
    with pytest.raises(ValueError, match="no frames"):
        eng.submit(StreamRequest(
            uid=0, frames=np.empty((0, SIZE, SIZE, 3), np.float32)))
    assert not eng.busy()


def test_stream_engine_rejects_baseline_variant(models):
    base = MNV2Config(variant="baseline", image_size=SIZE, width=0.25,
                      head_channels=16)
    params, bn = init_mnv2(torch.Generator().manual_seed(0), base,
                           device="cpu")
    with pytest.raises(ValueError, match="p2m variant"):
        StreamEngine(params, bn, base, models[1][2], device="cpu")


# ------------------------- mirrored: tests/test_p2m_conv_pipelined.py


def test_gated_engine_bitwise_matches_where_reference(models):
    gated_e = _engine(models[1], stem_path="gated")
    where = _engine(models[1], stem_path="where")
    done_g = gated_e.run(_streams(_frames([6, 6, 6])))
    done_w = where.run(_streams(_frames([6, 6, 6])))
    assert [r.uid for r in done_g] == [r.uid for r in done_w]
    for g, w in zip(done_g, done_w):
        for (bg, sg), (bw, sw) in zip(g.frame_outputs, w.frame_outputs):
            np.testing.assert_array_equal(bg, bw)
            np.testing.assert_array_equal(sg, sw)
    sg = gated_e.stream_summary()
    assert sg["stem_path"] == "gated"
    assert sg["stem_flops_skipped_ratio"] == pytest.approx(0.5)
    assert where.stream_summary()["stem_flops_skipped_ratio"] == 0.0


def test_gated_engine_runs_at_the_tuners_blocks(models, monkeypatch):
    """The gated path asks the tuner for the where path's signature (the
    key `core.p2m_conv.deploy_conv_blocks` builds for both paths) and
    hands the gated wrapper its blocks; its detections stay the where
    path's, bit for bit."""
    asked, handed = [], []

    def recorder(*args, **kw):
        asked.append((args, kw))
        return (3, None, 2)

    def gated_wrapper(*args, **kw):
        handed.append((kw["block_h"], kw["block_n"], kw["pipeline_depth"]))
        return gated.p2m_conv_fused_gated(*args, **kw)

    monkeypatch.setattr(tune, "get_conv_blocks", recorder)
    monkeypatch.setattr(engine_module, "p2m_conv_fused_gated", gated_wrapper)
    gated_e = _engine(models[1], stem_path="gated")
    done_g = gated_e.run(_streams(_frames([6, 6, 6])))
    ticks = gated_e.stats["launches"]
    p2m = CFG.p2m
    signature = (gated_e.n_slots, SIZE, SIZE, 3, p2m.out_channels,
                 p2m.kernel, p2m.stride, _coeff_tuple(default_pixel_model()),
                 "quant")
    assert asked == [(signature, {"device": torch.device("cpu")})] * ticks
    assert handed == [(3, None, 2)] * ticks
    done_w = _engine(models[1], stem_path="where").run(
        _streams(_frames([6, 6, 6])))
    for g, w in zip(done_g, done_w):
        assert g.uid == w.uid and g.skip_count == w.skip_count
        for (bg, sg), (bw, sw) in zip(g.frame_outputs, w.frame_outputs):
            np.testing.assert_array_equal(bg, bw)
            np.testing.assert_array_equal(sg, sw)


def test_stream_forward_rejects_unknown_stem_path(models):
    with pytest.raises(ValueError, match="stem_path"):
        _stream_forward_for.__wrapped__(CFG, DCFG, "patches")
    with pytest.raises(ValueError, match="stem_path"):
        _engine(models[1], stem_path="patches")


# ----------------------------------------------------------------- rules


def test_engine_without_device_needs_a_gpu(models, monkeypatch):
    params, bn, det, _ = models[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamEngine(params, bn, CFG, det, det_cfg=DCFG)


def test_auto_stem_path_is_where_on_the_cpu(models):
    assert _engine(models[1]).stem_path == "where"
    assert _engine(models[1], stem_path="gated").stem_path == "gated"


@pytest.mark.parametrize("stem_path", ["where", "gated"])
def test_failed_launch_surfaces_as_failed_requests(models, stem_path,
                                                   monkeypatch):
    """No degradation ladder: a launch that keeps failing is retried,
    then its streams are quarantined onto the failed ledger; the stem
    path stays as it was and only the fault count moves."""
    eng = _engine(models[1], stem_path=stem_path, launch_retries=1)
    calls = []

    def broken(images, cached, rerun):
        calls.append(eng.stem_path)
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(eng, "forward", broken)
    eng.run(_streams(_frames([3, 3])), on_undrained="raise")
    assert eng.completed == []
    assert [(r.uid, r.failure) for r in eng.failed] == [(0, "launch"),
                                                       (1, "launch")]
    assert calls == [stem_path, stem_path]  # one try, one retry
    health = eng.health()
    assert health["kernel_faults"] == 2 and health["degraded"] is None
    assert eng.stem_path == stem_path


@pytest.mark.parametrize("stem_path", ["where", "gated"])
def test_nonfinite_cache_forces_a_rerun(models, stem_path):
    eng = _engine(models[1], max_streams=1, stem_path=stem_path)
    eng.submit(StreamRequest(uid=0, frames=_frames([4])[0]))
    eng.step()  # frame 0 re-runs and fills the cache
    eng._cached_stem[0, 0, 0, 0] = float("inf")
    before = (gated.p2m_conv_fused_gated.launches,
              conv.p2m_conv_fused.launches)
    eng.run(on_undrained="raise")
    (r,) = eng.completed
    assert r.skip_count == 0  # frame 1 would have skipped
    assert eng._gates[0].disabled
    assert eng.health()["gate_faults"] == 1
    assert all(np.isfinite(s).all() for _, s in r.frame_outputs)
    # on the CPU nothing launches a kernel
    assert (gated.p2m_conv_fused_gated.launches,
            conv.p2m_conv_fused.launches) == before


def test_engine_publishes_stream_views(models):
    eng = _engine(models[1])
    eng.run(_streams(_frames([4])))
    snap = eng.registry.snapshot()
    views = snap["components"][eng.metrics_scope]
    assert views["stream"] == eng.stream_summary()
    assert views["gates"][0] is not None


def test_port_init_drives_the_engine(models):
    """The port's own init (no reference weights) builds a working head."""
    params, bn = init_mnv2(torch.Generator().manual_seed(0), CFG,
                           device="cpu")
    det = init_detect_head(torch.Generator().manual_seed(1), 16, DCFG,
                           device="cpu")
    eng = StreamEngine(params, bn, CFG, det, det_cfg=DCFG, device="cpu")
    (r,) = eng.run(_streams(_frames([3])))
    boxes, scores = r.frame_outputs[-1]
    assert boxes.shape == (4, 4) and scores.shape == (4,)
    assert np.isfinite(boxes).all() and np.isfinite(scores).all()
