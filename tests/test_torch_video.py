"""The port's video building blocks against the JAX reference, on the CPU:
`repro_torch.core.bandwidth`, `repro_torch.video` (synthetic streams,
tracker, delta gate, detection head) and the delta-gated stem's plain
twin (`repro_torch.kernels.p2m_conv.gated`).

Tolerances: the numpy modules (bandwidth, synthetic, track, delta,
`render_targets`) are copies and must agree exactly.  The detection head
runs fp32 convs in another order: 1e-5; `detect_loss` within 1e-5
relative, its gradient rtol 1e-4 / atol 1e-6 (logs and powers in fp32,
summed in another order).  `decode_detections` is exact on
the same head outputs, ties included (a stable sort puts the lower index
first, as `jax.lax.top_k` does).  The gated stem's plain twin: skipped
slots copy the cache bit for bit; computed slots as in
`tests/test_torch_p2m_conv.py` (raw and relu rtol 1e-5 / atol 1e-6,
quant within one count at half counts).  The Ho = 1 geometry is held at
rtol/atol 1e-5 only: there the reference's gated kernel is not bitwise
equal to its own dense kernel (ROADMAP, Queue C).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bandwidth as jbw
from repro.kernels.p2m_conv.gated import aligned_block_h as j_aligned_block_h
from repro.kernels.p2m_conv.gated import (
    p2m_conv_gated_jnp,
    p2m_conv_pallas_gated,
)
from repro.video import DeltaGate as JDeltaGate
from repro.video import DeltaGateConfig as JDeltaGateConfig
from repro.video import SyntheticVideo as JSyntheticVideo
from repro.video import Tracker as JTracker
from repro.video import detect as jdetect
from repro.video import iou_matrix as j_iou_matrix
from repro_torch import compat
from repro_torch.core import bandwidth as bw
from repro_torch.core.pixel_model import default_pixel_model
from repro_torch.kernels.p2m_conv import conv, gated
from repro_torch.kernels.p2m_conv.ops import _coeff_tuple
from repro_torch.video import (
    DeltaGate,
    DeltaGateConfig,
    DetectConfig,
    SyntheticVideo,
    Tracker,
    apply_detect_head,
    decode_detections,
    detect_loss,
    init_detect_head,
    iou_matrix,
    render_targets,
)
from repro_torch.video.detect import det_grid

COEFFS = _coeff_tuple(default_pixel_model())
V_LSB = 1.0 / 255.0
RTOL, ATOL = 1e-5, 1e-6


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------- bandwidth

GEOMS = [dict(), dict(image_size=40, kernel=5, stride=5),
         dict(image_size=24, kernel=4, stride=4, out_channels=4),
         dict(image_size=33, kernel=3, stride=2, padding=1, out_bits=4)]


@pytest.mark.parametrize("kw", GEOMS)
def test_bandwidth_formulas_match_reference(kw):
    g, jg = bw.FirstLayerGeom(**kw), jbw.FirstLayerGeom(**kw)
    assert dataclasses.asdict(g) == dataclasses.asdict(jg)
    assert (g.out_spatial, g.input_elems, g.output_elems) == (
        jg.out_spatial, jg.input_elems, jg.output_elems)
    assert bw.bandwidth_reduction(g) == jbw.bandwidth_reduction(jg)
    assert bw.compression_ratio(g) == jbw.compression_ratio(jg)
    assert bw.frame_output_bits(g) == jbw.frame_output_bits(jg)
    for frac in (0.0, 0.25, 0.5, 1.0):
        assert bw.event_readout_bits(g, frac) == jbw.event_readout_bits(
            jg, frac)


def test_paper_table1_bandwidth_reduction_is_18_75():
    """Eq. 2 at Table 1 (i = 560, k = s = 5, c_o = 8, N_b = 8)."""
    g = bw.paper_table1_geom()
    assert bw.bandwidth_reduction(g) == pytest.approx(18.75)
    assert bw.bandwidth_reduction(g) == jbw.bandwidth_reduction(
        jbw.paper_table1_geom())
    assert bw.compression_ratio(g) == pytest.approx(1 / 18.75)
    assert (bw.BAYER_FACTOR, bw.SENSOR_BIT_DEPTH, bw.SKIP_FLAG_BITS) == (
        jbw.BAYER_FACTOR, jbw.SENSOR_BIT_DEPTH, jbw.SKIP_FLAG_BITS)


@pytest.mark.parametrize("kw", [dict(image_size=0), dict(padding=-1),
                                dict(image_size=4, kernel=5),
                                dict(stride=0), dict(out_channels=0),
                                dict(out_bits=0)])
def test_bandwidth_geometry_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        jbw.FirstLayerGeom(**kw)
    with pytest.raises(ValueError):
        bw.FirstLayerGeom(**kw)
    with pytest.raises(ValueError):
        bw.event_readout_bits(bw.FirstLayerGeom(), 1.5)


def test_stream_ledger_matches_reference_over_a_recorded_sequence():
    rng = np.random.default_rng(0)
    reruns = [True] + list(rng.random(40) < 0.4)
    g = bw.FirstLayerGeom(image_size=40, kernel=5, stride=5)
    ledger = bw.StreamBandwidthLedger(g)
    ref = jbw.StreamBandwidthLedger(jbw.FirstLayerGeom(image_size=40,
                                                       kernel=5, stride=5))
    assert ledger.summary() == ref.summary()  # empty: all zeros
    for r in reruns:
        assert ledger.record(bool(r)) == ref.record(bool(r))
    assert ledger.summary() == ref.summary()
    assert ledger.bits == sum(reruns) * bw.frame_output_bits(g) + len(reruns)


# ------------------------------------------------- synthetic, track, delta


@pytest.mark.parametrize("kw", [
    dict(image_size=24, n_frames=5, n_objects=2, seed=7),
    dict(image_size=40, n_frames=6, hold=3, seed=1, n_objects=3),
    dict(image_size=24, n_frames=4, hold=2, seed=3, noise=0.05),
])
def test_synthetic_video_is_the_reference_bit_for_bit(kw):
    v, jv = SyntheticVideo(**kw), JSyntheticVideo(**kw)
    np.testing.assert_array_equal(v.frames(), jv.frames())
    np.testing.assert_array_equal(v.gt_boxes(), jv.gt_boxes())
    for t in (0, kw["n_frames"] - 1):
        got, want = v.frame_at(t), jv.frame_at(t)
        for key in ("image", "boxes", "ids"):
            np.testing.assert_array_equal(got[key], want[key])


def test_tracker_and_iou_match_reference():
    rng = np.random.default_rng(2)
    a = np.sort(rng.random((5, 4)).astype(np.float32).reshape(5, 2, 2),
                axis=1).reshape(5, 4)[:, [0, 2, 1, 3]]
    np.testing.assert_array_equal(iou_matrix(a, a[::-1]),
                                  j_iou_matrix(a, a[::-1]))
    trk, ref = Tracker(iou_thresh=0.3, max_age=2), JTracker(iou_thresh=0.3,
                                                            max_age=2)
    base = np.array([[0.1, 0.1, 0.3, 0.3], [0.5, 0.5, 0.8, 0.9],
                     [0.2, 0.6, 0.4, 0.8]], np.float32)
    for t in range(8):
        keep = rng.random(3) < 0.7
        boxes = (base + 0.02 * t + rng.normal(0, 0.01, base.shape)).astype(
            np.float32)[keep]
        scores = rng.random(int(keep.sum())).astype(np.float32)
        got = [(x.tid, x.box, x.score, x.age, x.hits)
               for x in trk.update(boxes, scores)]
        want = [(x.tid, x.box, x.score, x.age, x.hits)
                for x in ref.update(boxes, scores)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g[0] == w[0] and g[2:] == w[2:]
            np.testing.assert_array_equal(g[1], w[1])
        assert [x.tid for x in trk.tracks] == [x.tid for x in ref.tracks]


@pytest.mark.parametrize("threshold,noise", [(0.0, 0.0), (0.0, 0.02),
                                             (0.2, 0.02), (None, 0.0)])
def test_delta_gate_matches_reference(threshold, noise):
    kw = dict(image_size=24, kernel=4, padding=0, stride=4, out_channels=4,
              out_bits=8)
    gate = DeltaGate(DeltaGateConfig(threshold=threshold),
                     bw.FirstLayerGeom(**kw))
    ref = JDeltaGate(JDeltaGateConfig(threshold=threshold),
                     jbw.FirstLayerGeom(**kw))
    frames = SyntheticVideo(image_size=24, n_frames=8, hold=3, seed=0,
                            noise=noise).frames()
    for f in frames:
        r = gate.should_rerun(f)
        assert r == ref.should_rerun(f)
        assert gate.observe(f, r) == ref.observe(f, r)
    assert gate.ledger.summary() == ref.ledger.summary()
    # a corrupted reference frame drops both gates to dense
    gate._ref[0, 0, 0] = np.nan
    ref._ref[0, 0, 0] = np.nan
    if threshold is not None:
        assert gate.should_rerun(frames[0]) and ref.should_rerun(frames[0])
        assert gate.disabled and ref.disabled


# ----------------------------------------------------------- detection


DCFG = DetectConfig(head_channels=8, max_dets=4)
JDCFG = jdetect.DetectConfig(head_channels=8, max_dets=4)


def _head(in_channels=16, seed=1):
    ref = jdetect.init_detect_head(jax.random.PRNGKey(seed), in_channels,
                                   JDCFG)
    return ref, compat.tree_from_reference(_np_tree(ref), device="cpu")


def test_detect_head_carries_across_hwio_to_oihw():
    """`compat.tree_from_reference` takes the head's 4-D ``w`` leaves from
    HWIO to OIHW and leaves the biases alone; the port's own init draws
    the same structure and shapes."""
    ref, head = _head()
    for name in ("shared", "heatmap", "size", "offset"):
        w = np.asarray(ref[name]["w"])
        np.testing.assert_array_equal(head[name]["w"].numpy(),
                                      np.transpose(w, (3, 2, 0, 1)))
        np.testing.assert_array_equal(head[name]["b"].numpy(),
                                      np.asarray(ref[name]["b"]))
    own = init_detect_head(torch.Generator().manual_seed(0), 16, DCFG,
                           device="cpu")
    assert {k: {n: tuple(v.shape) for n, v in layer.items()}
            for k, layer in own.items()} == {
        k: {n: tuple(v.shape) for n, v in layer.items()}
        for k, layer in head.items()}
    assert float(own["heatmap"]["b"][0]) == pytest.approx(DCFG.prior_logit)


@pytest.mark.parametrize("hw,grid", [(3, 10), (2, 5), (5, 3), (4, 56),
                                     (1, 4)])
def test_apply_detect_head_matches_reference(hw, grid):
    """Non-whole resize ratios pin nearest-exact (half-pixel centres, as
    `jax.image.resize(..., "nearest")`)."""
    ref, head = _head()
    feats = np.random.default_rng(hw).random((2, hw, hw, 16)).astype(
        np.float32)
    want = jdetect.apply_detect_head(ref, jnp.asarray(feats), grid)
    got = apply_detect_head(head, torch.from_numpy(feats), grid)
    for key in ("heatmap", "size", "offset"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-5)


def _plateau_outs(b, h, w, seed):
    """Head outputs whose heatmap has plateaus (equal neighbours) and few
    peaks, so most of the top-k ties at zero."""
    rng = np.random.default_rng(seed)
    hm = np.zeros((b, h, w, 1), np.float32)
    hm[:, ::3, ::2, 0] = 0.25
    hm[0, h // 2, 0, 0] = hm[0, h // 2, 1, 0] = 0.7  # a plateau of two
    hm[-1, h - 1, w - 1, 0] = 0.9
    return {"heatmap": hm,
            "size": rng.random((b, h, w, 2)).astype(np.float32),
            "offset": rng.random((b, h, w, 2)).astype(np.float32)}


@pytest.mark.parametrize("b,h,w,k", [(2, 7, 9, 8), (3, 6, 6, 20),
                                     (1, 2, 2, 8), (2, 1, 3, 4)])
def test_decode_detections_matches_reference_exactly(b, h, w, k):
    """Plateaus and zero ties decode in the reference's order; a grid
    smaller than k pads (``kk < k``)."""
    outs = _plateau_outs(b, h, w, seed=h * w)
    jb, js = jdetect.decode_detections(
        {n: jnp.asarray(v) for n, v in outs.items()}, k)
    tb, ts = decode_detections({n: torch.from_numpy(v)
                                for n, v in outs.items()}, k)
    assert tb.shape == (b, k, 4) and ts.shape == (b, k)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_decode_on_the_head_agrees_with_reference():
    ref, head = _head()
    feats = np.random.default_rng(5).random((2, 3, 3, 16)).astype(np.float32)
    grid = det_grid(14)
    jo = jdetect.apply_detect_head(ref, jnp.asarray(feats), grid)
    to = apply_detect_head(head, torch.from_numpy(feats), grid)
    jb, js = jdetect.decode_detections(jo, 6)
    tb, ts = decode_detections(to, 6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-5)


def test_render_targets_and_detect_loss_match_reference():
    vid = SyntheticVideo(image_size=32, n_frames=2, n_objects=3, seed=4)
    boxes = vid.boxes_at(1)[0]
    tgt = render_targets(boxes, 12, 10)
    jtgt = jdetect.render_targets(boxes, 12, 10)
    for key in tgt:
        np.testing.assert_array_equal(tgt[key], jtgt[key])
    rng = np.random.default_rng(6)
    raw = {"heatmap": rng.random((1, 12, 10, 1)),
           "size": rng.random((1, 12, 10, 2)),
           "offset": rng.random((1, 12, 10, 2))}
    raw = {k: v.astype(np.float32) for k, v in raw.items()}
    outs = {k: torch.from_numpy(v).requires_grad_(True)
            for k, v in raw.items()}
    targets = {k: torch.from_numpy(v[None]) for k, v in tgt.items()}
    loss = detect_loss(outs, targets)
    jtargets = {k: jnp.asarray(v[None]) for k, v in jtgt.items()}
    jouts = {k: jnp.asarray(v) for k, v in raw.items()}
    jloss = jdetect.detect_loss(jouts, jtargets)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    grads = torch.autograd.grad(loss, list(outs.values()))
    jgrads = jax.grad(lambda o: jdetect.detect_loss(o, jtargets))(jouts)
    for g, key in zip(grads, outs):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[key]),
                                   rtol=1e-4, atol=1e-6)


# ------------------------------------------------------- gated stem twin

# (B, H, W, C, k, s, N): s == k, s < k, ragged N; then Ho = 1.
GATED_GEOMETRIES = [
    (4, 20, 20, 3, 5, 5, 8),
    (3, 13, 11, 2, 3, 2, 5),
    (4, 10, 12, 3, 4, 3, 8),
]
HO1 = (3, 4, 4, 2, 4, 4, 8)
MASKS = {"all rerun": [1, 1, 1, 1], "all skip": [0, 0, 0, 0],
         "mixed": [1, 0, 0, 1], "one slot": [0, 0, 1, 0]}


def _gated_data(b, h, w, c, k, s, n, seed):
    rng = np.random.default_rng(seed)
    imgs = rng.random((b, h, w, c)).astype(np.float32)
    wt = (rng.uniform(-1, 1, (k * k * c, n)) * (3.0 / (k * k * c)) ** 0.5
          ).astype(np.float32)
    sh = rng.uniform(-0.2, 0.2, (n,)).astype(np.float32)
    ho, wo = (h - k) // s + 1, (w - k) // s + 1
    cached = rng.random((b, ho, wo, n)).astype(np.float32)
    return imgs, wt, sh, cached


def _run_gated(geom, mask, mode, seed=0):
    b, h, w, c, k, s, n = geom
    imgs, wt, sh, cached = _gated_data(b, h, w, c, k, s, n, seed)
    rerun = np.asarray(mask[:b], bool)
    kw = dict(kernel=k, stride=s, mode=mode)
    got = gated.p2m_conv_gated_plain(
        torch.from_numpy(imgs), conv.premix_rows(torch.from_numpy(wt),
                                                 COEFFS, k),
        torch.from_numpy(sh), torch.from_numpy(cached),
        torch.from_numpy(rerun), **kw).numpy()
    jargs = (jnp.asarray(imgs), jnp.asarray(wt), jnp.asarray(sh),
             jnp.asarray(cached), jnp.asarray(rerun))
    xla = np.asarray(p2m_conv_gated_jnp(*jargs, coeffs=COEFFS, **kw))
    pallas = np.asarray(p2m_conv_pallas_gated(*jargs, coeffs=COEFFS,
                                              interpret=True, **kw))
    _, raw = conv.p2m_conv_premixed_plain(
        torch.from_numpy(imgs), conv.premix_rows(torch.from_numpy(wt),
                                                 COEFFS, k),
        torch.zeros(n), mode="raw", want_raw=True, kernel=k, stride=s)
    return got, (xla, pallas), cached, rerun, raw


def _assert_gated_close(got, ref, cached, rerun, raw, mode):
    """Skipped slots: the cache, bit for bit; computed slots: raw and
    relu at RTOL/ATOL, quant by the count rule."""
    np.testing.assert_array_equal(got[~rerun], cached[~rerun])
    np.testing.assert_array_equal(ref[~rerun], cached[~rerun])
    if mode == "quant":
        rep = conv.quant_disagreement(
            torch.from_numpy(got[rerun]), torch.from_numpy(ref[rerun]),
            raw[torch.from_numpy(rerun)], V_LSB)
        assert rep["max_count_diff"] <= 1, rep
        assert rep["n_diff"] <= 1e-4 * got[rerun].size, rep
        assert rep["all_near_half"], rep
    else:
        np.testing.assert_allclose(got[rerun], ref[rerun], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("geom", GATED_GEOMETRIES)
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("mode", ["raw", "relu", "quant"])
def test_gated_plain_twin_matches_reference(geom, mask, mode):
    got, refs, cached, rerun, raw = _run_gated(geom, MASKS[mask], mode)
    for ref in refs:
        _assert_gated_close(got, ref, cached, rerun, raw, mode)


@pytest.mark.parametrize("mode", ["raw", "relu", "quant"])
def test_gated_plain_twin_at_ho_1(mode):
    got, refs, cached, rerun, _ = _run_gated(HO1, [1, 0, 1], mode)
    assert got.shape[1:3] == (1, 1)
    for ref in refs:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_gated_plain_twin_random_masks_equal_b1_then_where():
    """On the CPU the gated twin is the plain conv followed by the
    select, to the bit, over random masks."""
    rng = np.random.default_rng(3)
    b, h, w, c, k, s, n = GATED_GEOMETRIES[0]
    imgs, wt, sh, cached = (torch.from_numpy(a) for a in _gated_data(
        b, h, w, c, k, s, n, 9))
    wrows = conv.premix_rows(wt, COEFFS, k)
    for _ in range(4):
        rerun = torch.from_numpy(rng.random(b) < 0.5)
        for mode in ("raw", "relu", "quant"):
            kw = dict(kernel=k, stride=s, mode=mode)
            dense = conv.p2m_conv_fused(imgs, wrows, sh, **kw)
            want = torch.where(rerun[:, None, None, None], dense, cached)
            assert torch.equal(gated.p2m_conv_gated_plain(
                imgs, wrows, sh, cached, rerun, **kw), want)


def test_gated_wrapper_on_the_cpu_runs_the_plain_twin():
    b, h, w, c, k, s, n = GATED_GEOMETRIES[1]
    imgs, wt, sh, cached = (torch.from_numpy(a) for a in _gated_data(
        b, h, w, c, k, s, n, 2))
    wrows = conv.premix_rows(wt, COEFFS, k)
    rerun = torch.tensor([True, False, True])
    before = gated.p2m_conv_fused_gated.launches
    got = gated.p2m_conv_fused_gated(imgs, wrows, sh, cached, rerun,
                                     kernel=k, stride=s, mode="quant")
    assert gated.p2m_conv_fused_gated.launches == before  # nothing launched
    assert torch.equal(got, gated.p2m_conv_gated_plain(
        imgs, wrows, sh, cached, rerun, kernel=k, stride=s, mode="quant"))
    # an int32 mask selects the same
    assert torch.equal(got, gated.p2m_conv_fused_gated(
        imgs, wrows, sh, cached, rerun.to(torch.int32), kernel=k, stride=s,
        mode="quant"))


def test_aligned_block_h_is_the_reference():
    """The port's copy of the slot-aligned row tile (the ring body's
    block_h clamp) equals the reference's for every Ho and block_h in
    1..130."""
    for ho in range(1, 131):
        for bh in range(1, 131):
            assert gated.aligned_block_h(ho, bh) == j_aligned_block_h(
                ho, bh), (ho, bh)


@pytest.mark.parametrize("depth", [0, 2, 3])
@pytest.mark.parametrize("block_h", [None, 1, 3, 7])
def test_gated_wrapper_on_the_cpu_takes_any_blocks(depth, block_h):
    """On the CPU the wrapper runs the plain twin whatever blocks it is
    asked for (at Ho = 4, block_h 3 and 7 clamp to 2 and 4 on the card),
    and agrees with the reference's gated kernel at the same block_h."""
    b, h, w, c, k, s, n = GATED_GEOMETRIES[0]
    imgs, wt, sh, cached = _gated_data(b, h, w, c, k, s, n, 4)
    rerun = np.asarray(MASKS["mixed"], bool)
    args = [torch.from_numpy(a) for a in (imgs, wt, sh, cached, rerun)]
    wrows = conv.premix_rows(args[1], COEFFS, k)
    kw = dict(kernel=k, stride=s, mode="quant")
    before = (gated.p2m_conv_fused_gated.launches,
              gated.p2m_conv_fused_gated.launches_pipelined)
    got = gated.p2m_conv_fused_gated(args[0], wrows, args[2], args[3],
                                     args[4], block_h=block_h,
                                     pipeline_depth=depth, **kw)
    assert (gated.p2m_conv_fused_gated.launches,
            gated.p2m_conv_fused_gated.launches_pipelined) == before
    assert torch.equal(got, gated.p2m_conv_gated_plain(
        args[0], wrows, args[2], args[3], args[4], **kw))
    ref = np.asarray(p2m_conv_pallas_gated(
        *(jnp.asarray(a) for a in (imgs, wt, sh, cached, rerun)),
        coeffs=COEFFS, interpret=True, block_h=block_h, **kw))
    _, raw = conv.p2m_conv_premixed_plain(
        args[0], wrows, torch.zeros(n), mode="raw", want_raw=True, kernel=k,
        stride=s)
    _assert_gated_close(got.numpy(), ref, cached, rerun, raw, "quant")


@pytest.mark.parametrize("depth", [1, -1, -2])
def test_gated_wrapper_refuses_depths_the_conv_refuses(depth):
    b, h, w, c, k, s, n = GATED_GEOMETRIES[0]
    imgs, wt, sh, cached = (torch.from_numpy(a) for a in _gated_data(
        b, h, w, c, k, s, n, 5))
    wrows = conv.premix_rows(wt, COEFFS, k)
    rerun = torch.ones(b, dtype=torch.bool)
    kw = dict(kernel=k, stride=s, pipeline_depth=depth)
    with pytest.raises(ValueError, match="pipeline_depth"):
        conv.p2m_conv_fused(imgs, wrows, sh, **kw)
    with pytest.raises(ValueError, match="pipeline_depth"):
        gated.p2m_conv_fused_gated(imgs, wrows, sh, cached, rerun, **kw)
