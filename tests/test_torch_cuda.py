"""The port's CUDA kernels, its engines and its train step on a GPU: each
test needs an NVIDIA card and skips without one.  This file imports no JAX, so it runs
on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)  The kernel builds
at first use.  Tolerances as in `tests/test_torch_p2m_conv.py`: raw and
relu rtol 1e-5 / atol 1e-6; quant counts may differ by one in at most
1e-4 of the elements, only at half counts.  The backward kernels (B3 dX,
B4 dW) are held to their plain twins computed in float64 within 1e-4 of
the largest |plain| (fp32 sums over up to 10^5 rows in another order).
The gated stem (B5) equals B1 followed by ``torch.where`` bit for bit,
and its plain twin to B1's tolerances.  The pipelined conv (B2) equals B1
bit for bit, raw included, whatever its blocks and depth, and so do the
gradients through it.  The P²M product (B6) is held to its plain twin at
B1's tolerances, and its gradients (B3, B4 through `ops.p2m_matmul`) to
autograd of the plain twin in float64 within 1e-4 of the largest value.  The chunked WKV (B7) is held to
its plain twin within 1e-4 of the largest |plain| (fp32 sums over up to
64 terms and exps in another order, as the reference holds its own
kernel), and keeps a masked row's state bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.p2m_vww import SMOKE
from repro_torch.core.p2m_conv import P2MConvConfig, apply_p2m_conv_deploy
from repro_torch.core.pixel_model import default_pixel_model
from repro_torch.data import SyntheticVWW
from repro_torch.kernels.p2m_conv import (
    backward,
    conv,
    gated,
    kernel,
    ops,
    tune,
)
from repro_torch.kernels.p2m_conv.ops import _coeff_tuple
from repro_torch.kernels.rwkv_wkv import kernel as wkv_kernel
from repro_torch.kernels.rwkv_wkv.ref import wkv_chunked_plain
from repro_torch.models.families import get_family
from repro_torch.models.mobilenetv2 import (
    MNV2Config,
    head_out_channels,
    init_mnv2,
)
from repro_torch.optim import sgd, step_decay
from repro_torch.serving import (
    Request,
    ServeEngine,
    SessionEngine,
    SessionRequest,
    VisionEngine,
    VisionRequest,
)
from repro_torch.serving.engine import FAILED_TOKEN
from repro_torch.train.vision import make_vww_train_step, vww_train_state
from repro_torch.video import (
    DetectConfig,
    StreamEngine,
    StreamRequest,
    SyntheticVideo,
    init_detect_head,
)

pytestmark = pytest.mark.cuda

COEFFS = _coeff_tuple(default_pixel_model())
V_LSB = 1.0 / 255.0
RTOL, ATOL = 1e-5, 1e-6
GEOMETRIES = [  # (B, H, W, C, k, s, N)
    (8, 60, 60, 3, 5, 5, 8),
    (1, 23, 19, 3, 5, 5, 8),
    (2, 14, 11, 2, 3, 2, 8),
    (2, 13, 13, 3, 5, 3, 5),
    (2, 10, 10, 3, 3, 6, 8),
    (1, 17, 12, 3, 4, 3, 16),
    (3, 9, 9, 1, 4, 4, 11),
    (2, 40, 40, 3, 5, 5, 300),  # W̃ split over several blocks of N
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _data(b, h, w, c, k, n, device, seed=0):
    rng = np.random.default_rng(seed)
    imgs = torch.from_numpy(rng.random((b, h, w, c), np.float32))
    scale = (3.0 / (k * k * c)) ** 0.5  # the model's init scale
    wt = torch.from_numpy((rng.uniform(-1, 1, (k * k * c, n)) * scale).astype(
        np.float32))
    sh = torch.from_numpy(rng.uniform(-0.2, 0.2, n).astype(np.float32))
    return (imgs.to(device), conv.premix_rows(wt, COEFFS, k).to(device),
            sh.to(device))


def _stem_launches():
    """B1's and B2's launches together: the tuner picks either."""
    return conv.p2m_conv_fused.launches + \
        conv.p2m_conv_fused.launches_pipelined


def _assert_quant_close(out, ref_out, ref_raw):
    rep = conv.quant_disagreement(out, ref_out, ref_raw, V_LSB)
    assert rep["max_count_diff"] <= 1, rep
    assert rep["n_diff"] <= 1e-4 * out.numel(), rep
    assert rep["all_near_half"], rep


@pytest.mark.parametrize("b,h,w,c,k,s,n", GEOMETRIES)
@pytest.mark.parametrize("mode", ["raw", "relu", "quant"])
def test_kernel_matches_plain(cuda, b, h, w, c, k, s, n, mode):
    x, wrows, shift = _data(b, h, w, c, k, n, cuda)
    before = conv.p2m_conv_fused.launches
    out, raw = conv.p2m_conv_fused(x, wrows, shift, kernel=k, stride=s,
                                   mode=mode, want_raw=True)
    torch.cuda.synchronize()
    assert conv.p2m_conv_fused.launches == before + 1
    ref_out, ref_raw = conv.p2m_conv_premixed_plain(
        x, wrows, shift, kernel=k, stride=s, mode=mode, want_raw=True)
    torch.testing.assert_close(raw, ref_raw, rtol=RTOL, atol=ATOL)
    if mode == "quant":
        _assert_quant_close(out, ref_out, ref_raw)
    else:
        torch.testing.assert_close(out, ref_out, rtol=RTOL, atol=ATOL)
    alone = conv.p2m_conv_fused(x, wrows, shift, kernel=k, stride=s,
                                mode=mode)
    assert torch.equal(alone, out)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, wrows, shift = _data(1, 10, 10, 3, 5, 8, cuda)
    kw = dict(kernel=5, stride=5)
    with pytest.raises(TypeError):
        conv.p2m_conv_fused(x.double(), wrows, shift, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        conv.p2m_conv_fused(x.transpose(1, 2), wrows, shift, **kw)
    with pytest.raises(ValueError, match="is on"):
        conv.p2m_conv_fused(x, wrows.cpu(), shift, **kw)
    wide = torch.zeros((5, 15 * 5, 8), device=cuda)  # dx = 5
    with pytest.raises(ValueError, match="dx=5"):
        conv.p2m_conv_fused(x, wide, shift, **kw)


def test_deploy_stem_on_the_card_uses_the_kernel(cuda):
    cfg = P2MConvConfig()
    x, _, shift = _data(2, 40, 40, 3, 5, 8, cuda, seed=1)
    w = torch.from_numpy(np.random.default_rng(1).uniform(
        -0.3, 0.3, (75, 8)).astype(np.float32)).to(cuda)
    dep = {"w": w, "shift": shift}
    before = _stem_launches()
    got = apply_p2m_conv_deploy(dep, x, cfg)
    assert _stem_launches() == before + 1
    ref = apply_p2m_conv_deploy(dep, x, cfg, impl="patches")
    _, raw = conv.p2m_conv_premixed_plain(
        x, conv.premix_rows(w, COEFFS, 5), torch.zeros_like(shift), kernel=5,
        stride=5, mode="raw", want_raw=True)
    _assert_quant_close(got, ref, raw)


def test_engine_on_the_card_matches_the_plain_stem(cuda):
    params, bn = init_mnv2(torch.Generator().manual_seed(0), SMOKE,
                           device=cuda)
    engine = VisionEngine(params, bn, SMOKE, max_batch=4)
    assert engine.device.type == "cuda"
    imgs = SyntheticVWW(image_size=SMOKE.image_size, batch=6,
                        seed=0).batch_at(0)["images"]
    before = _stem_launches()
    done = engine.run([VisionRequest(uid=i, image=imgs[i])
                       for i in range(6)], on_undrained="raise")
    assert [r.uid for r in done] == list(range(6))
    assert _stem_launches() - before == engine.stats["launches"]
    plain = engine.forward(torch.from_numpy(imgs).to(cuda),
                           p2m_impl="plain").cpu().numpy()
    np.testing.assert_allclose(np.stack([r.probs for r in done]), plain,
                               rtol=1e-4, atol=1e-4)


# ------------------------------------------------------- backward kernels

BWD_CASES = [  # (M, K, N, dw, dx)
    (48, 75, 8, 3, 3),
    (130, 33, 5, 3, 3),
    (8, 1, 1, 3, 3),
    (1000, 75, 13, 2, 1),
    (4097, 27, 16, 3, 2),
    (300, 75, 40, 4, 4),   # B4's pairs over two blocks along y
    (70_001, 75, 8, 3, 3),  # many B4 blocks, M not a multiple of a tile
]


def _bwd_case(m, k, n, dw, dx, device, seed=0):
    rng = np.random.default_rng(seed)
    coeffs = tuple(tuple(float(v) for v in rng.uniform(-1, 1, dx))
                   for _ in range(dw))
    x = torch.from_numpy(rng.random((m, k), np.float32)).to(device)
    w = torch.from_numpy(rng.uniform(-1, 1, (k, n)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    return g.to(device), w.to(device), x, coeffs


def _assert_bwd_close(got, plain64):
    err = float((got.double() - plain64).abs().max())
    assert err <= 1e-4 * float(plain64.abs().max()), err


@pytest.mark.parametrize("m,k,n,dw,dx", BWD_CASES)
def test_backward_kernels_match_plain(cuda, m, k, n, dw, dx):
    g, w, x, coeffs = _bwd_case(m, k, n, dw, dx, cuda)
    wmix = conv.premix_weights(w, coeffs)
    before = (backward.p2m_bwd_dx.launches, backward.p2m_bwd_dw.launches)
    gx = backward.p2m_bwd_dx(g, wmix, x, coeffs)
    gw = backward.p2m_bwd_dw(g, w, x, coeffs)
    torch.cuda.synchronize()
    assert (backward.p2m_bwd_dx.launches,
            backward.p2m_bwd_dw.launches) == (before[0] + 1, before[1] + 1)
    _assert_bwd_close(gx, backward.p2m_bwd_dx_plain(
        g.double(), wmix.double(), x.double()))
    _assert_bwd_close(gw, backward.p2m_bwd_dw_plain(
        g.double(), w.double(), x.double(), coeffs))
    # B4 sums its partials in a fixed order: the same bits every run
    assert torch.equal(gw, backward.p2m_bwd_dw(g, w, x, coeffs))
    assert torch.equal(gx, backward.p2m_bwd_dx(g, w, x, coeffs))


def test_backward_wrappers_reject_what_the_kernels_do_not_take(cuda):
    g, w, x, coeffs = _bwd_case(64, 75, 8, 3, 3, cuda)
    for fn in (backward.p2m_bwd_dx, backward.p2m_bwd_dw):
        with pytest.raises(TypeError):
            fn(g.double(), w, x, coeffs)
        with pytest.raises(ValueError, match="contiguous"):
            fn(g, w, x.t().contiguous().t(), coeffs)
        with pytest.raises(ValueError, match="is on"):
            fn(g, w, x.cpu(), coeffs)
        with pytest.raises(ValueError, match="expected"):
            fn(g, w[:5], x, coeffs)
    five = tuple((0.1,) * 5 for _ in range(3))  # dx = 5
    with pytest.raises(ValueError, match="dx=5"):
        backward.p2m_bwd_dw(g, w, x, five)
    with pytest.raises(ValueError, match="dx=5"):
        backward.p2m_bwd_dx(g, w, x, five)
    with pytest.raises(ValueError, match="dw=5"):
        backward.p2m_bwd_dw(g, w, x, ((0.1,) * 3,) * 5)


@pytest.mark.parametrize("b,h,w_dim,c,k,s",
                         [(2, 20, 20, 3, 5, 5), (2, 13, 11, 3, 5, 3),
                          (4, 60, 60, 3, 5, 5)])
@pytest.mark.parametrize("mode", ["raw", "relu", "quant"])
def test_function_gradients_on_the_card_match_plain_autograd(
        cuda, b, h, w_dim, c, k, s, mode):
    rng = np.random.default_rng(3)
    model = default_pixel_model()
    imgs = torch.from_numpy(rng.random((b, h, w_dim, c), np.float32))
    wt = torch.from_numpy(rng.uniform(-1, 1, (k * k * c, 8)).astype(
        np.float32) * (3.0 / (k * k * c)) ** 0.5)
    sh = torch.from_numpy(rng.uniform(-0.2, 0.2, 8).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal(
        (b, (h - k) // s + 1, (w_dim - k) // s + 1, 8)).astype(np.float32))
    ins = [t.to(cuda).requires_grad_(True) for t in (imgs, wt, sh)]
    counts = (_stem_launches(), backward.p2m_bwd_dx.launches,
              backward.p2m_bwd_dw.launches)
    out = ops.p2m_conv(*ins, model, mode=mode, kernel=k, stride=s)
    got = torch.autograd.grad((out * ct.to(cuda)).sum(), ins)
    assert (_stem_launches(), backward.p2m_bwd_dx.launches,
            backward.p2m_bwd_dw.launches) == tuple(c_ + 1 for c_ in counts)
    ref_ins = [t.to(cuda).double().requires_grad_(True)
               for t in (imgs, wt, sh)]
    ref = conv.p2m_conv_plain(*ref_ins, kernel=k, stride=s, coeffs=COEFFS,
                              mode="relu" if mode == "quant" else mode)
    want = torch.autograd.grad((ref * ct.to(cuda)).sum(), ref_ins)
    for a, r in zip(got, want):
        _assert_bwd_close(a, r)


def test_train_step_on_the_card_launches_every_kernel(cuda):
    cfg = MNV2Config(variant="p2m", image_size=80, width=0.25,
                     head_channels=32)
    params, bn = init_mnv2(torch.Generator().manual_seed(0), cfg, device=cuda)
    opt = sgd(step_decay(0.05, (10,)), momentum=0.9)
    state = vww_train_state(params, bn, opt.init(params))
    step = make_vww_train_step(cfg, opt)
    data = SyntheticVWW(image_size=80, batch=8, seed=0)
    for i in range(2):
        counts = (_stem_launches(),
                  backward.p2m_bwd_dx.launches, backward.p2m_bwd_dw.launches)
        state, m = step(state, data.batch_at(i))
        assert (_stem_launches(), backward.p2m_bwd_dx.launches,
                backward.p2m_bwd_dw.launches) == tuple(c + 1 for c in counts)
        assert np.isfinite(float(m["loss"]))
    assert state["step"] == 2
    assert state["params"]["stem"]["theta"].device.type == "cuda"


# ------------------------------------------------------- gated stem (B5)

GATED_GEOMETRIES = [  # (B, H, W, C, k, s, N)
    (4, 60, 60, 3, 5, 5, 8),
    (3, 14, 11, 2, 3, 2, 8),
    (4, 13, 13, 3, 5, 3, 5),
    (3, 4, 4, 2, 4, 4, 8),  # Ho = Wo = 1
    (2, 40, 40, 3, 5, 5, 300),  # W̃ split over several blocks of N
]
GATED_MASKS = {"all rerun": [1, 1, 1, 1], "all skip": [0, 0, 0, 0],
               "mixed": [1, 0, 0, 1], "one slot": [0, 0, 1, 0]}


@pytest.mark.parametrize("b,h,w,c,k,s,n", GATED_GEOMETRIES)
@pytest.mark.parametrize("mode", ["raw", "relu", "quant"])
def test_gated_kernel_is_b1_then_where_bit_for_bit(cuda, b, h, w, c, k, s,
                                                   n, mode):
    x, wrows, shift = _data(b, h, w, c, k, n, cuda)
    ho, wo = (h - k) // s + 1, (w - k) // s + 1
    cached = torch.rand((b, ho, wo, n), generator=torch.Generator()
                        .manual_seed(1)).to(cuda)
    kw = dict(kernel=k, stride=s, mode=mode)
    dense = conv.p2m_conv_fused(x, wrows, shift, **kw)
    for name, mask in GATED_MASKS.items():
        rerun = torch.tensor(mask[:b], dtype=torch.bool, device=cuda)
        before = gated.p2m_conv_fused_gated.launches
        got = gated.p2m_conv_fused_gated(x, wrows, shift, cached, rerun, **kw)
        torch.cuda.synchronize()
        assert gated.p2m_conv_fused_gated.launches == before + 1
        want = torch.where(rerun[:, None, None, None], dense, cached)
        assert torch.equal(got, want), name
        plain = gated.p2m_conv_gated_plain(x, wrows, shift, cached, rerun,
                                           **kw)
        if mode == "quant":
            _, raw = conv.p2m_conv_premixed_plain(
                x, wrows, torch.zeros_like(shift), mode="raw",
                want_raw=True, kernel=k, stride=s)
            _assert_quant_close(got, plain, raw)
        else:
            torch.testing.assert_close(got, plain, rtol=RTOL, atol=ATOL)


def test_gated_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, wrows, shift = _data(2, 10, 10, 3, 5, 8, cuda)
    cached = torch.zeros((2, 2, 2, 8), device=cuda)
    rerun = torch.ones(2, dtype=torch.bool, device=cuda)
    kw = dict(kernel=5, stride=5)
    with pytest.raises(TypeError):
        gated.p2m_conv_fused_gated(x, wrows, shift, cached.double(), rerun,
                                   **kw)
    with pytest.raises(TypeError, match="rerun"):
        gated.p2m_conv_fused_gated(x, wrows, shift, cached, rerun.float(),
                                   **kw)
    with pytest.raises(ValueError, match="contiguous"):
        gated.p2m_conv_fused_gated(x, wrows, shift,
                                   cached.transpose(1, 2), rerun, **kw)
    with pytest.raises(ValueError, match="is on"):
        gated.p2m_conv_fused_gated(x, wrows, shift, cached.cpu(), rerun,
                                   **kw)
    with pytest.raises(ValueError, match="is on"):
        gated.p2m_conv_fused_gated(x, wrows, shift, cached, rerun.cpu(),
                                   **kw)
    with pytest.raises(ValueError, match="cached"):
        gated.p2m_conv_fused_gated(x, wrows, shift, cached[:, :1], rerun,
                                   **kw)
    with pytest.raises(ValueError, match="rerun"):
        gated.p2m_conv_fused_gated(x, wrows, shift, cached, rerun[:1], **kw)
    wide = torch.zeros((5, 15 * 5, 8), device=cuda)  # dx = 5
    with pytest.raises(ValueError, match="dx=5"):
        gated.p2m_conv_fused_gated(x, wide, shift, cached, rerun, **kw)


def test_gated_stream_on_the_card(cuda):
    """A short stream through the engine on the card: the gated path by
    default, one B5 launch a tick and no B1; the same boxes and scores as
    the where path, bit for bit; half the hold-2 frames skipped."""
    torch.backends.cudnn.deterministic = True
    try:
        params, bn = init_mnv2(torch.Generator().manual_seed(0), SMOKE,
                               device=cuda)
        det = init_detect_head(torch.Generator().manual_seed(1),
                               head_out_channels(SMOKE), DetectConfig(),
                               device=cuda)
        frames = [SyntheticVideo(image_size=SMOKE.image_size, n_frames=n,
                                 hold=2, seed=i).frames()
                  for i, n in enumerate([6, 4, 6])]
        runs = {}
        for path in ("auto", "where"):
            eng = StreamEngine(params, bn, SMOKE, det, max_streams=2,
                               stem_path=path)
            counts = (gated.p2m_conv_fused_gated.launches,
                      _stem_launches())
            done = eng.run([StreamRequest(uid=i, frames=f)
                            for i, f in enumerate(frames)],
                           on_undrained="raise")
            runs[eng.stem_path] = (eng, done, (
                gated.p2m_conv_fused_gated.launches - counts[0],
                _stem_launches() - counts[1]))
        eng, done, (n_b5, n_b1) = runs["gated"]
        assert eng.device.type == "cuda"
        assert (n_b5, n_b1) == (eng.stats["launches"], 0)
        assert eng.stream_summary()["stem_flops_skipped_ratio"] == 0.5
        w_eng, w_done, (w_b5, w_b1) = runs["where"]
        assert (w_b5, w_b1) == (0, w_eng.stats["launches"])
        for a, b in zip(done, w_done):
            assert a.uid == b.uid and a.skip_count == b.skip_count
            for (ba, sa), (bb, sb) in zip(a.frame_outputs, b.frame_outputs):
                np.testing.assert_array_equal(ba, bb)
                np.testing.assert_array_equal(sa, sb)
    finally:
        torch.backends.cudnn.deterministic = False


# ------------------------------------------------------------------ WKV (B7)

WKV_TOL = 1e-4
WKV_SHAPES = [  # (B, S, H, D)
    (8, 64, 40, 64),  # the serving tick's shape
    (2, 1, 3, 64), (2, 15, 3, 16), (2, 17, 3, 64), (1, 100, 2, 16),
    (3, 45, 2, 32), (2, 16, 1, 7), (1, 0, 2, 16),
]


def _wkv_case(b, s, h, d, device, seed=0, zero_state=False):
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(device)
    r, k, v = f(b, s, h, d), f(b, s, h, d), f(b, s, h, d)
    lw = torch.from_numpy(-rng.uniform(1e-6, 5.0, (b, s, h, d)).astype(
        np.float32)).to(device)
    u = f(h, d) * 0.3
    s0 = torch.zeros((b, h, d, d), device=device) if zero_state else \
        f(b, h, d, d) * 0.5
    return r, k, v, lw, u, s0


def _assert_wkv_close(got, plain):
    err = float((got - plain).abs().max()) if got.numel() else 0.0
    scale = float(plain.abs().max()) if plain.numel() else 0.0
    assert err <= WKV_TOL * max(scale, 1.0), (err, scale)


@pytest.mark.parametrize("b,s,h,d", WKV_SHAPES)
@pytest.mark.parametrize("zero_state", [False, True])
def test_wkv_kernel_matches_plain(cuda, b, s, h, d, zero_state):
    ins = _wkv_case(b, s, h, d, cuda, zero_state=zero_state)
    before = wkv_kernel.wkv_fused.launches
    y, sf = wkv_kernel.wkv_fused(*ins)
    torch.cuda.synchronize()
    assert wkv_kernel.wkv_fused.launches == before + 1
    y_p, s_p = wkv_chunked_plain(*ins)
    assert y.shape == y_p.shape and sf.shape == s_p.shape
    _assert_wkv_close(y, y_p)
    _assert_wkv_close(sf, s_p)


@pytest.mark.parametrize("b,s,h,d", [(4, 37, 3, 64), (2, 64, 2, 16)])
def test_wkv_kernel_keeps_masked_rows_bit_for_bit(cuda, b, s, h, d):
    """A row whose lw and k are 0 everywhere keeps its state bit for bit;
    one masked past its 5th token equals the same row cut at 5 tokens."""
    r, k, v, lw, u, s0 = _wkv_case(b, s, h, d, cuda, seed=1)
    lw[1], k[1] = 0.0, 0.0
    lw[0, 5:], k[0, 5:] = 0.0, 0.0
    _, sf = wkv_kernel.wkv_fused(r, k, v, lw, u, s0)
    torch.cuda.synchronize()
    assert torch.equal(sf[1], s0[1])
    cut = [a[:, :5].contiguous() for a in (r, k, v, lw)]
    _, s5 = wkv_kernel.wkv_fused(*cut, u, s0)
    _assert_wkv_close(sf[0], s5[0])


def test_wkv_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    r, k, v, lw, u, s0 = _wkv_case(2, 20, 2, 16, cuda)
    with pytest.raises(TypeError, match="float32"):
        wkv_kernel.wkv_fused(r.double(), k, v, lw, u, s0)
    with pytest.raises(ValueError, match="contiguous"):
        wkv_kernel.wkv_fused(r.transpose(1, 2).contiguous().transpose(1, 2),
                             k, v, lw, u, s0)
    with pytest.raises(ValueError, match="chunk"):
        wkv_kernel.wkv_fused(r, k, v, lw, u, s0, chunk=8)
    with pytest.raises(ValueError, match="is on"):
        wkv_kernel.wkv_fused(r, k, v, lw, u.cpu(), s0)
    with pytest.raises(ValueError, match="state"):
        wkv_kernel.wkv_fused(r, k, v, lw, u, s0[:, :1].contiguous())
    big = _wkv_case(1, 4, 1, 80, cuda)
    with pytest.raises(ValueError, match="head dim"):
        wkv_kernel.wkv_fused(*big)


def test_lm_engine_on_the_card_matches_the_cpu_port(cuda):
    """SMOKE rwkv served on the card (chunked prefill through B7) gives
    the tokens the same engine gives on the CPU."""
    cfg = get_smoke_config("rwkv6-3b").replace(dtype=torch.float32)
    params, _ = get_family(cfg).init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).tolist()
               for n in (3, 17, 40, 9, 64, 1)]
    outs = {}
    for device in ("cpu", "cuda"):
        eng = ServeEngine(params, cfg, max_batch=4, max_len=128,
                          prefill_chunk=16, device=device)
        before = wkv_kernel.wkv_fused.launches
        done = eng.run([Request(uid=i, prompt=p, max_new_tokens=6)
                        for i, p in enumerate(prompts)],
                       on_undrained="raise")
        outs[device] = ({r.uid: r.output for r in done},
                        wkv_kernel.wkv_fused.launches - before)
    assert outs["cuda"][0] == outs["cpu"][0]
    assert outs["cpu"][1] == 0 and outs["cuda"][1] > 0
    assert outs["cuda"][1] % cfg.n_layers == 0


# ------------------------------------------------------ pipelined conv (B2)

PIPE_GEOMETRIES = [  # (B, H, W, C, k, s, N, dw, dx)
    (8, 60, 60, 3, 5, 5, 8, 3, 3),  # s = k, 16-byte copies
    (2, 14, 11, 2, 3, 2, 8, 3, 1),  # s < k, 4-byte copies
    (2, 13, 13, 3, 5, 3, 5, 2, 2),
    (3, 17, 12, 3, 4, 3, 24, 3, 3),  # three register chunks a thread
    (2, 40, 40, 3, 5, 5, 40, 4, 4),  # two N tiles, the last one ragged
    (1, 23, 19, 3, 5, 5, 11, 3, 4),
    (3, 9, 9, 1, 4, 4, 16, 2, 3),  # Ho = Wo = 2
]


def _pipe_case(b, h, w, c, k, n, dw, dx, device, seed=0):
    rng = np.random.default_rng(seed)
    coeffs = tuple(tuple(float(v) for v in rng.uniform(-1, 1, dx))
                   for _ in range(dw))
    imgs = torch.from_numpy(rng.random((b, h, w, c), np.float32))
    wt = torch.from_numpy(rng.uniform(-0.4, 0.4, (k * k * c, n)).astype(
        np.float32))
    sh = torch.from_numpy(rng.uniform(-0.2, 0.2, n).astype(np.float32))
    return (imgs.to(device), conv.premix_rows(wt, coeffs, k).to(device),
            sh.to(device))


@pytest.mark.parametrize("b,h,w,c,k,s,n,dw,dx", PIPE_GEOMETRIES)
@pytest.mark.parametrize("mode", ["raw", "relu", "quant"])
def test_pipelined_kernel_is_b1_bit_for_bit(cuda, b, h, w, c, k, s, n, dw,
                                            dx, mode):
    x, wrows, shift = _pipe_case(b, h, w, c, k, n, dw, dx, cuda)
    kw = dict(kernel=k, stride=s, mode=mode, want_raw=True)
    out1, raw1 = conv.p2m_conv_fused(x, wrows, shift, **kw)
    ho = (h - k) // s + 1
    wo = (w - k) // s + 1
    for depth in (2, 3, 8):  # 8 clamps to k
        for block_h in (1, 2, max(1, 256 // wo)):
            for block_n in (8, 32):
                before = conv.p2m_conv_fused.launches_pipelined
                out2, raw2 = conv.p2m_conv_fused(
                    x, wrows, shift, block_h=min(block_h, b * ho),
                    block_n=block_n, pipeline_depth=depth, **kw)
                torch.cuda.synchronize()
                assert conv.p2m_conv_fused.launches_pipelined == before + 1
                case = (depth, block_h, block_n)
                assert torch.equal(out2, out1), case
                assert torch.equal(raw2, raw1), case


def test_pipelined_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, wrows, shift = _data(2, 60, 60, 3, 5, 8, cuda)
    kw = dict(kernel=5, stride=5)
    for bad in (1, -2):
        with pytest.raises(ValueError, match="pipeline_depth"):
            conv.p2m_conv_fused(x, wrows, shift, pipeline_depth=bad, **kw)
    wide = _data(1, 60, 600, 3, 5, 8, cuda)[0]  # Ho = 12, Wo = 120
    with pytest.raises(ValueError, match="threads"):  # 8 x 120 pixels
        conv.p2m_conv_fused(wide, wrows, shift, pipeline_depth=2, block_h=8,
                            **kw)
    with pytest.raises(TypeError):
        conv.p2m_conv_fused(x.double(), wrows, shift, pipeline_depth=2, **kw)


def test_pipelined_runs_where_b1_cannot_stage_its_weights(cuda):
    # k = 15: B1's W̃ of all k rows (2025 x 8 floats) exceeds its 48 KB,
    # while B2 stages one kernel row's slab a ring slot.
    x, wrows, shift = _pipe_case(2, 45, 45, 3, 15, 8, 3, 3, cuda)
    kw = dict(kernel=15, stride=15, mode="relu")
    with pytest.raises(ValueError, match="does not fit"):
        conv.p2m_conv_fused(x, wrows, shift, **kw)
    got = conv.p2m_conv_fused(x, wrows, shift, pipeline_depth=2, **kw)
    want = conv.p2m_conv_premixed_plain(x.cpu(), wrows.cpu(), shift.cpu(),
                                        **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    cands = tune.conv_candidates(2, 3, 3, 8, 45, kernel=15, stride=15)
    assert cands and all(d >= 2 for *_, d in cands)


def test_pipelined_gradients_equal_b1_gradients(cuda):
    model = default_pixel_model()
    rng = np.random.default_rng(5)
    imgs = torch.from_numpy(rng.random((4, 23, 23, 3), np.float32))
    wt = torch.from_numpy(rng.uniform(-0.4, 0.4, (75, 8)).astype(np.float32))
    sh = torch.from_numpy(rng.uniform(-0.2, 0.2, 8).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal((4, 7, 7, 8)).astype(
        np.float32)).to(cuda)
    grads = {}
    for depth in (0, 2):
        ins = [t.to(cuda).requires_grad_(True) for t in (imgs, wt, sh)]
        out = ops.p2m_conv(*ins, model, mode="relu", kernel=5, stride=3,
                           pipeline_depth=depth)
        grads[depth] = torch.autograd.grad((out * ct).sum(), ins)
    for a, b in zip(grads[0], grads[2]):
        assert torch.equal(a, b)


def test_tuner_caches_its_decision_on_the_card(cuda):
    tune.cache_clear()
    args = (2, 60, 60, 3, 8, 5, 5, COEFFS, "quant")
    first = tune.get_conv_blocks(*args, device=cuda)
    records = tune.decision_records()
    assert len(records) == 1
    rec = records[0]
    assert rec["n_failed"] == 0 and rec["n_viable"] == len(rec["candidates"])
    assert rec["best"] == list(first)
    assert all(t is not None and t > 0 for t in rec["times_s"])
    assert all(b <= tune.SMEM_BUDGET_BYTES for b in rec["smem_bytes"])
    assert torch.cuda.get_device_name(cuda) in rec["key"]
    counts = (conv.p2m_conv_fused.launches,
              conv.p2m_conv_fused.launches_pipelined)
    assert tune.get_conv_blocks(*args, device=cuda) == first  # a hit
    assert len(tune.decision_records()) == 1
    assert (conv.p2m_conv_fused.launches,
            conv.p2m_conv_fused.launches_pipelined) == counts
    tune.cache_clear()


# ------------------------------------------------------ P²M product (B6)

MATMUL_CASES = [  # (M, K, N, dw, dx)
    (100, 75, 8, 3, 3), (1, 75, 8, 3, 3), (130, 33, 5, 3, 3),
    (1024, 75, 8, 2, 1), (4096, 147, 32, 3, 3), (300, 300, 40, 4, 4),
    (8, 1, 1, 3, 2), (100_352, 75, 8, 3, 3),
]


def _matmul_case(m, k, n, dw, dx, device, seed=0):
    rng = np.random.default_rng(seed)
    coeffs = tuple(tuple(float(v) for v in rng.uniform(-1, 1, dx))
                   for _ in range(dw))
    x = torch.from_numpy(rng.random((m, k), np.float32)).to(device)
    w = torch.from_numpy((rng.uniform(-1, 1, (k, n)) * (3.0 / k) ** 0.5)
                         .astype(np.float32)).to(device)
    s = torch.from_numpy(rng.uniform(-0.2, 0.2, n).astype(np.float32))
    return x, w, s.to(device), coeffs


@pytest.mark.parametrize("m,k,n,dw,dx", MATMUL_CASES)
@pytest.mark.parametrize("mode", ["raw", "relu", "quant"])
def test_matmul_kernel_matches_plain(cuda, m, k, n, dw, dx, mode):
    x, w, s, coeffs = _matmul_case(m, k, n, dw, dx, cuda)
    before = kernel.p2m_matmul_fused.launches
    out, raw = kernel.p2m_matmul_fused(x, w, s, coeffs=coeffs, mode=mode,
                                       want_raw=True)
    torch.cuda.synchronize()
    assert kernel.p2m_matmul_fused.launches == before + 1
    ref_raw = kernel.p2m_matmul_raw_plain(x, w, coeffs)
    ref_out = conv._epilogue_values(ref_raw, s, mode=mode, v_lsb=V_LSB,
                                    max_count=255)
    torch.testing.assert_close(raw, ref_raw, rtol=RTOL, atol=1e-5)
    if mode == "quant":
        _assert_quant_close(out, ref_out, ref_raw)
    else:
        torch.testing.assert_close(out, ref_out, rtol=RTOL, atol=1e-5)
    for blocks in ((64, 8, 32), (256, 32, 128), (1, 16, 7)):
        again = kernel.p2m_matmul_fused(
            x, w, s, coeffs=coeffs, mode="raw", block_m=blocks[0],
            block_n=blocks[1], block_k=blocks[2])
        torch.testing.assert_close(again, ref_raw + s, rtol=RTOL, atol=1e-5)


def test_matmul_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, w, s, coeffs = _matmul_case(64, 75, 8, 3, 3, cuda)
    kw = dict(coeffs=coeffs)
    with pytest.raises(TypeError):
        kernel.p2m_matmul_fused(x.double(), w, s, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.p2m_matmul_fused(x, w.t().contiguous().t(), s, **kw)
    with pytest.raises(ValueError, match="is on"):
        kernel.p2m_matmul_fused(x, w.cpu(), s, **kw)
    with pytest.raises(ValueError, match="expected"):
        kernel.p2m_matmul_fused(x, w[:5], s, **kw)
    with pytest.raises(ValueError, match="dx=5"):
        kernel.p2m_matmul_fused(x, w, s, coeffs=((0.1,) * 5,) * 3)
    with pytest.raises(ValueError, match="block_m"):
        kernel.p2m_matmul_fused(x, w, s, block_m=512, **kw)


@pytest.mark.parametrize("mode", ["raw", "relu", "quant"])
def test_matmul_gradients_match_plain_autograd(cuda, mode):
    model = default_pixel_model()
    x, w, s, _ = _matmul_case(2000, 75, 8, 3, 3, cuda, seed=2)
    ct = torch.randn((2000, 8), generator=torch.Generator().manual_seed(0))
    ins = [t.clone().requires_grad_(True) for t in (x, w, s)]
    counts = (kernel.p2m_matmul_fused.launches, backward.p2m_bwd_dx.launches,
              backward.p2m_bwd_dw.launches)
    out = ops.p2m_matmul(*ins, model, mode=mode)
    got = torch.autograd.grad((out * ct.to(cuda)).sum(), ins)
    assert (kernel.p2m_matmul_fused.launches, backward.p2m_bwd_dx.launches,
            backward.p2m_bwd_dw.launches) == tuple(c + 1 for c in counts)
    ref_ins = [t.double().requires_grad_(True) for t in (x, w, s)]
    ref_mode = "relu" if mode == "quant" else mode  # the STE gradient
    ref = ops.p2m_matmul_plain(*ref_ins, model, mode=ref_mode)
    want = torch.autograd.grad((ref * ct.to(cuda).double()).sum(), ref_ins)
    for a, r in zip(got, want):
        _assert_bwd_close(a, r)


# ------------------------------------------------------ C2: no silent cut


def test_wrappers_refuse_inputs_that_require_grad(cuda):
    x, wrows, shift = _data(2, 20, 20, 3, 5, 8, cuda)
    xg = x.clone().requires_grad_(True)
    cached = torch.zeros((2, 4, 4, 8), device=cuda)
    rerun = torch.ones(2, dtype=torch.bool, device=cuda)
    mx, mw, ms, coeffs = _matmul_case(64, 75, 8, 3, 3, cuda)
    bg, bw, bx, bcoeffs = _bwd_case(64, 75, 8, 3, 3, cuda)
    r, k, v, lw, u, s0 = _wkv_case(1, 16, 2, 16, cuda)
    calls = {
        "p2m_conv_fused": lambda: conv.p2m_conv_fused(
            xg, wrows, shift, kernel=5, stride=5),
        "p2m_conv_fused B2": lambda: conv.p2m_conv_fused(
            xg, wrows, shift, kernel=5, stride=5, pipeline_depth=2),
        "p2m_conv_fused_gated": lambda: gated.p2m_conv_fused_gated(
            xg, wrows, shift, cached, rerun, kernel=5, stride=5),
        "p2m_matmul_fused": lambda: kernel.p2m_matmul_fused(
            mx, mw.clone().requires_grad_(True), ms, coeffs=coeffs),
        "p2m_bwd_dx": lambda: backward.p2m_bwd_dx(
            bg.clone().requires_grad_(True), bw, bx, bcoeffs),
        "p2m_bwd_dw": lambda: backward.p2m_bwd_dw(
            bg.clone().requires_grad_(True), bw, bx, bcoeffs),
        "wkv_fused": lambda: wkv_kernel.wkv_fused(
            r, k.clone().requires_grad_(True), v, lw, u, s0),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="requires grad"):
            call()
        with torch.no_grad():
            call()  # the same call launches with grad mode off
    torch.cuda.synchronize()


# ------------------------------------------------------ C1: bad prompt token


def test_bad_prompt_token_fails_alone_on_the_card(cuda):
    cfg = get_smoke_config("rwkv6-3b").replace(dtype=torch.float32)
    params, _ = get_family(cfg).init(torch.Generator().manual_seed(0), cfg)
    good = [5, 17, 300, 2]
    for engine_type, make in (
            (ServeEngine, lambda uid, p: Request(uid=uid, prompt=p,
                                                 max_new_tokens=4)),
            (SessionEngine, lambda uid, p: SessionRequest(
                uid=uid, turns=[good, p], max_new_tokens=4))):
        eng = engine_type(params, cfg, max_batch=2, max_len=64,
                          prefill_chunk=4, device=cuda)
        bad = make(1, [3, cfg.padded_vocab, 4])
        assert eng.submit(make(0, good)) == "admitted"
        assert eng.submit(bad) == FAILED_TOKEN
        done = eng.run(on_undrained="raise")
        assert eng.failed == [bad] and bad.failure == "token"
        assert [r.uid for r in done] == [0]
        done = eng.run([make(2, good)], on_undrained="raise")
        assert [r.uid for r in done] == [0, 2]  # the context is sound
