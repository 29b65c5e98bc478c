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
The gated stem (B5), on either body, equals B1 followed by
``torch.where`` bit for bit, and its plain twin to B1's tolerances; a
skipped slot keeps its cache's bits, NaN payloads included.  The pipelined conv (B2) equals B1
bit for bit, raw included, whatever its blocks and depth, and so do the
gradients through it.  The P²M product (B6) is held to its plain twin at
B1's tolerances, and its gradients (B3, B4 through `ops.p2m_matmul`) to
autograd of the plain twin in float64 within 1e-4 of the largest value.  The chunked WKV (B7) is held to
its plain twin within 1e-4 of the largest |plain| (fp32 sums over up to
64 terms and exps in another order, as the reference holds its own
kernel), and keeps a masked row's state bit for bit; two launches, and
inputs at an unaligned offset, give the same bits.  Under autograd
(`ops.wkv`: B7 forward, the closed-form backward) its outputs and six
gradients are held to autograd of the plain twin in float64 within 1e-4
of the largest value; an LM train step launches B7 twice a layer with
remat, once without, and its loss is within 1e-5 of the plain WKV's.
The MoE layer (`models/moe.py::apply_moe`) and the RG-LRU SMOKE decode
run no kernel of the port: on the card they equal the CPU within 1e-5
of the largest value, a router tie included (the stable sort orders
equal probabilities on both devices as `jax.lax.top_k` does).  The P²M
frontend's deploy form launches B1 or B2 once and is held to its plain
stem by the count rule; the SMOKE VLM and Whisper decode on the card
equals their forward at the reference's tolerances and launches no
kernel of the port.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.p2m_vww import SMOKE
from repro_torch.core.p2m_conv import P2MConvConfig, apply_p2m_conv_deploy
from repro_torch.core.pixel_model import default_pixel_model
from repro_torch.data import SyntheticLMDataset, SyntheticVWW
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
from repro_torch.models import moe
from repro_torch.models.families import get_family
from repro_torch.models.init_utils import KeyGen, split_tree
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
    (300, 75, 40, 4, 4),   # B4's n-tiles over five blocks along y
    (70_001, 75, 8, 3, 3),  # many B4 blocks, M not a multiple of a tile
    (20, 75, 8, 3, 3),     # M below one 64-row tile
    # M not a multiple of a block's range: 261 blocks of 384 rows, 163 in
    # the last
    (100_003, 75, 8, 3, 3),
    (2049, 75, 8, 2, 4),
    (5000, 100, 3, 3, 3),  # 7 e-tiles: two e-groups along y
    (3000, 147, 32, 3, 3),  # 32-row tiles; 2 e-groups x 4 n-tiles
    (700, 675, 8, 1, 2),   # 8-row tiles (k = 15, C = 3)
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
    # views 4 bytes off 16-byte alignment take B4's 4-byte copies: the
    # same bits as the aligned inputs'
    x_off = torch.empty(m * k + 1, device=cuda)[1:].view(m, k)
    g_off = torch.empty(m * n + 1, device=cuda)[1:].view(m, n)
    x_off.copy_(x)
    g_off.copy_(g)
    assert x_off.data_ptr() % 16 and g_off.data_ptr() % 16
    assert torch.equal(gw, backward.p2m_bwd_dw(g_off, w, x_off, coeffs))


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
@pytest.mark.parametrize("depth", [0, 2, 3])
def test_gated_kernel_is_b1_then_where_bit_for_bit(cuda, b, h, w, c, k, s,
                                                   n, mode, depth):
    """Both gated bodies (depth 0: B1's; 2, 3: the ring) at block_h None,
    1, 2 and 3 (clamped to a divisor of Ho): B1 + where and the dense
    kernel at the same blocks + where, bit for bit, in every mask."""
    x, wrows, shift = _data(b, h, w, c, k, n, cuda)
    ho, wo = (h - k) // s + 1, (w - k) // s + 1
    cached = torch.rand((b, ho, wo, n), generator=torch.Generator()
                        .manual_seed(1)).to(cuda)
    kw = dict(kernel=k, stride=s, mode=mode)
    b1 = conv.p2m_conv_fused(x, wrows, shift, **kw)
    counter = "launches_pipelined" if depth else "launches"
    for block_h in (None, 1, 2, 3):
        aligned = gated.aligned_block_h(
            ho, block_h or conv.default_block_h(b * ho, wo))
        dense = conv.p2m_conv_fused(x, wrows, shift, block_h=aligned,
                                    pipeline_depth=depth, **kw)
        for name, mask in GATED_MASKS.items():
            rerun = torch.tensor(mask[:b], dtype=torch.bool, device=cuda)
            before = getattr(gated.p2m_conv_fused_gated, counter)
            got = gated.p2m_conv_fused_gated(x, wrows, shift, cached, rerun,
                                             block_h=block_h,
                                             pipeline_depth=depth, **kw)
            torch.cuda.synchronize()
            assert getattr(gated.p2m_conv_fused_gated, counter) == before + 1
            select = rerun[:, None, None, None]
            case = (block_h, name)
            assert torch.equal(got, torch.where(select, b1, cached)), case
            assert torch.equal(got, torch.where(select, dense, cached)), case
            plain = gated.p2m_conv_gated_plain(x, wrows, shift, cached,
                                               rerun, **kw)
            if mode == "quant":
                _, raw = conv.p2m_conv_premixed_plain(
                    x, wrows, torch.zeros_like(shift), mode="raw",
                    want_raw=True, kernel=k, stride=s)
                _assert_quant_close(got, plain, raw)
            else:
                torch.testing.assert_close(got, plain, rtol=RTOL, atol=ATOL)


#: float32 bit patterns a copy must keep: quiet and signalling NaNs of
#: either sign with payloads, +inf, -inf, -0.0 and the smallest subnormal.
SPECIAL_BITS = np.array([0x7FC00001, 0xFFC12345, 0x7F800001, 0xFFBFFFFF,
                         0x7F800000, 0xFF800000, 0x80000000, 0x00000001],
                        dtype=np.uint32).view(np.int32)


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("offset", [0, 1])
def test_gated_skips_copy_the_cache_bit_for_bit(cuda, depth, offset):
    """A skipped slot's output is its cache's bits, NaN payloads and
    infinities included, from a 16-byte-aligned cache (16-byte copies)
    and from one a float past such an address (4-byte copies)."""
    b, h, w, c, k, s, n = GATED_GEOMETRIES[0]
    x, wrows, shift = _data(b, h, w, c, k, n, cuda)
    ho, wo = (h - k) // s + 1, (w - k) // s + 1
    bits = np.random.default_rng(2).integers(
        -2**31, 2**31, size=(b, ho * wo * n), dtype=np.int64).astype(np.int32)
    bits[:, :len(SPECIAL_BITS)] = SPECIAL_BITS
    bits[:, -len(SPECIAL_BITS):] = SPECIAL_BITS
    buf = torch.empty(bits.size + offset, dtype=torch.int32, device=cuda)
    buf[offset:].copy_(torch.from_numpy(bits.reshape(-1)))
    cached = buf[offset:].view(torch.float32).view(b, ho, wo, n)
    assert (cached.data_ptr() % 16 != 0) == bool(offset)
    want = cached.view(torch.int32)
    for name in ("all skip", "mixed", "one slot"):
        rerun = torch.tensor(GATED_MASKS[name][:b], dtype=torch.bool,
                             device=cuda)
        got = gated.p2m_conv_fused_gated(x, wrows, shift, cached, rerun,
                                         kernel=k, stride=s, mode="quant",
                                         pipeline_depth=depth)
        torch.cuda.synchronize()
        skipped = ~rerun
        assert torch.equal(got.view(torch.int32)[skipped], want[skipped]), \
            name


def test_gated_launch_spills_nothing(cuda):
    """The ring body's gated instantiation at the stream signature (4 x
    560², N = 8, dx = 3): the dense B2's launch at the same blocks, no
    local memory; block_h 3 does not divide Ho = 112 and clamps to 2."""
    shape = (4, 560, 560, 3)
    for depth in (2, 3):
        for bh in (1, 2, 4):
            kw = dict(kernel=5, stride=5, block_h=bh, pipeline_depth=depth)
            geo = gated.gated_launch(shape, 8, 3, **kw)
            dense = conv.pipelined_launch(shape, 8, 3, **kw)
            for key in ("block_h", "blocks_x", "blocks_y", "threads",
                        "smem_bytes", "pixels_per_thread"):
                assert geo[key] == dense[key], (key, bh, depth)
            assert geo["local_bytes"] == 0 and geo["blocks_per_sm"] >= 1
    assert gated.gated_launch(shape, 8, 3, kernel=5, stride=5, block_h=3,
                              pipeline_depth=2)["block_h"] == 2


@pytest.mark.parametrize("b,h,w,c,k,s,n,offset", [
    (2, 10, 2605, 3, 5, 5, 8, 0),  # Wo = 521: 4 tiles a row, the last partial
    (4, 2700, 60, 3, 5, 5, 8, 0),  # more tiles than one wave's blocks
    (4, 60, 60, 3, 5, 5, 8, 1),  # images one float past 16 bytes
    (4, 40, 40, 3, 5, 5, 32, 0),  # N = 32, and 4 N tiles of 8
])
@pytest.mark.parametrize("mode", ["raw", "quant"])
def test_gated_b1_body_on_b1_tiles_is_b1_then_where(cuda, b, h, w, c, k, s,
                                                     n, offset, mode):
    """B1's gated body (depth 0) on B1's tiles: its partial tiles, a
    grid of uneven runs, unaligned images and N tiles give B1 + where bit
    for bit in every mask; the ring takes none of the first two."""
    x, wrows, shift = _data(b, h, w, c, k, n, cuda)
    if offset:
        buf = torch.empty(x.numel() + offset, device=cuda)
        buf[offset:].copy_(x.reshape(-1))
        x = buf[offset:].view(x.shape)
    ho, wo = (h - k) // s + 1, (w - k) // s + 1
    cached = torch.rand((b, ho, wo, n), generator=torch.Generator()
                        .manual_seed(1)).to(cuda)
    kw = dict(kernel=k, stride=s, mode=mode)
    b1 = conv.p2m_conv_fused(x, wrows, shift, **kw)
    for block_n in ((None, 8) if n > 8 else (None,)):
        for name, mask in GATED_MASKS.items():
            rerun = torch.tensor((mask * b)[:b], dtype=torch.bool,
                                 device=cuda)
            got = gated.p2m_conv_fused_gated(x, wrows, shift, cached, rerun,
                                             block_n=block_n, **kw)
            torch.cuda.synchronize()
            want = torch.where(rerun[:, None, None, None], b1, cached)
            assert torch.equal(got, want), (block_n, name)


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
    for bad in (1, -2):
        with pytest.raises(ValueError, match="pipeline_depth"):
            gated.p2m_conv_fused_gated(x, wrows, shift, cached, rerun,
                                       pipeline_depth=bad, **kw)
    xw = _data(1, 60, 600, 3, 5, 8, cuda)[0]  # Ho = 12, Wo = 120
    with pytest.raises(ValueError, match="threads"):  # 12 x 120 pixels
        gated.p2m_conv_fused_gated(
            xw, wrows, shift, torch.zeros((1, 12, 120, 8), device=cuda),
            rerun[:1], pipeline_depth=2, block_h=12, **kw)


def _gated_launches():
    """B5's launches by body: (B1's gated body, the ring)."""
    return (gated.p2m_conv_fused_gated.launches,
            gated.p2m_conv_fused_gated.launches_pipelined)


def test_gated_stream_on_the_card(cuda):
    """A short stream through the engine on the card: the gated path by
    default, one B5 launch a tick on the body of the tuner's depth (the
    ring, at a ring winner set in the tuner's cache) and no B1 or B2; the
    same boxes and scores as the where path, bit for bit; half the hold-2
    frames skipped."""
    torch.backends.cudnn.deterministic = True
    tune.cache_clear()
    try:
        params, bn = init_mnv2(torch.Generator().manual_seed(0), SMOKE,
                               device=cuda)
        det = init_detect_head(torch.Generator().manual_seed(1),
                               head_out_channels(SMOKE), DetectConfig(),
                               device=cuda)
        frames = [SyntheticVideo(image_size=SMOKE.image_size, n_frames=n,
                                 hold=2, seed=i).frames()
                  for i, n in enumerate([6, 4, 6])]
        p2m = SMOKE.p2m
        tune.get_conv_blocks(2, SMOKE.image_size, SMOKE.image_size, 3,
                             p2m.out_channels, p2m.kernel, p2m.stride,
                             COEFFS, "quant", device=cuda)
        (key,) = tune.cache_info()
        tune.set_winner(key, (1, 8, 2))
        runs = {}
        for path in ("auto", "where"):
            eng = StreamEngine(params, bn, SMOKE, det, max_streams=2,
                               stem_path=path)
            counts = (_gated_launches(), _stem_launches())
            done = eng.run([StreamRequest(uid=i, frames=f)
                            for i, f in enumerate(frames)],
                           on_undrained="raise")
            runs[eng.stem_path] = (eng, done, (
                tuple(a - b for a, b in zip(_gated_launches(), counts[0])),
                _stem_launches() - counts[1]))
        eng, done, (n_b5, n_b1) = runs["gated"]
        assert eng.device.type == "cuda"
        assert (n_b5, n_b1) == ((0, eng.stats["launches"]), 0)
        assert eng.stream_summary()["stem_flops_skipped_ratio"] == 0.5
        w_eng, w_done, (w_b5, w_b1) = runs["where"]
        assert (w_b5, w_b1) == ((0, 0), w_eng.stats["launches"])
        for a, b in zip(done, w_done):
            assert a.uid == b.uid and a.skip_count == b.skip_count
            for (ba, sa), (bb, sb) in zip(a.frame_outputs, b.frame_outputs):
                np.testing.assert_array_equal(ba, bb)
                np.testing.assert_array_equal(sa, sb)
    finally:
        torch.backends.cudnn.deterministic = False
        tune.cache_clear()


# ------------------------------------------------------------------ WKV (B7)

WKV_TOL = 1e-4
WKV_SHAPES = [  # (B, S, H, D)
    (8, 64, 40, 64),  # the serving tick's shape
    (2, 1, 3, 64), (2, 15, 3, 16), (2, 17, 3, 64), (1, 100, 2, 16),
    (3, 45, 2, 32), (2, 16, 1, 7), (1, 0, 2, 16),
]
# D across the kernel's 16-column warp slices, S across chunk edges.
WKV_SHAPES += [(2, s, 3, d) for d in (1, 16, 33, 64)
               for s in (0, 1, 15, 16, 17, 64, 100)
               if (2, s, 3, d) not in WKV_SHAPES]
# B*H from 1 to the serving tick's 320, and the edges of each warp slice.
WKV_SHAPES += [(1, 40, 1, 64), (5, 64, 64, 64), (4, 33, 80, 17)]
WKV_SHAPES += [(2, 23, 2, d) for d in (15, 17, 31, 32, 47, 48, 49, 63)]


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


@pytest.mark.parametrize("b,s,h,d", [
    (4, 37, 3, 64), (2, 64, 2, 16), (8, 64, 40, 64), (2, 100, 3, 33),
    (2, 17, 1, 1), (3, 64, 2, 48), (2, 1, 2, 16)])
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


def test_wkv_kernel_keeps_a_masked_rows_subnormal_state(cuda):
    """The masked row's state is fmaf(1, S, 0) outside the tensor cores,
    so subnormal entries come back too."""
    r, k, v, lw, u, s0 = _wkv_case(2, 40, 3, 64, cuda, seed=2)
    lw[1], k[1] = 0.0, 0.0
    s0[1] *= 1e-39
    assert bool((s0[1] != 0).any()) and float(s0[1].abs().max()) < 1.2e-38
    _, sf = wkv_kernel.wkv_fused(r, k, v, lw, u, s0)
    torch.cuda.synchronize()
    assert torch.equal(sf[1], s0[1])


@pytest.mark.parametrize("b,s,h,d", [(8, 64, 40, 64), (2, 100, 3, 33)])
def test_wkv_kernel_two_launches_agree_bit_for_bit(cuda, b, s, h, d):
    ins = _wkv_case(b, s, h, d, cuda, seed=3)
    y1, s1 = wkv_kernel.wkv_fused(*ins)
    y2, s2 = wkv_kernel.wkv_fused(*ins)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


def _unaligned(t):
    """A contiguous copy of ``t`` at a storage offset of one float."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


@pytest.mark.parametrize("b,s,h,d", [(8, 64, 40, 64), (2, 37, 3, 64),
                                     (2, 20, 2, 16), (1, 17, 2, 33)])
def test_wkv_kernel_unaligned_views_give_the_aligned_bits(cuda, b, s, h, d):
    """Views at a storage offset that is not 16-byte aligned take the
    kernel's 4-byte copies; the arithmetic, and so every bit, is that of
    the aligned inputs."""
    ins = _wkv_case(b, s, h, d, cuda, seed=4)
    y, sf = wkv_kernel.wkv_fused(*ins)
    for which in (range(6), [0], [3]):  # all inputs, r alone, lw alone
        moved = [_unaligned(a) if i in which else a
                 for i, a in enumerate(ins)]
        y_u, s_u = wkv_kernel.wkv_fused(*moved)
        torch.cuda.synchronize()
        assert torch.equal(y_u, y) and torch.equal(s_u, sf), which


def test_wkv_launch_geometry_follows_one_rule(cuda):
    """One block a (b, h), one warp a 16 value columns, a fixed ring."""
    serve = wkv_kernel.launch_geometry(8, 40, 64)
    assert (serve["blocks"], serve["threads"]) == (320, 128)
    for b, h, d in ((1, 1, 1), (2, 3, 16), (2, 3, 17), (4, 80, 33),
                    (1, 2, 48), (1, 2, 49)):
        geo = wkv_kernel.launch_geometry(b, h, d)
        assert geo["blocks"] == b * h
        assert geo["threads"] == 32 * -(-d // 16)
        assert (geo["stages"], geo["smem_bytes"]) == (
            serve["stages"], serve["smem_bytes"])


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

PIPE_GEOMETRIES = [  # (B, H, W, C, k, s, N, dw, dx, images' offset)
    (8, 60, 60, 3, 5, 5, 8, 3, 3, 0),  # s = k, 16-byte copies
    (2, 14, 11, 2, 3, 2, 8, 3, 1, 0),  # s < k, 4-byte copies
    (2, 13, 13, 3, 5, 3, 5, 2, 2, 0),
    (3, 17, 12, 3, 4, 3, 24, 3, 3, 0),  # three register chunks a thread
    (2, 40, 40, 3, 5, 5, 40, 4, 4, 0),  # two N tiles, the last one ragged
    (1, 23, 19, 3, 5, 5, 11, 3, 4, 0),
    (3, 9, 9, 1, 4, 4, 16, 2, 3, 0),  # Ho = Wo = 2
    # At an N tile of 8 a thread computes 2 of its block's pixels (csrc
    # kPipePixels): Wo = 1; Wo one below and one above a multiple of 2
    # (the last thread of an odd block has one pixel); the serving width;
    # and a last block shorter than block_h.
    (3, 12, 5, 3, 5, 5, 8, 3, 3, 0),  # Wo = 1
    (2, 20, 35, 3, 5, 5, 8, 3, 3, 0),  # Wo = 7
    (2, 20, 45, 3, 5, 5, 8, 3, 3, 0),  # Wo = 9
    (1, 40, 560, 3, 5, 5, 8, 3, 3, 0),  # Wo = 112 at B = 1
    (3, 45, 50, 3, 5, 5, 8, 3, 3, 0),  # B·Ho = 27 at block_h 2 and 25
    # images one float past a 16-byte address: 4-byte copies of the bands
    (2, 60, 60, 3, 5, 5, 8, 3, 3, 1),
    # B1's tiling: the serving shape (896 whole-row tiles, one bulk copy
    # each, over 264 blocks: uneven) and unaligned; more tiles than one
    # wave's blocks (2,160 rows of Wo = 12); k = 15 (tiles of 14 pixels,
    # the last of the row partial); s < k and s = k with W > (Wo-1)·s + k
    # (16-byte cp.async, not one span); N = 32 (and 4 N tiles of 8)
    (8, 560, 560, 3, 5, 5, 8, 3, 3, 0),
    (8, 560, 560, 3, 5, 5, 8, 3, 3, 1),
    (4, 2700, 60, 3, 5, 5, 8, 3, 3, 0),
    (1, 15, 600, 3, 15, 15, 8, 3, 1, 0),
    (2, 20, 22, 4, 3, 2, 8, 3, 3, 0),
    (1, 40, 564, 3, 5, 5, 8, 3, 3, 0),
    (2, 40, 40, 3, 5, 5, 32, 3, 3, 0),
]


def _pipe_id(geometry):
    """A case's id: its numbers as pytest writes them, and "unaligned"
    for images off a 16-byte address."""
    return ("-".join(map(str, geometry[:9]))
            + ("-unaligned" if geometry[9] else ""))


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


@pytest.mark.parametrize("b,h,w,c,k,s,n,dw,dx,offset", PIPE_GEOMETRIES,
                         ids=[_pipe_id(g) for g in PIPE_GEOMETRIES])
@pytest.mark.parametrize("mode", ["raw", "relu", "quant"])
def test_pipelined_kernel_is_b1_bit_for_bit(cuda, b, h, w, c, k, s, n, dw,
                                            dx, offset, mode):
    x, wrows, shift = _pipe_case(b, h, w, c, k, n, dw, dx, cuda)
    kw = dict(kernel=k, stride=s, mode=mode, want_raw=True)
    if offset:  # the same images at a 4-byte, not 16-byte, address
        aligned = conv.p2m_conv_fused(x, wrows, shift, **kw)
        buf = torch.empty(x.numel() + offset, device=cuda)
        buf[offset:].copy_(x.reshape(-1))
        x = buf[offset:].view(x.shape)
        assert x.data_ptr() % 16
    out1, raw1 = conv.p2m_conv_fused(x, wrows, shift, **kw)
    if offset:  # B1's 4-byte copies give its bulk or 16-byte copies' bits
        assert torch.equal(out1, aligned[0]) and torch.equal(raw1, aligned[1])
    if n > 8:  # B1 over N tiles of 8
        out8, raw8 = conv.p2m_conv_fused(x, wrows, shift, block_n=8, **kw)
        assert torch.equal(out8, out1) and torch.equal(raw8, raw1)
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


def test_pipelined_launch_follows_one_rule(cuda):
    # The serving shape: 8 x 560², N = 8, dx = 3, Wo = 112.  A thread
    # computes 2 pixels, so a block of block_h rows takes 56 threads a
    # row, in whole warps; the kernel spills nothing.
    for bh, threads in ((1, 64), (2, 128), (4, 224)):
        geo = conv.pipelined_launch((8, 560, 560, 3), 8, 3, kernel=5,
                                    stride=5, block_h=bh, pipeline_depth=3)
        assert geo["pixels_per_thread"] == 2 and geo["threads"] == threads
        assert (geo["blocks_x"], geo["blocks_y"]) == (896 // bh, 1)
        assert geo["smem_bytes"] == conv.pipelined_smem_bytes(
            112, 3, 5, 5, 3, bh, 8, 3)
        assert geo["local_bytes"] == 0 and geo["blocks_per_sm"] >= 1
    # an N tile of 32 outputs: one pixel a thread, two tiles for N = 40
    wide = conv.pipelined_launch((2, 40, 40, 3), 40, 4, kernel=5, stride=5,
                                 block_n=32, pipeline_depth=2)
    assert wide["pixels_per_thread"] == 1 and wide["blocks_y"] == 2
    assert wide["local_bytes"] == 0


@pytest.mark.parametrize("b", [8, 4, 32])
def test_b1_launch_follows_its_tiling_and_spills_nothing(cuda, b):
    """B1 (and B1's gated body) at the serving, stream and training
    stems: the launch `conv.b1_tiling` gives (whole 112-pixel rows, 5
    row groups of 64 threads, 74,400 bytes), one wave on the card (the
    occupancy the rule counts on holds), no local memory."""
    shape = (b, 560, 560, 3)
    tiling = conv.b1_tiling(shape, 8, 3, kernel=5, stride=5)
    for gated_body in (False, True):
        geo = conv.b1_launch(shape, 8, 3, kernel=5, stride=5,
                             gated=gated_body)
        for key in ("blocks_x", "blocks_y", "threads", "smem_bytes",
                    "tile_px", "tiles"):
            assert geo[key] == tiling[key], (key, gated_body)
        assert geo["pixels_per_thread"] == conv.B1_PIXELS
        assert geo["local_bytes"] == 0
        assert geo["blocks_per_sm"] >= tiling["blocks_per_sm"]
        assert geo["blocks_x"] * geo["blocks_y"] <= (
            torch.cuda.get_device_properties(cuda).multi_processor_count
            * geo["blocks_per_sm"])


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
    # B6's tiling: a partial last tile (bulk copies), M·K not a multiple
    # of 4 (4-byte copies), 4 N tiles of 8 at block_n 8, more tiles than
    # one wave's blocks
    (100_000, 75, 8, 3, 3), (1001, 75, 8, 3, 3), (4096, 75, 32, 3, 3),
    (401_408, 75, 8, 3, 3),
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


@pytest.mark.parametrize("m,k,n", [(100_352, 75, 8), (4096, 147, 32),
                                   (100_000, 75, 8)])
def test_matmul_unaligned_x_gives_the_aligned_bits(cuda, m, k, n):
    """x one float past a 16-byte address (4-byte copies) gives the bits
    of the aligned x (bulk copies where the blocks take all of K)."""
    x, w, s, coeffs = _matmul_case(m, k, n, 3, 3, cuda, seed=3)
    buf = torch.empty(x.numel() + 1, device=cuda)
    buf[1:].copy_(x.reshape(-1))
    xu = buf[1:].view(x.shape)
    assert xu.data_ptr() % 16
    for blocks in (kernel.MATMUL_DEFAULT_BLOCKS, (112, 8, 128), (64, 8, 32)):
        kw = dict(coeffs=coeffs, mode="quant", want_raw=True,
                  block_m=blocks[0], block_n=blocks[1], block_k=blocks[2])
        out, raw = kernel.p2m_matmul_fused(x, w, s, **kw)
        out_u, raw_u = kernel.p2m_matmul_fused(xu, w, s, **kw)
        assert torch.equal(out_u, out) and torch.equal(raw_u, raw), blocks


@pytest.mark.parametrize("blocks", [None, (112, 8, 128), (64, 8, 32),
                                    (256, 32, 128)])
def test_matmul_launch_follows_its_tiling_and_spills_nothing(cuda, blocks):
    """B6 at (100,352, 75, 8) (and (300, 300, 40) at one slot): the
    launch `kernel.matmul_tiling` gives, one wave on the card, no local
    memory."""
    for m, k, n, dx in ((100_352, 75, 8, 3), (300, 300, 40, 4)):
        bm, bn, bk = blocks or kernel.MATMUL_DEFAULT_BLOCKS
        tiling = kernel.matmul_tiling(m, k, n, dx, block_m=bm, block_n=bn,
                                      block_k=bk)
        geo = kernel.matmul_launch(m, k, n, dx, block_m=bm, block_n=bn,
                                   block_k=bk)
        for key in ("blocks_x", "blocks_y", "threads", "smem_bytes",
                    "slots", "tiles"):
            assert geo[key] == tiling[key], key
        assert geo["local_bytes"] == 0
        assert geo["blocks_per_sm"] >= tiling["blocks_per_sm"]


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


# ------------------------------------------------------ LM training (B7 under autograd)


@pytest.mark.parametrize("b,s,h,d", [(8, 64, 40, 64), (2, 37, 3, 64),
                                     (2, 20, 2, 16)])
def test_wkv_function_grads_match_plain_autograd_f64(cuda, b, s, h, d):
    """`ops.wkv(impl="cuda")` (B7 forward, the closed-form backward in
    float32) against autograd of the plain twin in float64, from a
    nonzero state with both cotangents: outputs and six gradients within
    1e-4 of the largest |float64 value|; B7 launches once."""
    from repro_torch.kernels.rwkv_wkv import ops as wkv_ops

    ins = _wkv_case(b, s, h, d, cuda, seed=5)
    gen = torch.Generator(cuda).manual_seed(6)
    dy = torch.randn((b, s, h, d), generator=gen, device=cuda)
    ds = torch.randn((b, h, d, d), generator=gen, device=cuda)
    live = [a.clone().requires_grad_() for a in ins]
    before = wkv_kernel.wkv_fused.launches
    y, sf = wkv_ops.wkv(*live)
    grads = torch.autograd.grad((y, sf), live, (dy, ds))
    assert wkv_kernel.wkv_fused.launches == before + 1
    live64 = [a.double().requires_grad_() for a in ins]
    y64, s64 = wkv_chunked_plain(*live64)
    want = torch.autograd.grad((y64, s64), live64, (dy.double(), ds.double()))
    for got, ref in zip((y, sf, *grads), (y64, s64, *want)):
        err = float((got.double() - ref).abs().max())
        assert err <= WKV_TOL * float(ref.abs().max()), (err, ref.shape)


def test_lm_train_step_on_the_card_launches_b7_per_layer(cuda):
    """One SMOKE AdamW step on the card: B7 runs twice a layer with remat
    (forward and recompute), once without; the loss is finite and within
    1e-5 of the step with the plain WKV; the state is written in place."""
    from repro_torch.optim import adamw, constant
    from repro_torch.train import TrainState, make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_smoke_config("rwkv6-3b").replace(dtype=torch.float32)
    params, _ = get_family(cfg).init(torch.Generator(cuda).manual_seed(0),
                                     cfg)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in SyntheticLMDataset(
        vocab=cfg.vocab, seq_len=40, batch=4).batch_at(0).items()}
    opt = adamw(constant(1e-3))
    losses = {}
    for remat, impl, want in ((True, "cuda", 2 * cfg.n_layers),
                              (False, "cuda", cfg.n_layers),
                              (True, "plain", 0)):
        p = tree_map(torch.clone, params)
        state = TrainState(p, opt.init(p))
        leaf = tree_leaves(p)[0]
        before = wkv_kernel.wkv_fused.launches
        state, m = make_train_step(cfg.replace(remat=remat, wkv_impl=impl),
                                   opt)(state, batch)
        torch.cuda.synchronize()
        assert wkv_kernel.wkv_fused.launches - before == want
        assert tree_leaves(state["params"])[0] is leaf
        assert state["step"] == 1 and np.isfinite(float(m["loss"]))
        losses[(remat, impl)] = float(m["loss"])
    assert losses[(True, "cuda")] == losses[(False, "cuda")]
    assert abs(losses[(True, "cuda")] - losses[(True, "plain")]) <= \
        1e-5 * abs(losses[(True, "plain")])


def test_lm_launcher_on_the_card(cuda):
    """`launch/train.py` with no ``--device`` trains on the card."""
    from repro_torch.launch import train as launch_train
    from repro_torch.tree import tree_leaves

    trainer = launch_train.main(["--arch", "rwkv6-3b", "--smoke", "--steps",
                                 "2", "--batch", "2", "--seq", "24"])
    assert trainer.state["step"] == 2
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    assert {t.device.type for t in tree_leaves(trainer.state["params"])} \
        == {"cuda"}


# ------------------------------------------------------------- front door


@pytest.mark.parametrize("chaos", [False, True], ids=["clean", "faults"])
def test_front_door_on_the_card_launches_what_its_engines_count(cuda, chaos):
    """A small door on the card (SMOKE LM, a pool of two 40² vision
    engines, a gated stream engine): no engine down; B1 + B2 launches =
    the replicas' launches, B5 = the stream engine's, B7 = 2 a prefill
    tick; with faults, every launch fault is an injected one."""
    import dataclasses

    from repro_torch.launch.serve import FrontDoor, _make_vision_engine
    from repro_torch.serving import SMOKE_PLAN, FaultInjector, ReplicaPool

    cfg = get_smoke_config("rwkv6-3b").replace(dtype=torch.float32)
    params, _ = get_family(cfg).init(torch.Generator().manual_seed(0), cfg)
    small, vcfg = _make_vision_engine(device=cuda)
    injectors = []

    def core(seed):
        if not chaos:
            return {}
        injectors.append(FaultInjector(dataclasses.replace(
            SMOKE_PLAN, seed=seed, launch_error_ticks=(2,), nan_ticks=(3,))))
        return {"faults": injectors[-1], "launch_retries": 1,
                "max_serve_ticks": 40}

    lm = ServeEngine(params, cfg, max_batch=4, max_len=128, prefill_chunk=16,
                     tick_cost=2, device=cuda, **core(1))
    prefill = []
    chunk_step = lm._chunk_step

    def counted_chunk(*a):
        prefill.append(1)
        return chunk_step(*a)

    lm._chunk_step = counted_chunk
    reps = [VisionEngine(small._params, small._bn, vcfg, max_batch=4,
                         device=cuda, **core(2 + k)) for k in range(2)]
    det = init_detect_head(torch.Generator().manual_seed(2),
                           head_out_channels(vcfg), DetectConfig(),
                           device=cuda)
    stream = StreamEngine(small._params, small._bn, vcfg, det, max_streams=2,
                          device=cuda, **core(4))
    assert stream.stem_path == "gated"
    door = FrontDoor(lm=lm, vision=ReplicaPool(*reps), stream=stream)
    rng = np.random.default_rng(0)
    imgs = SyntheticVWW(image_size=vcfg.image_size, batch=8).batch_at(0)[
        "images"]
    reqs = ([Request(uid=i, prompt=rng.integers(0, cfg.vocab,
                                                 int(n)).tolist(),
                     max_new_tokens=4, arrival_tick=i)
             for i, n in enumerate((5, 20, 40, 9))]
            + [VisionRequest(uid=100 + i, image=imgs[i], arrival_tick=i // 2)
               for i in range(8)]
            + [StreamRequest(uid=200 + i, frames=SyntheticVideo(
                image_size=vcfg.image_size, n_frames=5, seed=i).frames(),
                arrival_tick=i) for i in range(3)])
    before = (conv.p2m_conv_fused.launches
              + conv.p2m_conv_fused.launches_pipelined,
              gated.p2m_conv_fused_gated.launches
              + gated.p2m_conv_fused_gated.launches_pipelined,
              wkv_kernel.wkv_fused.launches)
    door.run(reqs, on_undrained="raise")
    torch.cuda.synchronize()
    after = (conv.p2m_conv_fused.launches
             + conv.p2m_conv_fused.launches_pipelined,
             gated.p2m_conv_fused_gated.launches
             + gated.p2m_conv_fused_gated.launches_pipelined,
             wkv_kernel.wkv_fused.launches)
    stem, b5, b7 = (a - b for a, b in zip(after, before))
    assert door.down == {}
    assert stem == sum(r.stats["launches"] for r in reps) > 0
    assert b5 == stream.stats["launches"] > 0
    assert b7 == cfg.n_layers * len(prefill) and prefill
    engines = [lm, *reps, stream]
    if chaos:
        assert [e.stats["launch_faults"] for e in engines] == \
            [i.counts["launch"] for i in injectors]
        assert sum(i.counts["launch"] for i in injectors) > 0
        assert any(e.failed for e in engines)
    else:
        assert len(door.completed) == len(reqs)
        assert all(not e.failed and not e.evicted and
                   e.stats["launch_faults"] == 0 for e in engines)


# ------------------------------------------------------ MoE and RG-LRU


def _max_rel(got, want):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("case", ["qwen3-moe-30b-a3b", "mixtral-8x22b",
                                  "drops", "tie"])
def test_moe_on_the_card_matches_the_cpu(cuda, case):
    """`apply_moe` at both SMOKE widths, with a capacity factor that drops
    tokens, and with a router whose top-2 the order at ties decides."""
    if case in ("drops", "tie"):
        cfg = get_smoke_config("qwen3-moe-30b-a3b").replace(
            capacity_factor=0.25 if case == "drops" else 0.5,
            **({"n_experts": 4} if case == "tie" else {}))
    else:
        cfg = get_smoke_config(case)
    cfg = cfg.replace(dtype=torch.float32)
    tree = moe.init_moe(KeyGen(torch.Generator().manual_seed(0)), cfg, (1,))
    p = {k: v[0] for k, v in split_tree(tree)[0].items()}
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (3, 40, cfg.d_model)).astype(np.float32)
    if case == "tie":  # experts 1.. share one integer column: exact ties
        x = np.round(x).astype(np.float32)
        col = rng.integers(-2, 3, cfg.d_model)
        p["router"] = torch.from_numpy(np.stack(
            [rng.integers(-2, 3, cfg.d_model)] + [col] * (cfg.n_experts - 1),
            axis=1).astype(np.float32))
    out = {}
    for device in ("cpu", "cuda"):
        with torch.no_grad():
            pd = {k: v.to(device) for k, v in p.items()}
            xd = torch.from_numpy(x).to(device)
            out[device] = (*moe.apply_moe(pd, xd, cfg),
                           moe.route(pd, xd, cfg)[2])
    assert torch.equal(out["cuda"][2].cpu(), out["cpu"][2])
    assert _max_rel(out["cuda"][0], out["cpu"][0]) <= 1e-5
    assert _max_rel(out["cuda"][1], out["cpu"][1]) <= 1e-5


def test_rglru_decode_on_the_card_matches_the_cpu(cuda):
    """RecurrentGemma SMOKE, 18 tokens token by token (the window is 8):
    every step's logits and the final state, leaf by leaf."""
    cfg = get_smoke_config("recurrentgemma-9b").replace(dtype=torch.float32)
    family = get_family(cfg)
    params, _ = family.init(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 18)))
    out = {}
    for device in ("cpu", "cuda"):
        pd = _to(params, device)
        state, _ = family.init_decode_state(cfg, 2, 64, device=device)
        logits = []
        with torch.no_grad():
            for t in range(toks.shape[1]):
                lg, state = family.decode(pd, state,
                                          toks[:, t:t + 1].to(device),
                                          torch.full((2,), t, device=device),
                                          cfg)
                logits.append(lg[:, 0])
        out[device] = (torch.stack(logits, 1), state)
    assert _max_rel(out["cuda"][0], out["cpu"][0]) <= 1e-5
    flat = lambda t: ([x for v in t.values() for x in flat(v)]  # noqa: E731
                      if isinstance(t, dict) else [t])
    for got, want in zip(flat(out["cuda"][1]), flat(out["cpu"][1])):
        assert got.shape == want.shape
        assert _max_rel(got, want) <= 1e-5


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_frontend_deploy_on_the_card_matches_plain(cuda):
    """The P²M frontend's deploy form on 8 frames of 80², pool 4, d_model
    64 (16,384 counts, so the count rule's 1e-4 admits one flip): one
    launch of B1 or B2 (as the tuner picks), the stem's counts against
    ``impl="plain"`` by the count rule, the embeddings within 1e-5 on
    every token whose counts all agree."""
    from repro_torch.core import bn_fold, frontend
    from repro_torch.core.p2m_conv import premix_deploy

    cfg = frontend.P2MFrontendConfig(image_size=80, d_model=64, pool=4)
    params = frontend.init_p2m_frontend(torch.Generator().manual_seed(0),
                                        cfg, device=cuda)
    state = frontend.init_p2m_frontend_state(cfg, device=cuda)
    deploy = premix_deploy(bn_fold.deploy_params(
        params["conv"], state["conv"], cfg.conv), cfg.conv)
    imgs = torch.from_numpy(SyntheticVWW(image_size=80, batch=8, seed=0)
                            .batch_at(0)["images"]).to(cuda)
    frontend.apply_p2m_frontend(params, state, imgs, cfg, deploy=deploy)
    before = (conv.p2m_conv_fused.launches
              + conv.p2m_conv_fused.launches_pipelined)
    with torch.no_grad():
        emb, _ = frontend.apply_p2m_frontend(params, state, imgs, cfg,
                                             deploy=deploy)
    assert (conv.p2m_conv_fused.launches
            + conv.p2m_conv_fused.launches_pipelined) == before + 1
    plain, _ = frontend.apply_p2m_frontend(params, state, imgs, cfg,
                                           deploy=deploy, impl="plain")
    fmap = apply_p2m_conv_deploy(deploy, imgs, cfg.conv)
    fmap_p = apply_p2m_conv_deploy(deploy, imgs, cfg.conv, impl="plain")
    raw = conv.p2m_conv_raw_plain(imgs, deploy["w"], kernel=5, stride=5,
                                  coeffs=COEFFS).reshape(fmap.shape)
    rep = conv.quant_disagreement(fmap, fmap_p, raw, V_LSB)
    assert rep["max_count_diff"] <= 1, rep
    assert rep["n_diff"] <= 1e-4 * fmap.numel(), rep
    assert rep["all_near_half"], rep
    agree = (torch.round(fmap / V_LSB) == torch.round(fmap_p / V_LSB))
    ok = frontend.pool_tokens(agree.float(), cfg.pool).min(-1).values.bool()
    assert emb.shape == (8, cfg.tokens, 64)
    assert float((emb - plain)[ok].abs().max()) <= \
        1e-5 * float(plain.abs().max())


@pytest.mark.parametrize("arch,s", [("llama-3.2-vision-11b", 12),
                                    ("whisper-tiny", 10)])
def test_multimodal_decode_on_the_card_matches_forward(cuda, arch, s):
    """SMOKE VLM (nonzero gates) and Whisper on the card:
    `prefill_cross_kv`, then token-by-token decode against the forward
    (the reference's rtol 2e-4, atol 5e-4), and the forward against the
    CPU's within 1e-5 of the largest value; no kernel of the port."""
    from repro_torch.models import vlm, whisper

    cfg = get_smoke_config(arch).replace(dtype=torch.float32)
    family = get_family(cfg)
    params, _ = family.init(torch.Generator().manual_seed(0), cfg)
    mod = vlm if cfg.family == "vlm" else whisper
    if mod is vlm:
        for gate in ("gate_attn", "gate_mlp"):
            params["cross"][gate] = torch.full_like(params["cross"][gate],
                                                    0.8)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, s)))
    n = cfg.n_image_tokens if mod is vlm else cfg.max_source_positions
    emb = torch.from_numpy(rng.normal(0, 1, (2, n, cfg.d_model)).astype(
        np.float32))

    def forward(p, t, e):
        with torch.no_grad():
            return (vlm.forward(p, t, e, cfg) if mod is vlm
                    else whisper.forward(p, e, t, cfg))[0]

    pd = _to(params, cuda)
    ref = forward(pd, toks.to(cuda), emb.to(cuda))
    assert _max_rel(ref, forward(params, toks, emb)) <= 1e-5
    state, _ = family.init_decode_state(cfg, 2, 32, device=cuda)
    state["cross"] = mod.prefill_cross_kv(pd, emb.to(cuda), cfg)
    wkv_before = wkv_kernel.wkv_fused.launches
    stem_before = conv.p2m_conv_fused.launches
    logits = []
    with torch.no_grad():
        for t in range(s):
            lg, state = family.decode(pd, state, toks[:, t:t + 1].to(cuda),
                                      torch.full((2,), t, device=cuda), cfg)
            logits.append(lg[:, 0])
    assert wkv_kernel.wkv_fused.launches == wkv_before
    assert conv.p2m_conv_fused.launches == stem_before
    np.testing.assert_allclose(torch.stack(logits, 1).cpu().numpy(),
                               ref.cpu().numpy(), rtol=2e-4, atol=5e-4)


def test_one_rank_nccl_dp_step_matches_the_single_process_step(cuda):
    """The data-parallel VWW step in a one-rank NCCL world (mesh (1, 1);
    the batch statistics, loss and gradient through the collectives) from
    the single-process step's state, at `configs/p2m_vww.py::CONFIG` (full
    width, batch 32): the loss within 1e-6, params and BN within 1e-3,
    the stem's kernels launched in the rank (B1 or B2, B3 and B4 once
    each).  At 40² the 1x1 tail's BN over 32 values turns the two sums'
    orders into 2.5e-5 of the loss on the card; at 560² its 7x7 tail
    keeps it at 6e-8."""
    import dataclasses

    import _scale_out_ranks as ranks
    from repro_torch.configs.p2m_vww import CONFIG, TRAIN_BATCH
    from repro_torch.launch.world import spawn_world
    from repro_torch.tree import tree_leaves

    cfg_kw = {f.name: getattr(CONFIG, f.name)
              for f in dataclasses.fields(CONFIG)}
    params, bn = init_mnv2(torch.Generator().manual_seed(0), CONFIG,
                           device="cpu")
    batch = SyntheticVWW(image_size=CONFIG.image_size, batch=TRAIN_BATCH,
                         seed=0).batch_at(0)
    (dp,) = spawn_world(ranks.dp_steps, 1, backend="nccl", cuda_index=0,
                        args=(cfg_kw, ranks.arrays(params), ranks.arrays(bn),
                              [batch], "cuda"), timeout=300)
    opt = ranks.dp_optimizer()
    p, b = ranks.tensors(ranks.arrays(params), cuda), ranks.tensors(
        ranks.arrays(bn), cuda)
    state = vww_train_state(p, b, opt.init(p), grad_compression="int8_ef")
    new, metrics = make_vww_train_step(CONFIG, opt,
                                       grad_compression="int8_ef")(state,
                                                                   batch)
    assert dp["first"]["local_batch"] == TRAIN_BATCH
    assert abs(dp["first"]["loss"] - float(metrics["loss"])) <= 1e-6
    for key in ("params", "bn"):
        for a, w in zip(tree_leaves(dp["first"][key]),
                        tree_leaves(ranks.arrays(new[key]))):
            assert np.abs(a - w).max() <= 1e-3
    assert dp["launches"] == {"forward": 1, "dx": 1, "dw": 1}


def test_one_rank_nccl_tp_step_matches_the_single_process_step(cuda):
    """The LM train step under ``plan_for`` in a one-rank NCCL world (mesh
    (1, 1): the tensor-parallel code, its *f*/*g*, the vocab-parallel
    loss and the gradient rule through NCCL collectives over one rank)
    on RWKV-6 SMOKE, TF32 off in the rank: loss within 1e-5 (relative)
    and params within 1e-5 of the single process's SGD step, B7 launched
    in the rank twice a layer (forward and remat recompute)."""
    import _lm_scale_out_ranks as ranks
    from repro_torch.launch.world import spawn_world
    from repro_torch.train import TrainState, make_train_step
    from repro_torch.tree import tree_leaves

    cfg = get_smoke_config("rwkv6-3b").replace(dtype=torch.float32)
    params, _ = get_family(cfg).init(torch.Generator().manual_seed(0), cfg)
    weights = ranks.arrays(params)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (4, 32)),
             "targets": rng.integers(0, cfg.vocab, (4, 32))}
    (tp,) = spawn_world(ranks.card_step, 1, backend="nccl", cuda_index=0,
                        args=(cfg, weights, [batch]), timeout=300)
    opt = ranks.optimizer()
    p = ranks.tensors(weights, cuda)
    state = TrainState(p, opt.init(p))
    new, metrics = make_train_step(cfg, opt)(
        state, {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()})
    want = float(metrics["loss"])
    assert abs(tp["losses"][0] - want) <= 1e-5 * abs(want)
    assert tp["shapes_agree"]
    got = ranks.arrays(new["params"])
    for a, w in zip(tree_leaves(tp["first"]), tree_leaves(got)):
        assert np.abs(a - w).max() <= 1e-5
    assert tp["b7"] == 2 * cfg.n_layers