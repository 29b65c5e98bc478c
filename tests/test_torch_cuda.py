"""The port's CUDA kernels, its engine and its train step on a GPU: each
test needs an NVIDIA card and skips without one.  This file imports no JAX, so it runs
on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)  The kernel builds
at first use.  Tolerances as in `tests/test_torch_p2m_conv.py`: raw and
relu rtol 1e-5 / atol 1e-6; quant counts may differ by one in at most
1e-4 of the elements, only at half counts.  The backward kernels (B3 dX,
B4 dW) are held to their plain twins computed in float64 within 1e-4 of
the largest |plain| (fp32 sums over up to 10^5 rows in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.p2m_vww import SMOKE
from repro_torch.core.p2m_conv import P2MConvConfig, apply_p2m_conv_deploy
from repro_torch.core.pixel_model import default_pixel_model
from repro_torch.data import SyntheticVWW
from repro_torch.kernels.p2m_conv import backward, conv, ops
from repro_torch.kernels.p2m_conv.ops import _coeff_tuple
from repro_torch.models.mobilenetv2 import MNV2Config, init_mnv2
from repro_torch.optim import sgd, step_decay
from repro_torch.serving import VisionEngine, VisionRequest
from repro_torch.train.vision import make_vww_train_step, vww_train_state

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
    before = conv.p2m_conv_fused.launches
    got = apply_p2m_conv_deploy(dep, x, cfg)
    assert conv.p2m_conv_fused.launches == before + 1
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
    before = conv.p2m_conv_fused.launches
    done = engine.run([VisionRequest(uid=i, image=imgs[i])
                       for i in range(6)], on_undrained="raise")
    assert [r.uid for r in done] == list(range(6))
    assert conv.p2m_conv_fused.launches - before == engine.stats["launches"]
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
    counts = (conv.p2m_conv_fused.launches, backward.p2m_bwd_dx.launches,
              backward.p2m_bwd_dw.launches)
    out = ops.p2m_conv(*ins, model, mode=mode, kernel=k, stride=s)
    got = torch.autograd.grad((out * ct.to(cuda)).sum(), ins)
    assert (conv.p2m_conv_fused.launches, backward.p2m_bwd_dx.launches,
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
        counts = (conv.p2m_conv_fused.launches,
                  backward.p2m_bwd_dx.launches, backward.p2m_bwd_dw.launches)
        state, m = step(state, data.batch_at(i))
        assert (conv.p2m_conv_fused.launches, backward.p2m_bwd_dx.launches,
                backward.p2m_bwd_dw.launches) == tuple(c + 1 for c in counts)
        assert np.isfinite(float(m["loss"]))
    assert state["step"] == 2
    assert state["params"]["stem"]["theta"].device.type == "cuda"
