"""The port's CUDA kernel and its engine on a GPU: each test needs an
NVIDIA card and skips without one.  This file imports no JAX, so it runs
on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)  The kernel builds
at first use.  Tolerances as in `tests/test_torch_p2m_conv.py`: raw and
relu rtol 1e-5 / atol 1e-6; quant counts may differ by one in at most
1e-4 of the elements, only at half counts.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.p2m_vww import SMOKE
from repro_torch.core.p2m_conv import P2MConvConfig, apply_p2m_conv_deploy
from repro_torch.core.pixel_model import default_pixel_model
from repro_torch.data import SyntheticVWW
from repro_torch.kernels.p2m_conv import conv
from repro_torch.kernels.p2m_conv.ops import _coeff_tuple
from repro_torch.models.mobilenetv2 import init_mnv2
from repro_torch.serving import VisionEngine, VisionRequest

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
