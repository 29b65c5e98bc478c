"""The plain references agree with the port's plain twins on the CPU at
small sizes: the same weights and inputs give the same answers, to
float32 rounding."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import common, data, weights
from portbench.drivers import port
from portbench.reference import mnv2 as ref_mnv2
from portbench.reference import optim as ref_optim
from portbench.reference import p2m as ref_p2m
from portbench.reference import rwkv6 as ref_rwkv

SEED = 2**32 + 5
VWW = dict(common.config_file("p2m-vww"), image_size=80, width=0.25,
           head_channels=64)
RWKV = dict(common.config_file("rwkv6-3b"), n_layers=2, d_model=64, n_heads=4,
            head_dim=16, d_ff=128, vocab=512, lora_dim=8)


def _coeffs():
    return ref_p2m.pixel_coefficients(VWW["pixel_model"])


def test_pixel_fit_equals_the_programs():
    from repro_torch.core.pixel_model import default_pixel_model

    np.testing.assert_allclose(_coeffs(), default_pixel_model().coeffs,
                               rtol=1e-12, atol=1e-14)


def test_deploy_stem_counts_agree():
    from repro_torch.core.bn_fold import deploy_params
    from repro_torch.core.p2m_conv import apply_p2m_conv_deploy
    from repro_torch.core.quant import QuantSpec, quantize_deploy

    params, bn = weights.mnv2(SEED, VWW, "cpu")
    bn["stem"]["bn_mean"] += 0.01  # a BN fold with a shift to quantize
    images = torch.from_numpy(data.vww_images(SEED, 0, 4, 80, "cpu")[0])
    pcfg = port.mnv2_config(VWW).p2m
    dep = quantize_deploy(deploy_params(params["stem"], bn["stem"], pcfg),
                          QuantSpec(8, 8))
    want = apply_p2m_conv_deploy(dep, images, pcfg, impl="plain")
    w, shift = ref_mnv2.deploy_stem(params, bn, VWW)
    got = ref_p2m.stem_deploy(w, shift, images, VWW["p2m"], _coeffs())
    counts = ((got - want).abs() * 255).round()
    assert counts.max() <= 1 and (counts > 0).float().mean() < 1e-3


def test_deployed_model_agrees():
    from repro_torch.serving.vision import VisionEngine

    params, bn = weights.mnv2(SEED, VWW, "cpu")
    images = data.vww_images(SEED, 0, 4, 80, "cpu")[0]
    engine = VisionEngine(params, bn, port.mnv2_config(VWW), device="cpu")
    want = engine.forward(torch.from_numpy(images))
    got = ref_mnv2.probs_deploy(params, bn, torch.from_numpy(images), VWW,
                                _coeffs())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_train_form_agrees_stage_by_stage():
    """The stem, then the backbone on the program's stem output: the
    train-mode model at its initial weights amplifies a stem's rounding
    (BN over channels whose spread is small beside their mean) some
    fortyfold into the logits, so each stage is held on its own."""
    from repro_torch.models import mobilenetv2 as mn

    params, bn = weights.mnv2(SEED, VWW, "cpu")
    images = torch.from_numpy(data.vww_images(SEED, 0, 4, 80, "cpu")[0])
    pcfg = port.mnv2_config(VWW)
    stem, stem_bn = mn.apply_mnv2_stem(params, bn, images, pcfg, train=True)
    p, s = params["stem"], bn["stem"]
    got, mean, var = ref_p2m.stem_train(p["theta"], p["bn_gamma"],
                                        p["bn_beta"], s["bn_mean"],
                                        s["bn_var"], images, VWW["p2m"],
                                        _coeffs(), train=True)
    torch.testing.assert_close(got, stem, rtol=0, atol=2e-5)
    torch.testing.assert_close(mean, stem_bn["stem"]["bn_mean"])
    torch.testing.assert_close(var, stem_bn["stem"]["bn_var"])
    x, want_bn = mn.apply_mnv2_backbone(params, bn, stem, pcfg, train=True)
    want = x.mean(dim=(1, 2)) @ params["fc"]["w"] + params["fc"]["b"]
    logits, got_bn = ref_mnv2.backbone(params, bn, stem, VWW, train=True)
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-5)
    for (k, a), (_, b) in zip(weights.leaves(got_bn), weights.leaves(want_bn)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=k)


def test_rwkv_logits_agree():
    from repro_torch.models import rwkv6

    params = weights.rwkv6(SEED, RWKV, "cpu")
    tokens = torch.from_numpy(data.lm_tokens(SEED, 0, 2, 40, RWKV["vocab"]))
    want, _, _ = rwkv6.forward(params, tokens,
                               port.rwkv_config(RWKV, wkv_impl="plain"))
    got = ref_rwkv.logits(params, tokens, RWKV)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_rwkv_loss_and_gradient_agree():
    from repro_torch.models.families import get_family

    pcfg = port.rwkv_config(RWKV, wkv_impl="plain")
    params = weights.rwkv6(SEED, RWKV, "cpu")
    batch = data.LMBatches(SEED, 2, 24, RWKV["vocab"]).batch_at(0)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    leaves = [t.clone().requires_grad_(True)
              for _, t in weights.leaves(params)]
    from portbench.drivers.rwkv6_train import _rebuild

    want, _ = get_family(pcfg).loss(_rebuild(params, leaves), b, pcfg)
    gw = torch.autograd.grad(want, leaves)
    mine = [t.detach().clone().requires_grad_(True) for t in leaves]
    got = ref_rwkv.loss(_rebuild(params, mine), b["tokens"].long(),
                        b["targets"].long(), RWKV)
    gg = torch.autograd.grad(got, mine)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    for a, c in zip(gg, gw):
        assert float((a - c).norm()) <= 1e-4 * float(c.norm()) + 1e-7


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_optimizer_steps_agree(name):
    from repro_torch import optim

    gen = torch.Generator().manual_seed(3)
    params = {"a": torch.randn(5, 7, generator=gen),
              "b": torch.randn(11, generator=gen)}
    grads = [{k: torch.randn(v.shape, generator=gen) for k, v in
              params.items()} for _ in range(3)]
    if name == "sgd":
        o = {"lr": 0.05, "momentum": 0.9}
        opt = optim.sgd(optim.constant(o["lr"]), momentum=o["momentum"])
    else:
        o = {"lr": 3e-3, "warmup": 2, "total": 10, "floor": 0.1, "b1": 0.9,
             "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "clip_norm": 1.0}
        opt = optim.adamw(optim.cosine_warmup(o["lr"], o["warmup"],
                                              o["total"]))
    state = opt.init(params)
    mine = [v.clone() for v in params.values()]
    slots = [[torch.zeros_like(v) for v in mine] for _ in range(2)]
    for step, g in enumerate(grads):
        params, state = opt.update(g, state, params, step)
        gl = [g[k].clone() for k in g]
        if name == "sgd":
            ref_optim.sgd_step(mine, gl, slots[0], o, step)
        else:
            ref_optim.adamw_step(mine, gl, slots[0], slots[1], o, step)
    for a, b in zip(mine, params.values()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
