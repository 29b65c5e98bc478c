"""The port's MobileNetV2 (`repro_torch.models.mobilenetv2`, eval) against
the JAX reference, with the reference's weights carried across by
`repro_torch.compat`: deploy-form P²M and baseline logits on even and odd
sizes, so that XLA's asymmetric SAME padding at stride 2 is exercised.

Tolerance: logits within 1e-4 (fp32 through a few dozen convs whose sums
run in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bn_fold import deploy_params as j_deploy_params
from repro.core.quant import QuantSpec as JQuantSpec
from repro.core.quant import quantize_deploy as j_quantize_deploy
from repro.models import mobilenetv2 as jm
from repro_torch import compat
from repro_torch.core.bn_fold import deploy_params
from repro_torch.core.quant import QuantSpec, quantize_deploy
from repro_torch.models import mobilenetv2 as tm

TOL = 1e-4


def _cfgs(variant, size, width=0.25, head=32):
    return (jm.MNV2Config(variant=variant, image_size=size, width=width,
                          head_channels=head),
            tm.MNV2Config(variant=variant, image_size=size, width=width,
                          head_channels=head))


def _reference_model(jcfg, seed=0):
    params, state = jm.init_mnv2(jax.random.PRNGKey(seed), jcfg)
    # non-trivial BN statistics, so that eval BN is exercised
    leaves, tdef = jax.tree.flatten(state)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(x) + rng.uniform(0.0, 0.2, np.shape(x)).astype(
        np.float32) for x in leaves]
    state = jax.tree.unflatten(tdef, leaves)
    return params, state


def _jit_apply(jcfg):
    """The reference eval forward, compiled once (op-by-op dispatch of the
    whole network costs tens of seconds of compiles on the CPU)."""
    return jax.jit(lambda p, s, x, dep: jm.apply_mnv2(
        p, s, x, jcfg, train=False, p2m_deploy=dep))


def _images(b, size, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((b, size, size, 3)).astype(np.float32)


def _to_port(params, state):
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return (compat.tree_from_reference(np_tree(params), device="cpu"),
            compat.tree_from_reference(np_tree(state), device="cpu"))


@pytest.mark.parametrize("size", [30, 35])
@pytest.mark.parametrize("quant_bits", [8, None])
def test_p2m_deploy_logits_match_reference(size, quant_bits):
    jcfg, tcfg = _cfgs("p2m", size)
    params, state = _reference_model(jcfg)
    imgs = _images(3, size)
    jdep = j_deploy_params(params["stem"], state["stem"], jcfg.p2m)
    tp, ts = _to_port(params, state)
    tdep = deploy_params(tp["stem"], ts["stem"], tcfg.p2m)
    if quant_bits:
        jdep = j_quantize_deploy(jdep, JQuantSpec(quant_bits, quant_bits))
        tdep = quantize_deploy(tdep, QuantSpec(quant_bits, quant_bits))
    ref, _ = _jit_apply(jcfg)(params, state, jnp.asarray(imgs), jdep)
    got, new_state = tm.apply_mnv2(tp, ts, torch.from_numpy(imgs), tcfg,
                                   p2m_deploy=tdep)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    assert set(new_state) == set(ts)


@pytest.mark.parametrize("size", [20, 21])
def test_baseline_logits_match_reference(size):
    jcfg, tcfg = _cfgs("baseline", size)
    params, state = _reference_model(jcfg, seed=1)
    imgs = _images(2, size, seed=1)
    ref, _ = _jit_apply(jcfg)(params, state, jnp.asarray(imgs), None)
    tp, ts = _to_port(params, state)
    got, _ = tm.apply_mnv2(tp, ts, torch.from_numpy(imgs), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("size,stride", [(8, 2), (7, 2), (5, 1), (6, 1)])
def test_same_padding_is_xla_same(size, stride):
    """3×3 convs pad as XLA's SAME does: (0, 1) at stride 2 on an even
    size, where PyTorch's symmetric padding would shift the grid."""
    rng = np.random.default_rng(2)
    x = rng.random((1, size, size, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)
    ref = np.asarray(jm._conv(jnp.asarray(x), jnp.asarray(w), stride=stride))
    got = tm._conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                   stride=stride).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["p2m", "baseline"])
def test_port_init_has_the_reference_tree(variant):
    """The port's own init gives the reference's tree, key for key, with
    conv weights in OIHW; the same seed gives the same weights."""
    jcfg, tcfg = _cfgs(variant, 40)
    params, state = jm.init_mnv2(jax.random.PRNGKey(0), jcfg)
    ref_p, ref_s = _to_port(params, state)
    got_p, got_s = tm.init_mnv2(torch.Generator().manual_seed(0), tcfg,
                                device="cpu")
    for ref, got in ((ref_p, got_p), (ref_s, got_s)):
        rl, rdef = jax.tree.flatten(ref)
        gl, gdef = jax.tree.flatten(got)
        assert rdef == gdef
        assert [tuple(x.shape) for x in rl] == [tuple(x.shape) for x in gl]
    again, _ = tm.init_mnv2(torch.Generator().manual_seed(0), tcfg,
                            device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(got_p),
                                                 jax.tree.leaves(again)))
    assert tm.head_out_channels(tcfg) == jm.head_out_channels(jcfg)
    assert tcfg.block_schedule() == jcfg.block_schedule()


def test_p2m_stem_impls_agree_and_train_form_is_refused():
    jcfg, tcfg = _cfgs("p2m", 30)
    params, state = _reference_model(jcfg)
    tp, ts = _to_port(params, state)
    dep = quantize_deploy(deploy_params(tp["stem"], ts["stem"], tcfg.p2m),
                          QuantSpec(8, 8))
    x = torch.from_numpy(_images(2, 30))
    plain, _ = tm.apply_mnv2_stem(tp, ts, x, tcfg, p2m_deploy=dep)
    patches, _ = tm.apply_mnv2_stem(tp, ts, x, tcfg, p2m_deploy=dep,
                                    p2m_impl="patches")
    assert plain.shape == (2, 6, 6, 8)
    torch.testing.assert_close(patches, plain, rtol=0, atol=tcfg.p2m.adc.v_lsb)
    # Without a deploy tree the stem runs its train form (here in eval,
    # on the running statistics), as the reference's does; the CUDA conv
    # is still refused for a CPU tensor.
    ref, _ = jm.apply_mnv2_stem(params, state, jnp.asarray(x.numpy()), jcfg,
                                train=False)
    train_form, _ = tm.apply_mnv2_stem(tp, ts, x, tcfg)
    np.testing.assert_allclose(train_form.numpy(), np.asarray(ref),
                               rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="CUDA"):
        tm.apply_mnv2_stem(tp, ts, x, tcfg, p2m_impl="cuda")
