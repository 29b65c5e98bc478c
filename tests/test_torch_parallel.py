"""The port's plan, spec and mesh layer (`repro_torch.parallel`,
`repro_torch.launch.specs`, `repro_torch.launch.mesh`,
`repro_torch.configs.shapes`) against the reference's, on the CPU, with
no process started.

The reference's spec machinery reads a mesh only as ``{axis: size}``
(its own tests' ``FakeMesh``), so both sides run on the same fake meshes
and every spec is compared one for one: the port's `P` is a tuple equal
to the reference's ``PartitionSpec`` of the same entries.  The cell
builders run at the published configs, allocation-free on both sides
(``jax.eval_shape`` there, ``meta`` tensors here).
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.launch import specs as jspecs
from repro.models.families import get_family as j_get_family
from repro.models.init_utils import abstract_init as j_abstract_init
from repro.optim import adamw as j_adamw
from repro.optim import constant as j_constant
from repro.parallel import axes as jaxes
from repro.parallel import plans as jplans
from repro.parallel import sharding_utils as jsu
from repro.train.state import state_logical_axes as j_state_logical_axes
from repro_torch import configs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs
from repro_torch.models.families import get_family
from repro_torch.models.init_utils import abstract_init, make
from repro_torch.parallel import (
    P,
    NamedSharding,
    current_plan,
    logical_spec,
    plan_for,
    sanitize_spec,
    shard,
    use_plan,
    vision_plan_for,
)
from repro_torch.parallel.sharding_utils import (
    batch_shardings,
    replicated_tree,
    shardings_for,
)
from repro_torch.train.state import state_logical_axes
from repro_torch.tree import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """No heavy compute here; one intra-op thread, as the other port
    tests, since the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    """The reference tests' abstract mesh: only ``shape`` is read."""

    def __init__(self, **shape):
        self.shape = shape


MESH16 = FakeMesh(data=4, model=4)
MESH1 = FakeMesh(data=1, model=1)
GRID_ARCHS = ["qwen3-32b", "mixtral-8x22b", "whisper-tiny",
              "llama-3.2-vision-11b"]


def _same(port_spec, ref_spec):
    assert isinstance(port_spec, P)
    assert port_spec == ref_spec, (port_spec, ref_spec)


# ------------------------------------------------------------ sanitize


@pytest.mark.parametrize("shape,spec", [
    ((8, 12), ("data", "model")),
    ((6, 12), ("data", "model")),  # 6 % 4: data dropped
    ((8, 8), (("pod", "data"), None)),  # no pod axis: dropped
    ((8, 16, 16), ("model", None, "model")),  # first claim keeps it
    ((6, 16, 16), ("model", None, "model")),  # ... unless it cannot
    ((16, 4), (("data", "model"), None)),
    ((8, 4), (("data", "model"), None)),  # model no longer divides
    ((4, 4, 4), ("data",)),  # short spec: trailing dims replicate
])
def test_sanitize_spec_matches_reference(shape, spec):
    _same(sanitize_spec(shape, P(*spec), MESH16),
          jaxes.sanitize_spec(shape, JP(*spec), MESH16))


def test_sanitize_spec_reads_a_device_mesh_by_axis_names():
    class DeviceMeshLike:
        mesh_dim_names = ("data", "model")
        shape = (4, 4)

    assert sanitize_spec((6, 12), P("data", "model"),
                         DeviceMeshLike()) == P(None, "model")


# ------------------------------------------------------------ plans


@pytest.mark.parametrize("kw", [
    {}, {"fsdp": True}, {"seq_shard": True}, {"cache_seq_shard": True},
    {"cache_seq_shard": True, "cache_seq_axes": ("data", "model")},
    {"fsdp": True, "overrides": {"opt_embed": "model"}},
])
def test_plan_for_rules_match_reference(kw):
    assert plan_for(MESH16, **kw).rules == jplans.plan_for(MESH16, **kw).rules


def test_vision_plan_is_pure_data_parallel_as_reference():
    plan = vision_plan_for(MESH1)
    assert plan.rules == jplans.vision_plan_for(MESH1).rules
    _same(logical_spec((32, 40, 40, 3), ("batch", None, None, None), plan),
          jaxes.logical_spec((32, 40, 40, 3), ("batch", None, None, None),
                             jplans.vision_plan_for(MESH1)))
    assert "model" not in {a for v in plan.rules.values() if v
                           for a in ((v,) if isinstance(v, str) else v)}


@pytest.mark.parametrize("shape,axes", [
    ((4, 8), ("batch", "seq")),
    ((32, 64, 128), ("batch", "seq", "embed")),
    ((8, 4096, 128), ("cache_batch", "cache_seq", "cache_heads")),
    ((64, 512, 1024), ("expert", "embed", "mlp")),
])
@pytest.mark.parametrize("mesh", [MESH1, MESH16], ids=["1x1", "4x4"])
@pytest.mark.parametrize("fsdp", [False, True])
def test_logical_spec_matches_reference(shape, axes, mesh, fsdp):
    _same(logical_spec(shape, axes, plan_for(mesh, fsdp=fsdp)),
          jaxes.logical_spec(shape, axes, jplans.plan_for(mesh, fsdp=fsdp)))


def test_logical_spec_outside_a_plan_and_rank_mismatch():
    assert current_plan() is None
    assert logical_spec((4, 4), ("batch", "seq")) == P()
    with pytest.raises(ValueError, match="rank"):
        logical_spec((4, 4), ("batch",), plan_for(MESH16))


def test_use_plan_nests_and_restores():
    a, b = plan_for(MESH1), vision_plan_for(MESH16)
    with use_plan(a):
        assert current_plan() is a
        with use_plan(b):
            assert current_plan() is b
        assert current_plan() is a
    assert current_plan() is None


def test_shard_is_a_no_op_outside_a_plan_and_on_local_tensors():
    x = torch.ones(4, 4)
    assert shard(x, "batch", "seq") is x
    with use_plan(plan_for(MESH16)):
        assert shard(x, "batch", "seq") is x


def test_named_sharding_shapes_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    class DeviceMeshLike:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 4, 2)

    sh = NamedSharding(DeviceMeshLike(), P(("pod", "data"), None, "model"))
    assert sh.shard_shape((16, 3, 8)) == (2, 3, 4)
    assert sh.placements == (Shard(0), Shard(0), Shard(2))
    assert not sh.is_fully_replicated
    rep = NamedSharding(DeviceMeshLike(), P())
    assert rep.placements == (Replicate(),) * 3 and rep.is_fully_replicated
    x = np.arange(6)
    assert rep.local(x) is x


# ------------------------------------------------------------ trees


def test_shardings_tree_matches_reference():
    values = {"a": torch.zeros(4, 8), "b": {"c": torch.zeros(2)}}
    axes = {"a": ("batch", "embed"), "b": {"c": ("heads",)}}
    sh = shardings_for(values, axes, plan_for(MESH1))
    ref_plan = jplans.plan_for(MESH1)
    _same(sh["a"].spec, jaxes.logical_spec((4, 8), axes["a"], ref_plan))
    _same(sh["b"]["c"].spec, jaxes.logical_spec((2,), ("heads",), ref_plan))


def test_replicated_tree_and_batch_shardings_match_reference():
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    plan = vision_plan_for(MESH1)
    jplan = jplans.vision_plan_for(jmesh)
    state = {"params": {"w": torch.ones(4, 3)}, "step": 0}
    assert all(s.spec == P() for s in tree_leaves(
        replicated_tree(state, plan)))
    batch = {"images": np.ones((8, 6, 6, 3), np.float32),
             "labels": np.ones((8,), np.int32),
             "mixup_lam": np.float32(0.2)}
    got = batch_shardings(batch, plan)
    want = jsu.batch_shardings(batch, jplan)
    for key in batch:
        _same(got[key].spec, want[key].spec)


# ------------------------------------------------------------ cells


@pytest.mark.parametrize("arch", GRID_ARCHS)
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_input_specs_match_reference(arch, shape):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    spec = configs.SHAPES[shape]
    inputs, axes = specs.input_specs(cfg, spec)
    jinputs, jaxes_ = jspecs.input_specs(jcfg, jconfigs.SHAPES[shape])
    assert axes == jaxes_
    assert inputs.keys() == jinputs.keys()
    for key, value in inputs.items():
        assert value.device.type == "meta"
        assert tuple(value.shape) == jinputs[key].shape
        assert str(value.dtype).split(".")[-1] == str(jinputs[key].dtype)


@pytest.mark.parametrize("arch", GRID_ARCHS + ["rwkv6-3b"])
def test_plan_for_cell_matches_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for shape in configs.cells(arch, cfg.family):
        got = specs.plan_for_cell(cfg, configs.SHAPES[shape], MESH16)
        want = jspecs.plan_for_cell(jcfg, jconfigs.SHAPES[shape], MESH16)
        assert got.rules == want.rules, shape


def test_shapes_and_cells_match_reference():
    assert {k: (v.name, v.kind, v.seq_len, v.global_batch)
            for k, v in configs.SHAPES.items()} == {
        k: (v.name, v.kind, v.seq_len, v.global_batch)
        for k, v in jconfigs.SHAPES.items()}
    for arch in configs.ARCH_IDS:
        fam = configs.get_config(arch).family
        assert configs.cells(arch, fam) == jconfigs.cells(arch, fam)


def _ref_spec_tree(values, axes, plan):
    """The reference's spec tree, through its own `logical_spec` (its
    `shardings_for` would build a ``NamedSharding`` on a real mesh)."""
    if isinstance(axes, tuple):
        return jaxes.logical_spec(np.shape(values) if not hasattr(
            values, "shape") else values.shape, axes, plan)
    return {k: _ref_spec_tree(values[k], axes[k], plan) for k in values}


def _assert_spec_trees(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_spec_trees(got[k], want[k])
    else:
        _same(got.spec, want)


@pytest.mark.parametrize("arch", ["qwen3-32b", "mixtral-8x22b",
                                  "rwkv6-3b"])
def test_train_cell_state_shardings_match_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    spec = configs.SHAPES["train_4k"]
    plan = specs.plan_for_cell(cfg, spec, MESH16)
    _, (state, inputs), (state_sh, input_sh) = specs.build_train_cell(
        cfg, spec, plan)
    assert all(t.device.type == "meta" for t in tree_leaves(
        {"p": state["params"], "o": state["opt"], "i": inputs}))

    jplan = jspecs.plan_for_cell(jcfg, jconfigs.SHAPES["train_4k"], MESH16)
    with j_abstract_init():
        jparams, jaxes_ = j_get_family(jcfg).init(jax.random.PRNGKey(0), jcfg)
    jopt = jax.eval_shape(j_adamw(j_constant(1e-4)).init, jparams)
    jstate = {"params": jparams, "opt": jopt,
              "step": jax.ShapeDtypeStruct((), np.int32)}
    jstate_axes = j_state_logical_axes(jaxes_, jopt)
    _assert_spec_trees(state_sh, _ref_spec_tree(jstate, jstate_axes, jplan))
    jin, jin_axes = jspecs.input_specs(jcfg, jconfigs.SHAPES["train_4k"])
    _assert_spec_trees(input_sh, _ref_spec_tree(jin, jin_axes, jplan))


def test_state_logical_axes_matches_reference():
    param_axes = {"embed": {"table": ("vocab", "embed")},
                  "layers": {"w": ("layers", "embed", "mlp"),
                             "b": ("mlp",)}}
    opt = {"m": None, "v": None}
    assert state_logical_axes(param_axes, opt) == j_state_logical_axes(
        param_axes, opt)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_abstract_init_leaves_every_leaf_on_meta(arch):
    cfg = configs.get_config(arch)
    with abstract_init():
        params, axes = get_family(cfg).init(torch.Generator(), cfg)
    leaves = tree_leaves(params)
    assert leaves and all(t.device.type == "meta" for t in leaves)
    assert len(tree_leaves(axes)) >= 1
    # the context ends with the block
    assert make(torch.Generator(), (2, 3), (None, None)).value.device.type \
        == "cpu"


@pytest.mark.parametrize("builder", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-tiny",
                                  "recurrentgemma-9b"])
def test_prefill_and_decode_cells_are_allocation_free(builder, arch):
    cfg = configs.get_config(arch)
    shape = "prefill_32k" if builder == "prefill" else "decode_32k"
    spec = configs.SHAPES[shape]
    plan = specs.plan_for_cell(cfg, spec, MESH16)
    build = getattr(specs, f"build_{builder}_cell")
    fn, abstract, shardings = build(cfg, spec, plan)
    assert callable(fn)
    leaves = tree_leaves({str(i): a for i, a in enumerate(abstract)})
    assert all(t.device.type == "meta" for t in leaves)
    assert all(isinstance(s, NamedSharding) for s in tree_leaves(
        {str(i): s for i, s in enumerate(shardings)}))


# ------------------------------------------------------------ meshes


def test_mesh_needs_a_process_group():
    for make_mesh in (tmesh.make_debug_mesh, tmesh.make_production_mesh):
        with pytest.raises(RuntimeError, match="initialised process group"):
            make_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="initialised process group"):
        tmesh.make_submeshes(2, device="cpu")


def test_roofline_constants_are_the_cards():
    """NVIDIA H100 80GB HBM3 at 700.00 W (data sheet); none of the
    reference's TPU v5e denominators."""
    assert tmesh.HBM_BW == 3.35e12
    assert tmesh.PEAK_FLOPS_FP32 == 67e12
    assert tmesh.PEAK_FLOPS_BF16 == 989e12
    assert tmesh.NVLINK_BW == 900e9
    assert not hasattr(tmesh, "ICI_BW")
