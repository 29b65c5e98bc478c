"""The port's checkpoint manager (atomicity, corruption fallback, GC),
trainer (resume, straggler detection, restart on failure) and data
pipeline (`repro_torch.checkpoint`, `repro_torch.train.trainer`,
`repro_torch.data.pipeline`), mirroring `tests/test_checkpoint_trainer.py`
test for test, on the CPU; plus a checkpoint the reference's manager
wrote for an LM train state, restored by the port's (equal bit for bit),
and a save that a step writing the state in place cannot change.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models.families import get_family as j_get_family
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.train.state import TrainState as JTrainState
from repro_torch import compat
from repro_torch.checkpoint import CheckpointManager
from repro_torch.common.pytree import (
    assert_trees_all_finite,
    flatten_with_names,
    param_count,
    tree_bytes,
    tree_map_with_path,
)
from repro_torch.data import DataPipeline, SyntheticLMDataset
from repro_torch.train import StragglerMonitor, Trainer
from repro_torch.tree import tree_leaves, tree_map


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These shapes are small: one intra-op thread runs them about ten
    times faster than eight, and the suite's parallel workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((4, 4), generator=g),
                   "b": torch.zeros((4,))},
        "opt": {"mu": {"w": torch.ones((4, 4)), "b": torch.zeros((4,))}},
        "step": 7,
    }


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    state = _state()
    mgr.save(7, state, extra={"pipeline": {"step": 7}}, blocking=True)
    restored, extra = mgr.restore_latest(_state(seed=1))
    assert extra == {"pipeline": {"step": 7}}
    assert torch.equal(restored["params"]["w"], state["params"]["w"])
    assert restored["step"] == 7 and isinstance(restored["step"], int)
    manifest = json.loads((tmp_path / "step_7" / "manifest.json").read_text())
    assert set(manifest["arrays"]) == {"params.b", "params.w", "opt.mu.b",
                                       "opt.mu.w", "step"}


def test_async_save_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, _state(step))
    mgr.wait()
    assert mgr.steps() == [3, 4]


def test_async_save_snapshots_before_an_in_place_step(tmp_path):
    """A step that writes the state in place right after ``save`` returns
    does not reach the checkpoint."""
    mgr = CheckpointManager(tmp_path)
    state = _state()
    want = state["params"]["w"].clone()
    mgr.save(7, state)
    state["params"]["w"].mul_(0.0).add_(5.0)
    mgr.wait()
    restored, _ = mgr.restore_latest(_state(seed=1))
    assert torch.equal(restored["params"]["w"], want)


def test_corrupt_checkpoint_falls_back(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=5)
    mgr.save(1, _state(1), blocking=True)
    mgr.save(2, _state(2), blocking=True)
    # corrupt newest: truncate the npz so it cannot be read back
    npz = tmp_path / "step_2" / "arrays.npz"
    npz.write_bytes(npz.read_bytes()[: 64])
    restored = mgr.restore_latest(_state())
    assert restored is not None
    state, _ = restored
    assert torch.equal(state["params"]["w"], _state(1)["params"]["w"])


def test_hash_mismatch_falls_back(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=5)
    mgr.save(1, _state(1), blocking=True)
    mgr.save(2, _state(2), blocking=True)
    path = tmp_path / "step_2" / "manifest.json"
    manifest = json.loads(path.read_text())
    manifest["arrays"]["params.w"]["sha256"] = "0" * 64
    path.write_text(json.dumps(manifest))
    state, _ = mgr.restore_latest(_state())
    assert torch.equal(state["params"]["w"], _state(1)["params"]["w"])


def test_tmp_dirs_ignored(tmp_path):
    mgr = CheckpointManager(tmp_path)
    (tmp_path / "step_9.tmp").mkdir()
    assert mgr.steps() == []


def test_restore_places_leaves_as_the_template():
    tmpl = _state()
    tmpl["params"]["w"] = tmpl["params"]["w"].double()
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(3, _state(2), blocking=True)
        state, _ = mgr.restore_latest(tmpl)
    assert state["params"]["w"].dtype == torch.float64
    assert state["params"]["b"].dtype == torch.float32
    assert torch.equal(state["params"]["w"].float(),
                       _state(2)["params"]["w"])


def test_straggler_monitor():
    mon = StragglerMonitor(window=16, threshold=3.0)
    flagged = []
    for i in range(20):
        dt = 1.0 if i != 15 else 10.0
        flagged.append(mon.observe(i, dt))
    assert flagged[15] is True
    assert sum(flagged) == 1
    assert mon.last_flagged == 15


class _FlakyStep:
    """Fails once at a chosen step, then behaves."""

    def __init__(self, fail_at=3):
        self.fail_at = fail_at
        self.calls = 0

    def __call__(self, state, batch):
        self.calls += 1
        if self.calls == self.fail_at:
            raise RuntimeError("simulated preemption")
        new = dict(state)
        new["step"] = state["step"] + 1
        new["params"] = tree_map(lambda p: p * 0.9, state["params"])
        return new, {"loss": torch.tensor(1.0 / self.calls)}


def test_trainer_restart_on_failure(tmp_path):
    ds = SyntheticLMDataset(vocab=64, seq_len=8, batch=2)
    pipe = DataPipeline(ds, prefetch=0)
    mgr = CheckpointManager(tmp_path)
    state = _state()
    state["step"] = 0
    trainer = Trainer(_FlakyStep(fail_at=3), state, pipe, ckpt_manager=mgr,
                      ckpt_every=1, log_every=0, max_restarts=2)
    trainer.run(6)
    assert trainer.state["step"] == 6
    assert mgr.steps()  # checkpoints exist


def test_trainer_without_checkpoint_reraises():
    ds = SyntheticLMDataset(vocab=64, seq_len=8, batch=2)
    state = _state()
    state["step"] = 0
    trainer = Trainer(_FlakyStep(fail_at=2), state, DataPipeline(ds, prefetch=0),
                      log_every=0)
    try:
        trainer.run(4)
    except RuntimeError as exc:
        assert "simulated preemption" in str(exc)
    else:
        raise AssertionError("the failed step was not re-raised")


def test_trainer_resume_from_checkpoint(tmp_path):
    ds = SyntheticLMDataset(vocab=64, seq_len=8, batch=2)
    mgr = CheckpointManager(tmp_path)
    pipe = DataPipeline(ds, prefetch=0)
    state = _state()
    state["step"] = 0
    t1 = Trainer(_FlakyStep(fail_at=10**9), state, pipe, ckpt_manager=mgr,
                 ckpt_every=2, log_every=0)
    t1.run(4)
    # fresh trainer restores where the last left off (incl. pipeline cursor)
    pipe2 = DataPipeline(ds, prefetch=0)
    t2 = Trainer(_FlakyStep(fail_at=10**9), _state(seed=9), pipe2,
                 ckpt_manager=mgr, log_every=0)
    assert t2.restore()
    assert t2.state["step"] == 4
    assert pipe2.state_dict()["step"] == pipe.state_dict()["step"]
    assert torch.equal(t2.state["params"]["w"], t1.state["params"]["w"])


def test_pipeline_determinism_and_restart():
    ds = SyntheticLMDataset(vocab=97, seq_len=16, batch=4)
    p1 = DataPipeline(ds, prefetch=2)
    batches = [next(p1) for _ in range(5)]
    cursor = p1.state_dict()
    p1.close()
    # restart from step 3 must reproduce batch 3 exactly
    p2 = DataPipeline(ds, prefetch=0)
    p2.load_state_dict({"step": 3})
    b3 = next(p2)
    np.testing.assert_array_equal(b3["tokens"], batches[3]["tokens"])
    assert cursor == {"step": 5}


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """A SMOKE LM train state (AdamW moments, step 5) saved by the
    reference's `CheckpointManager` restores through the port's manager
    into a port template: every array equal bit for bit, ``step`` an int,
    the extra state kept."""
    jcfg = j_get_smoke_config("rwkv6-3b").replace(dtype=jax.numpy.float32)
    jparams, _ = j_get_family(jcfg).init(jax.random.PRNGKey(0), jcfg)
    jo = jopt.adamw(jsched.constant(1e-3))
    rng = np.random.default_rng(0)
    jopt_state = jax.tree.map(
        lambda p: rng.standard_normal(np.shape(p)).astype(np.float32),
        jo.init(jparams))
    jstate = JTrainState(jparams, jopt_state, step=5)
    JCheckpointManager(tmp_path).save(5, jstate, extra={"pipeline": {
        "step": 5}}, blocking=True)

    np_state = jax.tree.map(np.asarray, jstate)
    template = compat.train_state_from_reference(np_state, device="cpu")
    template = {**template, "params": tree_map(torch.zeros_like,
                                               template["params"]),
                "step": 0}
    restored, extra = CheckpointManager(tmp_path).restore_latest(template)
    assert extra == {"pipeline": {"step": 5}}
    assert restored["step"] == 5 and isinstance(restored["step"], int)
    want = dict(flatten_with_names(np_state))
    got = dict(flatten_with_names(restored))
    assert set(got) == set(want)
    for name, arr in want.items():
        if name == "step":
            continue
        assert got[name].dtype == torch.float32
        np.testing.assert_array_equal(got[name].numpy(), arr, err_msg=name)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    state = _state(3)
    CheckpointManager(tmp_path).save(7, state, blocking=True)
    jtemplate = jax.tree.map(lambda t: np.zeros(t.shape, np.float32)
                             if isinstance(t, torch.Tensor) else t, state)
    restored, _ = JCheckpointManager(tmp_path).restore_latest(jtemplate)
    np.testing.assert_array_equal(np.asarray(restored["params"]["w"]),
                                  state["params"]["w"].numpy())
    assert int(restored["step"]) == 7


def test_tree_helpers_match_reference():
    from repro.common import pytree as jpytree

    state = _state()
    np_state = tree_map(lambda t: t.numpy() if isinstance(t, torch.Tensor)
                        else t, state)
    assert [n for n, _ in flatten_with_names(state)] == [
        n for n, _ in jpytree.flatten_with_names(np_state)]
    assert param_count(state) == jpytree.param_count(np_state)
    assert tree_bytes(state["params"]) == jpytree.tree_bytes(
        np_state["params"])
    paths = tree_map_with_path(lambda p, _: p, state)
    assert paths["opt"]["mu"]["w"] == "opt.mu.w"
    assert_trees_all_finite(state)
    bad = _state()
    bad["params"]["w"][0, 0] = float("nan")
    try:
        assert_trees_all_finite(bad, "state")
    except AssertionError as exc:
        assert "state[params.w]" in str(exc)
    else:
        raise AssertionError("a NaN leaf passed")
    assert len(tree_leaves(state)) == 5


def test_precision_policy_casts_floating_leaves_only():
    from repro.common import precision as jprecision
    from repro_torch.common import DEFAULT_POLICY, cast_floating
    from repro_torch.common.precision import FP32_POLICY

    tree = {"w": torch.ones(2, 3), "ids": torch.arange(3),
            "flag": torch.tensor([True])}
    low = DEFAULT_POLICY.cast_params(tree)
    assert low["w"].dtype == torch.bfloat16
    assert low["ids"].dtype == torch.int64 and low["flag"].dtype == torch.bool
    assert DEFAULT_POLICY.cast_output(low)["w"].dtype == torch.float32
    assert FP32_POLICY.cast_params(tree)["w"].dtype == torch.float32
    assert cast_floating(tree, torch.float64)["w"].dtype == torch.float64
    assert str(jprecision.DEFAULT_POLICY.compute_dtype.__name__) == "bfloat16"


def test_restore_keeps_the_templates_key_order(tmp_path):
    """The archive is sorted by path; the restored tree walks its leaves
    in the template's order, as the saved state did, so a sum over them
    (the gradients' global norm) rounds as it did before the save."""
    state = {"params": {"w": torch.ones(2), "b": torch.zeros(2),
                        "a": torch.full((2,), 3.0)}, "step": 1}
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, state, blocking=True)
    restored, _ = mgr.restore_latest(state)
    assert list(restored) == ["params", "step"]
    assert list(restored["params"]) == ["w", "b", "a"]
    assert [n for n, _ in flatten_with_names(restored)] == [
        n for n, _ in flatten_with_names(state)]
