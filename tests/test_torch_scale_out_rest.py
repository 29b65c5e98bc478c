"""The rest of the LM path's scale-out on the CPU, in spawned gloo worlds
of 2 and 4 ranks (`repro_torch.launch.world.spawn_world`, one intra-op
thread a rank; the rank bodies are `tests/_scale_out_rest_ranks.py`),
each held in float64 to the port's single process on the same weights
(the families' ``init`` seeded 0) within 1e-6 of each leaf's largest
|value| (the norms run in float32 in both, so the ranks' other order of
sums reaches ~5e-7):

* RWKV-6 where the model axis splits the columns but not the heads (1
  head of 64 over 2 ranks, 2 heads of 32 over 4: every rank gathers r,
  k, v and the decay and runs every head, as RWKV-6 3B's 40 heads over
  16): one train step's loss and gradients;
* the RG-LRU, VLM and encoder-decoder families (and Whisper with 6 heads
  of 16, whose 96 columns divide over 4 while its heads do not) tensor-
  parallel over the whole world and fully sharded over it: one train
  step's loss and gradients, each rank's leaves at the plan's shard
  shapes, and five teacher-forced decode steps' logits (the cross K/V
  prefilled under the plan);
* decode with a cache whose KV heads split over the model axis while the
  query heads stay whole (``plan_for(overrides={"heads": None})``);
* sharded checkpoints through ``launch/train.py --world 2
  --model-parallel 2 --ckpt-dir``: two steps, a save, and a restore into
  a new TP-2 world whose step 3 equals an uninterrupted run's bit for
  bit; the same checkpoint restored into an FSDP-2 world and into one
  process gives the saved global tree bit for bit.
"""
import numpy as np
import pytest
import torch

import _scale_out_rest_ranks as ranks
from repro_torch.checkpoint import CheckpointManager
from repro_torch.common.pytree import flatten_with_names
from repro_torch.launch import train as launch_train
from repro_torch.launch.world import spawn_world
from repro_torch.models.families import get_family
from repro_torch.train import TrainState

TOL = 1e-6  # of each leaf's (each logit tensor's) largest |value|
WORLD_TIMEOUT = 240.0
FAMILIES = ("rglru", "vlm", "encdec", "whisper6")
CKPT_ARGV = ["--arch", "rwkv6-3b", "--smoke", "--device", "cpu", "--batch",
             "4", "--seq", "16", "--world", "2", "--ckpt-every", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small shapes: one intra-op thread, as the spawned ranks have."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(n: int) -> dict:
    return {"rwkv": ("rwkv6-3b", {"rwkv_head_dim": ranks.RWKV_HEAD_DIM[n]}),
            "rglru": ("recurrentgemma-9b", {}),
            "vlm": ("llama-3.2-vision-11b", {}),
            "encdec": ("whisper-tiny", {}),
            "whisper6": ("whisper-tiny", ranks.WHISPER_6)}


def _cfg(n: int, name: str):
    arch, kw = _configs(n)[name]
    return ranks.config(arch, **kw)


def _rel(got, want) -> float:
    """The largest difference of a tree's leaves, each of its largest."""
    if isinstance(want, dict):
        return max(_rel(got[k], want[k]) for k in want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def world(request):
    n = request.param
    configs = _configs(n)
    batches = {k: ranks.batch_for(ranks.config(a, **kw))
               for k, (a, kw) in configs.items()}
    batches["dense"] = ranks.batch_for(ranks.config("llama3.2-1b"))
    out = spawn_world(ranks.scenarios, n, backend="gloo",
                      args=({"configs": configs, "batches": batches},),
                      timeout=WORLD_TIMEOUT)
    return n, out, batches


_SINGLE: dict = {}


def _single(n, name, batches, what):
    key = (n, name, what)
    if key not in _SINGLE:
        cfg = (ranks.config("llama3.2-1b") if name == "dense"
               else _cfg(n, name))
        fn = ranks.single_grads if what == "grads" else ranks.single_decode
        _SINGLE[key] = fn(cfg, batches[name])
    return _SINGLE[key]


def _check_step(res, want):
    loss, grads = want
    assert abs(res["loss"] - loss) <= TOL * abs(loss)
    assert _rel(res["grads"], grads) <= TOL
    assert res["shapes_agree"]


def test_rwkv_heads_that_do_not_divide_the_model_axis(world):
    """The plan splits wr's columns over the whole world but not w0's
    heads: every rank runs every head (B7's place, its plain twin here)
    and takes its columns into the row-split wo."""
    n, out, batches = world
    cfg = _cfg(n, "rwkv")
    assert cfg.n_rwkv_heads % n and cfg.d_model % n == 0
    want = _single(n, "rwkv", batches, "grads")
    for res in out:
        _check_step(res["tp"]["rwkv"], want)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_tensor_parallel_step_matches_single_process(world, name):
    n, out, batches = world
    want = _single(n, name, batches, "grads")
    for res in out:
        _check_step(res["tp"][name], want)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_fsdp_step_matches_single_process(world, name):
    n, out, batches = world
    want = _single(n, name, batches, "grads")
    for res in out:
        _check_step(res["fsdp"][name], want)


@pytest.mark.parametrize("kind", ["decode_tp", "decode_fsdp"])
@pytest.mark.parametrize("name", FAMILIES)
def test_family_decode_matches_single_process(world, name, kind):
    n, out, batches = world
    want = _single(n, name, batches, "decode")
    for res in out:
        assert _rel(res[kind][name]["logits"], want) <= TOL


def test_decode_with_a_heads_split_cache_and_whole_query_heads(world):
    """llama SMOKE's 2 KV heads over a model axis of 2 (the cache holds a
    rank's one), its 4 query heads whole: each rank attends with the 2
    query heads that read its KV head, and wo's rows for them add up."""
    n, out, batches = world
    want = _single(n, "dense", batches, "decode")
    for res in out:
        got = res["heads_cache"]
        assert got["cache"]["k"][3] == 1  # one KV head a rank
        assert _rel(got["logits"], want) <= TOL


# ------------------------------------------------------------ checkpoints


def _arrays(step_dir) -> dict:
    with np.load(step_dir / "arrays.npz") as npz:
        return {k: npz[k] for k in npz.files}


@pytest.fixture(scope="module")
def sharded_ckpt(tmp_path_factory):
    """An uninterrupted 3-step TP-2 run, and 2 steps + a restore + 1 step
    in two launcher runs, each in its own checkpoint directory."""
    whole = tmp_path_factory.mktemp("whole")
    split = tmp_path_factory.mktemp("split")
    tp = CKPT_ARGV + ["--model-parallel", "2"]
    runs = {
        "whole": launch_train.main(tp + ["--ckpt-dir", str(whole), "--steps",
                                         "3"]),
        "first": launch_train.main(tp + ["--ckpt-dir", str(split), "--steps",
                                         "2"]),
        "second": launch_train.main(tp + ["--ckpt-dir", str(split),
                                          "--steps", "1"]),
    }
    return whole, split, runs


def test_sharded_resume_is_bit_for_bit(sharded_ckpt):
    whole, split, runs = sharded_ckpt
    assert [r["step"] for r in runs["second"]] == [3, 3]
    for rank in range(2):
        assert runs["second"][rank]["history"][-1]["loss"] == \
            runs["whole"][rank]["history"][-1]["loss"]
    for step in (2, 3):
        a, b = _arrays(whole / f"step_{step}"), _arrays(split / f"step_{step}")
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_restore_into_another_layout_gives_the_saved_tree(sharded_ckpt):
    """The TP-2 checkpoint restored into an FSDP-2 world (each rank its
    part by the new plan) and into one process: the global tree equals
    the saved one bit for bit."""
    _, split, _ = sharded_ckpt
    saved = _arrays(split / "step_3")
    fsdp = CKPT_ARGV + ["--model-parallel", "1", "--fsdp"]
    out = spawn_world(ranks.restore, 2, backend="gloo",
                      args=(fsdp, str(split)), timeout=WORLD_TIMEOUT)
    for res in out:
        assert res["step"] == 3
        got = dict(flatten_with_names(res["tree"]))
        assert got.keys() == saved.keys() - {"step"}
        for k, v in got.items():
            np.testing.assert_array_equal(v, saved[k], err_msg=k)
    # FSDP splits the table's embed dimension over the data axis
    assert out[0]["local"]["embed.table"][1] * 2 == \
        saved["params.embed.table"].shape[1]

    args = launch_train._parse(CKPT_ARGV[:-4])
    cfg = launch_train.launch_config(args)
    params, _ = get_family(cfg).init(torch.Generator().manual_seed(1), cfg)
    opt = launch_train.adamw(launch_train.cosine_warmup(1e-3, 1, 2))
    state, extra = CheckpointManager(split).restore_latest(
        TrainState(params, opt.init(params)))
    assert state["step"] == 3 and extra["pipeline"] == out[0]["pipeline"]
    for k, v in flatten_with_names(state):
        if k != "step":
            np.testing.assert_array_equal(v.numpy(), saved[k], err_msg=k)
