"""Rank bodies of `tests/test_torch_scale_out_rest.py`: each runs in one
spawned rank of a gloo world on the CPU (`repro_torch.launch.world.
spawn_world`) and returns numpy results to the test.  Torch and the port
only: a rank imports no JAX.  Weights come from the families' own
``init`` on a generator seeded 0, in float64, the same in every rank and
in the test's single process.
"""
import numpy as np
import torch

from repro_torch.common.pytree import flatten_with_names
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.families import get_family
from repro_torch.optim.optimizers import Optimizer
from repro_torch.parallel import collectives as col
from repro_torch.parallel import plan_for, use_plan
from repro_torch.parallel.sharding_utils import (
    batch_shardings,
    local_tree,
    param_shardings,
    shardings_for,
)
from repro_torch.train import TrainState, make_train_step
from repro_torch.tree import tree_leaves, tree_map

# (arch, config overrides) by scenario name; a world of n runs each at a
# model axis of n ("tp") or under FSDP over n ("fsdp")
RWKV_HEAD_DIM = {2: 64, 4: 32}  # 1 head over 2 ranks, 2 heads over 4
WHISPER_6 = {"n_heads": 6, "n_kv_heads": 6, "head_dim": 16}  # 96 columns
DECODE_STEPS = 5
DECODE_LEN = 16


def config(arch: str, **kw):
    return get_smoke_config(arch).replace(dtype=torch.float64, **kw)


def weights(cfg):
    params, _ = get_family(cfg).init(torch.Generator().manual_seed(0), cfg)
    return tree_map(lambda t: t.double() if t.is_floating_point() else t,
                    params)


def batch_for(cfg, batch: int = 4, seq: int = 8, seed: int = 0) -> dict:
    """A global batch of numpy arrays, as `launch/train.py` draws one."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, seq)),
           "targets": rng.integers(0, cfg.vocab, (batch, seq))}
    if cfg.family == "vlm":
        out["image_embeds"] = rng.normal(
            0, 1, (batch, cfg.n_image_tokens, cfg.d_model))
    if cfg.family == "encdec":
        out["src_embeds"] = rng.normal(0, 1, (batch, seq, cfg.d_model))
    return out


def tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def arrays(tree):
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def recording():
    """An optimizer that keeps the step's (reduced) gradients and moves
    nothing: the train step's gradient rule, read before any update."""
    box = {}

    def update_in_place(grads, state, params, step, grad_norm=None):
        box["grads"] = tree_map(torch.clone, grads)

    return Optimizer(lambda p: {}, None, update_in_place), box


def grads(cfg, batch, model: int, fsdp: bool = False):
    """One train step under ``plan_for(make_debug_mesh(model), fsdp)``:
    the loss and every reduced gradient leaf, whole (the ranks' parts
    gathered), and whether each local leaf has the plan's shard shape."""
    plan = plan_for(make_debug_mesh(model=model, device="cpu"), fsdp=fsdp)
    params = weights(cfg)
    sh = param_shardings(cfg, plan)
    local = tree_map(torch.clone, local_tree(params, sh))
    opt, box = recording()
    step = make_train_step(cfg, opt)
    batch = tensors(batch)
    with use_plan(plan):
        _, metrics = step(TrainState(local, {}),
                          local_tree(batch, batch_shardings(batch, plan)))
    shapes = all(tuple(a.shape) == s.shard_shape(tuple(w.shape))
                 for a, w, s in zip(*(tree_leaves(t) for t in (
                     local, params, sh))))
    return {"loss": float(metrics["loss"]), "shapes_agree": shapes,
            "grads": arrays(col.whole_tree(box["grads"], sh))}


def decode(cfg, batch, model: int, fsdp: bool = False, overrides=None):
    """Teacher-forced decode under the plan: the first ``DECODE_STEPS``
    tokens of each row one at a time (the cross K/V prefilled under the
    plan for vlm and encdec), each step's logits with the rank's vocab
    columns gathered; and the rank's cache leaves' shapes."""
    plan = plan_for(make_debug_mesh(model=model, device="cpu"), fsdp=fsdp,
                    overrides=overrides)
    family = get_family(cfg)
    params = local_tree(weights(cfg), param_shardings(cfg, plan))
    batch = tensors(batch)
    b = batch["tokens"].shape[0]
    state, axes = family.init_decode_state(cfg, b, DECODE_LEN, device="cpu")
    state_sh = shardings_for(state, axes, plan)
    state = local_tree(state, state_sh)
    part = local_tree(batch, batch_shardings(batch, plan))
    rows = part["tokens"].shape[0]
    model_groups = col.axis_groups(plan.mesh, ("model",))
    out = []
    with use_plan(plan), torch.no_grad():
        if cfg.family == "vlm":
            from repro_torch.models import vlm

            state["cross"] = vlm.prefill_cross_kv(params,
                                                  part["image_embeds"], cfg)
        if cfg.family == "encdec":
            from repro_torch.models import whisper

            state["cross"] = whisper.prefill_cross_kv(params,
                                                      part["src_embeds"], cfg)
        for t in range(DECODE_STEPS):
            lg, state = family.decode(
                params, state, part["tokens"][:, t:t + 1],
                torch.full((rows,), t), cfg, cache_shardings=state_sh)
            lg = col.gather_from_model(lg, model_groups, -1)
            out.append(col.all_gather_batch(lg, col.axis_groups(
                plan.mesh, col.batch_axes(plan, b))))
    return {"logits": torch.cat(out, 1).numpy(),
            "cache": {k: tuple(v.shape) for k, v in
                      (("k", state["k"]), ("v", state["v"]))}
            if "k" in state else None}


def single_grads(cfg, batch):
    """The single process's loss and gradients on the same weights."""
    from repro_torch.tree import tree_unflatten

    params = weights(cfg)
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = get_family(cfg).loss(tree_unflatten(params, live),
                                   tensors(batch), cfg)
    g = torch.autograd.grad(loss, live)
    return float(loss.detach()), arrays(tree_unflatten(params, list(g)))


def single_decode(cfg, batch):
    """The single process's teacher-forced decode logits."""
    family = get_family(cfg)
    params = weights(cfg)
    batch = tensors(batch)
    b = batch["tokens"].shape[0]
    state, _ = family.init_decode_state(cfg, b, DECODE_LEN, device="cpu")
    out = []
    with torch.no_grad():
        if cfg.family == "vlm":
            from repro_torch.models import vlm

            state["cross"] = vlm.prefill_cross_kv(params,
                                                  batch["image_embeds"], cfg)
        if cfg.family == "encdec":
            from repro_torch.models import whisper

            state["cross"] = whisper.prefill_cross_kv(params,
                                                      batch["src_embeds"], cfg)
        for t in range(DECODE_STEPS):
            lg, state = family.decode(params, state,
                                      batch["tokens"][:, t:t + 1],
                                      torch.full((b,), t), cfg)
            out.append(lg)
    return torch.cat(out, 1).numpy()


def restore(rank, world, argv, ckpt_dir):
    """The launcher's state for ``argv`` (its plan's local parts as the
    template), restored from ``ckpt_dir`` by the current plan, whole."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import train as launch_train

    args = launch_train._parse(argv)
    cfg = launch_train.launch_config(args)
    plan = plan_for(make_debug_mesh(model=args.model_parallel, device="cpu"),
                    fsdp=args.fsdp)
    params, axes = get_family(cfg).init(torch.Generator().manual_seed(1),
                                        cfg)
    opt = launch_train.adamw(launch_train.cosine_warmup(1e-3, 1, 2))
    local, _, sh = launch_train._local_state(params, axes, opt, plan)
    state, extra = CheckpointManager(ckpt_dir).restore_latest(
        local, shardings=sh)
    whole = {k: col.whole_tree(state[k], sh[k]) for k in state if k != "step"}
    return {"step": int(state["step"]), "pipeline": extra["pipeline"],
            "tree": arrays(whole),
            "local": {k: tuple(v.shape) for k, v in
                      flatten_with_names(state["params"])}}


def scenarios(rank, world, inputs):
    """Every scenario of the module on one world (one spawn for all)."""
    torch.manual_seed(0)
    res = {"tp": {}, "fsdp": {}, "decode_tp": {}, "decode_fsdp": {}}
    for name, (arch, kw) in inputs["configs"].items():
        cfg = config(arch, **kw)
        batch = inputs["batches"][name]
        res["tp"][name] = grads(cfg, batch, world)
        if name != "rwkv":
            res["fsdp"][name] = grads(cfg, batch, 1, fsdp=True)
            res["decode_tp"][name] = decode(cfg, batch, world)
            res["decode_fsdp"][name] = decode(cfg, batch, 1, fsdp=True)
    dense = config("llama3.2-1b")
    res["heads_cache"] = decode(dense, inputs["batches"]["dense"], 2,
                                overrides={"heads": None})
    return res
