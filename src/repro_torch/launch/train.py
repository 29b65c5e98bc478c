"""Training launcher, LM path; port of `repro.launch.train`:

  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \\
      --smoke --device cpu --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-32b \\
      --smoke --device cpu --world 4 --model-parallel 2 --steps 2

Wires config → data pipeline → optimizer → train step → `Trainer`
(checkpointing, straggler monitor, restart), as the reference does,
float32 as the reference's launcher casts it, on random weights from seed
0 drawn on a generator on the device.  It runs on the GPU unless
``--device`` names another.  The step updates the state in place
(`train/step.py`), the counterpart of the reference's donated jit.

``--world N`` (N > 1) spawns N ranks (`launch.world.spawn_world`: gloo on
the CPU or where ranks share a card, NCCL where each rank has a card of
its own); each builds the reference's ``make_debug_mesh(model=…)`` →
``plan_for(mesh)`` (``--fsdp``: ZeRO-3 over ``"data"``) →
``shardings_for(state, state_logical_axes(...))`` wiring, keeps its part
of the state (`sharding_utils.local_tree`) and of each batch, and runs
the train step under the plan: tensor- and expert-parallel over
``--model-parallel`` ranks (which must divide N), data-parallel over the
rest.  ``main`` then returns each rank's summary (its losses, and its
leaves' shapes beside the plan's ``shard_shape``).  Every family trains
so.  ``--ckpt-dir`` under a world writes sharded checkpoints: each
leaf's global tensor gathered from the ranks' parts, rank 0 writing the
same files a single process writes; a restore gives each rank its part
by the current plan, so a checkpoint of one layout resumes in another
(`checkpoint.manager`).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import DataPipeline, SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.models.families import get_family
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.train import Trainer, TrainState, make_train_step
from repro_torch.tree import tree_map

WORLD_TIMEOUT = 3600.0  # seconds a world of ranks may take, start to end


def build_batch_transform(cfg, batch_size, seq):
    """Attach stub modality inputs for vlm/encdec families."""
    def transform(batch):
        if cfg.family == "vlm":
            rng = np.random.default_rng(0)
            batch["image_embeds"] = rng.normal(
                0, 1, (batch_size, cfg.n_image_tokens, cfg.d_model)
            ).astype(np.float32)
        if cfg.family == "encdec":
            rng = np.random.default_rng(0)
            batch["src_embeds"] = rng.normal(
                0, 1, (batch_size, seq, cfg.d_model)).astype(np.float32)
        return batch
    return transform


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", choices=["int8_ef"], default=None)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--world", type=int, default=1,
                    help="ranks to spawn (each a process, one mesh)")
    ap.add_argument("--fsdp", action="store_true",
                    help="shard the params' embed dimension over data")
    ap.add_argument("--device", default=None,
                    help="torch device; default the GPU")
    args = ap.parse_args(argv)
    if args.world < 1 or args.model_parallel < 1 or \
            args.world % args.model_parallel:
        raise SystemExit(f"--model-parallel {args.model_parallel} must "
                         f"divide --world {args.world}")
    return args


def launch_config(args):
    """The config the flags name: float32, its depth cut by ``--layers``."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(dtype=torch.float32)
    return cfg.replace(n_layers=args.layers) if args.layers else cfg


def _train(args, device, plan=None) -> tuple[Trainer, dict]:
    """Build and run the trainer (under ``plan``: on this rank's parts);
    returns it and, under a plan, each state leaf's (local shape, the
    plan's shard shape)."""
    cfg = launch_config(args)
    family = get_family(cfg)

    dataset = SyntheticLMDataset(vocab=cfg.vocab, seq_len=args.seq,
                                 batch=args.batch)
    sharding_fn = None
    if plan is not None:
        from repro_torch.parallel.sharding_utils import batch_shardings

        def sharding_fn(name, value):
            return batch_shardings({name: value}, plan)[name]

    pipeline = DataPipeline(dataset,
                            transform=build_batch_transform(cfg, args.batch,
                                                            args.seq),
                            sharding_fn=sharding_fn, device=device)

    optimizer = adamw(cosine_warmup(args.lr, warmup=20, total=args.steps))
    params, axes = family.init(torch.Generator(device).manual_seed(0), cfg)
    int8_ef = args.grad_compression == "int8_ef"
    shapes = shardings = None
    if plan is None:
        state = _state(params, optimizer, int8_ef)
    else:
        state, shapes, shardings = _local_state(params, axes, optimizer, plan,
                                                int8_ef)
    del params  # under a plan the whole tree goes: the rank keeps its part
    step = make_train_step(cfg, optimizer, accum_steps=args.accum,
                           grad_compression=args.grad_compression)
    if plan is not None:
        from repro_torch.parallel import use_plan

        step = _under(plan, step, use_plan)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    trainer = Trainer(step, state, pipeline, ckpt_manager=ckpt,
                      ckpt_every=args.ckpt_every if ckpt else 0,
                      shardings=shardings)
    try:
        if ckpt is not None and trainer.restore() and (
                plan is None or plan.mesh.get_rank() == 0):
            print(f"resumed from step {trainer.state['step']}")
        final = trainer.run(args.steps)
    finally:
        pipeline.close()
    if plan is None or plan.mesh.get_rank() == 0:
        print(f"final: {final}")
    return trainer, shapes or {}


def _under(plan, step, use_plan):
    def run(state, batch):
        with use_plan(plan):
            return step(state, batch)
    return run


def _state(params, optimizer, int8_ef: bool = False) -> dict:
    """The train state of ``params``: the optimizer's, and with
    ``int8_ef`` the error-feedback accumulator from the start, so every
    checkpoint has it."""
    extras = None
    if int8_ef:
        extras = {"ef_error": tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)}
    return TrainState(params, optimizer.init(params), extras=extras)


def _local_state(params, param_axes, optimizer, plan,
                 int8_ef: bool = False) -> tuple[dict, dict, dict]:
    """This rank's train state under ``plan`` from the whole ``params``:
    its part of them as ``shardings_for(state, state_logical_axes(...),
    plan)`` places them, and the optimizer's state (and EF's) made on
    that part, so no rank holds a whole moment; each leaf's (local shape,
    the sharding's ``shard_shape`` of the global one); the shardings."""
    from repro_torch.parallel.sharding_utils import local_tree, shardings_for
    from repro_torch.train.state import state_logical_axes

    whole = _state(tree_map(lambda t: torch.empty_like(t, device="meta"),
                            params), optimizer, int8_ef)
    axes = state_logical_axes(param_axes, whole["opt"])
    if int8_ef:
        axes["extras"] = {"ef_error": param_axes}
    sh = shardings_for(whole, axes, plan)
    local = _state(tree_map(torch.clone, local_tree(params, sh["params"])),
                   optimizer, int8_ef)
    shapes = {}

    def walk(value, part, s, path):
        if isinstance(value, dict):
            for k in value:
                walk(value[k], part[k], s[k], f"{path}/{k}")
        else:
            shapes[path] = (tuple(part.shape), s.shard_shape(value.shape))

    for key in ("params", "opt", "extras"):
        if key in whole:
            walk(whole[key], local[key], sh[key], key)
    return local, shapes, sh


def _world_rank(rank: int, world: int, argv) -> dict:
    """One rank of ``--world``: its mesh, plan and part of the state."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel import plan_for

    args = _parse(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    mesh = make_debug_mesh(model=args.model_parallel, device=device)
    plan = plan_for(mesh, fsdp=args.fsdp)
    trainer, shapes = _train(args, device, plan)
    return {"history": trainer.history, "step": trainer.state["step"],
            "shapes": shapes}


def main(argv=None):
    """Train as the flags say; returns the `Trainer` (whose ``history``
    and ``state`` a caller can read), or under ``--world N`` the N ranks'
    summaries (``history``, ``step``, ``shapes``), by rank."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parse(argv)
    if args.world == 1:
        if args.model_parallel > 1:
            raise SystemExit("--model-parallel > 1 needs --world")
        return _train(args, resolve_device(args.device))[0]
    from repro_torch.launch.world import spawn_world

    device = resolve_device(args.device)
    backend = "gloo"
    if device.type == "cuda" and torch.cuda.device_count() >= args.world:
        backend = "nccl"  # a card a rank; ranks sharing a card use gloo
    return spawn_world(_world_rank, args.world, backend=backend,
                       args=(argv,), timeout=WORLD_TIMEOUT)


if __name__ == "__main__":
    main()
