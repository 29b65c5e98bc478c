"""Training launcher, LM path; port of `repro.launch.train` on one device:

  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \\
      --smoke --device cpu --steps 5

Wires config → data pipeline → optimizer → train step → `Trainer`
(checkpointing, straggler monitor, restart), as the reference does,
float32 as the reference's launcher casts it, on random weights from seed
0 drawn on a generator on the device.  It runs on the GPU unless
``--device`` names another.  The step updates the state in place
(`train/step.py`), the counterpart of the reference's donated jit.
``--model-parallel`` above 1 needs scale-out, which is not ported yet.
"""
from __future__ import annotations

import argparse

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


def main(argv=None) -> Trainer:
    """Train as the flags say; returns the `Trainer`, whose ``history``
    and ``state`` a caller can read."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", choices=["int8_ef"], default=None)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device; default the GPU")
    args = ap.parse_args(argv)
    if args.model_parallel > 1:
        raise SystemExit("--model-parallel > 1 needs A12 (scale-out), "
                         "which is not ported yet")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(dtype=torch.float32)
    family = get_family(cfg)
    device = resolve_device(args.device)

    dataset = SyntheticLMDataset(vocab=cfg.vocab, seq_len=args.seq,
                                 batch=args.batch)
    pipeline = DataPipeline(dataset,
                            transform=build_batch_transform(cfg, args.batch,
                                                            args.seq),
                            device=device)

    optimizer = adamw(cosine_warmup(args.lr, warmup=20, total=args.steps))
    params, _ = family.init(torch.Generator(device).manual_seed(0), cfg)
    extras = None
    if args.grad_compression == "int8_ef":
        # the accumulator from the start, so every checkpoint has it
        extras = {"ef_error": tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)}
    state = TrainState(params, optimizer.init(params), extras=extras)
    step = make_train_step(cfg, optimizer, accum_steps=args.accum,
                           grad_compression=args.grad_compression)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    trainer = Trainer(step, state, pipeline, ckpt_manager=ckpt,
                      ckpt_every=args.ckpt_every if ckpt else 0)
    try:
        if ckpt is not None and trainer.restore():
            print(f"resumed from step {trainer.state['step']}")
        final = trainer.run(args.steps)
    finally:
        pipeline.close()
    print(f"final: {final}")
    return trainer


if __name__ == "__main__":
    main()
