"""Serving driver, LM path; port of the single-engine part of
`repro.launch.serve`:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
      --smoke --device cpu --requests 12 --max-batch 4 --prefill-chunk 8

Serves random prompts through `ServeEngine` on random weights from seed 0,
float32 (as the reference's driver runs it), on the GPU unless
``--device`` names another.  ``--mixed`` (the front door routing LM and
vision traffic) is not ported yet.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.families import get_family
from repro_torch.serving import Request, ServeEngine
from repro_torch.serving.vision import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--prefill-chunk", type=int, default=1,
                    help=">1 enables the chunked-prefill fast path")
    ap.add_argument("--device", default=None,
                    help="torch device; default the GPU")
    ap.add_argument("--mixed", action="store_true",
                    help="route a mixed LM + vision stream via the front "
                         "door (not ported yet)")
    args = ap.parse_args(argv)
    if args.mixed:
        raise SystemExit("--mixed needs the front door, which is not "
                         "ported yet")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(dtype=torch.float32)
    family = get_family(cfg)
    device = resolve_device(args.device)
    params, _ = family.init(torch.Generator(device).manual_seed(0), cfg)
    engine = ServeEngine(params, cfg, max_batch=args.max_batch,
                         max_len=args.max_len,
                         prefill_chunk=args.prefill_chunk, device=device)

    rng = np.random.default_rng(0)
    reqs = []
    for uid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, rng.integers(4, 12)).tolist()
        reqs.append(Request(uid=uid, prompt=prompt,
                            max_new_tokens=args.max_new_tokens))

    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    done = engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.output) for r in done)
    print(f"served {len(done)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens/dt:.1f} tok/s) on {device}")
    for r in done[:4]:
        print(f"  req {r.uid}: prompt[:4]={r.prompt[:4]} → out[:8]={r.output[:8]}")


if __name__ == "__main__":
    main()
