#!/usr/bin/env python3
"""Time the pipelined P²M conv (B2) at other pixels a thread, on one GPU.

    python3 b2_probe.py [--pixels 1,2,4]

For each value P, copies this checkout's ``src/repro_torch`` under
``src/repro_torch/kernels/.build/probe/`` with the constant
``kPipePixels`` of ``csrc/p2m_conv.cu`` (the pixels a B2 thread computes
at an N tile of 8) set to P, and runs the copy in a process of its own.
There it builds ``p2m_conv.cu``, prints ptxas's line for the served
instantiation, holds B2 to B1 bit for bit at the serving shape (``out``
and ``raw``, every depth and block_h timed), and times B2 beside B1 as
`chip_smoke.py` phase 9 does: its shapes and modes (`b2_shapes`), its
turns (`time_b2_shape`), block_h 1, 2, 4 x depths 2, 3, with the launch
at each shape's fastest setting.  Inputs are random from a seed, the
weights premixed with the default pixel model.

Prints one line a shape and variant, and one JSON object a variant.
Exits non-zero without a CUDA device, or if a variant's B2 differs from
its B1.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PACKAGE = ROOT / "src" / "repro_torch"
PROBE_DIR = PACKAGE / "kernels" / ".build" / "probe"
SEED = 7
BLOCK_HS = (1, 2, 4)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pixels", default="1,2,4",
                        help="comma-separated values of kPipePixels")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("b2_probe: no CUDA device is available", file=sys.stderr)
        return 2
    failed = False
    for pixels in (int(p) for p in args.pixels.split(",")):
        tree = PROBE_DIR / f"pixels{pixels}"
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(PACKAGE, tree / "repro_torch", ignore=shutil
                        .ignore_patterns(".build", "__pycache__"))
        source = tree / "repro_torch" / "kernels" / "p2m_conv" / "csrc" \
            / "p2m_conv.cu"
        text, n = re.subn(r"constexpr int kPipePixels = \d+;",
                          f"constexpr int kPipePixels = {pixels};",
                          source.read_text())
        if n != 1:
            raise RuntimeError("p2m_conv.cu has no one kPipePixels constant")
        source.write_text(text)
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(tree)] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
        proc = subprocess.run(
            [sys.executable, "-c", "import sys, b2_probe; "
             f"sys.exit(b2_probe.time_variant({pixels}, {str(tree)!r}))"],
            cwd=ROOT, env=env)
        failed |= proc.returncode != 0
    return 1 if failed else 0


def time_variant(pixels: int, tree: str) -> int:
    """In a process whose ``repro_torch`` is the copy under ``tree``:
    build it, check B2 against B1, time it.  Returns the exit code."""
    import numpy as np
    import torch

    from repro_torch.core.pixel_model import default_pixel_model
    from repro_torch.kernels import _build
    from repro_torch.kernels.p2m_conv import conv
    from repro_torch.kernels.p2m_conv.ops import _coeff_tuple

    import chip_smoke

    if not Path(conv.__file__).resolve().is_relative_to(Path(tree)):
        raise RuntimeError(f"imported {conv.__file__}, not the copy under "
                           f"{tree}")
    label = f"kPipePixels={pixels}"
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    conv.build_p2m_conv()
    seconds, report = _build.BUILD_INFO["p2m_conv"]
    print(f"[probe] {label}: {chip_smoke.smi_line()}; p2m_conv.cu built in "
          f"{seconds:.1f} s")
    for line in chip_smoke.ptxas_summary(report):
        if "pipelined_kernel<3, 1>" in line:
            print(f"    ptxas: {line}")

    from repro_torch.configs.p2m_vww import CONFIG, SERVE_MAX_BATCH

    adc = CONFIG.p2m.adc
    rng = np.random.default_rng(SEED)
    kk = 5 * 5 * 3
    wt = torch.from_numpy((rng.uniform(-1, 1, (kk, 8)) * (3.0 / kk) ** 0.5)
                          .astype(np.float32))
    wrows = conv.premix_rows(wt, _coeff_tuple(default_pixel_model()),
                             5).to(dev)
    shift = torch.from_numpy(rng.uniform(-0.2, 0.2, 8).astype(
        np.float32)).to(dev)
    images = torch.from_numpy(rng.random(
        (SERVE_MAX_BATCH, CONFIG.image_size, CONFIG.image_size, 3),
        np.float32)).to(dev)
    shapes = chip_smoke.b2_shapes(torch, np, dev, (images, wrows, shift))
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=dev)

    failed = False
    result = {"variant": label, "shapes": {}}
    for name, ((x, wr, sh), mode, _) in shapes.items():
        qkw = dict(kernel=5, stride=5, mode=mode, v_lsb=adc.v_lsb,
                   max_count=adc.max_count)
        if name.startswith("serving"):
            want = conv.p2m_conv_fused(x, wr, sh, want_raw=True, **qkw)
            for depth in (2, 3):
                for bh in BLOCK_HS:
                    got = conv.p2m_conv_fused(x, wr, sh, block_h=bh,
                                              pipeline_depth=depth,
                                              want_raw=True, **qkw)
                    if not all(torch.equal(g, w) for g, w in zip(got, want)):
                        print(f"[probe] {label}: B2 (block_h {bh}, depth "
                              f"{depth}) differs from B1", file=sys.stderr)
                        failed = True
        times, b1 = chip_smoke.time_b2_shape(torch, flush, (x, wr, sh), qkw,
                                             BLOCK_HS)
        best = min(times, key=times.get)
        geo = conv.pipelined_launch(tuple(x.shape), 8, 3, kernel=5,
                                    stride=5, block_h=best[0],
                                    pipeline_depth=best[1])
        print(f"[probe] {label} {name} {mode}: B1 {b1[0]:.4f}, {b1[1]:.4f} "
              f"ms; B2 (block_h, depth) " + ", ".join(
                  f"{k} {v:.4f}" for k, v in times.items())
              + f" ms; at {best}: {geo['pixels_per_thread']} px, "
              f"{geo['threads']} threads, {geo['registers']} regs, "
              f"{geo['local_bytes']} local B, {geo['blocks_per_sm']} blocks "
              f"an SM")
        result["shapes"][name] = {
            "mode": mode, "b1_ms_in_turns": b1,
            "ms_by_block_h_depth": {f"{k[0]},{k[1]}": v
                                    for k, v in times.items()},
            "best": list(best), "launch_at_best": geo}
    print(json.dumps(result))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
