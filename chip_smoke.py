#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero and prints
no result:

1. the card's name and power limit, torch and CUDA versions;
2. build every kernel of the main path from the sources in the checkout
   (nvcc, sm_90a) and print the build time and ptxas report;
3. hold each kernel against its plain PyTorch version on the card, TF32
   off, at the main path's shapes and at others (general stride, ragged
   N and rows), in every mode;
4. the main path: `VisionEngine` serving the full-width deploy-folded
   P²M-MobileNetV2 (`configs/p2m_vww.py::CONFIG`, 560², width 1.0,
   microbatch 8) with random weights from a seed, 24 SyntheticVWW
   requests with staggered arrivals through `drive()`; every request
   completes in order, the kernel launched once per engine launch, and
   each batch's probabilities equal the same forward with the plain stem;
5. times on the card (CUDA events, median of 25, L2 flushed between
   runs) of each kernel, its wrapper, its plain version and one library
   call computing the same function, beside the least time the card
   could take; the engine's time per launch, and its parts;
6. one JSON line ``{"kernels": [...]}``;
7. the card's name and power limit as nvidia-smi gives them, then the
   last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0
REPS = 25
# Published peaks of one H100 SXM at its full 700 W power limit
# (NVIDIA's data sheet, dense): HBM3 bytes/s, fp32 FLOP/s outside the
# tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
RAW_TOL = 1e-5
PROBS_TOL = 1e-4


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, flush) -> float:
    """Median device time of ``fn`` by CUDA events, L2 flushed before
    each run (the engine's caller finds it cold)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(torch, fn, flush) -> float:
    """Median host time of ``fn`` through its synchronize."""
    times = []
    for _ in range(REPS):
        flush.zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    from repro_torch.configs.p2m_vww import CONFIG, SERVE_MAX_BATCH
    from repro_torch.core.p2m_conv import apply_p2m_conv_deploy
    from repro_torch.data import SyntheticVWW
    from repro_torch.kernels import _build
    from repro_torch.kernels.p2m_conv import conv
    from repro_torch.models.mobilenetv2 import (
        apply_mnv2_backbone,
        apply_mnv2_stem,
        init_mnv2,
    )
    from repro_torch.serving import VisionEngine, VisionRequest, drive

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ------------------------------------------------------- phase 1
    smi = smi_line()
    print(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")

    # ------------------------------------------------------- phase 2
    t0 = time.perf_counter()
    conv.build_p2m_conv()
    seconds, report = _build.BUILD_INFO["p2m_conv"]
    print(f"[2] built p2m_conv.cu: nvcc {seconds:.2f} s, "
          f"{time.perf_counter() - t0:.2f} s with loading")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"    ptxas: {line.strip()}")

    # ------------------------------------------------------- phase 3
    gen = torch.Generator().manual_seed(SEED)
    params, bn = init_mnv2(gen, CONFIG, device=dev)
    engine = VisionEngine(params, bn, CONFIG, device=dev)
    cfg = CONFIG.p2m
    k, s, adc = cfg.kernel, cfg.stride, cfg.adc
    size = CONFIG.image_size
    B = SERVE_MAX_BATCH
    paper_imgs = torch.from_numpy(SyntheticVWW(
        image_size=size, batch=B, seed=SEED).batch_at(0)["images"]).to(dev)
    wrows = engine._deploy["wrows"]
    shift = engine._deploy["shift"].float().contiguous()
    rng = np.random.default_rng(SEED)

    def rand_case(b, h, w, c, kk, n):
        imgs = torch.from_numpy(rng.random((b, h, w, c), np.float32)).to(dev)
        wt = torch.from_numpy(rng.uniform(-0.4, 0.4, (kk * kk * c, n)).astype(
            np.float32))
        coeffs = tuple(tuple(float(v) for v in row)
                       for row in engine._pixel_model.coeffs)
        wr = conv.premix_rows(wt, coeffs, kk).to(dev)
        sh = torch.from_numpy(rng.uniform(-0.2, 0.2, n).astype(
            np.float32)).to(dev)
        return imgs, wr, sh

    general = rand_case(2, 64, 64, 3, 5, 8)
    ragged5 = rand_case(3, 37, 41, 3, 4, 5)
    ragged16 = rand_case(3, 37, 41, 3, 4, 16)
    cases = [  # name, inputs, kernel, stride, mode, want_raw
        ("paper raw", (paper_imgs, wrows, shift), k, s, "raw", False),
        ("paper relu", (paper_imgs, wrows, shift), k, s, "relu", False),
        ("paper quant", (paper_imgs, wrows, shift), k, s, "quant", False),
        ("paper quant+raw", (paper_imgs, wrows, shift), k, s, "quant", True),
    ]
    for mode in ("raw", "relu", "quant"):
        cases += [("k5 s3 " + mode, general, 5, 3, mode, True),
                  ("N5 ragged " + mode, ragged5, 4, 4, mode, True),
                  ("N16 ragged " + mode, ragged16, 4, 3, mode, True)]
    paper_err = 0.0
    for name, (x, wr, sh), kk, ss, mode, want_raw in cases:
        kw = dict(kernel=kk, stride=ss, mode=mode, v_lsb=adc.v_lsb,
                  max_count=adc.max_count)
        got = conv.p2m_conv_fused(x, wr, sh, want_raw=want_raw, **kw)
        torch.cuda.synchronize()
        out, raw = got if want_raw else (got, None)
        ref_out, ref_raw = conv.p2m_conv_premixed_plain(x, wr, sh,
                                                        want_raw=True, **kw)
        err = float((out - ref_out).abs().max())
        line = f"[3] {name:18s} {tuple(out.shape)} max_abs_err {err:.3e}"
        if raw is not None:
            raw_err = float((raw - ref_raw).abs().max())
            line += f" raw_err {raw_err:.3e}"
            check(raw_err <= RAW_TOL, f"{name}: raw differs by {raw_err}")
        if mode == "quant":
            rep = conv.quant_disagreement(out, ref_out, ref_raw, adc.v_lsb)
            line += (f" counts_differing {rep['n_diff']} "
                     f"(share {rep['share']:.2e}, max "
                     f"{rep['max_count_diff']:.0f})")
            check(rep["max_count_diff"] <= 1 and rep["share"] <= 1e-4
                  and rep["all_near_half"],
                  f"{name}: quant counts disagree: {rep}")
        else:
            check(err <= RAW_TOL, f"{name}: differs by {err}")
        if name.startswith("paper") and mode != "quant":
            paper_err = max(paper_err, err)
        if name.startswith("paper") and raw is not None:
            paper_err = max(paper_err, raw_err)
        print(line)

    # ------------------------------------------------------- phase 4
    n_req = 24
    data = SyntheticVWW(image_size=size, batch=n_req, seed=SEED + 1)
    images = data.batch_at(0)["images"]
    arrivals = [0] * 8 + [1] * 3 + [2] * 6 + [4] * 7
    reqs = [VisionRequest(uid=i, image=images[i], arrival_tick=t)
            for i, t in enumerate(arrivals)]
    conv.p2m_conv_fused.launches = 0
    t0 = time.perf_counter()
    drive(engine, reqs, on_undrained="raise")
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = conv.p2m_conv_fused.launches
    done = engine.completed
    check([r.uid for r in done] == list(range(n_req)),
          f"completion order {[r.uid for r in done]}")
    check(not engine.failed and not engine.evicted,
          f"failed {len(engine.failed)}, evicted {len(engine.evicted)}")
    check(launches == engine.stats["launches"] and launches > 0,
          f"kernel launches {launches} != engine launches "
          f"{engine.stats['launches']}")
    probs = np.stack([r.probs for r in done])
    check(probs.shape == (n_req, CONFIG.num_classes)
          and bool(np.isfinite(probs).all()), "probs not finite")
    batches: dict[int, list] = {}
    for r in done:
        batches.setdefault(r.served_tick, []).append(r)
    worst = 0.0
    for tick, group in sorted(batches.items()):
        x = np.zeros((B, size, size, 3), np.float32)
        for i, r in enumerate(group):
            x[i] = r.image
        plain = engine.forward(torch.from_numpy(x).to(dev),
                               p2m_impl="plain").cpu().numpy()
        diff = float(np.abs(plain[:len(group)] -
                            np.stack([r.probs for r in group])).max())
        worst = max(worst, diff)
        print(f"[4] tick {tick}: batch of {len(group)}, probs vs plain stem "
              f"max diff {diff:.3e}")
        check(diff <= PROBS_TOL, f"tick {tick}: probs differ by {diff}")
    # The stem against the patch-materializing reference conv (no premix).
    dep = engine._deploy
    stem_k = apply_p2m_conv_deploy(dep, paper_imgs, cfg, impl="cuda")
    stem_p = apply_p2m_conv_deploy(dep, paper_imgs, cfg, impl="patches")
    _, stem_raw = conv.p2m_conv_premixed_plain(
        paper_imgs, wrows, torch.zeros_like(shift), kernel=k, stride=s,
        mode="raw", want_raw=True)
    rep = conv.quant_disagreement(stem_k, stem_p, stem_raw, adc.v_lsb)
    print(f"[4] served {len(done)} requests in {engine.stats['launches']} "
          f"launches ({main_s:.2f} s), kernel launches {launches}; "
          f"stem vs patches reference: {rep['n_diff']} counts differ")
    check(rep["max_count_diff"] <= 1 and rep["share"] <= 1e-4
          and rep["all_near_half"], f"stem vs patches: {rep}")

    # ------------------------------------------------------- phase 5
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=dev)
    qkw = dict(kernel=k, stride=s, mode="quant", v_lsb=adc.v_lsb,
               max_count=adc.max_count)
    counted = conv.p2m_conv_fused.launches
    kernel_ms = cuda_ms(torch, lambda: conv.p2m_conv_fused(
        paper_imgs, wrows, shift, **qkw), flush)
    wrapper_ms = wall_ms(torch, lambda: conv.p2m_conv_fused(
        paper_imgs, wrows, shift, **qkw), flush)
    plain_ms = cuda_ms(torch, lambda: conv.p2m_conv_premixed_plain(
        paper_imgs, wrows, shift, **qkw), flush)
    conv.p2m_conv_fused.launches = counted  # timing launches are not the path's
    # Yardstick: one cuDNN conv over the power stack [x, x², x³] (NCHW),
    # which computes the raw accumulation.
    c = cfg.in_channels
    dx = wrows.shape[1] // (k * c)
    xs = paper_imgs.permute(0, 3, 1, 2)
    stack = torch.cat([xs, xs * xs, xs * xs * xs][:dx], dim=1).contiguous()
    wlib = (wrows.reshape(k, dx, k, c, -1).permute(4, 1, 3, 0, 2)
            .reshape(-1, dx * c, k, k).contiguous())
    lib_raw = torch.nn.functional.conv2d(stack, wlib, stride=s)
    _, ker_raw = conv.p2m_conv_fused(paper_imgs, wrows, shift, want_raw=True,
                                     **qkw)
    conv.p2m_conv_fused.launches = counted
    lib_err = float((lib_raw.permute(0, 2, 3, 1) - ker_raw).abs().max())
    check(lib_err <= 1e-4, f"library yardstick computes another function "
          f"({lib_err})")
    library_ms = cuda_ms(torch, lambda: torch.nn.functional.conv2d(
        stack, wlib, stride=s), flush)
    n = wrows.shape[2]
    ho = wo = cfg.out_spatial(size)
    m = B * ho * wo
    bytes_moved = 4 * (paper_imgs.numel() + wrows.numel() + shift.numel()
                       + m * n)
    flops = 2 * m * k * wrows.shape[1] * n
    bound_bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    bound_ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    bound_by = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"
    print(f"[5] p2m_conv_fused at ({B},{size},{size},3) k=s={k} N={n} quant: "
          f"kernel {kernel_ms:.4f} ms, wrapper {wrapper_ms:.4f} ms (host), "
          f"plain {plain_ms:.4f} ms, library conv2d {library_ms:.4f} ms "
          f"(raw err {lib_err:.1e}); bound {bound_ms:.4f} ms by {bound_by} "
          f"({bytes_moved} bytes -> {bound_bytes_ms:.4f} ms, {flops} FLOP "
          f"-> {bound_ops_ms:.4f} ms)")
    # Engine time per launch, warm: five full microbatches.
    before_l, before_us = engine.stats["launches"], engine.stats["wall_us"]
    warm = [VisionRequest(uid=100 + i, image=images[i % n_req])
            for i in range(5 * B)]
    drive(engine, warm, on_undrained="raise")
    n_launch = engine.stats["launches"] - before_l
    engine_ms = (engine.stats["wall_us"] - before_us) / n_launch / 1e3
    first_ms = engine.completed[0].launch_wall_us / 1e3
    print(f"[5] engine: {engine_ms:.3f} ms per launch of {B} images "
          f"(warm, {n_launch} launches); first launch {first_ms:.3f} ms")
    # Where a warm launch goes, each part timed alone as `_launch` runs
    # it: the host assembles the batch and copies it to the card, then
    # the stem and the backbone run.
    def batch_to_card():
        x = np.zeros((B, size, size, 3), np.float32)
        for i in range(B):
            x[i] = images[i]
        return torch.from_numpy(x).to(dev)

    host_ms = wall_ms(torch, batch_to_card, flush)
    xdev = batch_to_card()
    with torch.inference_mode():
        stem_out, _ = apply_mnv2_stem(engine._params, engine._bn, xdev,
                                      CONFIG, p2m_deploy=engine._deploy)
        stem_ms = cuda_ms(torch, lambda: apply_mnv2_stem(
            engine._params, engine._bn, xdev, CONFIG,
            p2m_deploy=engine._deploy), flush)
        backbone_ms = cuda_ms(torch, lambda: apply_mnv2_backbone(
            engine._params, engine._bn, stem_out, CONFIG), flush)
    conv.p2m_conv_fused.launches = counted
    print(f"[5] launch parts: host batch + copy {host_ms:.3f} ms, stem "
          f"{stem_ms:.3f} ms, backbone {backbone_ms:.3f} ms (device, "
          f"launch gaps included); sum "
          f"{host_ms + stem_ms + backbone_ms:.3f} of {engine_ms:.3f} ms")

    # ------------------------------------------------------- phase 6
    kernels = [{
        "name": "p2m_conv_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/p2m_conv/csrc/p2m_conv.cu",
        "replaces": "src/repro/kernels/p2m_conv/conv.py:466",
        "launches": launches,
        "max_abs_err": paper_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
