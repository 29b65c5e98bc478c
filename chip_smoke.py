#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero and prints
no result:

1. the card's name and power limit, torch and CUDA versions;
2. build every kernel of the main paths from the sources in the checkout
   (one nvcc per source, started together; sm_90a) and print the build
   times and ptxas reports;
3. hold the forward conv kernel (B1) against its plain PyTorch version on
   the card, TF32 off, at the serving shapes and at others (general
   stride, ragged N and rows), in every mode;
3b. hold the gated stem kernel (B5), both its bodies (B1's at depth 0,
   the gated ring of B2 at depths 2 and 3, block_h 1, 2, 4), against B1
   followed by `torch.where` and against the dense kernel at the same
   blocks followed by it, bit for bit, and against its plain version,
   over masks (all re-run, all skip, mixed, one slot), at the stream
   shape, at s < k and at Ho = 1, in every mode;
3c. hold the chunked WKV kernel (B7) against its plain version at the LM
   serving tick's shape (8, 64, 40, 64), at S in {1, 15, 17, 100} x D
   in {16, 64}, at S = 0 and 64, at D = 33, and on unaligned views (also
   bitwise equal to the aligned inputs' result), from a random initial
   state, within 1e-4 of the largest |plain|; a row whose lw and k are
   all zero keeps its state bit for bit;
3d. hold the pipelined conv (B2, `p2m_conv_fused(pipeline_depth>=2)`)
   against B1 bit for bit, `out` and `raw`, at depths 2, 3 and 8 (clamped
   to k) x block_h 1, 2, 4, in every mode, at the serving, stream and
   training shapes and over random geometries (s < k, N in {5, 8, 24},
   dx 1-4), one line per shape and mode;
3e. at the training shape, the gradients through `ops.p2m_conv` with
   pipeline_depth 2 and 0 are equal bit for bit;
3f. the tuner at the serving, stream and training signatures: its first
   call's time, each candidate's shared memory and time, the winner; no
   candidate may fail;
3g. hold the P²M product (B6) against its plain twin at (100,352, 75, 8)
   and (4096, 147, 32) in every mode, and `ops.p2m_matmul`'s gradients
   (B6, B3, B4) against float64 autograd of `p2m_matmul_plain`;
4. hold the backward kernels (B3 dX, B4 dW) against their plain versions
   in float64 over conv geometries (s < k, ragged M and N, dx = 1..4)
   and at the training shape;
5. the serving path: `VisionEngine` serving the full-width deploy-folded
   P²M-MobileNetV2 (`configs/p2m_vww.py::CONFIG`, 560², width 1.0,
   microbatch 8) with random weights from a seed, 24 SyntheticVWW
   requests with staggered arrivals through `drive()`; every request
   completes in order, B1 launched once per engine launch, and each
   batch's probabilities equal the same forward with the plain stem;
   the stem is B1 or B2, as the tuner picked;
5d. the patch-level path: the serving batch's patches through
   `ops.p2m_matmul` (B6, quant), held to the deploy stem by the count
   rule, with its gradients through B3 and B4;
5e. B2 inside an engine: the 24 requests served again with a depth-0
   (B1) and then a depth-2 (B2) winner in the tuner's cache entry of the
   serving signature; the two passes' probabilities equal bit for bit;
5b. the streaming path: `StreamEngine` on `CONFIG` with 4 slots, a
   detection head from a seed, six hold-2 `SyntheticVideo` streams of
   12, 8, 12, 6, 12 and 10 frames at 560² (the 6-frame one noisy), on the
   gated stem (the default on the card), on the where stem and dense
   (``threshold=None``); gated == where and gated == dense bit for bit,
   the measured skip rate and bandwidth reduction exact, B5 once a tick
   on the body of the tuner's depth for the engines' stem signature (the
   ring at depth >= 2) and no B1 or B2 on the gated engine, B1 or B2 once
   a tick on the where engine; a NaN cache forces its slot to re-run and
   drops its gate to dense;
5c. the LM path: RWKV-6 3B (`configs/rwkv6_3b.py::CONFIG`, 32 layers,
   d_model 2560, float32) with random weights from a seed, served through
   `ServeEngine` (8 slots, max_len 512, chunked prefill 64): 16
   SyntheticLMDataset prompts of 24-150 tokens with staggered arrivals,
   16 new tokens each, through `drive()`; every request completes, B7
   launches 32 times on each prefill tick and never on a decode tick; the
   first prefill tick replayed with each layer's B7 call held against the
   plain WKV on the same inputs (within 1e-4 of the largest |plain|); that
   tick's logits with B7 within the model's own float32 spread of those
   with the plain WKV (the spread: the largest difference among the
   plain WKV, the per-token scan and a float64 run, which at full depth is
   1e-2 of the logits); the tokens equal a plain-WKV run's, or first differ
   at a near-tie (top-2 margin within that spread); then `SessionEngine`:
   4 sessions of 3 turns on 4 slots, all complete, B7 on every turn
   prefill;
5f. the port's repaired faults: a prompt token ``padded_vocab`` fails
   only its request (SMOKE rwkv), and the engine serves the next; every
   kernel wrapper raises on an input that requires grad under grad mode;
5g. LM training: (a) the WKV autograd Function (B7 forward, the
   closed-form backward) at (8, 64, 40, 64) from a nonzero state with both
   cotangents, its outputs and six gradients within 1e-4 of the largest
   |value| of float64 autograd of the plain twin; (b) RWKV-6 3B's first
   two layers at full width, batch 8 x 128: every gradient leaf through
   B7 within 1e-3 of the leaf's largest |value| through the plain WKV
   (both float32); (c) `launch/train.py`'s ``main`` for RWKV-6 3B at full
   width and depth, float32, AdamW in place, 3 steps at 8 x 128 (the
   served weights freed first): every loss finite, the moments finite
   (so every gradient was), B7 twice a layer a step (forward and remat
   recompute), the step's time by the host clock through a synchronize,
   tokens/s and the peak memory beside the card's name and power limit,
   then the step's parts by CUDA events (forward, forward + backward, a
   layer's recompute, B7, the closed-form WKV backward, head + CE, the
   in-place AdamW); (d) at SMOKE, 4 steps with checkpoints, a fresh run
   that restores and takes 2 more: the losses equal one 6-step run's bit
   for bit;
6. the training path: 6 steps of `make_vww_train_step` on `CONFIG` at
   batch 32 with the paper's `sgd(step_decay(...), momentum=0.9)`; every
   loss finite, each step launches B1 or B2 (as tuned), B3 and B4
   exactly once;
7. the first step's gradients (cuDNN deterministic): the CUDA step
   twice gives the same bits; the conv's backward through B3 and B4
   equals autograd through the plain conv on the step's own cotangent;
   the step with the plain conv has the same loss; the rest of the two
   steps' differences, and the network's own reach (the CUDA step with
   its stem output moved by as much), are reported;
8. the trained model folded and 8-bit quantized (`deploy_params`,
   `quantize_deploy`) and served: 8 requests through `VisionEngine`; the
   served stem against the plain stem by the count rule, the
   probabilities against the plain stem's where no count differs;
9. times on the card (CUDA events, median of 25, L2 flushed between
   runs) of each kernel, its plain version and one library call beside
   the least time the card could take (B5 at skip shares 0, 1/2, 1, its
   ring at the engine's blocks and its B1 body in turns, beside the dense
   B2 at those blocks over 4, 1 and 2 images, one `amax` read of the
   images and one launch that writes 4 bytes, with the ring's launch,
   which must spill nothing; B2
   at depths 2 and 3 x block_h in turns with B1 at the serving, stream
   and training shapes, each with its launch: pixels a thread, threads,
   blocks an SM, registers and local bytes, none spilled, one read of
   the images by `amax` and the library conv; B1's launch (tiles, tile
   pixels, blocks, threads, shared memory, blocks an SM, registers and
   local bytes, which must be 0) beside one `amax` read of the images;
   B6 with its tuned blocks and its launch (tiles, rows a thread, ring
   slots, blocks, registers, local bytes 0) beside one `amax` read of x;
   B4's two passes apart, by the profiler, and its launch:
   blocks, threads, shared memory, registers, blocks an SM and local
   bytes, which must be 0);
   the vision engine's time per launch and its parts; the stream
   engines' time per tick and its parts; the train step's time and its
   parts; B7 at the serving tick's shape (with its launch geometry:
   blocks, threads, shared memory and its one ring depth), and the LM
   engine's time per prefill and per decode tick with their parts;
10. one JSON line ``{"kernels": [...]}`` (B1-B7);
11. the card's name and power limit as nvidia-smi gives them, then the
    last line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --b4`` runs phases 1, 4 and B4's times alone
(`b4_only`), ``python3 chip_smoke.py --b1b6`` phase 1, the builds of
B1's and B6's sources and their checks and times alone (`b1b6_only`),
each on this tree or, copied into its root, on an older one;
``python3 chip_smoke.py --lm-train`` phase 1, the build of ``wkv.cu``
and phase 5g alone (`lm_train_only`).
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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


def ptxas_summary(report: str) -> list[str]:
    """One line a kernel from nvcc's ``-Xptxas -v`` report: its name
    (demangled where the toolkit's ``cu++filt`` is found), its registers,
    shared memory and its stack frame and spills."""
    import re
    import shutil

    filt = (shutil.which("cu++filt") or shutil.which("c++filt")
            or next((str(p) for p in [Path("/usr/local/cuda/bin/cu++filt")]
                     if p.exists()), None))
    out, name, frame = [], "?", ""
    for line in report.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            name, frame = found.group(1), ""
            if filt:
                proc = subprocess.run([filt, name], capture_output=True,
                                      text=True, timeout=60)
                full = re.sub(r"\(anonymous namespace\)::|<unnamed>::|"
                              r"\((?:int|bool)\)", "", proc.stdout.strip())
                name = full.split("(")[0].removeprefix("void ") or name
        elif "stack frame" in line:
            frame = line.strip()
        elif "registers" in line:
            used = line.split(":", 1)[-1].strip()
            out.append(f"{name}: {used}; {frame}")
    return out


def cuda_ms(torch, fn, flush, reps=REPS) -> float:
    """Median device time of ``fn`` by CUDA events over ``reps`` runs, L2
    flushed before each run (the engine's caller finds it cold)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
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


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time (ms) the card could take: the larger of bytes over the
    memory rate and FLOPs over the fp32 rate, and which of them it is."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def bwd_inputs(torch, np, dev, images, k, s, n, coeffs, seed):
    """(g, w, x) for the backward kernels: x the im2col matrix of
    ``images``, w (K, N) weights off 0, g (M, N) a random cotangent."""
    from repro_torch.kernels.p2m_conv import conv
    rng = np.random.default_rng(seed)
    x = conv.im2col_matrix(images, k, s).contiguous()
    m, kk = x.shape
    w = rng.uniform(0.05, 1.0, (kk, n)) * rng.choice([-1.0, 1.0], (kk, n))
    g = rng.standard_normal((m, n))
    return (torch.from_numpy(g.astype(np.float32)).to(dev),
            torch.from_numpy(w.astype(np.float32)).to(dev), x)


def check_backward_kernels(torch, np, dev):
    """Phase 4: B3 and B4 against their plain twins in float64, max abs
    error within 1e-4 of the largest |plain|.  Returns the errors at the
    training shape and that shape's inputs."""
    from repro_torch.configs.p2m_vww import CONFIG, TRAIN_BATCH
    from repro_torch.core.p2m_conv import _flat_weights, init_p2m_conv
    from repro_torch.core.pixel_model import default_pixel_model
    from repro_torch.data import SyntheticVWW
    from repro_torch.kernels.p2m_conv import backward, conv
    from repro_torch.kernels.p2m_conv.ops import _coeff_tuple

    rng = np.random.default_rng(SEED + 7)

    def rand_coeffs(dw, dx):
        return tuple(tuple(float(v) for v in rng.uniform(-1, 1, dx))
                     for _ in range(dw))

    def rand_images(b, h, w, c):
        return torch.from_numpy(rng.random((b, h, w, c), np.float32)).to(dev)

    cases = [  # name, (B, H, W, C), k, s, N, coeffs
        ("k5 s3 N8 dx3", (2, 64, 64, 3), 5, 3, 8, rand_coeffs(3, 3)),
        ("k4 s4 N5 ragged", (3, 37, 41, 3), 4, 4, 5, rand_coeffs(3, 3)),
        ("k5 s5 N13 dx1", (1, 50, 50, 3), 5, 5, 13, rand_coeffs(2, 1)),
        ("k3 s2 N16 dx2", (2, 33, 30, 3), 3, 2, 16, rand_coeffs(3, 2)),
        ("k5 s5 N40 dx4", (1, 40, 40, 3), 5, 5, 40, rand_coeffs(4, 4)),
    ]
    cfg = CONFIG.p2m
    coeffs = _coeff_tuple(default_pixel_model())
    train_imgs = torch.from_numpy(SyntheticVWW(
        image_size=CONFIG.image_size, batch=TRAIN_BATCH,
        seed=SEED).batch_at(0)["images"]).to(dev)
    w_train = _flat_weights(init_p2m_conv(torch.Generator().manual_seed(SEED),
                                          cfg, device=dev)["theta"], cfg)
    errs = {}
    for i, (name, shape, kk, ss, n, cf) in enumerate(
            cases + [("training shape", None, cfg.kernel, cfg.stride,
                      cfg.out_channels, coeffs)]):
        if shape is None:
            g, _, x = bwd_inputs(torch, np, dev, train_imgs, kk, ss, n, cf,
                                 SEED)
            w = w_train.contiguous()
        else:
            g, w, x = bwd_inputs(torch, np, dev, rand_images(*shape), kk, ss,
                                 n, cf, SEED + i)
        wmix = conv.premix_weights(w, cf)
        gx = backward.p2m_bwd_dx(g, wmix, x, cf)
        gw = backward.p2m_bwd_dw(g, w, x, cf)
        torch.cuda.synchronize()
        ref_x = backward.p2m_bwd_dx_plain(g.double(), wmix.double(),
                                          x.double())
        ref_w = backward.p2m_bwd_dw_plain(g.double(), w.double(), x.double(),
                                          cf)
        again = backward.p2m_bwd_dw(g, w, x, cf)
        line = f"[4] {name:16s} M={x.shape[0]} K={x.shape[1]} N={n} " \
               f"dw={len(cf)} dx={len(cf[0])}:"
        for key, got, ref in (("p2m_bwd_dx", gx, ref_x),
                              ("p2m_bwd_dw", gw, ref_w)):
            err = float((got.double() - ref).abs().max())
            scale = float(ref.abs().max())
            line += f" {key} err {err:.3e} (of {scale:.3e})"
            check(err <= 1e-4 * scale, f"{name}: {key} differs by {err}, "
                  f"more than 1e-4 of {scale}")
            if shape is None:
                errs[key] = err
        check(torch.equal(gw, again), f"{name}: B4 differs from run to run")
        print(line)
    return errs, {"g": g, "w": w, "wmix": wmix, "x": x, "coeffs": coeffs}


def train_path(torch, np, dev):
    """Phase 6: the training path at full width.  Returns what the later
    phases read."""
    from repro_torch.configs.p2m_vww import CONFIG, TRAIN_BATCH
    from repro_torch.data import SyntheticVWW
    from repro_torch.kernels.p2m_conv import backward, conv
    from repro_torch.models.mobilenetv2 import init_mnv2
    from repro_torch.optim import sgd, step_decay
    from repro_torch.train.vision import make_vww_train_step, vww_train_state

    steps = 6
    params, bn = init_mnv2(torch.Generator().manual_seed(SEED), CONFIG,
                           device=dev)
    # the example's recipe: lr 0.05, x0.2 at 60 % and 85 % of the steps
    opt = sgd(step_decay(0.05, (int(steps * 0.6), int(steps * 0.85))),
              momentum=0.9)
    state = init_state = vww_train_state(params, bn, opt.init(params))
    step = make_vww_train_step(CONFIG, opt)
    data = SyntheticVWW(image_size=CONFIG.image_size, batch=TRAIN_BATCH,
                        seed=SEED)
    batches = [data.batch_at(i) for i in range(steps)]  # set-up, untimed
    wrappers = {"p2m_bwd_dx": backward.p2m_bwd_dx,
                "p2m_bwd_dw": backward.p2m_bwd_dw}

    def counts():
        return {**stem_launches(conv),
                **{k: fn.launches for k, fn in wrappers.items()}}

    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    reset_stem_launches(conv)
    ms, losses = [], []
    for i, batch in enumerate(batches):
        before = counts()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        loss = float(metrics["loss"])
        losses.append(loss)
        check(np.isfinite(loss), f"step {i}: loss {loss}")
        now = counts()
        diff = {k: now[k] - before[k] for k in now}
        # the stem's forward is B1 or B2, as the tuner picked
        check(diff["p2m_bwd_dx"] == diff["p2m_bwd_dw"] == 1
              and diff["p2m_conv_fused"]
              + diff["p2m_conv_fused_pipelined"] == 1,
              f"step {i}: launches {diff}")
        print(f"[6] step {i}: loss {loss:.4f} acc "
              f"{float(metrics['acc']):.3f} {ms[-1]:.1f} ms")
    launches = counts()
    check(launches["p2m_bwd_dx"] == launches["p2m_bwd_dw"] == steps,
          f"training launches {launches}")
    check(state["step"] == steps, f"state step {state['step']}")
    step_ms = statistics.median(ms[1:])
    print(f"[6] trained {steps} steps at batch {TRAIN_BATCH}, "
          f"{CONFIG.image_size}² width {CONFIG.width}: {step_ms:.2f} ms per "
          f"step (median of steps 2-{steps}, host clock through "
          f"synchronize), {TRAIN_BATCH / step_ms * 1e3:.1f} images/s; first "
          f"step {ms[0]:.1f} ms; launches {launches}")
    return {"state": state, "init_state": init_state, "batch": batches[0],
            "opt": opt,
            "launches": launches, "step_ms": step_ms, "losses": losses}


def grad_parity(torch, train):
    """Phase 7: gradients of the first step, the stem's conv on its CUDA
    kernels and on its plain PyTorch version (cuDNN deterministic).

    Held: (a) the CUDA step twice gives the same bits; (b) the conv's
    backward, B3 and B4 through `P2MConvFunction`, equals autograd through
    the plain conv on the step's own cotangent of the conv's output,
    within 1e-4 of the largest gradient; (c) the two steps' losses within
    1e-5.  Reported: the rest of the two steps' differences, and the same
    step with the CUDA stem's output moved by as much as the two convs
    differ, which shows how far the network itself carries such a
    difference."""
    from repro_torch.configs.p2m_vww import CONFIG
    from repro_torch.core import p2m_conv as core
    from repro_torch.core.pixel_model import default_pixel_model
    from repro_torch.models.mobilenetv2 import apply_mnv2_backbone
    from repro_torch.train.vision import _batch_to, softmax_ce
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    state, batch = train["init_state"], train["batch"]
    params, bn = state["params"], state["bn"]
    cfg, model = CONFIG.p2m, default_pixel_model()
    images, labels = _batch_to(batch, params["fc"]["w"].device)
    backbone = {k: v for k, v in params.items() if k != "stem"}

    def step(impl, nudge=None):
        """Loss, backbone grads, the stem output and its cotangent, the
        conv output's cotangent and the stem's grads: the train form
        written out (`core.apply_p2m_conv_train`'s ops) so that the conv's
        output is at hand."""
        theta = params["stem"]["theta"].detach().requires_grad_(True)
        gamma = params["stem"]["bn_gamma"].detach().requires_grad_(True)
        beta = params["stem"]["bn_beta"].detach().requires_grad_(True)
        raw = core._conv_raw(images, core._flat_weights(theta, cfg), cfg,
                             model, impl)
        flat = raw.reshape(-1, cfg.out_channels)
        mean, var = flat.mean(dim=0), flat.var(dim=0, correction=0)
        y = core.clip(gamma * (flat - mean) / torch.sqrt(var + cfg.bn_eps)
                      + beta, 0.0, cfg.adc.full_scale).reshape(raw.shape)
        x = y.detach() if nudge is None else y.detach() + nudge
        x.requires_grad_(True)
        live = [p.detach().requires_grad_(True) for p in tree_leaves(backbone)]
        tree = tree_unflatten(backbone, live)
        feats, _ = apply_mnv2_backbone(tree, bn, x, CONFIG, train=True)
        loss = softmax_ce(feats.mean(dim=(1, 2)) @ tree["fc"]["w"]
                          + tree["fc"]["b"], labels)
        *g_rest, g_x = torch.autograd.grad(loss, live + [x])
        g_raw, *g_stem = torch.autograd.grad(y, [raw, theta, gamma, beta],
                                             g_x)
        return {"loss": float(loss.detach()), "y": y.detach(), "g_x": g_x,
                "g_raw": g_raw, "rest": tree_unflatten(backbone, g_rest),
                "stem": dict(zip(("theta", "bn_gamma", "bn_beta"), g_stem))}

    def diff(a, b):
        return float((a - b).abs().max()), float(b.abs().max())

    def rel_tree(a, b):
        # per leaf, relative to its own scale, with a floor at float32
        # rounding of the largest gradient for leaves whose exact gradient
        # is 0 (the BN shift before a BN on batch statistics)
        top = max(float(t.abs().max()) for t in tree_leaves(b))
        rel = []
        tree_map(lambda u, v: rel.append(float((u - v).abs().max()) / (
            float(v.abs().max()) + 1e-7 * top)), a, b)
        return max(rel)

    def report(name, a, b):
        print(f"[7] {name}: loss {abs(a['loss'] - b['loss']):.3e} of "
              f"{b['loss']:.4f}; stem output %.3e of %.3e; its cotangent "
              f"%.3e of %.3e; backbone grads largest relative diff "
              f"{rel_tree(a['rest'], b['rest']):.3e}; stem grads " % (
                  *diff(a["y"], b["y"]), *diff(a["g_x"], b["g_x"]))
              + ", ".join(f"{k} %.3e of %.3e" % diff(a["stem"][k],
                                                      b["stem"][k])
                          for k in a["stem"]))

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cuda, again, plain = step("cuda"), step("cuda"), step("plain")
    # (a) the same bits from the same step
    same = (cuda["loss"] == again["loss"]
            and all(torch.equal(u, v) for u, v in zip(
                tree_leaves(cuda["rest"]), tree_leaves(again["rest"])))
            and all(torch.equal(cuda["stem"][k], again["stem"][k])
                    for k in cuda["stem"]))
    print(f"[7] the CUDA step twice: bitwise equal {same}")
    check(same, "the CUDA step is not deterministic")
    # (b) the conv's backward on the step's own cotangent
    w = core._flat_weights(params["stem"]["theta"], cfg).detach()
    for impl in ("cuda", "plain"):
        im = images.detach().requires_grad_(True)
        ww = w.clone().requires_grad_(True)
        raw = core._conv_raw(im, ww, cfg, model, impl)
        if impl == "cuda":
            got = torch.autograd.grad(raw, [im, ww], cuda["g_raw"])
        else:
            want = torch.autograd.grad(raw, [im, ww], cuda["g_raw"])
    for name, a, b in (("images (B3, col2im)", got[0], want[0]),
                       ("w (B4)", got[1], want[1])):
        err, scale = diff(a, b)
        print(f"[7] conv backward on the step's cotangent, d/d {name}: "
              f"{err:.3e} of {scale:.3e}")
        check(err <= 1e-4 * scale, f"conv gradient for {name} differs by "
              f"{err}, more than 1e-4 of {scale}")
    # (c) the two steps
    report("CUDA step vs plain step", cuda, plain)
    check(abs(cuda["loss"] - plain["loss"]) <= 1e-5 * abs(plain["loss"]),
          f"losses {cuda['loss']} and {plain['loss']}")
    # the network's own reach: the CUDA step, its stem output moved by as
    # much as the two convs' outputs differ
    gen = torch.Generator(device=images.device).manual_seed(SEED)
    shift = diff(cuda["y"], plain["y"])[0]
    nudge = shift * (2 * torch.rand(cuda["y"].shape, generator=gen,
                                    device=images.device) - 1)
    report(f"CUDA step vs itself with its stem output moved by up to "
           f"{shift:.1e}", step("cuda", nudge), cuda)
    torch.backends.cudnn.deterministic = False


def fold_and_serve(torch, np, dev, train):
    """Phase 8: fold and 8-bit quantize the trained stem and serve with
    it, the example's train -> deploy -> evaluate flow."""
    from repro_torch.configs.p2m_vww import CONFIG, SERVE_QUANT_BITS
    from repro_torch.core.bn_fold import deploy_params
    from repro_torch.core.p2m_conv import apply_p2m_conv_deploy
    from repro_torch.core.quant import QuantSpec, quantize_deploy
    from repro_torch.data import SyntheticVWW
    from repro_torch.kernels.p2m_conv import conv
    from repro_torch.models.mobilenetv2 import apply_mnv2_backbone
    from repro_torch.serving import VisionEngine, VisionRequest, drive
    from repro_torch.train.vision import make_vww_eval

    params, bn = train["state"]["params"], train["state"]["bn"]
    dep = quantize_deploy(deploy_params(params["stem"], bn["stem"],
                                        CONFIG.p2m),
                          QuantSpec(SERVE_QUANT_BITS, SERVE_QUANT_BITS))
    engine = VisionEngine(params, bn, CONFIG, device=dev)
    check(torch.equal(engine._deploy["w"], dep["w"])
          and torch.equal(engine._deploy["shift"], dep["shift"]),
          "the engine's deploy tree is not the folded, quantized stem")
    images = SyntheticVWW(image_size=CONFIG.image_size, batch=8,
                          seed=SEED + 2).batch_at(0)
    before = sum(stem_launches(conv).values())
    drive(engine, [VisionRequest(uid=i, image=images["images"][i])
                   for i in range(8)], on_undrained="raise")
    torch.cuda.synchronize()
    done = engine.completed
    check([r.uid for r in done] == list(range(8)),
          f"completion order {[r.uid for r in done]}")
    check(sum(stem_launches(conv).values()) - before
          == engine.stats["launches"], "served without the kernel")
    probs = np.stack([r.probs for r in done])
    check(bool(np.isfinite(probs).all()), "served probs not finite")
    x = torch.from_numpy(images["images"]).to(dev)
    cfg = CONFIG.p2m
    with torch.no_grad():
        stem_k = apply_p2m_conv_deploy(engine._deploy, x, cfg)
        stem_p = apply_p2m_conv_deploy(engine._deploy, x, cfg, impl="plain")
        _, raw = conv.p2m_conv_premixed_plain(
            x, engine._deploy["wrows"], torch.zeros_like(dep["shift"]),
            kernel=cfg.kernel, stride=cfg.stride, mode="raw", want_raw=True)
    rep = conv.quant_disagreement(stem_k, stem_p, raw, cfg.adc.v_lsb)
    check(rep["max_count_diff"] <= 1 and rep["share"] <= 1e-4
          and rep["all_near_half"], f"served stem vs plain stem: {rep}")
    # The served probabilities, every one, against the backbone run here
    # on the kernel's own stem: both sides see the same stem values.
    with torch.no_grad():
        feats, _ = apply_mnv2_backbone(engine._params, engine._bn, stem_k,
                                       CONFIG)
        logits = (feats.mean(dim=(1, 2)) @ engine._params["fc"]["w"]
                  + engine._params["fc"]["b"])
        own = torch.softmax(logits, dim=-1).cpu().numpy()
    own_diff = float(np.abs(own - probs).max())
    check(own_diff <= PROBS_TOL, f"served probs differ from the backbone "
          f"on the kernel's stem by {own_diff}")
    # Against the plain stem's, on every image whose stem counts all agree:
    # a count that flips at a half count (the count rule allows it) moves
    # its image's probabilities by the trained network's gain on one
    # count, which can exceed PROBS_TOL.
    plain = engine.forward(x, p2m_impl="plain").cpu().numpy()
    agree = (stem_k == stem_p).flatten(1).all(dim=1).cpu().numpy()
    diff = float(np.abs(plain - probs)[agree].max(initial=0.0))
    check(diff <= PROBS_TOL, f"served probs differ from the plain stem's "
          f"by {diff} on an image whose stem counts all agree")
    # The unfolded model on its running statistics, for comparison only:
    # six steps leave them far from the weights' batch statistics.
    acc_eval = make_vww_eval(CONFIG)(params, bn, images)
    acc_served = float((probs.argmax(-1) == images["labels"]).mean())
    print(f"[8] folded, {SERVE_QUANT_BITS}-bit stem served 8 requests in "
          f"{engine.stats['launches']} launch(es); stem vs plain stem "
          f"{rep['n_diff']} counts differ (at half counts); probs vs the "
          f"backbone on the kernel's stem {own_diff:.3e} (8 images), vs "
          f"plain stem {diff:.3e} ({int(agree.sum())} images whose stem "
          f"counts all agree); accuracy served {acc_served:.3f}, unfolded "
          f"eval {acc_eval:.3f}")


def time_backward_kernels(torch, bwd, flush):
    """Times of B3 and B4 at the training shape beside their plain twins,
    a one-call library yardstick of their contraction part and the
    bound.  Returns each kernel's row of the kernels line."""
    from repro_torch.kernels.p2m_conv import backward

    g, w, wmix, x, coeffs = (bwd[k] for k in ("g", "w", "wmix", "x",
                                              "coeffs"))
    m, kk = x.shape
    n = g.shape[1]
    dx = wmix.shape[0]
    counted = (backward.p2m_bwd_dx.launches, backward.p2m_bwd_dw.launches)
    rows = {}
    # B3: the contraction part is one product g @ W~cat^T.
    wcat_t = wmix.permute(2, 0, 1).reshape(n, dx * kk).contiguous()
    nbytes = 4 * (x.numel() + g.numel() + wmix.numel() + x.numel())
    flops = 2 * m * n * dx * kk + 3 * dx * m * kk
    b_ms, b_by = bound(nbytes, flops)
    rows["p2m_bwd_dx"] = {
        "ms": cuda_ms(torch, lambda: backward.p2m_bwd_dx(g, wmix, x, coeffs),
                      flush),
        "plain_ms": cuda_ms(torch, lambda: backward.p2m_bwd_dx_plain(
            g, wmix, x), flush),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(torch, lambda: torch.matmul(g, wcat_t), flush),
    }
    # B4: the contraction part is one product xcat^T @ g, xcat built here.
    xcat = torch.cat([x ** (j + 1) for j in range(dx)], dim=1)
    nbytes = 4 * (x.numel() + g.numel() + w.numel() + w.numel())
    flops = 2 * m * kk * n * dx + m * kk * (dx - 1)
    b_ms, b_by = bound(nbytes, flops)
    rows["p2m_bwd_dw"] = {
        "ms": cuda_ms(torch, lambda: backward.p2m_bwd_dw(g, w, x, coeffs),
                      flush),
        "plain_ms": cuda_ms(torch, lambda: backward.p2m_bwd_dw_plain(
            g, w, x, coeffs), flush),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(torch, lambda: torch.matmul(xcat.t(), g),
                              flush),
    }
    del xcat
    backward.p2m_bwd_dx.launches, backward.p2m_bwd_dw.launches = counted
    for name, row in rows.items():
        print(f"[9] {name} at M={m} K={kk} N={n} dx={dx}: kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
              f"matmul of the contraction {row['library_ms']:.4f} ms; bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']}")
    # B4's two passes apart, and its launch
    passes = b4_passes(torch, g, w, x, coeffs, flush)
    check(bool(passes), "the profiler saw no device time of B4")
    launch = backward.dw_launch(m, kk, n, dx)
    check(launch["local_bytes"] == 0 and launch["pass2_local_bytes"] == 0,
          f"B4 spills to local memory: {launch}")
    rows["p2m_bwd_dw"]["passes_ms"] = passes
    # one read of B4's inputs under the same timing: the flush leaves L2
    # dirty, so a read of X and G pays for write-backs too
    read_ms = cuda_ms(torch, lambda: (x.amax(), g.amax()), flush)
    print("[9] p2m_bwd_dw by kernel (mean of "
          f"{REPS}, profiler, L2 flushed): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in passes.items())
          + f"; one read of X and G (amax) {read_ms:.4f} ms")
    print(f"[9] p2m_bwd_dw launch: pass one {launch['blocks_x']} x "
          f"{launch['blocks_y']} blocks of {launch['threads']} threads "
          f"({launch['rows_per_block']} rows a block in tiles of "
          f"{launch['tile_rows']}), {launch['smem_bytes']} B dynamic shared "
          f"memory, {launch['registers']} registers, "
          f"{launch['local_bytes']} B local, {launch['blocks_per_sm']} "
          f"blocks an SM; pass two {launch['pass2_blocks']} blocks of "
          f"{launch['pass2_threads']} threads, {launch['pass2_registers']} "
          f"registers, {launch['pass2_local_bytes']} B local, "
          f"{launch['pass2_blocks_per_sm']} blocks an SM")
    return rows


def b4_passes(torch, g, w, x, coeffs, flush) -> dict:
    """B4's device time by kernel: ``torch.profiler`` (CUPTI) over REPS
    calls at these inputs, L2 flushed before each; the mean ms a launch
    of each kernel whose name holds ``p2m_bwd_dw``, by its short name.
    Empty where the profiler saw no device time.  Restores the count."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.p2m_conv import backward

    counted = backward.p2m_bwd_dw.launches
    for _ in range(3):
        backward.p2m_bwd_dw(g, w, x, coeffs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            flush.zero_()
            backward.p2m_bwd_dw(g, w, x, coeffs)
        torch.cuda.synchronize()
    backward.p2m_bwd_dw.launches = counted
    out = {}
    for ev in prof.key_averages():
        found = re.search(r"p2m_bwd_dw\w*(<\d+>)?", ev.key)
        total = (getattr(ev, "device_time_total", 0)
                 or getattr(ev, "cuda_time_total", 0))
        if found and total > 0 and ev.count:
            out[found.group(0)] = total / ev.count / 1e3
    return out


def b4_only(torch, np, dev) -> int:
    """``chip_smoke.py --b4``: phase 1, the build of ``p2m_bwd.cu`` with
    its ptxas lines, phase 4, then B4 at the training shape timed whole
    (CUDA events) and by kernel (`b4_passes`).  It reads only what every
    tree of the port since PR 13 has, so a copy of this script in the
    root of an older tree times that tree's B4."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.p2m_conv import backward

    print(f"[1] card: {smi_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    backward.build_p2m_bwd()
    seconds, report = _build.BUILD_INFO["p2m_bwd"]
    print(f"[2] p2m_bwd.cu: nvcc {seconds:.2f} s")
    for line in ptxas_summary(report):
        print(f"    ptxas: {line}")
    bwd_err, bwd = check_backward_kernels(torch, np, dev)
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=dev)
    g, w, x, coeffs = (bwd[k] for k in ("g", "w", "x", "coeffs"))
    ms = cuda_ms(torch, lambda: backward.p2m_bwd_dw(g, w, x, coeffs), flush)
    passes = b4_passes(torch, g, w, x, coeffs, flush)
    check(bool(passes), "the profiler saw no device time of B4")
    read_ms = cuda_ms(torch, lambda: (x.amax(), g.amax()), flush)
    print(f"[9] p2m_bwd_dw at M={x.shape[0]} K={x.shape[1]} N={g.shape[1]}: "
          f"{ms:.4f} ms (median of {REPS}, CUDA events); by kernel "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in passes.items())
          + f" (mean, profiler); one read of X and G (amax) {read_ms:.4f} ms")
    print(json.dumps({"b4": {"ms": ms, "passes_ms": passes,
                             "read_ms": read_ms,
                             "max_abs_err": bwd_err["p2m_bwd_dw"]}}))
    return 0


def b1b6_inputs(torch, np, dev):
    """``--b1b6``'s inputs, random from a seed: 8 SyntheticVWW images at
    560² (the serving batch; its first 4 the stream's), 32 random images
    (the training batch), the stem's weights (75 x 8, the model's init
    scale) premixed with the default pixel model, a shift, and x
    (100,352 x 75) for B6.  Returns (stem shapes as `b2_shapes` gives
    them, (x, w, shift, coeffs))."""
    from repro_torch.configs.p2m_vww import CONFIG, SERVE_MAX_BATCH
    from repro_torch.core.pixel_model import default_pixel_model
    from repro_torch.data import SyntheticVWW
    from repro_torch.kernels.p2m_conv import conv, ops

    coeffs = ops._coeff_tuple(default_pixel_model())
    size = CONFIG.image_size
    rng = np.random.default_rng(SEED + 40)
    imgs = torch.from_numpy(SyntheticVWW(
        image_size=size, batch=SERVE_MAX_BATCH, seed=SEED).batch_at(0)[
            "images"]).to(dev)
    wt = torch.from_numpy((rng.uniform(-1, 1, (75, 8)) * (3.0 / 75) ** 0.5)
                          .astype(np.float32))
    wrows = conv.premix_rows(wt, coeffs, 5).to(dev)
    shift = torch.from_numpy(rng.uniform(-0.2, 0.2, 8).astype(
        np.float32)).to(dev)
    x = torch.from_numpy(rng.random((100_352, 75), np.float32)).to(dev)
    return (b2_shapes(torch, np, dev, (imgs, wrows, shift)),
            (x, wt.to(dev), shift, coeffs))


def b1b6_only(torch, np, dev) -> int:
    """``chip_smoke.py --b1b6``: phase 1, the builds of ``p2m_conv.cu`` and
    ``p2m_matmul.cu`` with their ptxas lines, then B1 and B6 alone.  At
    phase 9's three stem shapes (serving and stream quant, training raw):
    B1 against its plain twin, B2 == B1 bit for bit, then B1 and B2
    (depths 2, 3 x block_h 1, 2, 4) in turns (`time_b2_shape`) and one
    `amax` read of the images.  At (100,352, 75, 8) quant: B6 with the
    tuner's blocks against its plain twin, beside `torch.matmul` of the
    power concat and one `amax` read of x.  Every time by `cuda_ms`.  It
    reads only what every tree of the port with B6 and the tuner has
    (B1's and B6's launch reports where the tree has them), so a copy of
    this script in the root of an older tree times that tree's B1 and
    B6."""
    from repro_torch.configs.p2m_vww import CONFIG
    from repro_torch.kernels import _build
    from repro_torch.kernels.p2m_conv import conv, tune
    from repro_torch.kernels.p2m_conv import kernel as mm_kernel

    adc = CONFIG.p2m.adc
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1] card: {smi_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, together
        for job in [pool.submit(conv.build_p2m_conv),
                    pool.submit(mm_kernel.build_p2m_matmul)]:
            job.result()
    for name in ("p2m_conv", "p2m_matmul"):
        seconds, report = _build.BUILD_INFO[name]
        print(f"[2] {name}.cu: nvcc {seconds:.2f} s")
        for line in ptxas_summary(report):
            print(f"    ptxas: {line}")
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=dev)
    shapes, (x, w, sh, coeffs) = b1b6_inputs(torch, np, dev)
    result = {"b1": {}}
    for name, ((imgs, wrows, shift), mode, _) in shapes.items():
        qkw = dict(kernel=5, stride=5, mode=mode, v_lsb=adc.v_lsb,
                   max_count=adc.max_count)
        out1, raw1 = conv.p2m_conv_fused(imgs, wrows, shift, want_raw=True,
                                         **qkw)
        _, ref_raw = conv.p2m_conv_premixed_plain(imgs, wrows, shift,
                                                  want_raw=True, **qkw)
        err = float((raw1 - ref_raw).abs().max())
        check(err <= RAW_TOL, f"B1 at {name}: raw differs by {err}")
        for depth in (2, 3):
            out2, raw2 = conv.p2m_conv_fused(imgs, wrows, shift, want_raw=True,
                                             pipeline_depth=depth, **qkw)
            check(torch.equal(out2, out1) and torch.equal(raw2, raw1),
                  f"B2 at {name}, depth {depth}, differs from B1")
        times, b1 = time_b2_shape(torch, flush, (imgs, wrows, shift), qkw,
                                  (1, 2, 4))
        read_ms = cuda_ms(torch, imgs.amax, flush)
        best = min(times, key=times.get)
        print(f"[9] B1 at {name} {mode}: {b1[0]:.4f} and {b1[1]:.4f} ms (in "
              f"turns with B2); raw vs plain {err:.1e}; B2 == B1 bitwise; "
              f"B2 (block_h, depth): "
              + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
              + f"; fastest B2 {best} {times[best]:.4f} ms; one read of the "
              f"images (amax) {read_ms:.4f} ms")
        result["b1"][name] = {"b1_ms": b1, "b2_ms": {
            f"{k[0]},{k[1]}": v for k, v in times.items()},
            "read_ms": read_ms, "raw_err": err}
        if hasattr(conv, "b1_launch"):
            dx = wrows.shape[1] // (5 * imgs.shape[3])
            geo = conv.b1_launch(tuple(imgs.shape), wrows.shape[2], dx,
                                 kernel=5, stride=5)
            print(f"[9] B1 launch at {name}: {geo}")
            result["b1"][name]["launch"] = geo
    m, kk = x.shape
    n = w.shape[1]
    blocks = tune.get_matmul_blocks(m, kk, n, coeffs, "quant", device=dev)
    rec = tune.decision_records()[-1]
    print(f"[3f] B6 tuner at ({m}, {kk}, {n}) quant, (block_m, block_n, "
          f"block_k): ms: " + ", ".join(
              f"{tuple(c)} {t * 1e3:.4f}" for c, t in zip(
                  rec["candidates"], rec["times_s"]) if t is not None))
    bm, bn, bk = blocks
    kw = dict(coeffs=coeffs, mode="quant", v_lsb=adc.v_lsb,
              max_count=adc.max_count)
    _, raw = mm_kernel.p2m_matmul_fused(x, w, sh, want_raw=True, block_m=bm,
                                        block_n=bn, block_k=bk, **kw)
    ref_raw = mm_kernel.p2m_matmul_raw_plain(x, w, coeffs)
    err = float((raw - ref_raw).abs().max())
    check(err <= RAW_TOL, f"B6 raw differs by {err}")
    dx = len(coeffs[0])
    xcat = torch.cat([x ** (j + 1) for j in range(dx)], dim=1)
    wcat = conv.premix_weights(w, coeffs).reshape(dx * kk, n)
    b6 = []
    library = []
    for _ in range(2):  # in turns: B6, library, B6, library
        b6.append(cuda_ms(torch, lambda: mm_kernel.p2m_matmul_fused(
            x, w, sh, block_m=bm, block_n=bn, block_k=bk, **kw), flush))
        library.append(cuda_ms(torch, lambda: torch.matmul(xcat, wcat),
                               flush))
    read_ms = cuda_ms(torch, x.amax, flush)
    print(f"[9] B6 at ({m}, {kk}, {n}) quant, tuner's blocks {blocks}: "
          f"{b6[0]:.4f} and {b6[1]:.4f} ms; raw vs plain {err:.1e}; "
          f"torch.matmul of the power concat {library[0]:.4f} and "
          f"{library[1]:.4f} ms; one read of x (amax) {read_ms:.4f} ms")
    result["b6"] = {"blocks": list(blocks), "ms": b6, "library_ms": library,
                    "read_ms": read_ms, "raw_err": err}
    if hasattr(mm_kernel, "matmul_launch"):
        geo = mm_kernel.matmul_launch(m, kk, n, dx, block_m=bm, block_n=bn,
                                      block_k=bk)
        print(f"[9] B6 launch: {geo}")
        result["b6"]["launch"] = geo
    print(json.dumps({"b1b6": result}))
    return 0


def time_train_step(torch, train, flush):
    """Where a training step's time goes: each part timed alone on the
    step's own inputs (device time by CUDA events, launch gaps
    included), beside the whole step (host clock)."""
    from repro_torch.configs.p2m_vww import CONFIG
    from repro_torch.core.p2m_conv import _flat_weights
    from repro_torch.core.pixel_model import default_pixel_model
    from repro_torch.kernels.p2m_conv import backward, conv
    from repro_torch.kernels.p2m_conv.ops import p2m_conv
    from repro_torch.models.mobilenetv2 import (
        apply_mnv2_backbone,
        apply_mnv2_stem,
    )
    from repro_torch.train.vision import _batch_to, softmax_ce
    from repro_torch.tree import tree_leaves, tree_unflatten

    state, batch, opt = train["state"], train["batch"], train["opt"]
    params, bn = state["params"], state["bn"]
    dev = params["fc"]["w"].device
    images, labels = _batch_to(batch, dev)
    counted = {fn: fn.launches for fn in (backward.p2m_bwd_dx,
                                          backward.p2m_bwd_dw)}
    counted_stem = stem_launches(conv)
    cfg = CONFIG.p2m
    theta = params["stem"]["theta"].detach().requires_grad_(True)
    stem_p = {**params["stem"], "theta": theta}

    def stem_fwd():
        return apply_mnv2_stem({"stem": stem_p}, bn, images, CONFIG,
                               train=True)[0]

    stem_out = stem_fwd()
    g_stem = torch.randn_like(stem_out)
    parts = {"batch to the card (numpy, pageable; host clock)": wall_ms(
        torch, lambda: _batch_to(batch, dev), flush)}
    fwd_name = "stem forward (conv, B1 or B2 as tuned, + BN + clamp)"
    parts[fwd_name] = cuda_ms(torch, stem_fwd, flush)
    parts["stem backward (forward + backward, less the forward)"] = cuda_ms(
        torch, lambda: torch.autograd.grad(stem_fwd(), theta, g_stem),
        flush) - parts[fwd_name]
    w = _flat_weights(theta.detach(), cfg)
    zero = torch.zeros(cfg.out_channels, device=dev)
    parts["  im2col of the images"] = cuda_ms(
        torch, lambda: conv.im2col_matrix(images, cfg.kernel, cfg.stride),
        flush)
    im = images.detach().requires_grad_(True)
    x = conv.im2col_matrix(im, cfg.kernel, cfg.stride)
    gx = torch.randn_like(x)
    parts["  col2im (autograd of im2col)"] = cuda_ms(
        torch, lambda: torch.autograd.grad(x, im, gx, retain_graph=True),
        flush)
    w.requires_grad_(True)
    parts["  conv Function forward + backward (B1 or B2, im2col, B3, B4, "
          "col2im)"] = cuda_ms(torch, lambda: torch.autograd.grad(
              p2m_conv(images, w, zero, default_pixel_model(), cfg.adc,
                       "raw", cfg.kernel, cfg.stride).sum(), w), flush)

    leaves = tree_leaves({k: v for k, v in params.items() if k != "stem"})
    live = [p.detach().requires_grad_(True) for p in leaves]
    rest = tree_unflatten({k: v for k, v in params.items() if k != "stem"},
                          live)
    stem_in = stem_out.detach().requires_grad_(True)

    def backbone_fwd():
        feats, _ = apply_mnv2_backbone(rest, bn, stem_in, CONFIG, train=True)
        logits = feats.mean(dim=(1, 2)) @ rest["fc"]["w"] + rest["fc"]["b"]
        return softmax_ce(logits, labels)

    parts["backbone + head forward"] = cuda_ms(torch, backbone_fwd, flush)
    parts["backbone + head forward + backward"] = cuda_ms(
        torch, lambda: torch.autograd.grad(backbone_fwd(), live + [stem_in]),
        flush)
    grads = tree_unflatten(params, [torch.randn_like(p)
                                    for p in tree_leaves(params)])
    parts["optimizer update (sgd, momentum)"] = cuda_ms(
        torch, lambda: opt.update(grads, state["opt"], params, 6), flush)
    for fn, n in counted.items():
        fn.launches = n
    (conv.p2m_conv_fused.launches,
     conv.p2m_conv_fused.launches_pipelined) = counted_stem.values()
    for name, ms in parts.items():
        print(f"[9] train step part: {name}: {ms:.3f} ms")
    print(f"[9] train step, whole: {train['step_ms']:.3f} ms (host clock)")


STREAM_LENGTHS = (12, 8, 12, 6, 12, 10)
NOISY_STREAM = 3  # the one stream with per-frame noise: it never skips


#: B5's bodies and blocks phase 3b holds: (pipeline_depth, block_h).
#: Depth 0 is B1's gated body; the rest the ring, block_h clamped to a
#: divisor of Ho.
GATED_BLOCKS = ((0, None), (2, 1), (2, 2), (3, 4))


def check_gated_kernel(torch, np, dev, imgs, wrows, shift, rand_case, adc):
    """Phase 3b: the gated stem (B5), both bodies (B1's and the ring, at
    `GATED_BLOCKS`), against B1 + `torch.where` and against the dense
    kernel at the same blocks + where, bit for bit, and against its plain
    twin (raw, relu within 1e-5; quant by the count rule), over masks
    (all re-run, all skip, mixed, one slot), geometries (the stream shape,
    s < k, Ho = 1) and modes.  Returns the largest raw/relu difference
    from the plain twin at the stream shape."""
    from repro_torch.kernels.p2m_conv import conv, gated

    masks = {"all rerun": [1, 1, 1, 1], "all skip": [0, 0, 0, 0],
             "mixed": [1, 0, 0, 1], "one slot": [0, 0, 1, 0]}
    gen = torch.Generator().manual_seed(SEED + 3)
    geoms = [("stream k5 s5", (imgs, wrows, shift), 5, 5),
             ("k5 s3", rand_case(4, 64, 64, 3, 5, 8), 5, 3),
             ("Ho=1 k5 s5", rand_case(4, 5, 5, 3, 5, 8), 5, 5)]
    stream_err = 0.0
    for name, (x, wr, sh), kk, ss in geoms:
        b = x.shape[0]
        ho = (x.shape[1] - kk) // ss + 1
        wo = (x.shape[2] - kk) // ss + 1
        cached = torch.rand((b, ho, wo, wr.shape[2]), generator=gen).to(dev)
        for mode in ("raw", "relu", "quant"):
            kw = dict(kernel=kk, stride=ss, mode=mode, v_lsb=adc.v_lsb,
                      max_count=adc.max_count)
            b1 = conv.p2m_conv_fused(x, wr, sh, **kw)
            _, raw = conv.p2m_conv_premixed_plain(
                x, wr, torch.zeros_like(sh), want_raw=True,
                **{**kw, "mode": "raw"})
            line = f"[3b] {name:13s} {mode:5s} {tuple(b1.shape)}:"
            errs = {}
            for depth, bh in GATED_BLOCKS:
                aligned = gated.aligned_block_h(
                    ho, bh or conv.default_block_h(b * ho, wo))
                dense = conv.p2m_conv_fused(x, wr, sh, block_h=aligned,
                                            pipeline_depth=depth, **kw)
                for mname, mask in masks.items():
                    rerun = torch.tensor(mask, dtype=torch.bool, device=dev)
                    got = gated.p2m_conv_fused_gated(
                        x, wr, sh, cached, rerun, block_h=bh,
                        pipeline_depth=depth, **kw)
                    torch.cuda.synchronize()
                    sel = rerun[:, None, None, None]
                    case = f"{name} {mode} {mname} depth {depth} block_h {bh}"
                    check(torch.equal(got, torch.where(sel, b1, cached)),
                          f"{case}: B5 differs from B1 + where")
                    check(torch.equal(got, torch.where(sel, dense, cached)),
                          f"{case}: B5 differs from the dense kernel at its "
                          "blocks + where")
                    plain = gated.p2m_conv_gated_plain(x, wr, sh, cached,
                                                       rerun, **kw)
                    if mode == "quant":
                        rep = conv.quant_disagreement(got, plain, raw,
                                                      adc.v_lsb)
                        check(rep["max_count_diff"] <= 1
                              and rep["share"] <= 1e-4
                              and rep["all_near_half"],
                              f"{case}: quant counts disagree: {rep}")
                        errs[mname] = f"={rep['n_diff']} counts"
                    else:
                        err = float((got - plain).abs().max())
                        check(err <= RAW_TOL, f"{case}: B5 vs plain {err}")
                        if name.startswith("stream"):
                            stream_err = max(stream_err, err)
                        errs[mname] = f"{err:.1e}"
            line += "".join(f" {m} {e}" for m, e in errs.items())
            print(line + " (bitwise = B1 + where and = the dense kernel at "
                  "the same blocks + where, in every mask, at (depth, "
                  f"block_h) {GATED_BLOCKS})")
    return stream_err


def stream_path(torch, np, dev, params, bn):
    """Phase 5b: the streaming path at full width.  ``StreamEngine`` on
    `CONFIG` with 4 slots (`STREAM_MAX_SLOTS`), the port's detection head
    from a seed, six hold-2 `SyntheticVideo` streams of mixed lengths at
    560² (one with per-frame noise), through `drive()`: the gated engine
    (the default on the card), the where engine and the dense engine
    (``threshold=None``).  Returns what the timings read."""
    from repro_torch.configs.p2m_vww import CONFIG, STREAM_MAX_SLOTS
    from repro_torch.core.bandwidth import frame_output_bits
    from repro_torch.core.p2m_conv import deploy_conv_blocks
    from repro_torch.kernels.p2m_conv import conv, gated
    from repro_torch.models.mobilenetv2 import head_out_channels
    from repro_torch.serving import drive
    from repro_torch.video import (
        DeltaGateConfig,
        DetectConfig,
        StreamEngine,
        StreamRequest,
        SyntheticVideo,
        init_detect_head,
    )

    t0 = time.perf_counter()
    frames = [SyntheticVideo(image_size=CONFIG.image_size, n_frames=n,
                             hold=2, seed=SEED + i,
                             noise=0.02 if i == NOISY_STREAM else 0.0).frames()
              for i, n in enumerate(STREAM_LENGTHS)]
    setup_s = time.perf_counter() - t0
    det = init_detect_head(torch.Generator().manual_seed(SEED + 1),
                           head_out_channels(CONFIG), DetectConfig(),
                           device=dev)

    def requests():
        return [StreamRequest(uid=i, frames=f) for i, f in enumerate(frames)]

    def run(threshold=0.0, **kw):
        eng = StreamEngine(params, bn, CONFIG, det,
                           gate=DeltaGateConfig(threshold=threshold),
                           device=dev, **kw)
        torch.cuda.synchronize()
        reset_gated_launches(gated)
        reset_stem_launches(conv)
        t0 = time.perf_counter()
        drive(eng, requests(), on_undrained="raise")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {**gated_launches(gated), **stem_launches(conv)}
        done = eng.completed
        check(sorted(r.uid for r in done) == list(range(len(frames)))
              and not eng.failed and not eng.evicted,
              f"{eng.stem_path}: completion {[r.uid for r in done]}, failed "
              f"{len(eng.failed)}, evicted {len(eng.evicted)}")
        for r in done:
            for boxes, scores in r.frame_outputs:
                check(boxes.shape == (eng.det_cfg.max_dets, 4)
                      and scores.shape == (eng.det_cfg.max_dets,)
                      and bool(np.isfinite(boxes).all())
                      and bool(np.isfinite(scores).all()),
                      f"stream {r.uid}: outputs not finite or misshapen")
        print(f"[5b] {eng.stem_path:5s} engine, threshold {threshold}: "
              f"{len(done)} streams, {sum(r.frames_done for r in done)} "
              f"frames in {eng.stats['launches']} ticks ({seconds:.2f} s); "
              f"launches {counts}; summary {eng.stream_summary()}")
        return eng, done, counts

    def same_outputs(a, b):
        return all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
                   for ra, rb in zip(a, b)
                   for x, y in zip(ra.frame_outputs, rb.frame_outputs))

    def ledgers(done):
        return [(r.uid, r.served_tick, r.finished_tick, r.frames_done,
                 r.ledger.summary()) for r in done]

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    g_eng, g_done, g_counts = run()  # the main path: stem_path="auto"
    w_eng, w_done, w_counts = run(stem_path="where")
    d_eng, d_done, _ = run(threshold=None)
    check(g_eng.stem_path == "gated" and d_eng.stem_path == "gated",
          f"auto picked {g_eng.stem_path} on the card")
    ticks = g_eng.stats["launches"]
    # The tuner's blocks for the engines' stem signature (a cache hit: the
    # engines asked it): B5 runs the body of its depth, once a tick.
    blocks = deploy_conv_blocks(torch.empty(
        STREAM_MAX_SLOTS, CONFIG.image_size, CONFIG.image_size, 3,
        device=dev), CONFIG.p2m)
    body = ("p2m_conv_fused_gated_pipelined" if blocks[2] >= 2
            else "p2m_conv_fused_gated")
    want = {name: 0 for name in g_counts}
    check(g_counts == {**want, body: ticks},
          f"gated engine launches {g_counts} in {ticks} ticks, tuner's "
          f"blocks {blocks}")
    # the where engine's stem is B1 or B2, as the tuner picked
    check(w_counts["p2m_conv_fused_gated"] == 0
          and w_counts["p2m_conv_fused_gated_pipelined"] == 0
          and w_counts["p2m_conv_fused"]
          + w_counts["p2m_conv_fused_pipelined"] == w_eng.stats["launches"],
          f"where engine launches {w_counts}")
    check(ledgers(g_done) == ledgers(w_done),
          "gated and where engines' ledgers differ")
    check(same_outputs(g_done, w_done),
          "gated and where engines' boxes or scores differ")
    check(same_outputs(g_done, d_done),
          "gated (threshold 0) and dense engines' boxes or scores differ")
    check(all(r.skip_count == 0 for r in d_done), "the dense engine skipped")
    for r in g_done:
        want = 0.0 if r.uid == NOISY_STREAM else 0.5
        check(r.skip_rate == want, f"stream {r.uid}: skip rate "
              f"{r.skip_rate}, not {want}")
    frames_n = sum(STREAM_LENGTHS)
    skips = sum(n // 2 for i, n in enumerate(STREAM_LENGTHS)
                if i != NOISY_STREAM)
    dense_bits = frame_output_bits(g_eng.geom)
    bits = (frames_n - skips) * dense_bits + frames_n
    summary = g_eng.stream_summary()
    check(summary["frames"] == frames_n
          and summary["stem_skip_rate"] == skips / frames_n
          and summary["stem_flops_skipped_ratio"] == skips / frames_n
          and summary["measured_reduction_vs_dense"]
          == dense_bits / (bits / frames_n),
          f"stream summary {summary}")
    print(f"[5b] gated == where (ledgers, boxes, scores: bitwise), gated == "
          f"dense at threshold 0 (bitwise); skip rate {skips}/{frames_n} = "
          f"{skips / frames_n:.4f} (each noiseless stream 0.5, the noisy "
          f"one 0); measured reduction vs dense "
          f"{summary['measured_reduction_vs_dense']:.6f}; B5 launched "
          f"{g_counts[body]} times in {ticks} ticks on "
          f"{'the ring' if blocks[2] >= 2 else 'the B1 body'} at the "
          f"tuner's blocks {tuple(blocks)}, B1 and B2 0 times; the where "
          f"engine launched B1 {w_counts['p2m_conv_fused']} and B2 "
          f"{w_counts['p2m_conv_fused_pipelined']} times; frames made in "
          f"{setup_s:.2f} s")

    # A corrupted cache: slot 0's stem becomes NaN after its first frame.
    eng = StreamEngine(params, bn, CONFIG, det, device=dev, max_streams=2)
    for r in requests()[:2]:
        eng.submit(r)
    eng.step()
    eng._cached_stem[0] = float("nan")
    eng.run(on_undrained="raise")
    a, b = eng.completed
    check(a.uid == 1 and b.uid == 0, f"order {[a.uid, b.uid]}")
    check(b.skip_count == 0 and eng._gates[0].disabled
          and eng.health()["gate_faults"] == 1 and a.skip_count == 4,
          f"NaN cache: skips {b.skip_count}/{a.skip_count}, health "
          f"{eng.health()}")
    check(all(bool(np.isfinite(s).all()) for r in (a, b)
              for _, s in r.frame_outputs), "NaN reached the outputs")
    print(f"[5b] NaN cache in slot 0: the stream re-ran every frame "
          f"(skips 0 of {b.frames_done}), its gate dropped to dense, "
          f"gate_faults {eng.health()['gate_faults']}; slot 1 kept "
          f"skipping ({a.skip_count} of {a.frames_done})")
    torch.backends.cudnn.deterministic = False
    return {"gated": g_eng, "where": w_eng, "frames": frames,
            "requests": requests, "launches": g_counts,
            "where_launches": w_counts, "ticks": ticks,
            "slots": STREAM_MAX_SLOTS, "blocks": tuple(blocks)}


def time_stream(torch, np, dev, stream, flush, adc):
    """Phase 9, stream part: B5 alone at skip shares 0, 1/2 and 1, its
    ring at the engine's blocks (the tuner's) and its B1 body (depth 0) in
    turns (ring, B1 body, B1 body, ring), beside its bound, the dense B2 at
    the same blocks, one `amax` read of the images, its plain twin and the
    library conv2d + where; the ring's launch; the engines' time per tick,
    warm; and the parts of a tick.  Returns B5's row of the kernels line,
    without launches and error."""
    from repro_torch.configs.p2m_vww import CONFIG
    from repro_torch.kernels.p2m_conv import conv, gated
    from repro_torch.models.mobilenetv2 import apply_mnv2_backbone
    from repro_torch.serving import drive
    from repro_torch.video.delta import frame_delta
    from repro_torch.video.detect import (
        apply_detect_head,
        decode_detections,
        det_grid,
    )

    eng = stream["gated"]
    b = stream["slots"]
    cfg = CONFIG.p2m
    k, s = cfg.kernel, cfg.stride
    size = CONFIG.image_size
    dep = eng._deploy
    wrows, shift = dep["wrows"], dep["shift"]
    n = wrows.shape[2]
    dx = wrows.shape[1] // (k * 3)
    ho = cfg.out_spatial(size)
    frames = stream["frames"]
    images = torch.from_numpy(np.stack([f[0] for f in frames[:b]])).to(dev)
    cached = torch.rand((b, ho, ho, n), generator=torch.Generator()
                        .manual_seed(SEED + 4)).to(dev)
    qkw = dict(kernel=k, stride=s, mode="quant", v_lsb=adc.v_lsb,
               max_count=adc.max_count)
    counted = (gated_launches(gated), stem_launches(conv))
    # The engine's blocks; the ring at (2, None, 2) where the tuner picked
    # B1 (then the engine ran the B1 body).
    bh, bn, depth = stream["blocks"]
    engine_kw = dict(block_h=bh, block_n=bn, pipeline_depth=depth)
    ring_kw = engine_kw if depth >= 2 else dict(block_h=2, block_n=None,
                                                pipeline_depth=2)
    bodies = {"ring": ring_kw, "B1 body": dict(pipeline_depth=0)}
    launch = gated.gated_launch(tuple(images.shape), n, dx, kernel=k,
                                stride=s, **ring_kw)
    check(launch["local_bytes"] == 0, f"B5's ring at {ring_kw} uses "
          f"{launch['local_bytes']} bytes of local memory a thread")

    def dense_b2():
        return conv.p2m_conv_fused(images, wrows, shift, **qkw, **ring_kw)

    dense_ms = [cuda_ms(torch, dense_b2, flush)]
    img_bytes = 4 * size * size * 3
    out_bytes = 4 * ho * ho * n
    rows = {}
    # The kernel alone takes its int32 mask; the engine hands the wrapper a
    # bool mask, which costs one more (conversion) launch, timed apart.
    for share, mask in (("0", [1] * b), ("0.5", [1, 0] * (b // 2)),
                        ("1", [0] * b)):
        rerun = torch.tensor(mask, dtype=torch.int32, device=dev)
        n_run = sum(mask)
        nbytes = (n_run * img_bytes + (b - n_run) * out_bytes
                  + b * out_bytes + 4 * (wrows.numel() + shift.numel() + b))
        flops = 2 * n_run * ho * ho * k * wrows.shape[1] * n
        b_ms, b_by = bound(nbytes, flops)
        turns = {name: [] for name in bodies}
        for name in ("ring", "B1 body", "B1 body", "ring"):
            turns[name].append(cuda_ms(
                torch, lambda: gated.p2m_conv_fused_gated(
                    images, wrows, shift, cached, rerun, **qkw,
                    **bodies[name]), flush))
        rows[share] = {"turns": turns, "ms": statistics.mean(turns["ring"]),
                       "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                       "flops": flops}
        if share == "0.5":
            half = rerun.to(torch.bool)
    dense_ms.append(cuda_ms(torch, dense_b2, flush))
    read_ms = cuda_ms(torch, images.amax, flush)
    # Whether B5's time here follows its work or one block's chain of k
    # rows: the dense B2 at the same blocks over the first 1 and 2 images
    # (a quarter and a half of the blocks, each the same chain).
    fewer = {nb: images[:nb] for nb in (1, 2)}
    fewer_ms = {nb: cuda_ms(torch, lambda: conv.p2m_conv_fused(
        x, wrows, shift, **qkw, **ring_kw), flush)
        for nb, x in fewer.items()}
    # The floor of this timing: one launch that writes 4 bytes.
    launch_ms = cuda_ms(torch, torch.zeros(1, device=dev).zero_, flush)
    rows["0.5"]["plain_ms"] = cuda_ms(torch, lambda: gated.p2m_conv_gated_plain(
        images, wrows, shift, cached, half, **qkw), flush)
    bool_ms = cuda_ms(torch, lambda: gated.p2m_conv_fused_gated(
        images, wrows, shift, cached, half, **qkw, **engine_kw), flush)
    # Yardstick: cuDNN's conv over the power stack (the raw accumulation,
    # every slot) and the select.
    library = conv2d_yardstick(torch, images, wrows, k, s)
    cached_nchw = cached.permute(0, 3, 1, 2)
    rows["0.5"]["library_ms"] = cuda_ms(torch, lambda: torch.where(
        half[:, None, None, None], library(), cached_nchw), flush)
    print(f"[9] p2m_conv_fused_gated (B5) at ({b},{size},{size},3) quant; "
          f"the engine ran {'the ring' if depth >= 2 else 'the B1 body'} "
          f"at the tuner's blocks {stream['blocks']}; ring {ring_kw}: block_h "
          f"{launch['block_h']}, {launch['ring_slots']} slots, "
          f"{launch['pixels_per_thread']} px, {launch['threads']} x "
          f"{launch['blocks_x']}x{launch['blocks_y']}, {launch['smem_bytes']}"
          f" B shared, {launch['blocks_per_sm']} an SM, "
          f"{launch['registers']} regs, {launch['local_bytes']} B local")
    for share, row in rows.items():
        extra = (f"; with a bool mask (+ its conversion) {bool_ms:.4f} ms, "
                 f"plain {row['plain_ms']:.4f} ms, library conv2d + where "
                 f"{row['library_ms']:.4f} ms" if share == "0.5" else "")
        print(f"[9] B5 skip share {share}: ring "
              + " and ".join(f"{v:.4f}" for v in row["turns"]["ring"])
              + " ms, B1 body "
              + " and ".join(f"{v:.4f}" for v in row["turns"]["B1 body"])
              + f" ms (in turns){extra}; bound {row['bound_ms']:.4f} ms by "
              f"{row['bound_by']} ({row['bytes']} bytes, {row['flops']} FLOP)")
    print(f"[9] beside B5: dense B2 at {ring_kw} {dense_ms[0]:.4f} and "
          f"{dense_ms[1]:.4f} ms (before and after), over the first 1 and 2 "
          f"images {fewer_ms[1]:.4f} and {fewer_ms[2]:.4f} ms; one read of "
          f"the images (amax) {read_ms:.4f} ms; one launch that writes 4 "
          f"bytes {launch_ms:.4f} ms")

    # The engines per tick, warm: the same six streams again, in turns
    # (gated, where, where, gated).
    per_tick = {"gated": [], "where": []}
    for path in ("gated", "where", "where", "gated"):
        e = stream[path]
        before_l, before_us = e.stats["launches"], e.stats["wall_us"]
        drive(e, stream["requests"](), on_undrained="raise")
        per_tick[path].append((e.stats["wall_us"] - before_us)
                              / (e.stats["launches"] - before_l) / 1e3)
    print(f"[9] stream engine per tick (4 slots, warm, host clock, "
          f"{stream['ticks']} ticks a run, runs in turns): gated "
          + " and ".join(f"{v:.3f}" for v in per_tick["gated"]) + " ms, where "
          + " and ".join(f"{v:.3f}" for v in per_tick["where"]) + " ms")

    # Where a tick goes, each part timed alone as `_launch` runs it.
    def assemble():
        x = np.zeros((b, size, size, 3), np.float32)
        for i in range(b):
            x[i] = frames[i][0]
        return torch.from_numpy(x).to(dev)

    parts = {"host: frames assembled in numpy, pageable copy to the card":
             wall_ms(torch, assemble, flush),
             "host: delta-gate decisions (mean |frame - reference| a slot)":
             wall_ms(torch, lambda: [frame_delta(frames[i][0], frames[i][1])
                                     for i in range(b)], flush)}
    rerun = torch.tensor([1, 0] * (b // 2), dtype=torch.bool, device=dev)
    fwd = eng.forward
    with torch.no_grad():
        stem = gated.p2m_conv_fused_gated(images, wrows, shift, cached,
                                          rerun, **qkw)
        feats, _ = apply_mnv2_backbone(eng._params, eng._bn, stem, CONFIG)
        grid = det_grid(ho)
        parts["stem, gated (B5 + the bool mask's conversion, skip share "
              "1/2)"] = bool_ms
        parts["stem, where (the tuner's B1 or B2 + torch.where)"] = cuda_ms(
            torch, lambda: torch.where(
                rerun[:, None, None, None],
                conv.p2m_conv_fused(images, wrows, shift, **qkw,
                                    **engine_kw), cached),
            flush)
        parts["backbone"] = cuda_ms(torch, lambda: apply_mnv2_backbone(
            eng._params, eng._bn, stem, CONFIG), flush)
        stem8 = torch.cat([stem, stem])
        parts["(backbone on 8 such stems, the vision engine's batch)"] = \
            cuda_ms(torch, lambda: apply_mnv2_backbone(
                eng._params, eng._bn, stem8, CONFIG), flush)
        parts["detection head + decode"] = cuda_ms(
            torch, lambda: decode_detections(apply_detect_head(
                eng._det, feats, grid), eng.det_cfg.max_dets), flush)
        parts["forward, gated (device)"] = cuda_ms(
            torch, lambda: fwd(images, cached, rerun), flush)
        parts["forward, gated, with the results to the host (host clock)"] = \
            wall_ms(torch, lambda: [t.cpu() for t in fwd(images, cached,
                                                          rerun)[1:]], flush)
    (gated.p2m_conv_fused_gated.launches,
     gated.p2m_conv_fused_gated.launches_pipelined) = counted[0].values()
    (conv.p2m_conv_fused.launches,
     conv.p2m_conv_fused.launches_pipelined) = counted[1].values()
    for name, ms in parts.items():
        print(f"[9] stream tick part: {name}: {ms:.3f} ms")
    row = rows["0.5"]
    return {"ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "body": "ring" if depth >= 2 else "B1 body",
            "blocks": list(stream["blocks"]),
            "ms_by_skip_share": {k: v["ms"] for k, v in rows.items()},
            "turns_by_skip_share": {k: v["turns"] for k, v in rows.items()},
            "bound_ms_by_skip_share": {k: v["bound_ms"]
                                       for k, v in rows.items()},
            "dense_b2_ms": dense_ms, "dense_b2_ms_by_images": fewer_ms,
            "read_ms": read_ms, "empty_launch_ms": launch_ms,
            "launch": launch}


LM_ARCH = "rwkv6-3b"
LM_MAX_BATCH, LM_MAX_LEN, LM_CHUNK = 8, 512, 64
LM_REQUESTS, LM_NEW_TOKENS = 16, 16
WKV_SERVE_SHAPE = (LM_MAX_BATCH, LM_CHUNK, 40, 64)  # (B, S, H, D) a tick
WKV_TOL = 1e-4  # of the largest |plain|: fp32 sums and exps in another order
# The first prefill tick's logits, absolute (the largest |logit| is 4.6 at
# this seed).  Float32 rounding, carried through 32 random-weight layers,
# moves them 0.045 between B7 and the plain twin and up to 0.20 between
# runs with no kernel; a wrong WKV moves them further (PERF.md §6).
LM_LOGIT_TOL = 0.1  # B7 vs the plain twin; a differing token's top-2 margin
LM_SPREAD_TOL = 0.3  # any two of B7, plain, per-token scan and float64
LM_SWEEP_DEPTHS = (1, 2, 4, 8, 16)


def wkv_inputs(torch, np, dev, b, s, h, d, seed):
    """r, k, v, lw, u, state for B7: lw in the model's band [-5, -1e-6],
    a random nonzero initial state."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)

    lw = torch.from_numpy(-rng.uniform(1e-6, 5.0, (b, s, h, d)).astype(
        np.float32)).to(dev)
    return f(b, s, h, d), f(b, s, h, d), f(b, s, h, d), lw, f(h, d) * 0.3, \
        f(b, h, d, d) * 0.5


def unaligned_copy(torch, t):
    """A contiguous copy of ``t`` at a storage offset of one float, so its
    data pointer is not 16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def check_wkv_kernel(torch, np, dev):
    """Phase 3c: B7 against its plain twin at the serving tick's shape, at
    S in {1, 15, 17, 100} x D in {16, 64}, at S = 0 and S = 64, at D = 33
    (a partial warp slice), with a random initial state, and on inputs
    that are views at an offset that is not 16-byte aligned (which must
    also give the aligned inputs' bits); a row whose lw and k are all zero
    keeps its state bit for bit.  Returns the largest abs error at the
    serving shape and its inputs."""
    from repro_torch.kernels.rwkv_wkv import kernel, ref

    cases = [("serving tick", WKV_SERVE_SHAPE, False)] + [
        (f"S={s} D={d}", (2, s, 3, d), False) for s in (1, 15, 17, 100)
        for d in (16, 64)] + [
        (f"S={s} D={d}", (2, s, 3, d), False)
        for s, d in ((0, 64), (64, 64), (17, 33), (64, 33), (100, 33))] + [
        ("unaligned", (2, 37, 3, 64), True),
        ("unaligned", (2, 20, 3, 33), True)]
    for i, (name, shape, moved) in enumerate(cases):
        r, k, v, lw, u, s0 = wkv_inputs(torch, np, dev, *shape, SEED + 20 + i)
        lw[1], k[1] = 0.0, 0.0  # row 1 advances no token
        ins = (r, k, v, lw, u, s0)
        if moved:
            aligned = kernel.wkv_fused(*ins)
            ins = tuple(unaligned_copy(torch, a) for a in ins)
            check(all(a.data_ptr() % 16 for a in ins), f"{name}: the views "
                  "are 16-byte aligned")
        y, sf = kernel.wkv_fused(*ins)
        torch.cuda.synchronize()
        y_p, s_p = ref.wkv_chunked_plain(*ins)
        line = f"[3c] {name:12s} {shape}:"
        errs = {}
        for key, got, want in (("y", y, y_p), ("state", sf, s_p)):
            check(got.shape == want.shape, f"{name}: B7 {key} has shape "
                  f"{tuple(got.shape)}, not {tuple(want.shape)}")
            err = float((got - want).abs().max()) if want.numel() else 0.0
            scale = float(want.abs().max()) if want.numel() else 0.0
            errs[key] = err
            line += f" {key} err {err:.3e} (of {scale:.3e})"
            check(err <= WKV_TOL * scale, f"{name}: B7 {key} differs by "
                  f"{err}, more than {WKV_TOL} of {scale}")
        check(torch.equal(sf[1], s0[1]), f"{name}: the masked row's state "
              "changed")
        line += "; masked row's state bitwise kept"
        if moved:
            check(torch.equal(y, aligned[0]) and torch.equal(sf, aligned[1]),
                  f"{name}: the unaligned views' result differs from the "
                  "aligned inputs'")
            line += "; bitwise equal to the aligned inputs'"
        print(line)
        if i == 0:
            serve_err = max(errs.values())
            serve_inputs = (r, k, v, lw, u, s0)
    return serve_err, serve_inputs


def lm_path(torch, np, dev, cfg):
    """Phase 5c: serve ``cfg`` (rwkv6-3b, float32, random weights from
    ``SEED``) through `ServeEngine` with chunked prefill and through
    `SessionEngine`.  Returns what phase 9 reads."""
    from repro_torch.common.pytree import param_count
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels.rwkv_wkv import kernel
    from repro_torch.models import rwkv6
    from repro_torch.models.families import get_family
    from repro_torch.serving import (
        Request,
        ServeEngine,
        SessionEngine,
        SessionRequest,
        drive,
    )
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    params, _ = get_family(cfg).init(torch.Generator(dev).manual_seed(SEED),
                                     cfg)
    torch.cuda.synchronize()
    n_params = param_count(params)
    print(f"[5c] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_rwkv_heads} heads of {cfg.rwkv_head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}; {n_params} parameters "
          f"({4 * n_params / 1e9:.2f} GB fp32), initialized on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED + 12)
    lengths = rng.integers(24, 151, LM_REQUESTS)
    data = SyntheticLMDataset(vocab=cfg.vocab, seq_len=150,
                              batch=LM_REQUESTS, seed=SEED).batch_at(0)
    prompts = [data["tokens"][i, :n].tolist() for i, n in enumerate(lengths)]
    arrivals = [0] * 6 + [1] * 2 + [3] * 4 + [7] * 4

    def requests():
        return [Request(uid=i, prompt=p, max_new_tokens=LM_NEW_TOKENS,
                        arrival_tick=t)
                for i, (p, t) in enumerate(zip(prompts, arrivals))]

    def instrument(eng, first=None):
        """Record each step's kind and B7 launches, and the top-2 margin
        of the logits behind each emitted token; keep the first chunk
        step's inputs and logits in ``first``."""
        ticks, margins, now = [], {}, {}
        steps = {"prefill": eng._chunk_step, "decode": eng._step}

        def wrap(kind):
            def step(params_, state, *args):
                if kind == "prefill" and first is not None and not first:
                    first["inputs"] = (tree_map(torch.clone, state),
                                       *(a.clone() for a in args))
                before = kernel.wkv_fused.launches
                last, new_state = steps[kind](params_, state, *args)
                ticks.append((kind, kernel.wkv_fused.launches - before))
                top = torch.topk(last, 2, dim=-1).values
                now["margin"] = (top[:, 0] - top[:, 1]).cpu().numpy()
                if kind == "prefill" and first is not None \
                        and "last" not in first:
                    first["last"] = last.clone()
                return last, new_state
            return step

        eng._chunk_step, eng._step = wrap("prefill"), wrap("decode")
        absorb = eng._absorb

        def absorb_and_record(i, req, result):
            n = len(eng._gen(req))
            finished = absorb(i, req, result)
            if len(eng._gen(req)) > n:
                margins.setdefault(req.uid, []).append(float(now["margin"][i]))
            return finished

        eng._absorb = absorb_and_record
        return ticks, margins

    def serve(run_cfg, first=None):
        eng = ServeEngine(params, run_cfg, max_batch=LM_MAX_BATCH,
                          max_len=LM_MAX_LEN, prefill_chunk=LM_CHUNK,
                          device=dev)
        ticks, margins = instrument(eng, first)
        torch.cuda.synchronize()
        kernel.wkv_fused.launches = 0
        t0 = time.perf_counter()
        drive(eng, requests(), on_undrained="raise")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernel.wkv_fused.launches
        done = sorted(eng.completed, key=lambda r: r.uid)
        check([r.uid for r in done] == list(range(LM_REQUESTS))
              and not eng.failed and not eng.evicted,
              f"{run_cfg.wkv_impl}: completed {[r.uid for r in done]}, "
              f"failed {len(eng.failed)}, evicted {len(eng.evicted)}")
        check(all(len(r.output) == LM_NEW_TOKENS
                  and all(0 <= t < cfg.vocab for t in r.output)
                  for r in done), f"{run_cfg.wkv_impl}: outputs misshapen")
        kinds = [k for k, _ in ticks]
        print(f"[5c] ServeEngine ({run_cfg.wkv_impl}): {len(done)} requests "
              f"(prompts {min(lengths)}-{max(lengths)} tokens), "
              f"{sum(len(r.output) for r in done)} tokens in "
              f"{eng.stats['launches']} ticks ({kinds.count('prefill')} "
              f"prefill, {kinds.count('decode')} decode), {seconds:.2f} s; "
              f"B7 launches {launches}")
        return eng, done, ticks, margins, launches

    first = {}
    eng, done, ticks, margins, launches = serve(cfg, first)
    for j, (kind, n) in enumerate(ticks):
        want = cfg.n_layers if kind == "prefill" else 0
        check(n == want, f"step {j} ({kind}) launched B7 {n} times, not "
              f"{want}")
    check(launches == cfg.n_layers * sum(k == "prefill" for k, _ in ticks)
          and launches > 0, f"B7 launches {launches}")
    # The first prefill tick again, each layer's B7 call held against the
    # plain twin on the same inputs (these launches are not the path's).
    from repro_torch.kernels.rwkv_wkv import ops, ref

    plain_cfg = cfg.replace(wkv_impl="plain")
    state, tokens, _, n_active = first["inputs"]
    layer_errs = []

    def layer_err(y, s_new, r, k, v, lw, u, st, chunk):
        """Largest error of a WKV call's (y, state) against the plain
        twin's on the same inputs, of the largest |plain|."""
        y_p, s_p = ref.wkv_chunked_plain(r, k, v, lw, u, st, chunk)
        return max(float((y - y_p).abs().max()) / float(y_p.abs().max()),
                   float((s_new - s_p).abs().max()) / float(s_p.abs().max()))

    def checked(r, k, v, lw, u, st, *, chunk):
        y, s_new = real(r, k, v, lw, u, st, chunk=chunk)
        layer_errs.append(layer_err(y, s_new, r, k, v, lw, u, st, chunk))
        return y, s_new

    real, counted = ops.wkv_fused, kernel.wkv_fused.launches
    ops.wkv_fused = checked
    try:
        with torch.no_grad():
            replay, _ = rwkv6.prefill_step(params, state, tokens, n_active,
                                           cfg)
    finally:
        ops.wkv_fused = real
    kernel.wkv_fused.launches = counted
    print(f"[5c] first prefill tick replayed: B7 vs plain twin on each "
          f"layer's own inputs, largest error (of the largest |plain|) "
          f"{max(layer_errs):.3e} over {len(layer_errs)} layers; logits "
          f"equal to the run's bit for bit: {torch.equal(replay, first['last'])}")
    check(len(layer_errs) == cfg.n_layers
          and max(layer_errs) <= WKV_TOL, f"B7 on the model's inputs: "
          f"{layer_errs}")
    check(torch.equal(replay, first["last"]), "the replayed tick's logits "
          "differ from the run's")
    # The tick's logits from the first ``depth`` layers: B7, the plain
    # twin, the per-token scan, and the plain twin with every weight and
    # activation outside the WKV (which the model runs in float32) in
    # float64.  Shallower depths show how the spread grows; two wrong
    # WKVs show what the limit must catch.
    rows = n_active > 0
    p64 = tree_map(lambda a: a.double(), params)
    s64 = {k: a if k == "wkv" else a.double() for k, a in state.items()}
    f64_cfg = plain_cfg.replace(dtype=torch.float64)

    def tick(p, s, depth, run_cfg):
        p = {"embed": p["embed"],
             "layers": tree_map(lambda a: a[:depth], p["layers"])}
        s = tree_map(lambda a: a[:depth], s)
        with torch.no_grad():
            return rwkv6.prefill_step(p, s, tokens, n_active, run_cfg.replace(
                n_layers=depth))[0][rows].double()

    def gap(a, b):
        return float((a - b).abs().max())

    counted = kernel.wkv_fused.launches
    for depth in (d for d in LM_SWEEP_DEPTHS if d < cfg.n_layers):
        plain = tick(params, state, depth, plain_cfg)
        print(f"[5c] first prefill tick, first {depth:2d} layers: logits "
              f"cuda-plain {gap(tick(params, state, depth, cfg), plain):.3e}"
              f", plain-f64 {gap(plain, tick(p64, s64, depth, f64_cfg)):.3e}")
    kernel.wkv_fused.launches = counted
    last = {"cuda": first["last"][rows].double(),
            "plain": tick(params, state, cfg.n_layers, plain_cfg),
            "naive": tick(params, state, cfg.n_layers,
                          cfg.replace(wkv_impl="naive")),
            "f64": tick(p64, s64, cfg.n_layers, f64_cfg)}
    del p64, s64
    torch.cuda.empty_cache()
    dist = {f"{a}-{b}": gap(last[a], last[b])
            for a, b in (("cuda", "plain"), ("cuda", "naive"),
                         ("plain", "naive"), ("cuda", "f64"), ("plain", "f64"),
                         ("naive", "f64"))}
    print(f"[5c] first prefill tick ({int(rows.sum())} slots, "
          f"{int(n_active.sum())} tokens), all {cfg.n_layers} layers: logits "
          f"max abs differences (of {float(last['f64'].abs().max()):.3e}): "
          + ", ".join(f"{k} {v:.3e}" for k, v in dist.items()))
    check(dist["cuda-plain"] <= LM_LOGIT_TOL, f"first prefill tick: B7's "
          f"logits {dist['cuda-plain']} from the plain twin's, more than "
          f"{LM_LOGIT_TOL}")
    check(max(dist.values()) <= LM_SPREAD_TOL, f"first prefill tick: the "
          f"logits' float32 spread {dist} exceeds {LM_SPREAD_TOL}")
    plain_wkv = ops.wkv_chunked_plain

    def no_bonus(r, k, v, lw, u, st, chunk):
        return plain_wkv(r, k, v, lw, torch.zeros_like(u), st, chunk)

    def no_carry(r, k, v, lw, u, st, chunk):
        ys = []
        for i in range(0, r.shape[1], chunk):
            y, s_new = plain_wkv(*(a[:, i:i + chunk] for a in (r, k, v, lw)),
                                 u, st, chunk)
            ys.append(y)
        return torch.cat(ys, 1), s_new

    # Each wrong WKV must fail the per-layer check or the logits limit.
    for name, wrong in (("bonus u dropped", no_bonus),
                        ("state not carried across chunks", no_carry)):
        errs = []

        def traced(r, k, v, lw, u, st, chunk, wrong=wrong, errs=errs):
            y, s_new = wrong(r, k, v, lw, u, st, chunk)
            errs.append(layer_err(y, s_new, r, k, v, lw, u, st, chunk))
            return y, s_new

        ops.wkv_chunked_plain = traced
        try:
            moved = gap(tick(params, state, cfg.n_layers, plain_cfg),
                        last["plain"])
        finally:
            ops.wkv_chunked_plain = plain_wkv
        print(f"[5c] wrong WKV, {name}: per layer {max(errs):.3e} of the "
              f"largest |plain| (limit {WKV_TOL}), logits {moved:.3e} "
              f"(limit {LM_LOGIT_TOL})")
        check(max(errs) > WKV_TOL or moved > LM_LOGIT_TOL, f"the wrong WKV "
              f"({name}) passes both the per-layer check and the logits "
              "limit")
    del state, first
    # Tokens of a plain-twin run: identical, or the first difference at a
    # near-tie.
    p_eng, p_done, _, p_margins, p_launches = serve(plain_cfg)
    check(p_launches == 0, f"the plain run launched B7 {p_launches} times")
    same = 0
    for a, b in zip(done, p_done):
        if a.output == b.output:
            same += 1
            continue
        j = next(i for i, (x, y) in enumerate(zip(a.output, b.output))
                 if x != y)
        m = min(margins[a.uid][j], p_margins[b.uid][j])
        print(f"[5c] request {a.uid}: tokens differ first at output {j} "
              f"({a.output[j]} vs {b.output[j]}), top-2 margin {m:.3e} "
              f"(limit {LM_LOGIT_TOL})")
        check(m <= LM_LOGIT_TOL, f"request {a.uid}: tokens differ at output "
              f"{j}, not a near-tie (margin {m})")
    print(f"[5c] tokens: {same} of {len(done)} requests identical to the "
          f"plain-twin run; the smallest top-2 margin behind any emitted "
          f"token {min(min(v) for v in margins.values()):.3e}")
    del p_eng, p_done

    # Sessions: 4 conversations of 3 turns on 4 slots.
    srng = np.random.default_rng(SEED + 13)
    sdata = SyntheticLMDataset(vocab=cfg.vocab, seq_len=90, batch=12,
                               seed=SEED + 1).batch_at(0)["tokens"]
    turns = [[sdata[3 * i + t, :int(srng.integers(20, 91))].tolist()
              for t in range(3)] for i in range(4)]
    sess = SessionEngine(params, cfg, max_batch=4, max_len=LM_MAX_LEN,
                         prefill_chunk=LM_CHUNK, device=dev)
    s_ticks, _ = instrument(sess)
    torch.cuda.synchronize()
    kernel.wkv_fused.launches = 0
    t0 = time.perf_counter()
    sreqs = [SessionRequest(uid=i, turns=t, max_new_tokens=8)
             for i, t in enumerate(turns)]
    drive(sess, sreqs, on_undrained="raise")
    torch.cuda.synchronize()
    s_launches = kernel.wkv_fused.launches
    check(sorted(r.uid for r in sess.completed) == [0, 1, 2, 3]
          and all(r.done and len(r.outputs) == 3
                  and all(len(o) == 8 for o in r.outputs) for r in sreqs),
          "sessions did not all complete their 3 turns")
    n_prefill = sum(k == "prefill" for k, _ in s_ticks)
    check(all(n == (cfg.n_layers if k == "prefill" else 0)
              for k, n in s_ticks) and s_launches == cfg.n_layers * n_prefill
          and n_prefill >= 3, f"session B7 launches {s_launches} over "
          f"{n_prefill} prefill ticks")
    print(f"[5c] SessionEngine: 4 sessions x 3 turns (turn prompts "
          f"{min(len(t) for ts in turns for t in ts)}-"
          f"{max(len(t) for ts in turns for t in ts)} tokens) in "
          f"{sess.stats['launches']} ticks ({n_prefill} prefill), "
          f"{time.perf_counter() - t0:.2f} s; B7 launches {s_launches}")
    return {"params": params, "cfg": cfg, "requests": requests, "launches": launches + s_launches,
            "serve_launches": launches, "session_launches": s_launches}


LM_TRAIN_STEPS = 3  # full width and depth, through launch/train.py
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 128  # the launcher's defaults
WKV_TRAIN_SHAPE = (LM_TRAIN_BATCH, LM_TRAIN_SEQ, 40, 64)  # (B, S, H, D)
WKV_GRAD_TOL = 1e-4  # of the largest |float64 value|, as B3 and B4
# Depth 2 at full width: each gradient leaf of the B7 path within this
# share of the leaf's largest |value| of the plain-WKV path's, both
# float32, and of the path whose WKV runs in float64 (every leaf sat
# near 2e-4 from the plain path's at this seed, PERF.md §6).
LM_GRAD_TOL = 1e-3
LM_LOSS_RTOL = 1e-5  # depth 2: the three losses, of the float64 one
LM_RESUME_STEPS = (4, 2)  # SMOKE: 4 steps, a restore, 2 more
TRAIN_REPS = 5  # CUDA-event runs a part of the full-width step


def check_wkv_grads(torch, np, dev):
    """Phase 5g (a): `ops.wkv` (B7 forward, the closed-form backward) at
    the serving tick's shape and at the train step's, from a nonzero
    state with both cotangents, its outputs and six gradients against
    autograd of the plain twin in float64 on the card.  Returns the
    largest error (of the largest |value|)."""
    from repro_torch.kernels.rwkv_wkv import kernel, ops, ref

    worst = 0.0
    for i, (what, shape) in enumerate((("serving tick", WKV_SERVE_SHAPE),
                                       ("train step", WKV_TRAIN_SHAPE))):
        ins = wkv_inputs(torch, np, dev, *shape, SEED + 40 + 2 * i)
        gen = torch.Generator(dev).manual_seed(SEED + 41 + 2 * i)
        dy = torch.randn(ins[0].shape, generator=gen, device=dev)
        ds = torch.randn(ins[5].shape, generator=gen, device=dev)
        counted = kernel.wkv_fused.launches
        live = [a.clone().requires_grad_() for a in ins]
        y, sf = ops.wkv(*live)
        grads = torch.autograd.grad((y, sf), live, (dy, ds))
        torch.cuda.synchronize()
        check(kernel.wkv_fused.launches == counted + 1, "the WKV Function "
              "did not launch B7 once")
        kernel.wkv_fused.launches = counted
        live64 = [a.double().requires_grad_() for a in ins]
        y64, s64 = ref.wkv_chunked_plain(*live64)
        want = torch.autograd.grad((y64, s64), live64, (dy.double(),
                                                        ds.double()))
        line = ""
        for name, got, w in zip(("y", "state", "dr", "dk", "dv", "dlw", "du",
                                 "dstate0"), (y, sf, *grads),
                                (y64, s64, *want)):
            got, w = got.detach(), w.detach()
            err = float((got.double() - w).abs().max())
            scale = float(w.abs().max())
            worst = max(worst, err / scale)
            line += f" {name} {err / scale:.2e} (of {scale:.2e})"
            check(err <= WKV_GRAD_TOL * scale, f"WKV Function at {shape}: "
                  f"{name} differs by {err}, more than {WKV_GRAD_TOL} of "
                  f"{scale}")
        print(f"[5g] (a) WKV Function at the {what}'s {shape} vs float64 "
              f"autograd of the plain twin, nonzero state, both cotangents; "
              f"error of the largest |value| (limit {WKV_GRAD_TOL}):{line}")
    return worst


def lm_batch(torch, dev, vocab, seed=0):
    """The launcher's batch: `SyntheticLMDataset` at 8 x 128, on ``dev``."""
    from repro_torch.data import SyntheticLMDataset

    data = SyntheticLMDataset(vocab=vocab, seq_len=LM_TRAIN_SEQ,
                              batch=LM_TRAIN_BATCH, seed=seed).batch_at(0)
    return {k: torch.from_numpy(v).to(dev) for k, v in data.items()}


def lm_value_and_grad(torch, params, batch, cfg):
    """(loss, gradient leaves in `tree_leaves` order) of the LM loss."""
    from repro_torch.models.families import get_family
    from repro_torch.tree import tree_leaves, tree_unflatten

    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, _ = get_family(cfg).loss(tree_unflatten(params, live), batch, cfg)
    return loss.detach(), torch.autograd.grad(loss, live)


def wkv_float64(r, k, v, lw, u, state, chunk=None, impl=None):
    """The plain WKV twin in float64, its outputs rounded to float32: the
    depth-2 witness's WKV (autograd runs through it in float64)."""
    from repro_torch.kernels.rwkv_wkv import ref

    y, sf = ref.wkv_chunked_plain(*(a.double() for a in (r, k, v, lw, u,
                                                         state)))
    return y.float(), sf.float()


def check_lm_grads_depth2(torch, np, dev, cfg):
    """Phase 5g (b): the first two layers at full width, batch 8 x 128:
    the gradient tree through B7 against the one through the plain WKV,
    both float32, and against a third whose WKV runs in float64 (the rest
    of the model as in the other two), each leaf within ``LM_GRAD_TOL`` of
    its largest |value|; the three losses within ``LM_LOSS_RTOL``.  Prints
    how far each float32 WKV path sits from the float64 one.  Returns the
    largest share of B7 against the plain WKV."""
    from repro_torch.common.pytree import (
        assert_trees_all_finite,
        flatten_with_names,
    )
    from repro_torch.kernels.rwkv_wkv import kernel
    from repro_torch.models import rwkv6
    from repro_torch.models.families import get_family
    from repro_torch.tree import tree_unflatten

    c2 = cfg.replace(n_layers=2)
    params, _ = get_family(c2).init(torch.Generator(dev).manual_seed(SEED),
                                    c2)
    batch = lm_batch(torch, dev, cfg.vocab, SEED + 1)
    counted = kernel.wkv_fused.launches
    runs = {impl: lm_value_and_grad(torch, params, batch,
                                    c2.replace(wkv_impl=impl))
            for impl in ("cuda", "plain")}
    torch.cuda.synchronize()
    check(kernel.wkv_fused.launches - counted == 2 * c2.n_layers,
          f"depth 2: B7 launched {kernel.wkv_fused.launches - counted} "
          "times, not twice a layer")
    kernel.wkv_fused.launches = counted
    real = rwkv6.wkv_chunked
    rwkv6.wkv_chunked = wkv_float64
    try:
        runs["float64"] = lm_value_and_grad(torch, params, batch,
                                            c2.replace(wkv_impl="plain"))
    finally:
        rwkv6.wkv_chunked = real
    check(kernel.wkv_fused.launches == counted, "the float64 witness "
          "launched B7")
    named = {impl: dict(flatten_with_names(tree_unflatten(params, list(g))))
             for impl, (_, g) in runs.items()}
    assert_trees_all_finite(named["cuda"], "depth-2 gradient (B7)")

    def shares(got, want):
        out = {}
        for name, w in named[want].items():
            scale = float(w.abs().max())
            err = float((named[got][name] - w).abs().max())
            out[name] = err / scale if scale else err
        return sorted(out.items(), key=lambda kv: -kv[1])

    pairs = {("cuda", "plain"): "B7 vs plain", ("cuda", "float64"):
             "B7 vs float64", ("plain", "float64"): "plain vs float64"}
    worst = {}
    loss = {impl: float(run[0]) for impl, run in runs.items()}
    print(f"[5g] (b) {c2.name} at depth 2, full width, batch "
          f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}: loss B7 {loss['cuda']:.9f}, "
          f"plain {loss['plain']:.9f}, float64 WKV {loss['float64']:.9f}")
    for pair, what in pairs.items():
        ranked = shares(*pair)
        worst[pair] = ranked[0]
        print(f"[5g] (b) gradient leaves, {what}: largest error of the "
              f"leaf's largest |value| (limit {LM_GRAD_TOL}): "
              + ", ".join(f"{n} {v:.2e}" for n, v in ranked[:5])
              + f"; the median leaf "
              f"{statistics.median(v for _, v in ranked):.2e}")
    for a, b in (("cuda", "plain"), ("cuda", "float64"),
                 ("plain", "float64")):
        check(abs(loss[a] - loss[b]) <= LM_LOSS_RTOL * abs(loss["float64"]),
              f"depth 2: loss {a} {loss[a]} and {b} {loss[b]} differ by more "
              f"than {LM_LOSS_RTOL}")
    for pair in (("cuda", "plain"), ("cuda", "float64")):
        name, share = worst[pair]
        check(share <= LM_GRAD_TOL, f"depth 2, {pairs[pair]}: gradient leaf "
              f"{name} differs by {share} of its largest value")
    return worst[("cuda", "plain")][1], worst[("cuda", "float64")][1], \
        worst[("plain", "float64")][1]


def time_lm_train(torch, np, dev, trainer, cfg, flush):
    """Phase 5g: the parts of the full-width train step on its own state,
    each timed alone by CUDA events (median of ``TRAIN_REPS``): the
    forward (loss with remat), forward + backward, one layer's recompute,
    B7 forward and the closed-form WKV backward at a layer's shape, the
    head and CE forward + backward, and the in-place AdamW update (which
    writes the state).  Returns the parts in ms a step."""
    from repro_torch.common.pytree import param_count
    from repro_torch.kernels.rwkv_wkv import kernel, ops
    from repro_torch.models import rwkv6
    from repro_torch.models.families import cross_entropy, get_family
    from repro_torch.models.layers import lm_head
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    counted = kernel.wkv_fused.launches
    state = trainer.state
    params = state["params"]
    batch = lm_batch(torch, dev, cfg.vocab, SEED + 2)
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    tree = tree_unflatten(params, live)
    family = get_family(cfg)

    def forward():
        return family.loss(tree, batch, cfg)[0]

    def forward_backward():
        return torch.autograd.grad(forward(), live)

    parts = {"forward (remat: layer inputs kept)":
             cuda_ms(torch, forward, flush, TRAIN_REPS)}
    parts["forward + backward"] = cuda_ms(torch, forward_backward, flush,
                                          TRAIN_REPS)
    b, s, d = LM_TRAIN_BATCH, LM_TRAIN_SEQ, cfg.d_model
    h, hd = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    gen = torch.Generator(dev).manual_seed(SEED + 3)
    x = torch.randn((b, s, d), generator=gen, device=dev)
    lp = tree_map(lambda a: a[0], tree["layers"])
    st = tree_map(lambda a: a[0], rwkv6.init_rwkv_state(cfg, b,
                                                        device=dev)[0])
    layer_ms = cuda_ms(torch, lambda: rwkv6._layer(x, lp, st, cfg), flush)
    wkv_in = [torch.randn((b, s, h, hd), generator=gen, device=dev)
              for _ in range(3)]
    lw = -torch.rand((b, s, h, hd), generator=gen, device=dev) * 5
    u = params["layers"]["att"]["u"][0].float()
    s0 = torch.zeros((b, h, hd, hd), device=dev)
    dy = torch.randn((b, s, h, hd), generator=gen, device=dev)
    with torch.no_grad():
        b7_ms = cuda_ms(torch, lambda: kernel.wkv_fused(*wkv_in, lw, u, s0),
                        flush)
    bwd_ms = cuda_ms(torch, lambda: ops.wkv_backward(*wkv_in, lw, u, s0, dy,
                                                     None), flush)
    head = [tree["embed"]["final_norm"]["scale"], tree["embed"]["head"]]
    xh = x.clone().requires_grad_()

    def head_ce():
        logits = lm_head(tree["embed"], xh, cfg)
        return torch.autograd.grad(cross_entropy(logits, batch["targets"]),
                                   [xh, *head])

    head_ms = cuda_ms(torch, head_ce, flush)
    grads = tree_unflatten(params, list(forward_backward()))
    opt = adamw(cosine_warmup(3e-3, warmup=20, total=LM_TRAIN_STEPS))
    opt_ms = cuda_ms(torch, lambda: opt.update_in_place(
        grads, state["opt"], params, state["step"]), flush, TRAIN_REPS)
    del grads
    kernel.wkv_fused.launches = counted
    n_params = param_count(params)
    # read p, g, m, v and write p, m, v once each, float32
    opt_bound_ms, _ = bound(7 * 4 * n_params, 0)
    n = cfg.n_layers
    parts.update({
        f"  of which recompute, one layer's forward x {n}": n * layer_ms,
        f"  of which B7 forward x {2 * n} (forward and recompute)":
            2 * n * b7_ms,
        f"  of which WKV backward (closed form, plain) x {n}": n * bwd_ms,
        "  of which head + CE forward and backward": head_ms,
        "optimizer (AdamW in place, clip included)": opt_ms,
        "  its bound (p, g, m, v read and p, m, v written once)":
            opt_bound_ms})
    for name, t in parts.items():
        print(f"[5g] train step part: {name}: {t:.3f} ms")
    print(f"[5g] train step parts: forward + backward + optimizer "
          f"{parts['forward + backward'] + opt_ms:.3f} ms; one layer's "
          f"forward {layer_ms:.3f} ms, B7 {b7_ms:.4f} ms, WKV backward "
          f"{bwd_ms:.3f} ms at ({b}, {s}, {h}, {hd})")
    return parts


def lm_train_path(torch, np, dev, lm, flush=None):
    """Phase 5g: LM training.  (a) the WKV Function against float64
    autograd; (b) depth 2 at full width, B7 against the plain WKV's
    gradients; (c) `launch/train.py`'s ``main`` at full width and depth for
    ``LM_TRAIN_STEPS`` steps (every loss and gradient finite, B7 twice a
    layer a step, the step's time and peak memory), then its parts; (d)
    at SMOKE, 4 steps with checkpoints, a fresh run that restores and
    takes 2 more, bit for bit the losses of 6 steps in one run.  The
    served parameters are freed for (c) and drawn again from the seed
    after it.  Returns what the kernels line reads."""
    import tempfile

    from repro_torch.common.pytree import (
        assert_trees_all_finite,
        param_count,
    )
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.rwkv_wkv import kernel
    from repro_torch.launch import train as launch_train
    from repro_torch.models.families import get_family

    cfg = lm["cfg"]
    wkv_grad_err = check_wkv_grads(torch, np, dev)
    depth2_err, depth2_err64, plain_err64 = check_lm_grads_depth2(
        torch, np, dev, cfg)

    # (c) the served parameters give way to the train state
    lm["params"] = None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    real, per_step = launch_train.make_train_step, []

    def counting_step(*args, **kw):
        step = real(*args, **kw)

        def counted(state, batch):
            before = kernel.wkv_fused.launches
            out = step(state, batch)
            per_step.append(kernel.wkv_fused.launches - before)
            return out

        return counted

    launch_train.make_train_step = counting_step
    kernel.wkv_fused.launches = 0
    t0 = time.perf_counter()
    try:
        trainer = launch_train.main(["--arch", LM_ARCH, "--steps",
                                     str(LM_TRAIN_STEPS)])
    finally:
        launch_train.make_train_step = real
    torch.cuda.synchronize()
    launches = kernel.wkv_fused.launches
    run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    total_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    hist = trainer.history
    state = trainer.state
    n_params = param_count(state["params"])
    losses = [h["loss"] for h in hist]
    step_s = [h["step_time_s"] for h in hist]
    print(f"[5g] (c) launch/train.py --arch {LM_ARCH} --steps "
          f"{LM_TRAIN_STEPS}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params} parameters fp32, batch {LM_TRAIN_BATCH} x "
          f"{LM_TRAIN_SEQ}, AdamW in place; {run_s:.2f} s with the init")
    print(f"[5g] (c) losses {losses}; step times (host clock, through a "
          f"synchronize) " + ", ".join(f"{t * 1e3:.1f}" for t in step_s)
          + f" ms; B7 launches a step {per_step}")
    check(len(hist) == LM_TRAIN_STEPS and state["step"] == LM_TRAIN_STEPS,
          f"{len(hist)} steps ran, state step {state['step']}")
    check(all(np.isfinite(v) for v in losses), f"a loss is not finite: "
          f"{losses}")
    # AdamW's moments are finite only if every step's gradient was
    for name, tree in (("params", state["params"]), ("m", state["opt"]["m"]),
                       ("v", state["opt"]["v"])):
        assert_trees_all_finite(tree, f"the train state's {name}")
    check(per_step == [2 * cfg.n_layers] * LM_TRAIN_STEPS
          and launches == 2 * cfg.n_layers * LM_TRAIN_STEPS,
          f"B7 launched {per_step} a step ({launches} in all), not "
          f"{2 * cfg.n_layers} a step")
    check(peak_gb < total_gb, f"peak {peak_gb} GB of {total_gb} GB")
    steady = statistics.median(step_s[1:])
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    print(f"[5g] (c) train step {steady * 1e3:.1f} ms (median of steps "
          f"2-{LM_TRAIN_STEPS}), {tokens / steady:.1f} tokens/s; peak "
          f"memory allocated {peak_gb:.2f} GB (max_memory_allocated, "
          f"{base_gb:.2f} GB of other phases resident before) of "
          f"{total_gb:.2f} GB; card {smi_line()}")
    if flush is None:
        flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                            device=dev)
    parts = time_lm_train(torch, np, dev, trainer, cfg, flush)
    del trainer, state, flush
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # (d) resume at SMOKE, bit for bit
    smoke = ["--arch", LM_ARCH, "--smoke"]
    whole = launch_train.main(smoke + ["--steps", str(sum(LM_RESUME_STEPS))])
    with tempfile.TemporaryDirectory(prefix=".ckpt-", dir=ROOT) as ckdir:
        ck = ["--ckpt-dir", ckdir, "--ckpt-every", "2"]
        first = launch_train.main(smoke + ck + ["--steps",
                                                str(LM_RESUME_STEPS[0])])
        second = launch_train.main(smoke + ck + ["--steps",
                                                 str(LM_RESUME_STEPS[1])])
    got = [h["loss"] for h in first.history + second.history]
    want = [h["loss"] for h in whole.history]
    scfg = get_smoke_config(LM_ARCH)
    print(f"[5g] (d) {scfg.name} on the card: {LM_RESUME_STEPS[0]} steps, "
          f"restored at step {first.state['step']} by a fresh trainer, "
          f"{LM_RESUME_STEPS[1]} more: losses {got}; one run of "
          f"{sum(LM_RESUME_STEPS)}: {want}; bit for bit: {got == want}")
    check(second.state["step"] == sum(LM_RESUME_STEPS) and got == want,
          "the resumed run's losses differ from one uninterrupted run's")
    del whole, first, second

    lm["params"], _ = get_family(cfg).init(
        torch.Generator(dev).manual_seed(SEED), cfg)
    return {"launches": launches, "wkv_grad_err": wkv_grad_err,
            "depth2_err": depth2_err, "depth2_err_vs_float64": depth2_err64,
            "plain_err_vs_float64": plain_err64, "step_ms": steady * 1e3,
            "peak_gb": peak_gb, "parts": parts}


def time_lm(torch, np, dev, lm, wkv_in, flush):
    """Phase 9, LM part: B7 alone at the serving tick's shape beside its
    bound and its plain twin; the engine's time per prefill and per
    decode tick, warm; and the parts of each, timed alone.  Returns B7's
    row of the kernels line, without launches and error."""
    from repro_torch.common.pytree import param_count
    from repro_torch.kernels.rwkv_wkv import kernel, ref
    from repro_torch.models import rwkv6
    from repro_torch.models.layers import apply_norm, embed_tokens, lm_head
    from repro_torch.serving import drive
    from repro_torch.tree import tree_map

    counted = kernel.wkv_fused.launches
    r, k, v, lw, u, s0 = wkv_in
    b, s, h, d = r.shape
    ms = cuda_ms(torch, lambda: kernel.wkv_fused(r, k, v, lw, u, s0), flush)
    plain_ms = cuda_ms(torch, lambda: ref.wkv_chunked_plain(
        r, k, v, lw, u, s0), flush)
    nbytes = 4 * (5 * r.numel() + u.numel() + 2 * s0.numel())
    n_chunks = -(-s // 16)
    # per chunk and head: inter q@S0 and the state's kd^T v (2 C D^2 each),
    # the strictly causal scores and their product with v (C(C-1) D each),
    # the decay's scale of S (D^2), the bonus diagonal (3 C D)
    flops = b * h * n_chunks * (4 * 16 * d * d + 2 * 16 * 15 * d + d * d
                                + 3 * 16 * d)
    b_ms, b_by = bound(nbytes, flops)
    print(f"[9] wkv_fused at {tuple(r.shape)}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, no library call computes it; bound "
          f"{b_ms:.4f} ms by {b_by} ({nbytes} bytes, {flops} FLOP)")
    geo = kernel.launch_geometry(b, h, d)
    print(f"[9] wkv_fused launch geometry at {tuple(r.shape)}: "
          f"{geo['blocks']} blocks x {geo['threads']} threads, "
          f"{geo['smem_bytes']} bytes of shared memory a block, a ring of "
          f"{geo['stages']} chunk tiles")

    # The engine per tick, warm: the same requests again, each step timed
    # on the host clock (a step ends in the copy of its tokens to the
    # host).
    from repro_torch.serving import ServeEngine

    cfg, params = lm["cfg"], lm["params"]
    eng = ServeEngine(params, cfg, max_batch=LM_MAX_BATCH, max_len=LM_MAX_LEN,
                      prefill_chunk=LM_CHUNK, device=dev)
    launch = eng._launch
    per = {"prefill": [], "decode": []}

    def timed(active):
        t0 = time.perf_counter()
        nxt, adv = launch(active)
        per["prefill" if int(adv.max()) > 1 else "decode"].append(
            (time.perf_counter() - t0) * 1e3)
        return nxt, adv

    eng._launch = timed
    drive(eng, lm["requests"](), on_undrained="raise")
    tick = {kind: statistics.median(v) for kind, v in per.items()}
    weight_bytes = 4 * param_count(params)
    print(f"[9] LM engine, warm (host clock): prefill tick "
          f"{tick['prefill']:.3f} ms (median of {len(per['prefill'])}, "
          f"{LM_MAX_BATCH} slots x {LM_CHUNK} tokens), decode tick "
          f"{tick['decode']:.3f} ms (median of {len(per['decode'])}, "
          f"{LM_MAX_BATCH} slots); reading the weights once takes "
          f"{weight_bytes / PEAK_BYTES_PER_S * 1e3:.3f} ms at the HBM rate")

    # Where a tick goes: one layer's parts at each tick's shape, timed
    # alone (CUDA events), times the layers; the head once.
    lp = tree_map(lambda a: a[0], params["layers"])
    gen = torch.Generator(dev).manual_seed(SEED + 14)
    with torch.no_grad():
        for kind, seq in (("prefill", LM_CHUNK), ("decode", 1)):
            x = torch.randn((LM_MAX_BATCH, seq, cfg.d_model), generator=gen,
                            device=dev)
            prev = torch.randn((LM_MAX_BATCH, cfg.d_model), generator=gen,
                               device=dev)
            st = torch.randn((LM_MAX_BATCH, cfg.n_rwkv_heads,
                              cfg.rwkv_head_dim, cfg.rwkv_head_dim),
                             generator=gen, device=dev) * 0.1
            lengths = torch.full((LM_MAX_BATCH,), seq, device=dev)
            chunked = kind == "prefill"
            kw = dict(chunked=chunked, lengths=lengths if chunked else None)
            parts = {
                "norms (2 a layer)": cuda_ms(torch, lambda: (
                    apply_norm(lp["att_norm"], x, cfg),
                    apply_norm(lp["ffn_norm"], x, cfg)), flush),
                "time mix (ddlerp, r/k/v/g/decay projections, WKV, "
                "GroupNorm, output)": cuda_ms(torch, lambda: rwkv6._time_mix(
                    lp["att"], x, prev, st, cfg, **kw), flush),
            }
            hh, dd = cfg.n_rwkv_heads, cfg.rwkv_head_dim
            wk = [torch.randn((LM_MAX_BATCH, seq, hh, dd), generator=gen,
                              device=dev) for _ in range(3)]
            wl = -torch.rand((LM_MAX_BATCH, seq, hh, dd), generator=gen,
                             device=dev) * 5
            uu = lp["att"]["u"].float()
            wkv_fn = ((lambda: kernel.wkv_fused(*wk, wl, uu, st)) if chunked
                      else (lambda: rwkv6.wkv_naive(*wk, wl, uu, st)))
            parts["  of which WKV (B7)" if chunked else
                  "  of which WKV (per-token scan, plain)"] = cuda_ms(
                      torch, wkv_fn, flush)
            parts["channel mix (ddlerp, squared-ReLU FFN, receptance)"] = \
                cuda_ms(torch, lambda: rwkv6._channel_mix(
                    lp["ffn"], x, prev, cfg, lengths=kw["lengths"]), flush)
            toks = torch.zeros((LM_MAX_BATCH, seq), dtype=torch.long,
                               device=dev)
            once = {"embedding": cuda_ms(torch, lambda: embed_tokens(
                        params["embed"], toks, cfg), flush),
                    f"head (final norm, {cfg.d_model} x "
                    f"{cfg.padded_vocab} projection, all positions)":
                    cuda_ms(torch, lambda: lm_head(
                        params["embed"], x, cfg), flush)}
            wkv_key = [key for key in parts if key.startswith("  of which")][0]
            proj = parts["time mix (ddlerp, r/k/v/g/decay projections, WKV, "
                         "GroupNorm, output)"] - parts[wkv_key]
            total = (cfg.n_layers * (sum(parts.values()) - parts[wkv_key])
                     + sum(once.values()))
            for name, t in parts.items():
                print(f"[9] LM {kind} tick part, one layer: {name}: {t:.4f} "
                      f"ms (x {cfg.n_layers} = {cfg.n_layers * t:.3f} ms)")
            print(f"[9] LM {kind} tick part: projections and the rest of the "
                  f"time mix (time mix less WKV), x {cfg.n_layers}: "
                  f"{cfg.n_layers * proj:.3f} ms")
            for name, t in once.items():
                print(f"[9] LM {kind} tick part: {name}: {t:.3f} ms")
            print(f"[9] LM {kind} tick: parts sum to {total:.3f} ms of "
                  f"{tick[kind]:.3f} ms")
    kernel.wkv_fused.launches = counted
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


def stem_launches(conv) -> dict:
    """B1's and B2's launch counts (the tuner picks either for a stem)."""
    return {"p2m_conv_fused": conv.p2m_conv_fused.launches,
            "p2m_conv_fused_pipelined":
                conv.p2m_conv_fused.launches_pipelined}


def reset_stem_launches(conv) -> None:
    conv.p2m_conv_fused.launches = 0
    conv.p2m_conv_fused.launches_pipelined = 0


def gated_launches(gated) -> dict:
    """B5's launch counts by body: B1's gated body and the ring."""
    return {"p2m_conv_fused_gated": gated.p2m_conv_fused_gated.launches,
            "p2m_conv_fused_gated_pipelined":
                gated.p2m_conv_fused_gated.launches_pipelined}


def reset_gated_launches(gated) -> None:
    gated.p2m_conv_fused_gated.launches = 0
    gated.p2m_conv_fused_gated.launches_pipelined = 0


def check_pipelined_kernel(torch, np, dev, serve_in, adc):
    """Phase 3d: B2 (the pipelined ring) against B1, bit for bit, `out`
    and `raw`, at depths 2, 3 and 8 (which clamps to k) and block_h 1, 2
    and 4, in every mode, at the serving (8x560²x3, the engine's folded
    stem), stream (4x560²x3) and training (32x560²x3, random weights)
    shapes, and over random geometries with s < k, N in {5, 8, 24} and
    dx 1-4.  Also against the plain twin at the serving shape.  Returns
    that largest raw/relu difference."""
    from repro_torch.configs.p2m_vww import CONFIG, TRAIN_BATCH
    from repro_torch.kernels.p2m_conv import conv

    rng = np.random.default_rng(SEED + 30)
    size = CONFIG.image_size

    def case(b, h, w, c, k, n, dw, dx):
        coeffs = tuple(tuple(float(v) for v in rng.uniform(-1, 1, dx))
                       for _ in range(dw))
        imgs = torch.from_numpy(rng.random((b, h, w, c), np.float32)).to(dev)
        wt = torch.from_numpy(rng.uniform(-0.4, 0.4, (k * k * c, n)).astype(
            np.float32))
        sh = torch.from_numpy(rng.uniform(-0.2, 0.2, n).astype(np.float32))
        return imgs, conv.premix_rows(wt, coeffs, k).to(dev), sh.to(dev)

    paper_imgs, wrows, shift = serve_in
    train_imgs = torch.from_numpy(rng.random((TRAIN_BATCH, size, size, 3),
                                             np.float32)).to(dev)
    cases = [  # name, inputs, k, s
        (f"serving {len(paper_imgs)}x{size}²", (paper_imgs, wrows, shift),
         5, 5),
        (f"stream 4x{size}²", (paper_imgs[:4].contiguous(), wrows, shift),
         5, 5),
        (f"training {TRAIN_BATCH}x{size}²", (train_imgs, wrows, shift), 5,
         5),
        ("k5 s3 N8 dx3", case(2, 64, 64, 3, 5, 8, 3, 3), 5, 3),
        ("k4 s3 N5 dx1", case(3, 37, 41, 3, 4, 5, 3, 1), 4, 3),
        ("k3 s2 N24 dx2", case(2, 33, 30, 3, 3, 24, 3, 2), 3, 2),
        ("k5 s4 N24 dx4", case(2, 40, 43, 3, 5, 24, 4, 4), 5, 4),
        ("k5 s2 N5 dx2", case(1, 50, 50, 3, 5, 5, 2, 2), 5, 2),
        ("k4 s2 N8 dx4", case(4, 29, 31, 2, 4, 8, 3, 4), 4, 2),
    ]
    serve_err = 0.0
    for name, (x, wr, sh), kk, ss in cases:
        for mode in ("raw", "relu", "quant"):
            kw = dict(kernel=kk, stride=ss, mode=mode, v_lsb=adc.v_lsb,
                      max_count=adc.max_count, want_raw=True)
            out1, raw1 = conv.p2m_conv_fused(x, wr, sh, **kw)
            n_b2 = 0
            for depth in (2, 3, 8):
                for bh in (1, 2, 4):
                    out2, raw2 = conv.p2m_conv_fused(
                        x, wr, sh, block_h=bh, pipeline_depth=depth, **kw)
                    torch.cuda.synchronize()
                    check(torch.equal(out2, out1) and torch.equal(raw2, raw1),
                          f"{name} {mode} depth {depth} block_h {bh}: B2 "
                          "differs from B1")
                    n_b2 += 1
            line = (f"[3d] {name:17s} {mode:5s} {tuple(out1.shape)}: B2 == "
                    f"B1 bitwise (out and raw) at depths 2, 3, 8 x block_h "
                    f"1, 2, 4 ({n_b2} launches)")
            if name.startswith("serving"):
                ref_out, ref_raw = conv.p2m_conv_premixed_plain(
                    x, wr, sh, **kw)
                err = float((raw1 - ref_raw).abs().max())
                if mode != "quant":
                    err = max(err, float((out1 - ref_out).abs().max()))
                    check(err <= RAW_TOL, f"{name}: B2 vs plain {err}")
                serve_err = max(serve_err, err)
                line += f"; vs plain {err:.3e}"
            print(line)
    del train_imgs
    return serve_err


def check_pipelined_grads(torch, np, dev):
    """Phase 3e: at the training shape (32x560²x3, the train stem's raw
    mode), `ops.p2m_conv` with pipeline_depth=2 and with 0 give the same
    gradients for images, w and shift, bit for bit."""
    from repro_torch.configs.p2m_vww import CONFIG, TRAIN_BATCH
    from repro_torch.core.pixel_model import default_pixel_model
    from repro_torch.kernels.p2m_conv import conv, ops

    cfg = CONFIG.p2m
    rng = np.random.default_rng(SEED + 31)
    size = CONFIG.image_size
    kk = cfg.kernel * cfg.kernel * cfg.in_channels
    imgs = torch.from_numpy(rng.random((TRAIN_BATCH, size, size, 3),
                                       np.float32)).to(dev)
    wt = torch.from_numpy((rng.uniform(-1, 1, (kk, cfg.out_channels))
                           * (3.0 / kk) ** 0.5).astype(np.float32)).to(dev)
    sh = torch.from_numpy(rng.uniform(-0.2, 0.2, cfg.out_channels).astype(
        np.float32)).to(dev)
    ho = cfg.out_spatial(size)
    ct = torch.from_numpy(rng.standard_normal(
        (TRAIN_BATCH, ho, ho, cfg.out_channels)).astype(np.float32)).to(dev)
    grads, counts = {}, {}
    for depth in (0, 2):
        ins = [t.clone().requires_grad_(True) for t in (imgs, wt, sh)]
        before = stem_launches(conv)
        out = ops.p2m_conv(*ins, default_pixel_model(), cfg.adc, "relu",
                           cfg.kernel, cfg.stride, pipeline_depth=depth)
        grads[depth] = torch.autograd.grad((out * ct).sum(), ins)
        counts[depth] = {k: v - before[k]
                         for k, v in stem_launches(conv).items()}
    torch.cuda.synchronize()
    check(counts[0] == {"p2m_conv_fused": 1, "p2m_conv_fused_pipelined": 0}
          and counts[2] == {"p2m_conv_fused": 0,
                            "p2m_conv_fused_pipelined": 1},
          f"forward launches {counts}")
    for name, a, b in zip(("images", "w", "shift"), grads[0], grads[2]):
        check(torch.equal(a, b), f"d/d {name} differs between depth 2 and 0")
    print(f"[3e] training shape {tuple(imgs.shape)}, relu: gradients for "
          f"images, w and shift through p2m_conv at pipeline_depth 2 (B2) "
          f"== at 0 (B1), bit for bit; forward launches {counts}")


def tune_signatures(torch, dev, signatures):
    """Phase 3f: the tuner at each signature (name -> get_conv_blocks
    arguments), timed as the first call of a path would meet it; print
    each decision record: every candidate with its shared-memory bytes and
    time, and the winner.  Fails if a candidate failed.  Returns the
    winners and the first-call seconds."""
    from repro_torch.kernels.p2m_conv import tune

    out = {}
    for name, args in signatures.items():
        n_before = len(tune.decision_records())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        best = tune.get_conv_blocks(*args, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        records = tune.decision_records()
        check(len(records) == n_before + 1, f"{name}: no new decision")
        rec = records[-1]
        check(rec["n_failed"] == 0, f"{name}: candidates failed: "
              f"{[e for e in rec['errors'] if e]}")
        print(f"[3f] tuner at the {name} signature {args[:7]} "
              f"mode {args[8]}: first call {seconds * 1e3:.1f} ms, winner "
              f"{tuple(best)} ({rec['best_s'] * 1e3:.4f} ms); candidates "
              f"(block_h, block_n, depth): smem bytes, ms:")
        for cand, smem, t in zip(rec["candidates"], rec["smem_bytes"],
                                 rec["times_s"]):
            print(f"    {tuple(cand)}: {smem} B, {t * 1e3:.4f} ms")
        out[name] = {"best": tuple(best), "first_call_s": seconds,
                     "key": rec["key"]}
    return out


def check_matmul_kernel(torch, np, dev, adc):
    """Phase 3g: B6 against its plain twin at (100,352, 75, 8) (8 images
    at 112², the reference benchmark's shape) and (4096, 147, 32), in
    every mode: raw and relu within 1e-5, quant by the count rule; and
    `ops.p2m_matmul`'s gradients (B6 forward, B3 and B4 backward) against
    autograd of `p2m_matmul_plain` in float64 within 1e-4 of the largest
    value.  Returns the largest raw/relu difference at the first shape."""
    from repro_torch.core.pixel_model import default_pixel_model
    from repro_torch.kernels.p2m_conv import conv, kernel, ops

    model = default_pixel_model()
    coeffs = ops._coeff_tuple(model)
    rng = np.random.default_rng(SEED + 32)
    first_err = 0.0
    for m, kk, n in ((100_352, 75, 8), (4096, 147, 32)):
        x = torch.from_numpy(rng.random((m, kk), np.float32)).to(dev)
        w = torch.from_numpy((rng.uniform(-1, 1, (kk, n)) * (3.0 / kk) ** 0.5)
                             .astype(np.float32)).to(dev)
        sh = torch.from_numpy(rng.uniform(-0.2, 0.2, n).astype(
            np.float32)).to(dev)
        line = f"[3g] p2m_matmul_fused at ({m}, {kk}, {n}):"
        for mode in ("raw", "relu", "quant"):
            out, raw = kernel.p2m_matmul_fused(
                x, w, sh, coeffs=coeffs, mode=mode, v_lsb=adc.v_lsb,
                max_count=adc.max_count, want_raw=True)
            torch.cuda.synchronize()
            ref_raw = kernel.p2m_matmul_raw_plain(x, w, coeffs)
            ref_out = conv._epilogue_values(ref_raw, sh, mode=mode,
                                            v_lsb=adc.v_lsb,
                                            max_count=adc.max_count)
            err = float((raw - ref_raw).abs().max())
            check(err <= RAW_TOL, f"B6 ({m}, {kk}, {n}) raw differs by {err}")
            if mode == "quant":
                rep = conv.quant_disagreement(out, ref_out, ref_raw,
                                              adc.v_lsb)
                check(rep["max_count_diff"] <= 1 and rep["share"] <= 1e-4
                      and rep["all_near_half"],
                      f"B6 ({m}, {kk}, {n}) quant counts disagree: {rep}")
                line += f" quant {rep['n_diff']} counts differ (raw {err:.1e})"
            else:
                err = max(err, float((out - ref_out).abs().max()))
                check(err <= RAW_TOL, f"B6 ({m}, {kk}, {n}) {mode} differs "
                      f"by {err}")
                line += f" {mode} {err:.2e};"
                if m == 100_352:
                    first_err = max(first_err, err)
        print(line)
    m, kk, n = 20_000, 75, 8
    x = torch.from_numpy(rng.random((m, kk), np.float32)).to(dev)
    w = torch.from_numpy((rng.uniform(-1, 1, (kk, n)) * (3.0 / kk) ** 0.5)
                         .astype(np.float32)).to(dev)
    sh = torch.from_numpy(rng.uniform(-0.2, 0.2, n).astype(np.float32)).to(dev)
    ct = torch.from_numpy(rng.standard_normal((m, n)).astype(
        np.float32)).to(dev)
    line = f"[3g] p2m_matmul gradients at ({m}, {kk}, {n}) vs float64 autograd:"
    for mode in ("raw", "relu", "quant"):
        ins = [t.clone().requires_grad_(True) for t in (x, w, sh)]
        got = torch.autograd.grad(
            (ops.p2m_matmul(*ins, model, adc, mode) * ct).sum(), ins)
        ref_ins = [t.double().requires_grad_(True) for t in (x, w, sh)]
        want = torch.autograd.grad(
            (ops.p2m_matmul_plain(*ref_ins, model, adc,
                                  "relu" if mode == "quant" else mode)
             * ct.double()).sum(), ref_ins)
        for name, a, b in zip(("x", "w", "shift"), got, want):
            err = float((a.double() - b).abs().max())
            scale = float(b.abs().max())
            check(err <= 1e-4 * scale, f"p2m_matmul {mode} d/d {name}: "
                  f"{err} of {scale}")
            line += f" {mode} d{name} {err:.1e} of {scale:.1e};"
    print(line)
    return first_err


def matmul_path(torch, np, dev, engine, images, adc):
    """Phase 5d: the patch-level path (the reference's "patches + kernel"
    tier): the serving batch's stem through `extract_patches` and
    `ops.p2m_matmul` (B6, quant) with the engine's folded weights, held to
    the deploy stem (B1/B2) by the count rule, and its gradients through
    B3 and B4.  Returns B6's launches."""
    from repro_torch.configs.p2m_vww import CONFIG
    from repro_torch.core.p2m_conv import (
        apply_p2m_conv_deploy,
        extract_patches,
    )
    from repro_torch.kernels.p2m_conv import backward, conv, kernel, ops

    cfg = CONFIG.p2m
    dep = engine._deploy
    b = images.shape[0]
    ho = cfg.out_spatial(images.shape[1])
    w = dep["w"].contiguous()
    shift = dep["shift"].float().contiguous()
    with torch.no_grad():
        stem = apply_p2m_conv_deploy(dep, images, cfg)
    torch.cuda.synchronize()
    counted = {fn: fn.launches for fn in (backward.p2m_bwd_dx,
                                          backward.p2m_bwd_dw)}
    kernel.p2m_matmul_fused.launches = 0
    x = extract_patches(images, cfg.kernel, cfg.stride).reshape(b * ho * ho,
                                                                -1)
    xg = x.contiguous().requires_grad_(True)
    wg = w.clone().requires_grad_(True)
    out = ops.p2m_matmul(xg, wg, shift, engine._pixel_model, adc, "quant")
    grads = torch.autograd.grad(out.sum(), [xg, wg])
    torch.cuda.synchronize()
    launches = kernel.p2m_matmul_fused.launches
    check(launches == 1, f"patch path launched B6 {launches} times")
    for fn, n in counted.items():
        check(fn.launches == n + 1, "patch path backward missed a kernel")
        fn.launches = n
    _, raw = conv.p2m_conv_premixed_plain(
        images, dep["wrows"], torch.zeros_like(shift), kernel=cfg.kernel,
        stride=cfg.stride, mode="raw", want_raw=True)
    rep = conv.quant_disagreement(out.detach().reshape(stem.shape), stem,
                                  raw, adc.v_lsb)
    check(rep["max_count_diff"] <= 1 and rep["share"] <= 1e-4
          and rep["all_near_half"], f"patch path vs deploy stem: {rep}")
    check(all(bool(torch.isfinite(g).all()) for g in grads),
          "patch path gradients not finite")
    print(f"[5d] patch path: {tuple(x.shape)} patches of the serving batch "
          f"through p2m_matmul (B6, quant): {launches} launch, "
          f"{rep['n_diff']} counts differ from the deploy stem; its "
          f"gradients through B3 and B4 finite")
    return launches


def engine_b2_pass(torch, np, dev, params, bn, reqs_fn, serve_key):
    """Phase 5e: B2 inside an engine, whatever the tuner picked.  The
    serving signature's tuner cache entry is set to a depth-0 winner (B1)
    and then to a depth-2 winner (B2) by `tune.set_winner`, the way the
    reference's tests reach it, and the same 24 requests are served
    through a fresh `VisionEngine` each time; the probabilities must be
    equal bit for bit.  Returns each pass's launch counts."""
    from repro_torch.configs.p2m_vww import CONFIG
    from repro_torch.kernels.p2m_conv import conv, tune
    from repro_torch.serving import VisionEngine, drive

    (rec,) = [r for r in tune.decision_records() if r["key"] == serve_key]
    b2 = [tuple(c) for c in rec["candidates"] if c[2] >= 2]
    b2_best = min(b2, key=lambda c: rec["times_s"][
        rec["candidates"].index(list(c))])
    b1 = [tuple(c) for c in rec["candidates"] if c[2] == 0][0]
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    probs, counts = {}, {}
    try:
        for name, winner in (("B1", b1), ("B2", b2_best)):
            tune.set_winner(serve_key, winner)
            eng = VisionEngine(params, bn, CONFIG, device=dev)
            torch.cuda.synchronize()
            reset_stem_launches(conv)
            drive(eng, reqs_fn(), on_undrained="raise")
            torch.cuda.synchronize()
            counts[name] = stem_launches(conv)
            done = eng.completed
            check([r.uid for r in done] == list(range(len(done)))
                  and not eng.failed, f"{name} pass: completion")
            probs[name] = np.stack([r.probs for r in done])
            print(f"[5e] {name} pass, serving winner {winner}: "
                  f"{len(done)} requests in {eng.stats['launches']} "
                  f"launches; launches {counts[name]}")
    finally:
        tune.set_winner(serve_key, rec["best"])
        torch.backends.cudnn.deterministic = False
    check(counts["B2"]["p2m_conv_fused_pipelined"] > 0
          and counts["B2"]["p2m_conv_fused"] == 0
          and counts["B1"]["p2m_conv_fused_pipelined"] == 0
          and counts["B1"]["p2m_conv_fused"] > 0, f"launches {counts}")
    check(np.array_equal(probs["B1"], probs["B2"]),
          "B2 pass probabilities differ from the B1 pass's")
    print(f"[5e] the B2 pass's probabilities equal the B1 pass's bit for "
          f"bit ({probs['B2'].shape})")
    return counts


def check_faults(torch, np, dev):
    """Phase 5f: the port's two fixed faults, on the card.  C1: a request
    with prompt token ``cfg.padded_vocab`` fails alone at submit (SMOKE
    rwkv), the others complete, and the same engine then serves a good
    request.  C2: every kernel wrapper raises on an input that requires
    grad under grad mode, and launches the same call under no_grad."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.p2m_conv import backward, conv, gated, kernel
    from repro_torch.kernels.rwkv_wkv import kernel as wkv_kernel
    from repro_torch.models.families import get_family
    from repro_torch.serving import Request, ServeEngine, drive
    from repro_torch.serving.engine import FAILED_TOKEN

    cfg = get_smoke_config(LM_ARCH).replace(dtype=torch.float32)
    params, _ = get_family(cfg).init(torch.Generator(dev).manual_seed(SEED),
                                     cfg)
    eng = ServeEngine(params, cfg, max_batch=2, max_len=64, prefill_chunk=4,
                      device=dev)
    good = [5, 17, 300, 2, 9]
    reqs = [Request(uid=0, prompt=good, max_new_tokens=4),
            Request(uid=1, prompt=[3, cfg.padded_vocab, 4],
                    max_new_tokens=4),
            Request(uid=2, prompt=good[::-1], max_new_tokens=4)]
    statuses = [eng.submit(r) for r in reqs]
    drive(eng, [], on_undrained="raise")
    torch.cuda.synchronize()
    check(statuses[1] == FAILED_TOKEN and eng.failed == [reqs[1]]
          and sorted(r.uid for r in eng.completed) == [0, 2],
          f"C1: statuses {statuses}, failed {[r.uid for r in eng.failed]}, "
          f"completed {[r.uid for r in eng.completed]}")
    drive(eng, [Request(uid=3, prompt=good, max_new_tokens=4)],
          on_undrained="raise")
    torch.cuda.synchronize()
    check(eng.completed[-1].uid == 3
          and eng.completed[-1].output == reqs[0].output,
          "C1: the engine did not serve the next request")
    print(f"[5f] C1: token {cfg.padded_vocab} (= padded_vocab) fails its "
          f"request alone at submit ({statuses[1]}); the other 2 completed, "
          f"then a good request served with the same tokens as before")

    rng = np.random.default_rng(SEED + 33)

    def t(*shape):
        return torch.from_numpy(rng.random(shape, np.float32)).to(dev)

    x, shift = t(2, 20, 20, 3), t(8)
    wrows = t(5, 45, 8) - 0.5
    xg = x.clone().requires_grad_(True)
    r, k, v = t(1, 16, 2, 16), t(1, 16, 2, 16), t(1, 16, 2, 16)
    lw, u, s0 = -t(1, 16, 2, 16), t(2, 16), t(1, 2, 16, 16)
    mx, mw, mg = t(64, 75), t(75, 8) - 0.5, t(64, 8) - 0.5
    coeffs = ((0.5, 0.1, 0.0), (0.2, 0.0, 0.0), (0.1, 0.0, 0.0))
    calls = {
        "p2m_conv_fused (B1)": lambda: conv.p2m_conv_fused(
            xg, wrows, shift, kernel=5, stride=5),
        "p2m_conv_fused (B2)": lambda: conv.p2m_conv_fused(
            xg, wrows, shift, kernel=5, stride=5, pipeline_depth=2),
        "p2m_conv_fused_gated (B5)": lambda: gated.p2m_conv_fused_gated(
            xg, wrows, shift, torch.zeros((2, 4, 4, 8), device=dev),
            torch.ones(2, dtype=torch.bool, device=dev), kernel=5, stride=5),
        "p2m_matmul_fused (B6)": lambda: kernel.p2m_matmul_fused(
            mx, mw.clone().requires_grad_(True), t(8), coeffs=coeffs),
        "p2m_bwd_dx (B3)": lambda: backward.p2m_bwd_dx(
            mg.clone().requires_grad_(True), mw, mx, coeffs),
        "p2m_bwd_dw (B4)": lambda: backward.p2m_bwd_dw(
            mg.clone().requires_grad_(True), mw, mx, coeffs),
        "wkv_fused (B7)": lambda: wkv_kernel.wkv_fused(
            r, k.clone().requires_grad_(True), v, lw, u, s0),
    }
    counted = (stem_launches(conv), gated.p2m_conv_fused_gated.launches,
               kernel.p2m_matmul_fused.launches, backward.p2m_bwd_dx.launches,
               backward.p2m_bwd_dw.launches, wkv_kernel.wkv_fused.launches)
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as exc:
            check("requires grad" in str(exc), f"C2 {name}: {exc}")
        else:
            check(False, f"C2: {name} launched on an input that requires "
                  "grad under grad mode")
        with torch.no_grad():
            call()
    torch.cuda.synchronize()
    (conv.p2m_conv_fused.launches,
     conv.p2m_conv_fused.launches_pipelined) = counted[0].values()
    (gated.p2m_conv_fused_gated.launches, kernel.p2m_matmul_fused.launches,
     backward.p2m_bwd_dx.launches, backward.p2m_bwd_dw.launches,
     wkv_kernel.wkv_fused.launches) = counted[1:]
    print(f"[5f] C2: {', '.join(calls)} each raise on an input that "
          f"requires grad under grad mode, and launch under no_grad")


def conv2d_yardstick(torch, images, wrows, k, s):
    """One cuDNN conv over the power stack [x, x², x³] (NCHW) with the
    premixed weights, which computes the fused conv's raw accumulation:
    returns it as a call, its inputs built once."""
    c = images.shape[3]
    dx = wrows.shape[1] // (k * c)
    xs = images.permute(0, 3, 1, 2)
    stack = torch.cat([xs, xs * xs, xs * xs * xs][:dx], dim=1).contiguous()
    wlib = (wrows.reshape(k, dx, k, c, -1).permute(4, 1, 3, 0, 2)
            .reshape(-1, dx * c, k, k).contiguous())
    return lambda: torch.nn.functional.conv2d(stack, wlib, stride=s)


def conv_bound(images, wrows, shift, k) -> tuple[float, str]:
    """The least time (ms) of one fused conv at stride = kernel = ``k``:
    each image, weight and shift byte read once, each output written
    once."""
    b, h, w, _ = images.shape
    n = wrows.shape[2]
    m = b * ((h - k) // k + 1) * ((w - k) // k + 1)
    nbytes = 4 * (images.numel() + wrows.numel() + shift.numel() + m * n)
    return bound(nbytes, 2 * m * k * wrows.shape[1] * n)


def time_b2_shape(torch, flush, inputs, qkw, block_hs):
    """B2 at depths 2 and 3 x ``block_hs`` in turns with B1 (B1, the B2s,
    B1) on one shape, each by `cuda_ms`; the launch counters restored.
    Returns ({(block_h, depth): ms}, [B1 before, B1 after])."""
    from repro_torch.kernels.p2m_conv import conv

    x, wr, sh = inputs
    counted = (conv.p2m_conv_fused.launches,
               conv.p2m_conv_fused.launches_pipelined)
    b1 = [cuda_ms(torch, lambda: conv.p2m_conv_fused(x, wr, sh, **qkw),
                  flush)]
    times = {}
    for depth in (2, 3):
        for bh in block_hs:
            times[(bh, depth)] = cuda_ms(torch, lambda: conv.p2m_conv_fused(
                x, wr, sh, block_h=bh, pipeline_depth=depth, **qkw), flush)
    b1.append(cuda_ms(torch, lambda: conv.p2m_conv_fused(x, wr, sh, **qkw),
                      flush))
    (conv.p2m_conv_fused.launches,
     conv.p2m_conv_fused.launches_pipelined) = counted
    return times, b1


def b2_shapes(torch, np, dev, serve_in):
    """Phase 9's B2 shapes: name -> (inputs, mode, tuner signature name):
    the serving batch (quant), its first 4 images as the stream's (quant)
    and 32 random images as the training batch (raw, the train stem's
    mode), all with the serving stem's weights."""
    from repro_torch.configs.p2m_vww import CONFIG, TRAIN_BATCH

    paper_imgs, wrows, shift = serve_in
    size = CONFIG.image_size
    rng = np.random.default_rng(SEED + 35)
    train_imgs = torch.from_numpy(rng.random((TRAIN_BATCH, size, size, 3),
                                             np.float32)).to(dev)
    return {
        f"serving {len(paper_imgs)}x{size}²": (serve_in, "quant", "serving"),
        f"stream 4x{size}²": ((paper_imgs[:4].contiguous(), wrows, shift),
                              "quant", "stream"),
        f"training {TRAIN_BATCH}x{size}²": ((train_imgs, wrows, shift), "raw",
                                            "training"),
    }


def time_pipelined(torch, np, dev, flush, serve_in, adc, tuned, b1_row):
    """Phase 9, B2: at the serving, stream and training shapes, B2 at
    depths 2 and 3 with block_h 1, 2, 4 and the tuned block_h, in turns
    with B1 (B1, B2s, B1), each with its launch (pixels a thread, threads
    and blocks, registers and local bytes a thread, blocks an SM), and one
    read of the images (`amax`, each byte read once, nothing written)
    and the library yardstick (`conv2d_yardstick`) under the same timing;
    the served kernel spills nothing.  Returns B2's row of the kernels line
    (its ms at the serving shape's fastest setting, beside B1's bound,
    plain and library rows), without launches and error."""
    from repro_torch.kernels.p2m_conv import conv

    by_shape = {}
    for name, ((x, wr, sh), mode, sig) in b2_shapes(torch, np, dev,
                                                    serve_in).items():
        qkw = dict(kernel=5, stride=5, mode=mode, v_lsb=adc.v_lsb,
                   max_count=adc.max_count)
        best_bh = tuned[sig]["best"][0]
        bhs = sorted({1, 2, 4} | ({best_bh} if best_bh else set()))
        times, b1 = time_b2_shape(torch, flush, (x, wr, sh), qkw, bhs)
        read_ms = cuda_ms(torch, x.amax, flush)
        library_ms = cuda_ms(torch, conv2d_yardstick(torch, x, wr, 5, 5),
                             flush)
        dx = wr.shape[1] // (5 * x.shape[3])
        geo = {key: conv.pipelined_launch(
            tuple(x.shape), wr.shape[2], dx, kernel=5, stride=5,
            block_h=key[0], pipeline_depth=key[1]) for key in times}
        for key, g in geo.items():
            check(g["local_bytes"] == 0, f"B2 at {name} {key} uses "
                  f"{g['local_bytes']} bytes of local memory a thread")
        b_ms, b_by = conv_bound(x, wr, sh, 5)
        best = min(times, key=times.get)
        print(f"[9] p2m_conv_fused pipelined (B2) at {name} {mode}; (block_h, "
              f"depth): ms, pixels a thread, threads x blocks, blocks an SM, "
              f"registers, local bytes:")
        for key, ms in times.items():
            g = geo[key]
            print(f"    {key}: {ms:.4f} ms, {g['pixels_per_thread']} px, "
                  f"{g['threads']} x {g['blocks_x']}x{g['blocks_y']}, "
                  f"{g['blocks_per_sm']} an SM, {g['registers']} regs, "
                  f"{g['local_bytes']} B")
        print(f"    B1 {b1[0]:.4f} and {b1[1]:.4f} ms (before and after); "
              f"fastest B2 {best} {times[best]:.4f} ms; tuned winner "
              f"{tuned[sig]['best']}; bound {b_ms:.4f} ms by {b_by}; one "
              f"read of the images (amax) {read_ms:.4f} ms; library conv2d "
              f"{library_ms:.4f} ms")
        by_shape[name] = {
            "mode": mode, "bound_ms": b_ms, "b1_ms_in_turns": b1,
            "read_ms": read_ms, "library_ms": library_ms,
            "ms_by_block_h_depth": {f"{k[0]},{k[1]}": v
                                    for k, v in times.items()},
            "launch": {f"{k[0]},{k[1]}": v for k, v in geo.items()}}
    serving = next(iter(by_shape.values()))
    return {"ms": min(serving["ms_by_block_h_depth"].values()),
            "plain_ms": b1_row["plain_ms"], "bound_ms": b1_row["bound_ms"],
            "bound_by": b1_row["bound_by"],
            "library_ms": b1_row["library_ms"],
            "ms_by_block_h_depth": serving["ms_by_block_h_depth"],
            "b1_ms_in_turns": serving["b1_ms_in_turns"],
            "by_shape": by_shape}


def time_matmul(torch, np, dev, flush, adc):
    """Phase 9, B6 at (100,352, 75, 8), quant, with the tuner's blocks,
    beside its plain twin, one `torch.matmul` of the power concat with the
    premixed W̃ (the raw accumulation) and the bound.  Returns B6's row of
    the kernels line, without launches and error."""
    from repro_torch.core.pixel_model import default_pixel_model
    from repro_torch.kernels.p2m_conv import conv, kernel, ops, tune

    coeffs = ops._coeff_tuple(default_pixel_model())
    m, kk, n = 100_352, 75, 8
    rng = np.random.default_rng(SEED + 34)
    x = torch.from_numpy(rng.random((m, kk), np.float32)).to(dev)
    w = torch.from_numpy((rng.uniform(-1, 1, (kk, n)) * (3.0 / kk) ** 0.5)
                         .astype(np.float32)).to(dev)
    sh = torch.from_numpy(rng.uniform(-0.2, 0.2, n).astype(np.float32)).to(dev)
    counted = kernel.p2m_matmul_fused.launches
    t0 = time.perf_counter()
    blocks = tune.get_matmul_blocks(m, kk, n, coeffs, "quant", device=dev)
    tune_s = time.perf_counter() - t0
    rec = tune.decision_records()[-1]
    check(rec["n_failed"] == 0, f"B6 tuner: {rec['errors']}")
    bm, bn, bk = blocks
    kw = dict(coeffs=coeffs, mode="quant", v_lsb=adc.v_lsb,
              max_count=adc.max_count)
    ms = cuda_ms(torch, lambda: kernel.p2m_matmul_fused(
        x, w, sh, block_m=bm, block_n=bn, block_k=bk, **kw), flush)
    plain_ms = cuda_ms(torch, lambda: ops.p2m_matmul_plain(
        x, w, sh, default_pixel_model(), adc, "quant"), flush)
    dx = len(coeffs[0])
    xcat = torch.cat([x ** (j + 1) for j in range(dx)], dim=1)
    wcat = conv.premix_weights(w, coeffs).reshape(dx * kk, n)
    lib_err = float((torch.matmul(xcat, wcat)
                     - kernel.p2m_matmul_raw_plain(x, w, coeffs)).abs().max())
    check(lib_err <= 1e-4, f"B6 library yardstick differs by {lib_err}")
    library_ms = cuda_ms(torch, lambda: torch.matmul(xcat, wcat), flush)
    kernel.p2m_matmul_fused.launches = counted
    read_ms = cuda_ms(torch, x.amax, flush)
    geo = kernel.matmul_launch(m, kk, n, dx, block_m=bm, block_n=bn,
                               block_k=bk)
    check(geo["local_bytes"] == 0, f"B6 uses local memory a thread: {geo}")
    nbytes = 4 * (x.numel() + w.numel() + sh.numel() + m * n)
    flops = 2 * m * kk * n * dx
    b_ms, b_by = bound(nbytes, flops)
    print(f"[9] p2m_matmul_fused at ({m}, {kk}, {n}) quant, blocks "
          f"{blocks} (tuner first call {tune_s * 1e3:.1f} ms over "
          f"{len(rec['candidates'])} candidates): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library matmul of the power concat "
          f"{library_ms:.4f} ms (raw err {lib_err:.1e}); bound {b_ms:.4f} ms "
          f"by {b_by} ({nbytes} bytes, {flops} FLOP); one read of x (amax) "
          f"{read_ms:.4f} ms")
    print(f"[9] p2m_matmul_fused launch: {geo['tiles']} tiles of "
          f"{geo['block_m']} rows over {geo['blocks_x']} x {geo['blocks_y']} "
          f"blocks of {geo['threads']} threads ({geo['rows_per_thread']} rows "
          f"a thread), {geo['slots']} slots, {geo['smem_bytes']} B dynamic "
          f"shared memory, {geo['blocks_per_sm']} blocks an SM, "
          f"{geo['registers']} registers, {geo['local_bytes']} B local")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms,
            "blocks": list(blocks), "read_ms": read_ms, "launch": geo}


def lm_train_only(torch, np, dev) -> int:
    """``chip_smoke.py --lm-train``: phase 1, the build of ``wkv.cu`` with
    its ptxas lines, and phase 5g alone."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv_wkv import kernel as wkv_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1] card: {smi_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    wkv_kernel.build_wkv()
    seconds, report = _build.BUILD_INFO["wkv"]
    print(f"[2] wkv.cu: nvcc {seconds:.2f} s")
    for line in ptxas_summary(report):
        print(f"    ptxas: {line}")
    lm = {"cfg": get_config(LM_ARCH).replace(dtype=torch.float32)}
    out = lm_train_path(torch, np, dev, lm)
    print(json.dumps({k: v for k, v in out.items()}))
    return 0


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
    if sys.argv[1:] == ["--b4"]:
        return b4_only(torch, np, torch.device("cuda"))
    if sys.argv[1:] == ["--b1b6"]:
        return b1b6_only(torch, np, torch.device("cuda"))
    if sys.argv[1:] == ["--lm-train"]:
        return lm_train_only(torch, np, torch.device("cuda"))

    from repro_torch.configs.p2m_vww import (
        CONFIG,
        SERVE_MAX_BATCH,
        TRAIN_BATCH,
    )
    from repro_torch.core.p2m_conv import apply_p2m_conv_deploy
    from repro_torch.data import SyntheticVWW
    from repro_torch.kernels import _build
    from repro_torch.configs import get_config
    from repro_torch.kernels.p2m_conv import backward, conv, gated, tune
    from repro_torch.kernels.p2m_conv import kernel as mm_kernel
    from repro_torch.kernels.p2m_conv.ops import _coeff_tuple
    from repro_torch.kernels.rwkv_wkv import kernel as wkv_kernel
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
    with ThreadPoolExecutor(4) as pool:  # one nvcc per source, together
        for job in [pool.submit(conv.build_p2m_conv),
                    pool.submit(backward.build_p2m_bwd),
                    pool.submit(mm_kernel.build_p2m_matmul),
                    pool.submit(wkv_kernel.build_wkv)]:
            job.result()
    print(f"[2] built the four sources in {time.perf_counter() - t0:.2f} s "
          "with loading")
    for name in ("p2m_conv", "p2m_bwd", "p2m_matmul", "wkv"):
        seconds, report = _build.BUILD_INFO[name]
        print(f"[2] {name}.cu: nvcc {seconds:.2f} s")
        for line in ptxas_summary(report):
            print(f"    ptxas: {line}")

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

    gated_err = check_gated_kernel(torch, np, dev,
                                   paper_imgs[:4].contiguous(), wrows, shift,
                                   rand_case, adc)
    wkv_err, wkv_in = check_wkv_kernel(torch, np, dev)
    serve_in = (paper_imgs, wrows, shift)
    pipe_err = check_pipelined_kernel(torch, np, dev, serve_in, adc)
    check_pipelined_grads(torch, np, dev)
    coeffs = _coeff_tuple(engine._pixel_model)
    sig = (size, size, 3, cfg.out_channels, k, s, coeffs)
    tuned = tune_signatures(torch, dev, {
        "serving": (B, *sig, "quant"),
        "stream": (4, *sig, "quant"),
        "training": (TRAIN_BATCH, *sig, "raw")})
    mm_err = check_matmul_kernel(torch, np, dev, adc)

    # ------------------------------------------------------- phase 4
    bwd_err, bwd = check_backward_kernels(torch, np, dev)

    # ------------------------------------------------------- phase 5
    n_req = 24
    data = SyntheticVWW(image_size=size, batch=n_req, seed=SEED + 1)
    images = data.batch_at(0)["images"]
    arrivals = [0] * 8 + [1] * 3 + [2] * 6 + [4] * 7

    def vision_requests():
        return [VisionRequest(uid=i, image=images[i], arrival_tick=t)
                for i, t in enumerate(arrivals)]

    reset_stem_launches(conv)
    t0 = time.perf_counter()
    drive(engine, vision_requests(), on_undrained="raise")
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    serve_launches = stem_launches(conv)
    launches = sum(serve_launches.values())
    done = engine.completed
    check([r.uid for r in done] == list(range(n_req)),
          f"completion order {[r.uid for r in done]}")
    check(not engine.failed and not engine.evicted,
          f"failed {len(engine.failed)}, evicted {len(engine.evicted)}")
    check(launches == engine.stats["launches"] and launches > 0,
          f"kernel launches {serve_launches} != engine launches "
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
        print(f"[5] tick {tick}: batch of {len(group)}, probs vs plain stem "
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
    print(f"[5] served {len(done)} requests in {engine.stats['launches']} "
          f"launches ({main_s:.2f} s) with the tuned stem "
          f"{tuned['serving']['best']}, kernel launches {serve_launches}; "
          f"stem vs patches reference: {rep['n_diff']} counts differ")
    check(rep["max_count_diff"] <= 1 and rep["share"] <= 1e-4
          and rep["all_near_half"], f"stem vs patches: {rep}")
    mm_launches = matmul_path(torch, np, dev, engine, paper_imgs, adc)
    pass_launches = engine_b2_pass(torch, np, dev, params, bn,
                                   vision_requests, tuned["serving"]["key"])

    stream = stream_path(torch, np, dev, params, bn)

    lm = lm_path(torch, np, dev,
                 get_config(LM_ARCH).replace(dtype=torch.float32))
    check_faults(torch, np, dev)
    lm_train = lm_train_path(torch, np, dev, lm)

    # ------------------------------------------------------- phase 6
    train = train_path(torch, np, dev)

    # ------------------------------------------------------- phase 7
    grad_parity(torch, train)

    # ------------------------------------------------------- phase 8
    fold_and_serve(torch, np, dev, train)

    # ------------------------------------------------------- phase 9
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=dev)
    qkw = dict(kernel=k, stride=s, mode="quant", v_lsb=adc.v_lsb,
               max_count=adc.max_count)
    counted = conv.p2m_conv_fused.launches
    counted_b2 = conv.p2m_conv_fused.launches_pipelined
    kernel_ms = cuda_ms(torch, lambda: conv.p2m_conv_fused(
        paper_imgs, wrows, shift, **qkw), flush)
    wrapper_ms = wall_ms(torch, lambda: conv.p2m_conv_fused(
        paper_imgs, wrows, shift, **qkw), flush)
    plain_ms = cuda_ms(torch, lambda: conv.p2m_conv_premixed_plain(
        paper_imgs, wrows, shift, **qkw), flush)
    conv.p2m_conv_fused.launches = counted  # timing launches are not the path's
    library = conv2d_yardstick(torch, paper_imgs, wrows, k, s)
    _, ker_raw = conv.p2m_conv_fused(paper_imgs, wrows, shift, want_raw=True,
                                     **qkw)
    conv.p2m_conv_fused.launches = counted
    lib_err = float((library().permute(0, 2, 3, 1) - ker_raw).abs().max())
    check(lib_err <= 1e-4, f"library yardstick computes another function "
          f"({lib_err})")
    library_ms = cuda_ms(torch, library, flush)
    n = wrows.shape[2]
    ho = wo = cfg.out_spatial(size)
    m = B * ho * wo
    bytes_moved = 4 * (paper_imgs.numel() + wrows.numel() + shift.numel()
                       + m * n)
    flops = 2 * m * k * wrows.shape[1] * n
    bound_ms, bound_by = bound(bytes_moved, flops)
    print(f"[9] p2m_conv_fused at ({B},{size},{size},3) k=s={k} N={n} quant: "
          f"kernel {kernel_ms:.4f} ms, wrapper {wrapper_ms:.4f} ms (host), "
          f"plain {plain_ms:.4f} ms, library conv2d {library_ms:.4f} ms "
          f"(raw err {lib_err:.1e}); bound {bound_ms:.4f} ms by {bound_by} "
          f"({bytes_moved} bytes, {flops} FLOP)")
    b1_geo = conv.b1_launch(tuple(paper_imgs.shape), n,
                            wrows.shape[1] // (k * paper_imgs.shape[3]),
                            kernel=k, stride=s)
    check(b1_geo["local_bytes"] == 0,
          f"B1 uses local memory a thread: {b1_geo}")
    b1_read_ms = cuda_ms(torch, paper_imgs.amax, flush)
    print(f"[9] p2m_conv_fused (B1) launch: {b1_geo['tiles']} tiles of "
          f"{b1_geo['tile_px']} pixels over {b1_geo['blocks_x']} x "
          f"{b1_geo['blocks_y']} blocks of {b1_geo['threads']} threads "
          f"({b1_geo['pixels_per_thread']} pixels a thread), "
          f"{b1_geo['smem_bytes']} B dynamic shared memory, "
          f"{b1_geo['blocks_per_sm']} blocks an SM, {b1_geo['registers']} "
          f"registers, {b1_geo['local_bytes']} B local; one read of the "
          f"images (amax) {b1_read_ms:.4f} ms")
    # Engine time per launch, warm: five full microbatches.
    before_l, before_us = engine.stats["launches"], engine.stats["wall_us"]
    warm = [VisionRequest(uid=100 + i, image=images[i % n_req])
            for i in range(5 * B)]
    drive(engine, warm, on_undrained="raise")
    n_launch = engine.stats["launches"] - before_l
    engine_ms = (engine.stats["wall_us"] - before_us) / n_launch / 1e3
    first_ms = engine.completed[0].launch_wall_us / 1e3
    print(f"[9] engine: {engine_ms:.3f} ms per launch of {B} images "
          f"(warm, {n_launch} launches, tuned stem "
          f"{tuned['serving']['best']}); first launch {first_ms:.3f} ms "
          f"(the tuner ran before it: "
          f"{tuned['serving']['first_call_s'] * 1e3:.1f} ms at this "
          f"signature, phase 3f)")
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
    conv.p2m_conv_fused.launches_pipelined = counted_b2
    print(f"[9] launch parts: host batch + copy {host_ms:.3f} ms, stem "
          f"{stem_ms:.3f} ms, backbone {backbone_ms:.3f} ms (device, "
          f"launch gaps included); sum "
          f"{host_ms + stem_ms + backbone_ms:.3f} of {engine_ms:.3f} ms")

    b1_row = {"plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "library_ms": library_ms,
              "read_ms": b1_read_ms, "launch": b1_geo}
    pipe_row = time_pipelined(torch, np, dev, flush, serve_in, adc, tuned,
                              b1_row)
    mm_row = time_matmul(torch, np, dev, flush, adc)
    gated_row = time_stream(torch, np, dev, stream, flush, adc)
    bwd_rows = time_backward_kernels(torch, bwd, flush)
    time_train_step(torch, train, flush)
    wkv_row = time_lm(torch, np, dev, lm, wkv_in, flush)

    # ------------------------------------------------------- phase 10
    # B1 and B2 run, as the tuner picks, on the serving run, the training
    # run and the stream run's where path; the two forced passes of phase
    # 5e run each once through the engine.
    stem_paths = {}
    for name in ("p2m_conv_fused", "p2m_conv_fused_pipelined"):
        stem_paths[name] = {
            "serve": serve_launches[name],
            "serve_forced": pass_launches["B1" if name == "p2m_conv_fused"
                                          else "B2"][name],
            "train": train["launches"][name],
            "stream": stream["where_launches"][name]}
        check(sum(stem_paths[name].values()) > 0,
              f"{name} launched no time on the main paths")
    kernels = [{
        "name": "p2m_conv_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/p2m_conv/csrc/p2m_conv.cu",
        "replaces": "src/repro/kernels/p2m_conv/conv.py:466",
        "launches": sum(stem_paths["p2m_conv_fused"].values()),
        "launches_by_path": stem_paths["p2m_conv_fused"],
        "max_abs_err": paper_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "read_ms": b1_read_ms,
        "launch": b1_geo,
    }, {
        "name": "p2m_conv_fused_pipelined",
        "route": "cuda",
        "source": "src/repro_torch/kernels/p2m_conv/csrc/p2m_conv.cu",
        "replaces": "src/repro/kernels/p2m_conv/conv.py:438",
        "launches": sum(stem_paths["p2m_conv_fused_pipelined"].values()),
        "launches_by_path": stem_paths["p2m_conv_fused_pipelined"],
        "max_abs_err": pipe_err,
        **pipe_row,
    }]
    for name, replaces in (
            ("p2m_bwd_dx", "src/repro/kernels/p2m_conv/backward.py:95"),
            ("p2m_bwd_dw", "src/repro/kernels/p2m_conv/backward.py:176")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/p2m_conv/csrc/p2m_bwd.cu",
            "replaces": replaces,
            "launches": train["launches"][name],
            "launches_by_path": {"train": train["launches"][name]},
            "max_abs_err": bwd_err[name],
            **bwd_rows[name],
        })
    b5 = sum(stream["launches"][name] for name in gated_launches(gated))
    check(b5 > 0, "p2m_conv_fused_gated launched no time on the main paths")
    kernels.append({
        "name": "p2m_conv_fused_gated",
        "route": "cuda",
        "source": "src/repro_torch/kernels/p2m_conv/csrc/p2m_conv.cu",
        "replaces": "src/repro/kernels/p2m_conv/gated.py:221",
        # the gated stem runs on the stream path (its default on the card),
        # on the body of the tuner's depth: the ring (launches_pipelined)
        # or B1's
        "launches": b5,
        "launches_pipelined":
            stream["launches"]["p2m_conv_fused_gated_pipelined"],
        "launches_by_path": {"stream": b5},
        "max_abs_err": gated_err,
        **gated_row,
    })
    kernels.append({
        "name": "p2m_matmul_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/p2m_conv/csrc/p2m_matmul.cu",
        "replaces": "src/repro/kernels/p2m_conv/kernel.py:159",
        # the patch-level path of phase 5d
        "launches": mm_launches,
        "launches_by_path": {"patches": mm_launches},
        "max_abs_err": mm_err,
        **mm_row,
    })
    kernels.append({
        "name": "wkv_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv_wkv/csrc/wkv.cu",
        "replaces": "src/repro/kernels/rwkv_wkv/kernel.py:108",
        # the LM path: ServeEngine's and SessionEngine's prefill ticks;
        # the LM train steps (forward and recompute, phase 5g (c))
        "launches": lm["launches"] + lm_train["launches"],
        "launches_by_path": {"lm": lm["launches"],
                             "lm_train": lm_train["launches"]},
        "max_abs_err": wkv_err,
        **wkv_row,
    })
    check(len(kernels) == 7, f"{len(kernels)} kernels in the line")
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
