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
4. hold the backward kernels (B3 dX, B4 dW) against their plain versions
   in float64 over conv geometries (s < k, ragged M and N, dx = 1..4)
   and at the training shape;
5. the serving path: `VisionEngine` serving the full-width deploy-folded
   P²M-MobileNetV2 (`configs/p2m_vww.py::CONFIG`, 560², width 1.0,
   microbatch 8) with random weights from a seed, 24 SyntheticVWW
   requests with staggered arrivals through `drive()`; every request
   completes in order, B1 launched once per engine launch, and each
   batch's probabilities equal the same forward with the plain stem;
6. the training path: 6 steps of `make_vww_train_step` on `CONFIG` at
   batch 32 with the paper's `sgd(step_decay(...), momentum=0.9)`; every
   loss finite, each step launches B1, B3 and B4 exactly once;
7. the first step's gradients (cuDNN deterministic): the CUDA step
   twice gives the same bits; the conv's backward through B3 and B4
   equals autograd through the plain conv on the step's own cotangent;
   the step with the plain conv has the same loss; the rest of the two
   steps' differences, and the network's own reach (the CUDA step with
   its stem output moved by as much), are reported;
8. the trained model folded and 8-bit quantized (`deploy_params`,
   `quantize_deploy`) and served: 8 requests through `VisionEngine`;
9. times on the card (CUDA events, median of 25, L2 flushed between
   runs) of each kernel, its plain version and one library call beside
   the least time the card could take; the engine's time per launch and
   its parts; the train step's time and its parts;
10. one JSON line ``{"kernels": [...]}``;
11. the card's name and power limit as nvidia-smi gives them, then the
    last line ``{"ok": true, "device": {...}}``.
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
    wrappers = {"p2m_conv_fused": conv.p2m_conv_fused,
                "p2m_bwd_dx": backward.p2m_bwd_dx,
                "p2m_bwd_dw": backward.p2m_bwd_dw}
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    ms, losses = [], []
    for i, batch in enumerate(batches):
        before = {k: fn.launches for k, fn in wrappers.items()}
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        loss = float(metrics["loss"])
        losses.append(loss)
        check(np.isfinite(loss), f"step {i}: loss {loss}")
        for k, fn in wrappers.items():
            check(fn.launches == before[k] + 1,
                  f"step {i}: {k} launched {fn.launches - before[k]} times")
        print(f"[6] step {i}: loss {loss:.4f} acc "
              f"{float(metrics['acc']):.3f} {ms[-1]:.1f} ms")
    launches = {k: fn.launches for k, fn in wrappers.items()}
    check(all(v == steps for v in launches.values()),
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
    from repro_torch.core.quant import QuantSpec, quantize_deploy
    from repro_torch.data import SyntheticVWW
    from repro_torch.kernels.p2m_conv import conv
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
    before = conv.p2m_conv_fused.launches
    drive(engine, [VisionRequest(uid=i, image=images["images"][i])
                   for i in range(8)], on_undrained="raise")
    torch.cuda.synchronize()
    done = engine.completed
    check([r.uid for r in done] == list(range(8)),
          f"completion order {[r.uid for r in done]}")
    check(conv.p2m_conv_fused.launches - before == engine.stats["launches"],
          "served without the kernel")
    probs = np.stack([r.probs for r in done])
    check(bool(np.isfinite(probs).all()), "served probs not finite")
    plain = engine.forward(torch.from_numpy(images["images"]).to(dev),
                           p2m_impl="plain").cpu().numpy()
    diff = float(np.abs(plain - probs).max())
    check(diff <= PROBS_TOL, f"served probs differ from the plain stem's "
          f"by {diff}")
    # The unfolded model on its running statistics, for comparison only:
    # six steps leave them far from the weights' batch statistics.
    acc_eval = make_vww_eval(CONFIG)(params, bn, images)
    acc_served = float((probs.argmax(-1) == images["labels"]).mean())
    print(f"[8] folded, {SERVE_QUANT_BITS}-bit stem served 8 requests in "
          f"{engine.stats['launches']} launch(es); probs vs plain stem "
          f"{diff:.3e}; accuracy served {acc_served:.3f}, unfolded eval "
          f"{acc_eval:.3f}")


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
    return rows


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
    counted = {fn: fn.launches for fn in (conv.p2m_conv_fused,
                                          backward.p2m_bwd_dx,
                                          backward.p2m_bwd_dw)}
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
    parts["stem forward (conv B1 + BN + clamp)"] = cuda_ms(
        torch, stem_fwd, flush)
    parts["stem backward (forward + backward, less the forward)"] = cuda_ms(torch, lambda: torch.autograd
                                                 .grad(stem_fwd(), theta,
                                                       g_stem), flush) - \
        parts["stem forward (conv B1 + BN + clamp)"]
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
    parts["  conv Function forward + backward (B1, im2col, B3, B4, "
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
    for name, ms in parts.items():
        print(f"[9] train step part: {name}: {ms:.3f} ms")
    print(f"[9] train step, whole: {train['step_ms']:.3f} ms (host clock)")


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
    from repro_torch.kernels.p2m_conv import backward, conv
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
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, together
        for job in [pool.submit(conv.build_p2m_conv),
                    pool.submit(backward.build_p2m_bwd)]:
            job.result()
    print(f"[2] built both sources in {time.perf_counter() - t0:.2f} s "
          "with loading")
    for name in ("p2m_conv", "p2m_bwd"):
        seconds, report = _build.BUILD_INFO[name]
        print(f"[2] {name}.cu: nvcc {seconds:.2f} s")
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
    bwd_err, bwd = check_backward_kernels(torch, np, dev)

    # ------------------------------------------------------- phase 5
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
          f"launches ({main_s:.2f} s), kernel launches {launches}; "
          f"stem vs patches reference: {rep['n_diff']} counts differ")
    check(rep["max_count_diff"] <= 1 and rep["share"] <= 1e-4
          and rep["all_near_half"], f"stem vs patches: {rep}")

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
    bound_ms, bound_by = bound(bytes_moved, flops)
    print(f"[9] p2m_conv_fused at ({B},{size},{size},3) k=s={k} N={n} quant: "
          f"kernel {kernel_ms:.4f} ms, wrapper {wrapper_ms:.4f} ms (host), "
          f"plain {plain_ms:.4f} ms, library conv2d {library_ms:.4f} ms "
          f"(raw err {lib_err:.1e}); bound {bound_ms:.4f} ms by {bound_by} "
          f"({bytes_moved} bytes, {flops} FLOP)")
    # Engine time per launch, warm: five full microbatches.
    before_l, before_us = engine.stats["launches"], engine.stats["wall_us"]
    warm = [VisionRequest(uid=100 + i, image=images[i % n_req])
            for i in range(5 * B)]
    drive(engine, warm, on_undrained="raise")
    n_launch = engine.stats["launches"] - before_l
    engine_ms = (engine.stats["wall_us"] - before_us) / n_launch / 1e3
    first_ms = engine.completed[0].launch_wall_us / 1e3
    print(f"[9] engine: {engine_ms:.3f} ms per launch of {B} images "
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
    print(f"[9] launch parts: host batch + copy {host_ms:.3f} ms, stem "
          f"{stem_ms:.3f} ms, backbone {backbone_ms:.3f} ms (device, "
          f"launch gaps included); sum "
          f"{host_ms + stem_ms + backbone_ms:.3f} of {engine_ms:.3f} ms")

    bwd_rows = time_backward_kernels(torch, bwd, flush)
    time_train_step(torch, train, flush)

    # ------------------------------------------------------- phase 10
    kernels = [{
        "name": "p2m_conv_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/p2m_conv/csrc/p2m_conv.cu",
        "replaces": "src/repro/kernels/p2m_conv/conv.py:466",
        # B1 runs on both paths: the serving run's and the training run's
        "launches": launches + train["launches"]["p2m_conv_fused"],
        "launches_by_path": {
            "serve": launches, "train": train["launches"]["p2m_conv_fused"]},
        "max_abs_err": paper_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
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
