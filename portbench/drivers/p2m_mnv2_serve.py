"""Served P²M-MobileNetV2: an open loop of frames due at their own times,
through the port's `VisionEngine` (`submit`, `step`).

Each frame is timed from its due time to the return of the launch that
served it; a frame that is evicted or fails counts as missing.  Once the
window has closed every due frame is waited for (at most
``wait_after_close_s``), and every served frame's class probabilities
are compared with the reference's for its input."""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import common, data, roofline, session, traffic, weights
from portbench.drivers import port
from portbench.reference import mnv2 as ref
from portbench.reference import p2m as p2m_ref
from portbench.trace import span


def run(r: session.Run) -> None:
    from repro_torch.serving.vision import VisionEngine, VisionRequest

    cfg, tr = r.config, r.traffic
    nb = int(tr["max_batch"])
    params, bn = weights.mnv2(r.seed, cfg, r.device)
    pool, _ = data.vww_images(r.seed, 0, int(tr["pool"]), cfg["image_size"],
                              r.device)
    arrivals = traffic.open_loop(tr, r.seed, r.seconds)
    engine = VisionEngine(params, bn, port.mnv2_config(cfg), max_batch=nb,
                          max_queue=int(tr["max_queue"]),
                          deploy_quant_bits=cfg["deploy_quant_bits"],
                          evict=tr["evict"], device=r.device)
    for w in range(int(tr["warm_launches"])):  # the one shape: full batches
        for j in range(nb):
            engine.submit(VisionRequest(uid=-1, image=pool[(w * nb + j)
                                                           % len(pool)]))
        engine.step()
    r.sync()
    common.log(f"[tuner] {port.tuner_decisions()}")
    r.warm_profiler()
    coeffs = p2m_ref.pixel_coefficients(cfg["pixel_model"])
    size, k = cfg["image_size"], cfg["p2m"]
    # a launch runs the whole microbatch, its empty slots too
    r.layer["stem_least_s"] = roofline.least_s(*roofline.stem_forward(
        nb, size, size, k["in_channels"], k["out_channels"], k["kernel"],
        k["stride"], cfg["pixel_model"]["degree_x"]))
    r.layer["flops_per_launch"] = session.model_flops(
        lambda p, s, x: ref.forward_train(p, s, x, cfg, coeffs, train=False),
        params, bn, torch.zeros(nb, size, size, 3))

    n = len(arrivals)
    reqs: list = [None] * n
    done = [math.inf] * n
    lag = [0.0] * n
    launches0 = port.p2m_launches()
    stats0 = dict(engine.stats)
    t0 = r.open_window()
    state = {"next": 0}

    def serve(until: float, drain: bool = False) -> None:
        while True:
            now = time.perf_counter() - t0
            i = state["next"]
            while i < n and arrivals[i][0] <= now:
                reqs[i] = VisionRequest(uid=i, image=pool[arrivals[i][1]])
                lag[i] = now - arrivals[i][0]
                with span(torch, "engine.submit"):
                    engine.submit(reqs[i])
                i += 1
            state["next"] = i
            if not drain and now >= until:
                return
            if engine.busy():
                with span(torch, "engine.step"):
                    finished = engine.step()
                t = time.perf_counter() - t0
                for q in finished:
                    done[q.uid] = t
            elif i < n:
                wait = arrivals[i][0] - (time.perf_counter() - t0)
                if wait > 0.002:
                    time.sleep(wait - 0.001)
            else:
                return
            if drain and now > r.seconds + float(tr["wait_after_close_s"]):
                return

    trace_at = min(float(tr["trace_at_s"]), 0.3 * r.seconds)
    serve(min(trace_at, r.seconds))
    if r.profiler is not None:
        with r.traced():
            serve(min(trace_at + float(tr["trace_s"]), r.seconds))
    serve(r.seconds)
    r.layer["backlog_at_close"] = len(engine.queue)
    serve(math.inf, drain=True)
    r.close_window()

    lat = [(done[i] - arrivals[i][0]) * 1e3 for i in range(n)]
    r.attempted = n
    r.failed = sum(1 for x in lat if not math.isfinite(x))
    r.e2e["frame_p95_ms"] = session.percentile(lat, 95)
    served = {k: engine.stats[k] - stats0[k] for k in ("launches", "wall_us")}
    r.layer["launch_ms"] = served["wall_us"] / max(served["launches"], 1) / 1e3
    r.layer["launches"] = served["launches"]
    r.layer["evictions"] = engine.stats["evictions"]
    common.log(f"[window] {n} frames due at {tr['rate_per_s']} /s, "
               f"{r.failed} missing, evictions {r.layer['evictions']}, "
               f"backlog at the close {r.layer['backlog_at_close']}, "
               f"launches {served['launches']}, "
               f"mean launch {r.layer['launch_ms']:.3f} ms, "
               f"p50 {session.percentile(lat, 50):.3f} ms, "
               f"p95 {r.e2e['frame_p95_ms']:.3f} ms")
    common.log(f"[generator] late by p50 {np.median(lag) * 1e3:.3f} ms, "
               f"p99 {np.percentile(lag, 99) * 1e3:.3f} ms, "
               f"max {max(lag, default=0) * 1e3:.3f} ms")
    common.log(f"[launches] {port.delta(port.p2m_launches(), launches0)}")

    # the reference, once the program's engine is gone
    probs = {i: (arrivals[i][1], reqs[i].probs) for i in range(n)
             if math.isfinite(done[i])}
    del engine, reqs
    session.free()
    want = ref_probs(params, bn, pool, cfg, coeffs, r.device, nb)
    gap = max((float(np.abs(p - want[j]).max()) for j, p in probs.values()),
              default=math.inf)
    r.check("prob_gap", gap)
    if r.control:
        seen = sorted({j for j, _ in probs.values()})
        with session.tf32():
            low = ref_probs(params, bn, pool, cfg, coeffs, r.device, nb)
        r.readings["control"] = {
            "prob_gap": float(np.abs(low[seen] - want[seen]).max())}


@torch.no_grad()
def ref_probs(params, bn, pool: np.ndarray, cfg: dict, coeffs, device,
              block: int) -> np.ndarray:
    """The reference's class probabilities of every pool frame."""
    stem = ref.deploy_stem(params, bn, cfg)
    out = [ref.probs_deploy(params, bn,
                            torch.from_numpy(pool[i:i + block]).to(device),
                            cfg, coeffs, stem).cpu().numpy()
           for i in range(0, len(pool), block)]
    return np.concatenate(out)
