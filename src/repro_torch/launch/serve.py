"""Serving launcher: continuous-batching engines + the multi-engine front
door that routes mixed LM/vision/video traffic; port of
`repro.launch.serve`.

Single-engine LM serving:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
      --smoke --device cpu --requests 12 --max-batch 4 --prefill-chunk 8

``--arch`` takes any ported architecture (`configs.PORTED`) that the slot
engines serve: rwkv6-3b, the dense family (llama3.2-1b, stablelm-1.6b,
qwen3-32b, qwen2-72b) and the MoE family (qwen3-moe-30b-a3b,
mixtral-8x22b).  recurrentgemma-9b is ported, but its decode state keeps
batch at axis 2, so `ServeEngine` refuses it with a ``cache_batch``
ValueError, as the reference's launcher does.  The vlm and encdec
families (llama-3.2-vision-11b, whisper-tiny) are refused with the
reference's message: they need a per-request prefill of their
cross-attention K/V (`models/vlm.py`, `models/whisper.py`).

Mixed LM + vision (+ video) traffic through the front door:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
      --smoke --device cpu --mixed --video-streams 2 --vision-replicas 2

Random weights from seeds, float32 (as the reference's launcher runs
them), on the GPU unless ``--device`` names another.
"""
from __future__ import annotations

import argparse
import heapq
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.families import get_family
from repro_torch.obs.metrics import default_registry
from repro_torch.serving import Request, ServeEngine, VisionRequest
from repro_torch.serving.scheduler import drive


class FrontDoor:
    """Multi-engine front door: one submission surface over per-modality
    engines and replica pools (DESIGN.md §8, §11).

    Requests route by each engine's declared ``request_type``
    (``Request`` → the LM engine, ``VisionRequest`` → the vision engine,
    ``StreamRequest`` → the multi-tick video stream engine — any
    `SlotEngine` adapter or `serving.pool.ReplicaPool` that declares one
    plugs in without touching the router); each engine keeps its own
    clock, queue policy, and latency ledger, and completion streams
    merge into a single list in completion order (``(name, request)``
    pairs; ties within a tick resolve in engine registration order).

    **Event-driven cadences (DESIGN.md §11):** each engine declares a
    ``tick_cost`` — one engine tick costs that many ticks of front-door
    time (LM prefill is expensive, a vision microbatch cheap, a stream
    frame cheapest).  The door advances a dense virtual clock one tick
    per ``step`` and fires engines off a priority queue of ready events:
    an engine with ``tick_cost=c`` first fires at door tick ``c`` and
    re-arms ``c`` ticks later each time, so cheap engines tick many
    times while an expensive one ticks once and a slow modality never
    stalls a fast one.  With every ``tick_cost`` equal the schedule is
    *bit-identical* to the lockstep door (``lockstep=True`` keeps that
    path alive as the equivalence reference).

    ``arrival_tick`` on submitted-via-``run`` requests is interpreted on
    the *front door's* clock, and every tick-denominated latency figure
    the door reports is converted engine ticks → front-door ticks here,
    once (``tick_cost ×``, any ``*_ticks`` key at any depth) — adapters
    never convert.

    The door is host code: it launches nothing itself.  Its engines run
    the port's kernels on the card (the vision stem B1/B2, the gated
    stream stem B5, the chunked WKV B7 on LM prefill ticks).
    """

    def __init__(self, lockstep: bool = False, tracer=None, registry=None,
                 **engines):
        """``tracer``/``registry`` are the observability knobs
        (DESIGN.md §13): the tracer gets this door attached as its clock
        root — each engine's track is labeled by its registration name
        and scaled by its ``tick_cost`` so every stamp in the export
        lands on the door's shared virtual clock; the registry receives
        the door's latency/health views (``None`` = process default).
        Neither touches the schedule (``tracer=None`` is bit-for-bit
        free)."""
        if not engines:
            raise ValueError("FrontDoor needs at least one engine")
        self.engines = engines
        self.lockstep = lockstep
        self.tracer = tracer
        self.tick = 0
        self.completed: list[tuple[str, object]] = []
        self.down: dict[str, str] = {}  # engine name -> failure reason
        self._order = list(engines)  # registration order = tie-break order
        self._costs = {}
        for name, engine in engines.items():
            cost = getattr(engine, "tick_cost", 1)
            if not (isinstance(cost, int) and cost >= 1):
                raise ValueError(f"engine {name!r} declares tick_cost "
                                 f"{cost!r}; need an int >= 1")
            if lockstep and cost != 1:
                raise ValueError(f"lockstep door requires tick_cost=1 "
                                 f"everywhere; engine {name!r} declares "
                                 f"{cost}")
            self._costs[name] = cost
        if tracer is not None:
            tracer.attach(self, "door")
            for name, engine in engines.items():
                engine.tracer = tracer
                tracer.label(engine, name)
                tracer.set_scale(engine, self._costs[name])
                # replica pools fan events out from their replicas, which
                # tick on the pool's cadence — same scale
                for k, rep in enumerate(getattr(engine, "replicas", ())):
                    rep.tracer = tracer
                    tracer.label(rep, f"{name}[{k}]")
                    tracer.set_scale(rep, self._costs[name])
        reg = registry if registry is not None else default_registry()
        self.metrics_scope = reg.register_component(
            self, {"latency": self.latency_summary, "health": self.health})
        # Ready-event queue: (due door-tick, registration index).  An
        # engine first fires once its cost is paid, i.e. at tick ==
        # tick_cost; heap order + index tie-break keeps the schedule
        # deterministic.
        self._due = [(self._costs[name], ix)
                     for ix, name in enumerate(self._order)]
        heapq.heapify(self._due)

    def _route(self, req) -> str:
        # Route by the request type each engine's adapter declares.
        for name, engine in self.engines.items():
            want = getattr(engine, "request_type", None)
            if want is not None and isinstance(req, want):
                return name
        registered = ", ".join(
            f"{name}={getattr(e, 'request_type', None).__name__}"
            for name, e in self.engines.items()
            if getattr(e, "request_type", None) is not None) or "none"
        raise TypeError(f"no engine registered for {type(req).__name__}; "
                        f"registered request types: {registered}")

    def submit(self, req) -> str:
        """Route and submit; returns the engine's admission status
        (`ADMITTED` / a `REJECTED_*` constant).  Submissions to a down
        engine bounce with `REJECTED_HALTED` instead of raising — one
        modality failing must not poison the submission surface."""
        return self.engines[self._route(req)].submit(req)

    def busy(self) -> bool:
        return any(e.busy() for e in self.engines.values())

    def _step_engine(self, name: str, out: list) -> bool:
        """Step one engine inside the isolation boundary; returns False
        when the engine was halted by this step.

        Fault containment (DESIGN.md §10): an engine whose ``step``
        escapes its own containment (a bug past the scheduler's launch
        quarantine) is *halted*, not propagated — its queued and running
        requests land on its ``failed`` ledger, it bounces future
        submissions, and the other engines keep serving.  ``down``
        names it, so a caller that must not serve degraded checks
        ``down`` (and the engines' ``failed`` ledgers) after a run."""
        engine = self.engines[name]
        try:
            out.extend((name, r) for r in engine.step())
            return True
        except Exception as exc:  # noqa: BLE001 — isolation boundary
            reason = f"{type(exc).__name__}: {exc}"
            self.down[name] = reason
            engine.halt(reason)
            return False

    def step(self) -> list[tuple[str, object]]:
        """One front-door tick: advance the virtual clock by one and
        fire every engine whose ready event is due (all of them, in the
        lockstep reference path).  A fired engine re-arms ``tick_cost``
        ticks out; a halted engine leaves the event queue.  Returns this
        tick's merged completions as ``(engine name, request)``,
        registration-ordered within the tick."""
        self.tick += 1
        out: list[tuple[str, object]] = []
        if self.lockstep:
            for name in self._order:
                if name not in self.down:
                    self._step_engine(name, out)
            if self.tracer is not None:
                self.tracer.tick_span(self, "door_tick", self.tick, 1, 0,
                                      fired=len(self._order) - len(self.down),
                                      finished=len(out))
            self.completed.extend(out)
            return out
        fired: list[int] = []
        while self._due and self._due[0][0] <= self.tick:
            fired.append(heapq.heappop(self._due)[1])
        for ix in sorted(fired):  # registration order within the tick
            name = self._order[ix]
            if name in self.down:
                continue
            if self._step_engine(name, out):
                heapq.heappush(self._due, (self.tick + self._costs[name], ix))
        if self.tracer is not None and fired:
            self.tracer.tick_span(self, "door_tick", self.tick, 1, 0,
                                  fired=len(fired), finished=len(out))
        self.completed.extend(out)
        return out

    def run(self, requests: Sequence | None = None,
            max_ticks: int = 10_000,
            on_undrained: str = "warn") -> list[tuple[str, object]]:
        # same replay as a lone engine
        drive(self, requests, max_ticks, on_undrained=on_undrained)
        return self.completed

    def _on_door_clock(self, name: str, obj):
        """Convert an engine's tick-denominated report onto the shared
        front-door clock: every ``*_ticks`` key, at any depth (replica
        pools nest per-replica summaries), scales by the engine's
        ``tick_cost``.  This is the single conversion point — adapters
        and pools always report on their own clocks."""
        cost = self._costs[name]
        if cost == 1:
            return obj

        def conv(x):
            if isinstance(x, dict):
                return {k: (v * cost if k.endswith("_ticks")
                            and isinstance(v, (int, float))
                            else conv(v))
                        for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(conv(v) for v in x)
            return x

        return conv(obj)

    def latency_summary(self) -> dict:
        """Per-engine latency summaries, tick figures converted onto the
        front-door clock (see ``_on_door_clock``)."""
        return {name: self._on_door_clock(name, engine.latency_summary())
                for name, engine in self.engines.items()}

    def health(self) -> dict:
        """Aggregate health report: per-engine `SlotEngine.health()`
        (queue depth + occupancy — the dispatcher's load signal doubles
        as the operator's) *folded with* each engine's latency-summary
        percentiles on the front-door clock, plus the door's own view of
        which engines are down — one surface for observability and load
        signals alike.  The port's engines have no degradation ladder,
        so each engine's ``degraded`` is ``None``."""
        return {
            "tick": self.tick,
            "down": dict(self.down),
            "engines": {
                name: {
                    **engine.health(),
                    "tick_cost": self._costs[name],
                    "latency": self._on_door_clock(
                        name, engine.latency_summary()),
                }
                for name, engine in self.engines.items()},
        }


def _make_vision_engine(image_size: int = 40, max_batch: int = 4,
                        device=None):
    """The reference's small vision engine (width 0.25, head 64), weights
    from seed 1 on a CPU generator (the same weights on any device)."""
    from repro_torch.models.mobilenetv2 import MNV2Config, init_mnv2
    from repro_torch.serving import VisionEngine

    device = resolve_device(device)
    cfg = MNV2Config(variant="p2m", image_size=image_size, width=0.25,
                     head_channels=64)
    params, bn = init_mnv2(torch.Generator().manual_seed(1), cfg,
                           device=device)
    return VisionEngine(params, bn, cfg, max_batch=max_batch,
                        device=device), cfg


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
                    help="route a mixed LM + vision stream via the "
                         "FrontDoor")
    ap.add_argument("--vision-requests", type=int, default=8)
    ap.add_argument("--video-streams", type=int, default=0,
                    help="with --mixed: add N multi-tick video streams "
                         "(delta-gated detection, DESIGN.md §9)")
    ap.add_argument("--vision-replicas", type=int, default=1,
                    help="with --mixed: serve vision from a ReplicaPool "
                         "of N engines behind least-loaded dispatch "
                         "(DESIGN.md §11)")
    ap.add_argument("--lm-tick-cost", type=int, default=1,
                    help="with --mixed: front-door ticks one LM engine "
                         "tick costs — cheap engines tick more often "
                         "(event-driven cadences, DESIGN.md §11)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(dtype=torch.float32)
    family = get_family(cfg)
    if cfg.family in ("vlm", "encdec"):
        raise SystemExit("serve driver targets pure-text families; "
                         "multimodal serving needs per-request prefill of "
                         "cross-attention KV (see serving/engine.py notes)")
    device = resolve_device(args.device)
    params, _ = family.init(torch.Generator(device).manual_seed(0), cfg)
    engine = ServeEngine(params, cfg, max_batch=args.max_batch,
                         max_len=args.max_len,
                         prefill_chunk=args.prefill_chunk, device=device,
                         tick_cost=args.lm_tick_cost if args.mixed else 1)

    rng = np.random.default_rng(0)
    reqs = []
    for uid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, rng.integers(4, 12)).tolist()
        reqs.append(Request(uid=uid, prompt=prompt,
                            max_new_tokens=args.max_new_tokens))

    if args.mixed:
        from repro_torch.data import SyntheticVWW

        vis0, vcfg = _make_vision_engine(device=device)
        vision = vis0
        if args.vision_replicas > 1:
            from repro_torch.serving import ReplicaPool

            more = [_make_vision_engine(device=device)[0]
                    for _ in range(args.vision_replicas - 1)]
            vision = ReplicaPool(vis0, *more)
        frames = SyntheticVWW(image_size=vcfg.image_size,
                              batch=args.vision_requests).batch_at(0)["images"]
        for uid in range(args.vision_requests):
            reqs.append(VisionRequest(uid=1000 + uid, image=frames[uid],
                                      arrival_tick=uid // 2))
        engines = {"lm": engine, "vision": vision}
        if args.video_streams:
            from repro_torch.models.mobilenetv2 import head_out_channels
            from repro_torch.video import (DetectConfig, StreamEngine,
                                           StreamRequest, SyntheticVideo,
                                           init_detect_head)

            vparams, vbn = vis0._params, vis0._bn
            det = init_detect_head(torch.Generator().manual_seed(2),
                                   head_out_channels(vcfg), DetectConfig(),
                                   device=device)
            engines["stream"] = StreamEngine(vparams, vbn, vcfg, det,
                                             max_streams=2, device=device)
            for uid in range(args.video_streams):
                vid = SyntheticVideo(image_size=vcfg.image_size,
                                     n_frames=8, seed=uid)
                reqs.append(StreamRequest(uid=2000 + uid,
                                          frames=vid.frames(),
                                          arrival_tick=uid))
        door = FrontDoor(**engines)
        t0 = time.perf_counter()
        done = door.run(reqs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        by = {name: [r for n, r in done if n == name] for name in engines}
        toks = sum(len(r.output) for r in by["lm"])
        print(f"front door: {len(by['lm'])} LM requests ({toks} tokens) + "
              f"{len(by['vision'])} frames + "
              f"{len(by.get('stream', []))} video streams in {dt:.2f}s "
              f"({door.tick} front-door ticks) on {device}")
        if "stream" in engines:
            s = engines["stream"].stream_summary()
            print(f"  stream: {s['frames']} frames, "
                  f"stem-skip {s['stem_skip_rate']:.2f}, "
                  f"measured bandwidth reduction "
                  f"{s['measured_reduction_vs_dense']:.2f}x vs dense")
        for name, s in door.latency_summary().items():
            print(f"  {name}: launches={s['launches']} "
                  f"mean_queue={s['mean_queue_ticks']:.2f} ticks "
                  f"mean_launch={s['mean_launch_us'] / 1e3:.1f} ms")
        return

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
