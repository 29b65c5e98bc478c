"""Served RWKV-6: a closed loop of clients on the port's `ServeEngine`
(`submit`, `step`), chunked prefill through B7 and decode through the
plain WKV.

The window opens with every client sending at once; a client sends its
next request when the last one finishes.  The rate counts every token the
engine advanced (prompt tokens prefilled and tokens generated) in ticks
that end inside the window, over the time to the end of the last such
tick.  Once the window has closed, a sample of finished requests drawn
from the seed, the longest among them, is run through the reference over
prompt and served tokens: each served token's logit is compared with the
reference's best at its position, where float32 settles the reference
(`SETTLED`)."""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import common, data, roofline, session, traffic, weights
from portbench.drivers import port
from portbench.reference import rwkv6 as ref
from portbench.trace import span


def _request(Request, spec: dict, tokens: np.ndarray):
    prompt = tokens[spec["row"], :spec["prompt_len"]].tolist()
    return Request(uid=spec["row"], prompt=prompt,
                   max_new_tokens=spec["new_tokens"])


def run(r: session.Run) -> None:
    from repro_torch.serving.engine import Request, ServeEngine

    cfg, tr = r.config, r.traffic
    params = weights.rwkv6(r.seed, cfg, r.device)
    specs = traffic.closed_loop(tr, r.seed)
    tokens = data.lm_tokens(r.seed, 0, len(specs), int(tr["prompt_max"]),
                            cfg["vocab"])
    chunk = int(tr["prefill_chunk"])
    engine = ServeEngine(params, port.rwkv_config(cfg),
                         max_batch=int(tr["max_batch"]),
                         max_len=int(tr["max_len"]), prefill_chunk=chunk,
                         device=r.device)
    # one chunk tick and one decode tick: the two shapes the window runs
    warm = Request(uid=-1, prompt=tokens[0, :chunk].tolist(), max_new_tokens=2)
    engine.submit(warm)
    while not warm.done:
        engine.step()
    r.sync()
    r.warm_profiler()
    h, hd = cfg["n_heads"], cfg["head_dim"]
    r.layer["wkv_least_s"] = roofline.least_s(*roofline.wkv(
        int(tr["max_batch"]), chunk, h, hd))
    r.layer["n_model"] = weights.n_params(params) - params["embed"][
        "table"].numel()

    clients = int(tr["clients"])
    queue = list(specs)
    live: dict = {}

    def send():
        spec = queue.pop(0)
        q = _request(Request, spec, tokens)
        live[spec["row"]] = q
        with span(torch, "engine.submit"):
            engine.submit(q)

    def progress() -> int:
        return sum(_advanced(engine, q) for q in live.values())

    finished: list = []
    wkv0, stats0 = port.wkv_launches(), dict(engine.stats)
    t0 = r.open_window()
    for _ in range(clients):
        send()
    advanced = 0
    end = t0

    def serve(until: float) -> None:
        nonlocal advanced, end
        while time.perf_counter() - t0 < until:
            before = progress()
            with span(torch, "engine.step"):
                for q in engine.step():
                    finished.append(q)
                    if queue:
                        send()
            t = time.perf_counter()
            after = progress()
            advanced += after - before
            end = t
            for q in [q for q in live.values() if q.done]:
                del live[q.uid]

    trace_at = min(float(tr["trace_at_s"]), 0.3 * r.seconds)
    serve(min(trace_at, r.seconds))
    if r.profiler is not None:
        with r.traced():
            serve(min(trace_at + float(tr["trace_s"]), r.seconds))
    serve(r.seconds)
    window = end - t0
    r.close_window()

    ticks = engine.stats["launches"] - stats0["launches"]
    r.e2e["serve_tokens_per_s"] = advanced / window
    r.layer["launch_ms"] = (engine.stats["wall_us"] - stats0["wall_us"]) \
        / max(ticks, 1) / 1e3
    r.layer["tokens_per_s"] = r.e2e["serve_tokens_per_s"]
    r.attempted = len(finished) + len(live)
    r.failed = len(engine.failed) + len(engine.rejected) + len(engine.evicted)
    common.log(f"[window] {window:.3f} s, {ticks} ticks, {advanced} tokens "
               f"advanced, {len(finished)} requests finished, {len(live)} "
               f"in flight, mean tick {r.layer['launch_ms']:.3f} ms, "
               f"B7 launches {port.wkv_launches() - wkv0}")
    if not finished:
        r.check("token_gap", math.inf)
        return

    picked = traffic.sample(
        int(tr["sample"]), r.seed, len(finished),
        always=max(range(len(finished)),
                   key=lambda i: len(finished[i].prompt)
                   + len(finished[i].output)))
    served = [(finished[i].prompt, list(finished[i].output)) for i in picked]
    del engine, live, finished
    session.free()
    t_ref = time.perf_counter()
    gaps = judge(params, served, cfg, r.device, control=r.control)
    common.log(f"[reference] {len(served)} requests, "
               f"{sum(len(o) for _, o in served)} served tokens, "
               f"{gaps['left_out']} of them at positions left out, "
               f"{time.perf_counter() - t_ref:.1f} s")
    r.check("token_gap", gaps["token_gap"])
    if r.control:
        r.readings["control"] = {"token_gap": gaps["control"]}


def _advanced(engine, q) -> int:
    """Tokens of ``q`` the engine has taken in: prompt consumed + tokens
    generated."""
    if q.done:
        return len(q.prompt) + len(q.output)
    for i, s in enumerate(engine.slots):
        if s is q:
            return int(engine._slot_cursor[i]) + len(q.output)
    return 0


@torch.no_grad()
def reference_hidden(params, served, cfg: dict, device) -> torch.Tensor:
    """The reference's final hidden states over each request's prompt and
    served tokens but the last (B, T, d), the batch padded at the end."""
    seqs = [p + o[:-1] for p, o in served]
    toks = torch.zeros(len(seqs), max(len(s) for s in seqs),
                       dtype=torch.long, device=device)
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = torch.tensor(s, device=device)
    return ref.hidden(params, toks, cfg)


#: A position is judged only where the float32 reference's logits lie
#: within this many logits of the float64 reference's and pick the same
#: token: where the reference itself is not settled by float32 rounding
#: (the random model amplifies it to whole logits at some positions), no
#: float32 program can be judged.
SETTLED = 0.01


@torch.no_grad()
def judge(params, served, cfg: dict, device, control: bool = False) -> dict:
    """``token_gap``: the widest gap by which a served token's float64
    reference logit lies below the reference's best at its position,
    over the settled positions (`SETTLED`); ``left_out``: served positions
    not settled; with ``control``, ``control``: the same gap of the token
    TF32 puts first, read where ``token_gap`` is read (the settled
    positions of the served tokens)."""
    h32 = reference_hidden(params, served, cfg, device)
    low = None
    if control:
        with session.tf32():
            low = reference_hidden(params, served, cfg, device)
    p64 = _to(params, torch.float64)
    h64 = reference_hidden(p64, served, cfg, device)
    head32, head64 = params["embed"]["head"], p64["embed"]["head"]
    out = {"token_gap": 0.0, "left_out": 0, "control": 0.0}
    for i, (p, o) in enumerate(served):
        n = len(p) + len(o) - 1
        lg64 = h64[i, :n] @ head64
        lg32 = (h32[i, :n] @ head32).double()
        settled = (lg32.argmax(-1) == lg64.argmax(-1)) & (
            (lg32 - lg64).abs().amax(-1) <= SETTLED)
        best = lg64.amax(-1)
        pos = torch.arange(len(p) - 1, n, device=device)
        tok = torch.tensor(o, device=device)
        gap = best[pos] - lg64[pos, tok]
        keep = settled[pos]
        out["left_out"] += int((~keep).sum())
        if keep.any():
            out["token_gap"] = max(out["token_gap"], float(gap[keep].max()))
        if low is not None and keep.any():
            with session.tf32():
                pick = (low[i, pos] @ head32).argmax(-1)
            g = best[pos] - lg64[pos].gather(-1, pick[:, None])[:, 0]
            out["control"] = max(out["control"], float(g[keep].max()))
    return out


def _to(tree, dtype):
    if isinstance(tree, dict):
        return {k: _to(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)
