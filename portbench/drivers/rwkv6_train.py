"""Trained RWKV-6: the port's `Trainer` over `make_train_step`, wired as
`launch/train.py` wires it (AdamW under the cosine warm-up, a layer
recomputed in the backward), on the seed's token stream through the
port's `DataPipeline`.

Set-up builds the one train state and drives it through its first
``check_steps`` steps with the window's own call (`Trainer.run(1)`, on
batches whose rows all differ).  The reference follows them from the
same weights and batches, after the program's state is freed; compared
are each step's loss, the first clipped gradient as AdamW got it (its
first moment after one step, over 1 − β₁) and the parameters' change over
the steps, by the worst leaf."""
from __future__ import annotations

import time

import torch

from portbench import common, data, roofline, session, weights
from portbench.drivers import port
from portbench.reference import optim as ref_optim
from portbench.reference import rwkv6 as ref
from portbench.trace import span


def run(r: session.Run) -> None:
    from repro_torch.data import DataPipeline

    cfg, tr = r.config, r.traffic
    opt = tr["optimizer"]
    nb, seq = int(tr["batch"]), int(tr["seq"])
    dataset = data.LMBatches(r.seed, nb, seq, cfg["vocab"])
    pipeline = DataPipeline(dataset, device=r.device)
    try:
        _run(r, dataset, pipeline, opt, nb, seq)
    finally:
        pipeline.close()


def _run(r: session.Run, dataset, pipeline, opt: dict, nb: int, seq: int):
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.train import Trainer, TrainState, make_train_step

    cfg, tr = r.config, r.traffic
    pcfg = port.rwkv_config(cfg, remat=bool(tr["remat"]))
    optimizer = adamw(cosine_warmup(opt["lr"], warmup=opt["warmup"],
                                    total=opt["total"]),
                      b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
                      weight_decay=opt["weight_decay"],
                      clip_norm=opt["clip_norm"])
    params = weights.rwkv6(r.seed, cfg, r.device)
    n_model = weights.n_params(params) - params["embed"]["table"].numel()
    trainer = Trainer(make_train_step(pcfg, optimizer),
                      TrainState(params, optimizer.init(params)), pipeline,
                      log_every=0)
    del params

    n_check = int(tr["check_steps"])
    grad1 = None
    for i in range(n_check):
        trainer.run(1)
        if i == 0:  # AdamW's first moment after one step: (1 − β₁)·g
            grad1 = {k: float(torch.linalg.vector_norm(t)) / (1 - opt["b1"])
                     for k, t in weights.leaves(trainer.state["opt"]["m"])}
    prog = {"losses": [h["loss"] for h in trainer.history], "grad1": grad1,
            "change": _change_from_seed(r, trainer.state["params"])}
    r.sync()
    r.warm_profiler()
    r.layer["n_model"] = n_model
    r.layer["wkv_least_s"] = roofline.least_s(*roofline.wkv(
        nb, seq, cfg["n_heads"], cfg["head_dim"]))

    wkv0 = port.wkv_launches()
    steps = 0
    t0 = r.open_window()

    def train(until: float) -> None:
        nonlocal steps
        while time.perf_counter() - t0 < until:
            with span(torch, "trainer.run"):
                trainer.run(1)
            steps += 1

    train(min(float(tr["trace_at_s"]), 0.3 * r.seconds))
    if r.profiler is not None:
        with r.traced():
            for _ in range(int(tr["trace_steps"])):
                with span(torch, "trainer.run"):
                    trainer.run(1)
                steps += 1
    train(r.seconds)
    window = time.perf_counter() - t0
    r.close_window()
    r.e2e["train_tokens_per_s"] = steps * nb * seq / window
    r.layer["tokens_per_s"] = r.e2e["train_tokens_per_s"]
    r.attempted, r.failed = steps, 0
    times = [h["step_time_s"] for h in trainer.history[n_check:]]
    common.log(f"[window] {steps} steps of {nb}x{seq} in {window:.3f} s "
               f"(step {min(times):.4f}-{max(times):.4f} s, stragglers "
               f"{trainer.straggler.stragglers}), B7 launches "
               f"{port.wkv_launches() - wkv0}")

    del trainer
    session.free()
    want = reference(r, dataset, n_check)
    gaps = session.train_gaps(prog, want)
    common.log(f"[reference] losses {prog['losses']} against "
               f"{want['losses']}; {gaps['where']}")
    r.readings["program"] = gaps
    for k in r.limits:
        r.check(k, gaps[k])
    if r.control:
        with session.tf32():
            r.readings["control"] = session.train_gaps(
                reference(r, dataset, n_check), want)
        r.readings["half_batch"] = session.train_gaps(
            reference(r, dataset, n_check, half=True), want)


def _change_from_seed(r: session.Run, params) -> dict:
    """‖p − p₀‖ a leaf, p₀ drawn again from the seed (the step wrote over
    the first weights in place)."""
    p0 = weights.rwkv6(r.seed, r.config, r.device)
    out = {k: float(torch.linalg.vector_norm(a - b)) for (k, a), (_, b)
           in zip(weights.leaves(params), weights.leaves(p0))}
    del p0
    session.free()
    return out


def reference(r: session.Run, dataset, n_check: int, half: bool = False):
    """``losses``, the first clipped gradient's leaf norms (``grad1``) and
    the change's (``change``) of the reference's first ``n_check`` steps, from the seed's weights;
    with ``half`` the loss is the mean over the first half of each batch
    (a planted fault)."""
    cfg, opt = r.config, r.traffic["optimizer"]
    params = weights.rwkv6(r.seed, cfg, r.device)
    names = [k for k, _ in weights.leaves(params)]
    live = [t for _, t in weights.leaves(params)]
    m = [torch.zeros_like(t) for t in live]
    v = [torch.zeros_like(t) for t in live]
    losses, grad1 = [], None
    for i in range(n_check):
        b = dataset.batch_at(i)
        if half:
            b = {k: x[:len(x) // 2] for k, x in b.items()}
        toks = torch.from_numpy(b["tokens"]).to(r.device, torch.long)
        tgts = torch.from_numpy(b["targets"]).to(r.device, torch.long)
        for t in live:
            t.requires_grad_(True)
        loss = ref.loss(_rebuild(params, live), toks, tgts, cfg,
                        remat=bool(r.traffic["remat"]))
        grads = list(torch.autograd.grad(loss, live))
        for t in live:
            t.requires_grad_(False)
        losses.append(float(loss.detach()))
        ref_optim.adamw_step(live, grads, m, v, opt, i)
        if i == 0:
            grad1 = {k: float(torch.linalg.vector_norm(t)) / (1 - opt["b1"])
                     for k, t in zip(names, m)}
        del grads
    del m, v
    session.free()
    p0 = weights.rwkv6(r.seed, cfg, r.device)
    change = {k: float(torch.linalg.vector_norm(a - b)) for k, a, (_, b)
              in zip(names, live, weights.leaves(p0))}
    return {"losses": losses, "grad1": grad1, "change": change}


def _rebuild(tree, flat: list, it=None):
    it = iter(flat) if it is None else it
    if isinstance(tree, dict):
        return {k: _rebuild(v, flat, it) for k, v in tree.items()}
    return next(it)
