"""Trained P²M-MobileNetV2: the port's `make_vww_train_step` at the
paper's recipe, on a pool of batches made at set-up and cycled through
(their copy to the card stays inside the step, as for users; with the
traffic's ``pin``, from page-locked host memory, as a loader with
``pin_memory`` hands them over).

Set-up builds the one train state, drives it from the seed through its
first ``check_steps`` steps (the window's own call, on batches whose rows
all differ) and hands that state to the window.  The reference follows
those steps from the same weights and batches.  Compared: each step's
loss, the first gradient as the optimizer got it (its momentum after
one step), what the first step wrote (the parameters' change and the BN
running statistics' change) and the parameters' change over all the
steps, by the worst leaf and by the median leaf."""
from __future__ import annotations

import time

import torch

from portbench import common, data, roofline, session, weights
from portbench.drivers import port
from portbench.reference import mnv2 as ref
from portbench.reference import optim as ref_optim
from portbench.reference import p2m as p2m_ref
from portbench.trace import span


def _norms(tree) -> dict:
    return {k: float(torch.linalg.vector_norm(t.float()))
            for k, t in weights.leaves(tree)}


def run(r: session.Run) -> None:
    from repro_torch.optim import constant, sgd
    from repro_torch.train.vision import make_vww_train_step, vww_train_state

    cfg, tr = r.config, r.traffic
    opt = tr["optimizer"]
    nb, size = int(tr["batch"]), cfg["image_size"]
    params, bn = weights.mnv2(r.seed, cfg, r.device)
    p0 = {k: t.clone() for k, t in weights.leaves(params)}
    bn0 = {k: t.clone() for k, t in weights.leaves(bn)}
    pool = [dict(zip(("images", "labels"),
                     data.vww_images(r.seed, i * nb, nb, size, r.device)))
            for i in range(int(tr["pool"]))]
    if tr.get("pin") and r.device.type == "cuda":
        for b in pool:
            b["images"] = torch.from_numpy(b["images"]).pin_memory()
    optimizer = sgd(constant(opt["lr"]), momentum=opt["momentum"])
    step = make_vww_train_step(port.mnv2_config(cfg), optimizer)
    state = vww_train_state(params, bn, optimizer.init(params))
    del params

    n_check = int(tr["check_steps"])
    prog = {"losses": []}
    for i in range(n_check):
        state, m = step(state, pool[i % len(pool)])
        prog["losses"].append(float(m["loss"]))
        if i == 0:  # SGD's momentum after one step is the gradient
            prog["grad1"] = _norms(state["opt"]["mu"])
            prog["change1"] = _change(state["params"], p0)
            prog["bn1"] = _change(state["bn"], bn0)
    prog["change"] = _change(state["params"], p0)
    del p0, bn0
    r.sync()
    r.warm_profiler()
    coeffs = p2m_ref.pixel_coefficients(cfg["pixel_model"])
    fwd = session.model_flops(
        lambda p, s, x: ref.forward_train(p, s, x, cfg, coeffs),
        state["params"], state["bn"], torch.zeros(1, size, size, 3))
    r.layer["flops_per_image"] = 3 * fwd
    k = cfg["p2m"]
    dx = cfg["pixel_model"]["degree_x"]
    ho = (size - k["kernel"]) // k["stride"] + 1
    mm, kk, n = nb * ho * ho, k["kernel"] ** 2 * k["in_channels"], \
        k["out_channels"]
    r.layer["stem_least_s"] = {
        "forward": roofline.least_s(*roofline.stem_forward(
            nb, size, size, k["in_channels"], n, k["kernel"], k["stride"],
            dx)),
        "dx": roofline.least_s(*roofline.stem_backward_dx(mm, kk, n, dx)),
        "dw": roofline.least_s(*roofline.stem_backward_dw(mm, kk, n, dx))}

    launches0 = port.p2m_launches()
    steps = 0
    t0 = r.open_window()
    i = n_check

    def train(until: float) -> None:
        nonlocal state, steps, i
        while time.perf_counter() - t0 < until:
            with span(torch, "train.step"):
                state, _ = step(state, pool[i % len(pool)])
            i += 1
            steps += 1

    trace_at = min(float(tr["trace_at_s"]), 0.3 * r.seconds)
    train(min(trace_at, r.seconds))
    if r.profiler is not None:
        with r.traced():
            for _ in range(int(tr["trace_steps"])):
                with span(torch, "train.step"):
                    state, _ = step(state, pool[i % len(pool)])
                i += 1
                steps += 1
    train(r.seconds)
    r.sync()
    window = time.perf_counter() - t0
    r.close_window()
    r.e2e["train_images_per_s"] = steps * nb / window
    r.layer["images_per_s"] = r.e2e["train_images_per_s"]
    r.attempted, r.failed = steps, 0
    common.log(f"[window] {steps} steps of {nb} in {window:.3f} s, "
               f"launches {port.delta(port.p2m_launches(), launches0)}")

    del state
    session.free()
    t_ref = time.perf_counter()
    want = reference(r, pool, coeffs, n_check)
    gaps = session.train_gaps(prog, want)
    common.log(f"[reference] {time.perf_counter() - t_ref:.1f} s; losses "
               f"{prog['losses']} against {want['losses']}; {gaps['where']}")
    r.readings["program"] = gaps
    for k in r.limits:
        r.check(k, gaps[k])
    if r.control:
        with session.tf32():
            r.readings["control"] = session.train_gaps(
                reference(r, pool, coeffs, n_check), want)
        for fault in FAULTS:
            r.readings[fault] = session.train_gaps(
                reference(r, pool, coeffs, n_check, fault=fault), want)
        # a second witness of what float32 rounding does over the steps
        r.readings["reference_float32"] = session.train_gaps(
            want, reference(r, pool, coeffs, n_check, dtype=torch.float64))


#: Faults planted in the reference put in the program's place, read with
#: the control: half of each batch left out; the parameters left in
#: place while the momentum is written; the BN running statistics left
#: as they were.
FAULTS = ("half_batch", "params_still", "bn_still")


def _change(tree, start: dict) -> dict:
    """‖t − t₀‖ a leaf of ``tree`` against ``start`` (path → t₀)."""
    return {k: float(torch.linalg.vector_norm(t.double() - start[k].double()))
            for k, t in weights.leaves(tree)}


def reference(r: session.Run, pool: list, coeffs, n_check: int,
              fault: str | None = None, dtype=torch.float32) -> dict:
    """The reference's first ``n_check`` steps from the seed's weights, in
    ``dtype``: ``losses``, the first gradient's leaf norms (``grad1``), the
    first step's change of the parameters and of the BN running
    statistics (``change1``, ``bn1``) and the change over the steps
    (``change``), a leaf each; ``fault`` one of `FAULTS`."""
    cfg, opt = r.config, r.traffic["optimizer"]
    params, bn = weights.mnv2(r.seed, cfg, r.device)
    params, bn = _cast(params, dtype), _cast(bn, dtype)
    bn0 = {k: t.clone() for k, t in weights.leaves(bn)}
    names = [k for k, _ in weights.leaves(params)]
    live = [t for _, t in weights.leaves(params)]
    p0 = {k: t.clone() for k, t in zip(names, live)}
    mom = [torch.zeros_like(t) for t in live]
    tree = _rebuild(params, live)
    out = {"losses": []}
    for i in range(n_check):
        b = pool[i % len(pool)]
        rows = len(b["labels"]) // 2 if fault == "half_batch" \
            else len(b["labels"])
        images = torch.as_tensor(b["images"][:rows]).to(r.device, dtype)
        labels = torch.as_tensor(b["labels"][:rows]).to(r.device, torch.long)
        for t in live:
            t.requires_grad_(True)
        logits, new_bn = ref.forward_train(tree, bn, images, cfg, coeffs)
        loss = ref.softmax_ce(logits, labels)
        grads = torch.autograd.grad(loss, live)
        for t in live:
            t.requires_grad_(False)
        out["losses"].append(float(loss.detach()))
        if fault != "bn_still":
            bn = _detach(new_bn)
        if i == 0:
            out["grad1"] = {k: float(torch.linalg.vector_norm(g))
                            for k, g in zip(names, grads)}
        if fault == "params_still":
            ref_optim.sgd_step([t.clone() for t in live], grads, mom, opt, i)
        else:
            ref_optim.sgd_step(live, grads, mom, opt, i)
        if i == 0:
            out["change1"] = _change(tree, p0)
            out["bn1"] = _change(bn, bn0)
    out["change"] = _change(tree, p0)
    return out


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def _rebuild(tree, flat: list, it=None):
    it = iter(flat) if it is None else it
    if isinstance(tree, dict):
        return {k: _rebuild(v, flat, it) for k, v in tree.items()}
    return next(it)


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach()
