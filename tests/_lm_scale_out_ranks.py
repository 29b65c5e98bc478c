"""Rank bodies of `tests/test_torch_lm_scale_out.py`: each runs in one
spawned rank of a gloo world on the CPU (`repro_torch.launch.world.
spawn_world`) and returns numpy results to the test.  Torch and the port
only: a rank imports no JAX.  Weights arrive as numpy trees (the
reference's init, carried across by the test).
"""
import numpy as np
import torch

from repro_torch import compat
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import moe
from repro_torch.models.families import get_family
from repro_torch.optim import constant, sgd
from repro_torch.parallel import collectives as col
from repro_torch.parallel import plan_for, use_plan
from repro_torch.parallel.sharding_utils import (
    batch_shardings,
    local_tree,
    param_shardings,
    shardings_for,
)
from repro_torch.serving import ServeEngine
from repro_torch.serving.engine import greedy_generate
from repro_torch.serving.sessions import SessionEngine, SessionRequest
from repro_torch.train import TrainState, make_train_step
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

SGD_LR = 1e-2


def config(arch: str, **kw):
    return get_smoke_config(arch).replace(dtype=torch.float32, **kw)


def tensors(tree, device="cpu"):
    return compat.tree_from_reference(tree, device=device)


def arrays(tree):
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def optimizer():
    return sgd(constant(SGD_LR))


def _mesh(model: int, device="cpu"):
    return make_debug_mesh(model=model, device=device)


def _shapes_agree(local, whole, shardings) -> bool:
    """Each local leaf has the shape the plan's `shard_shape` gives."""
    return all(tree_leaves(tree_map(
        lambda a, w, sh: tuple(a.shape) == sh.shard_shape(tuple(w.shape)),
        local, whole, shardings)))


def train(cfg, weights, batches, model: int, *, fsdp=False,
          grad_compression=None, device="cpu"):
    """The train step under ``plan_for(mesh, fsdp=…)`` over ``batches``
    (global numpy batches, each split over the batch axes): every loss,
    the params after the first and the last step (whole), and whether
    the rank's leaves have the plan's shard shapes."""
    mesh = _mesh(model, device)
    plan = plan_for(mesh, fsdp=fsdp)
    params = tensors(weights, device)
    sh = param_shardings(cfg, plan)
    local = local_tree(params, sh)
    opt = optimizer()
    extras = None
    if grad_compression == "int8_ef":
        extras = {"ef_error": tree_map(torch.zeros_like, local)}
    state = TrainState(local, opt.init(local), extras=extras)
    step = make_train_step(cfg, opt, grad_compression=grad_compression)
    out = {"losses": [], "shapes_agree": _shapes_agree(local, params, sh)}
    with use_plan(plan):
        for i, batch in enumerate(batches):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in batch.items()}
            state, metrics = step(state, local_tree(
                batch, batch_shardings(batch, plan)))
            out["losses"].append(float(metrics["loss"]))
            if i == 0:
                out["first"] = arrays(col.whole_tree(state["params"], sh))
    out["last"] = arrays(col.whole_tree(state["params"], sh))
    return out


def off_thread_grads(cfg, weights, batch, model: int):
    """The TP loss's gradients with the backward (and each layer's remat
    recompute) run on another thread, where the thread-local plan is not
    set, as the autograd engine runs a CUDA backward: the largest
    difference from the same backward on this thread."""
    import threading

    mesh = _mesh(model)
    plan = plan_for(mesh)
    local = local_tree(tensors(weights), param_shardings(cfg, plan))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    batch = local_tree(batch, batch_shardings(batch, plan))
    family = get_family(cfg)
    grads = []
    for off in (False, True):
        live = [p.detach().requires_grad_(True) for p in tree_leaves(local)]
        with use_plan(plan):
            loss, _ = family.loss(tree_unflatten(local, live), batch, cfg)
        box = {}

        def run():
            box["g"] = torch.autograd.grad(loss, live)

        if off:
            t = threading.Thread(target=run)
            t.start()
            t.join()
        else:
            with use_plan(plan):
                run()
        grads.append(box["g"])
    return max(float((a - b).abs().max()) for a, b in zip(*grads))


def moe_losses(cfg, weights, batch, model: int):
    """The MoE loss under ``plan_for(mesh)`` (experts over the model axis)
    for both ``moe_impl``s, with the drops each layer counted."""
    mesh = _mesh(model)
    plan = plan_for(mesh)
    params = tensors(weights)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    drops = []
    positions = moe.positions

    def counting(top_idx, n_experts):
        pos = positions(top_idx, n_experts)
        drops.append(int((pos >= moe.capacity(cfg, top_idx.shape[1])).sum()))
        return pos

    moe.positions = counting
    try:
        for impl in ("xla", "shard_map"):
            run_cfg = cfg.replace(moe_impl=impl)
            local = local_tree(params, param_shardings(run_cfg, plan))
            drops.clear()
            with use_plan(plan), torch.no_grad():
                loss, metrics = get_family(run_cfg).loss(
                    local, local_tree(batch, batch_shardings(batch, plan)),
                    run_cfg)
                loss = col.all_reduce_sum(loss, col.axis_groups(
                    mesh, col.batch_axes(plan)))
            out[impl] = {"loss": float(loss), "aux": float(metrics["aux"]),
                         "drops": list(drops),
                         "experts_here": int(local["layers"]["moe"]["wi"]
                                             .shape[1])}
    finally:
        moe.positions = positions
    return out


def decode(cfg, weights, prompts, model: int, steps: int, max_len: int,
           cache_seq_shard: bool = True):
    """Decode under ``plan_for(mesh, cache_seq_shard=…)``: split-KV with the
    cache's sequence over the model axis, else the cache's heads split
    over it where they divide (whole where not).  The prompts
    teacher-forced through ``decode_step`` (each step's logits, the
    rank's vocab columns gathered), then `greedy_generate` under the
    plan."""
    mesh = _mesh(model)
    plan = plan_for(mesh, cache_seq_shard=cache_seq_shard)
    family = get_family(cfg)
    params = local_tree(tensors(weights), param_shardings(cfg, plan))
    b, p = prompts.shape
    state, axes = family.init_decode_state(cfg, b, max_len, device="cpu")
    state_sh = shardings_for(state, axes, plan)
    state = local_tree(state, state_sh)
    model_groups = col.axis_groups(mesh, ("model",))
    logits = []
    with use_plan(plan), torch.no_grad():
        for t in range(p):
            lg, state = family.decode(
                params, state, torch.from_numpy(prompts[:, t:t + 1]),
                torch.full((b,), t), cfg, cache_shardings=state_sh)
            logits.append(col.gather_from_model(lg, model_groups, -1)
                          .numpy().copy())
        tokens = greedy_generate(params, cfg, prompts, steps)
    return {"logits": np.stack(logits, 1)[:, :, 0],
            "cache_local": tuple(state["k"].shape), "tokens": tokens.numpy()}


def sessions(cfg, weights, all_turns, leak_turns):
    """The sharded `SessionEngine` (8 slots over the data axis): the
    outputs and the whole state, then the leak check on a state filled
    with 7s."""
    mesh = _mesh(1)
    params = tensors(weights)
    eng = SessionEngine(params, cfg, max_batch=8, max_len=256,
                        prefill_chunk=4, mesh=mesh, device="cpu")
    reqs = [SessionRequest(uid=i, turns=[list(t) for t in ts],
                           max_new_tokens=4)
            for i, ts in enumerate(all_turns)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    groups = col.axis_groups(mesh, ("data",))
    out = {"outputs": [r.outputs for r in reqs],
           "rows": eng._shards.rows.tolist(),
           "state": arrays(tree_map(
               lambda a: col.all_gather_batch(a.transpose(0, 1), groups)
               .transpose(0, 1), eng.state))}
    for leaf in tree_leaves(eng.state):
        leaf.fill_(7.0)
    req = SessionRequest(uid=99, turns=leak_turns, max_new_tokens=3)
    eng.submit(req)
    eng.run()
    out["leak"] = req.outputs
    return out


FAMILY_ARCHS = ("recurrentgemma-9b", "llama-3.2-vision-11b", "whisper-tiny")


def family_case(arch: str):
    """(cfg, params, batch) of a family's SMOKE loss: the family's init
    seeded 0 and a batch from a seeded generator, the same in every rank
    and in the test's single process."""
    cfg = config(arch)
    family = get_family(cfg)
    params, _ = family.init(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 6), generator=gen),
             "targets": torch.randint(0, cfg.vocab, (4, 6), generator=gen)}
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.randn(
            (4, cfg.n_image_tokens, cfg.d_model), generator=gen)
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.randn((4, 6, cfg.d_model), generator=gen)
    return cfg, params, batch


def refusals(weights_by_arch):
    """What must raise: a slot table the data axis does not divide.  And
    the rglru, vlm and encdec families' loss under a plan with a model
    axis of 2 (tensor-parallel; FSDP over the rest of the world), which
    they once refused: the global loss, the shares summed."""
    res = {}
    rwkv = config("rwkv6-3b")
    try:
        ServeEngine(tensors(weights_by_arch["rwkv6-3b"]), rwkv, max_batch=3,
                    mesh=_mesh(1), device="cpu")
    except ValueError as exc:
        res["max_batch"] = str(exc)
    plan = plan_for(_mesh(2), fsdp=True)
    for arch in FAMILY_ARCHS:
        cfg, params, batch = family_case(arch)
        local = local_tree(params, param_shardings(cfg, plan))
        with use_plan(plan), torch.no_grad():
            loss, _ = get_family(cfg).loss(
                local, local_tree(batch, batch_shardings(batch, plan)), cfg)
            loss = col.all_reduce_sum(loss, col.axis_groups(
                plan.mesh, col.batch_axes(plan)))
        res[cfg.family] = float(loss)
    return res


def card_step(rank, world, cfg, weights, batches):
    """`train` on the card in a one-rank world (mesh (1, 1): the
    tensor-parallel code over one rank's groups), TF32 off, with B7's
    launches in the rank."""
    from repro_torch.kernels.rwkv_wkv import kernel as wkv_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    before = wkv_kernel.wkv_fused.launches
    out = train(cfg, weights, batches, 1, device="cuda")
    out["b7"] = wkv_kernel.wkv_fused.launches - before
    return out


def scenarios(rank, world, inputs):
    """Every scenario of the module on one world (one spawn for all)."""
    torch.manual_seed(0)
    w = inputs["weights"]
    model = world  # the whole world on the model axis
    res = {
        "dense": train(config("qwen3-32b"), w["qwen3-32b"],
                       inputs["dense_batches"], 2 if world == 4 else 1,
                       fsdp=True),
        "moe": {factor: moe_losses(
            config("qwen3-moe-30b-a3b", capacity_factor=factor),
            w["qwen3-moe-30b-a3b"], inputs["moe_batch"], model)
            for factor in inputs["capacity_factors"]},
        "decode": {arch: decode(config(arch), w[arch], inputs["prompts"],
                                model, inputs["decode_steps"], 32)
                   for arch in ("qwen3-moe-30b-a3b", "llama3.2-1b")},
        "decode_heads": decode(config("llama3.2-1b"), w["llama3.2-1b"],
                               inputs["prompts"], model,
                               inputs["decode_steps"], 32,
                               cache_seq_shard=False),
        "int8": train(config("llama3.2-1b"), w["llama3.2-1b"],
                      inputs["int8_batches"], 2, grad_compression="int8_ef"),
        "rwkv": train(config("rwkv6-3b"), w["rwkv6-3b"],
                      inputs["dense_batches"][:1], model),
        "off_thread": {arch: off_thread_grads(
            config(arch), w[arch], inputs["dense_batches"][0], model)
            for arch in ("rwkv6-3b", "qwen3-moe-30b-a3b")},
        "rwkv_fsdp": train(config("rwkv6-3b"), w["rwkv6-3b"],
                           inputs["dense_batches"][:1], 1, fsdp=True),
        "sessions": sessions(config("rwkv6-3b"), w["rwkv6-3b"],
                             inputs["turns"], inputs["leak_turns"]),
        "refusals": refusals(w),
    }
    return res
