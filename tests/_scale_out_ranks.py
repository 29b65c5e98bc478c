"""Rank bodies of `tests/test_torch_scale_out.py`: each runs in one spawned
rank of a gloo world on the CPU (`repro_torch.launch.world.spawn_world`)
and returns numpy results to the test.  Torch and the port only: a rank
imports no JAX.
"""
import numpy as np
import torch

from repro_torch.data import DataPipeline, SyntheticVWW
from torch.distributed.tensor import Replicate, distribute_tensor

from repro_torch.launch.mesh import (
    make_debug_mesh,
    make_production_mesh,
    make_submeshes,
)
from repro_torch.models.mobilenetv2 import MNV2Config
from repro_torch.optim import constant, sgd
from repro_torch.parallel import shard, use_plan, vision_plan_for
from repro_torch.parallel.sharding_utils import batch_shardings, local_tree
from repro_torch.serving import (
    FaultInjector,
    FaultPlan,
    ReplicaPool,
    VisionEngine,
    VisionRequest,
)
from repro_torch.train.vision import (
    make_vww_train_step,
    vww_train_shardings,
    vww_train_state,
)
from repro_torch.tree import tree_map
from repro_torch.video import DetectConfig, StreamEngine, StreamRequest

ENGINE_CFG = MNV2Config(variant="p2m", image_size=20, width=0.25,
                        head_channels=16)
DCFG = DetectConfig(head_channels=8, max_dets=4)
FAULT_PLAN = FaultPlan(launch_error_ticks=(1,), nan_ticks=(3,))


def tensors(tree, device="cpu"):
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def arrays(tree):
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def stem_kernel_launches() -> dict:
    """The train step's kernels' launch counts in this process: the stem's
    forward (B1 or B2, as tuned) and its backward (B3, B4)."""
    from repro_torch.kernels.p2m_conv import backward, conv

    return {"forward": conv.p2m_conv_fused.launches
            + conv.p2m_conv_fused.launches_pipelined,
            "dx": backward.p2m_bwd_dx.launches,
            "dw": backward.p2m_bwd_dw.launches}


def dp_optimizer():
    return sgd(constant(0.01), momentum=0.9)


def dp_steps(rank, world, cfg_kw, params, bn, batches, device="cpu"):
    """The data-parallel VWW step (int8_ef) over every batch from the
    same state: the first step's state and metrics, every loss, the last
    state's params and EF error, and the stem kernels' launches."""
    torch.backends.cuda.matmul.allow_tf32 = False  # as the test's own
    torch.backends.cudnn.allow_tf32 = False  # process runs
    cfg = MNV2Config(**cfg_kw)
    opt = dp_optimizer()
    params, bn = tensors(params, device), tensors(bn, device)
    state = vww_train_state(params, bn, opt.init(params),
                            grad_compression="int8_ef")
    step = make_vww_train_step(cfg, opt, grad_compression="int8_ef")
    plan = vision_plan_for(make_debug_mesh(device=device))
    out = {"losses": []}
    with use_plan(plan):
        _, b_sh = vww_train_shardings(state, batches[0], plan)
        for i, batch in enumerate(batches):
            local = local_tree(batch, b_sh)
            state, metrics = step(state, local)
            out["losses"].append(float(metrics["loss"]))
            if i == 0:
                out["first"] = {"params": arrays(state["params"]),
                                "bn": arrays(state["bn"]),
                                "loss": float(metrics["loss"]),
                                "acc": float(metrics["acc"]),
                                "local_batch": len(local["labels"])}
    out["step"] = state["step"]
    out["last"] = {"params": arrays(state["params"]),
                   "ef": arrays(state["extras"]["ef_error"])}
    out["launches"] = stem_kernel_launches()
    return out


def _done(requests):
    return [(r.uid, r.probs, r.label) for r in requests]


def engines(rank, world, params, bn, det, images, streams):
    """The sharded vision and stream engines, the gated refusal, a pool
    over two submeshes, fault containment, ``sharding_fn`` and the
    wrong-size mesh, on one world."""
    mesh = make_debug_mesh(device="cpu")
    params, bn, det = tensors(params), tensors(bn), tensors(det)
    kw = dict(device="cpu")
    res = {}

    eng = VisionEngine(params, bn, ENGINE_CFG, max_batch=8, mesh=mesh, **kw)
    for i in range(8):
        eng.submit(VisionRequest(uid=i, image=images[i]))
    res["vision"] = _done(eng.step())
    res["vision_rows"] = eng._shards.rows.tolist()
    odd = VisionEngine(params, bn, ENGINE_CFG, max_batch=3, mesh=mesh, **kw)
    for i in range(3):
        odd.submit(VisionRequest(uid=i, image=images[i]))
    res["vision_odd"] = _done(odd.step())
    res["vision_odd_rows"] = odd._shards.rows.tolist()

    seng = StreamEngine(params, bn, ENGINE_CFG, det, det_cfg=DCFG,
                        max_streams=8, mesh=mesh, **kw)
    done = seng.run([StreamRequest(uid=i, frames=f)
                     for i, f in enumerate(streams)])
    res["stream"] = [(r.uid, r.skip_count, r.frame_outputs) for r in done]
    res["stream_path"] = seng.stem_path
    res["stream_rows"] = seng._shards.rows.tolist()
    res["stream_cache_shape"] = tuple(seng._cached_stem.shape)
    try:
        StreamEngine(params, bn, ENGINE_CFG, det, det_cfg=DCFG,
                     max_streams=8, mesh=mesh, stem_path="gated", **kw)
    except ValueError as exc:
        res["gated_refusal"] = str(exc)

    subs = make_submeshes(2, device="cpu")
    pool = ReplicaPool(
        VisionEngine(params, bn, ENGINE_CFG, max_batch=4, mesh=subs[0], **kw),
        VisionEngine(params, bn, ENGINE_CFG, max_batch=4, mesh=subs[1], **kw))
    res["pool"] = _done(pool.run([VisionRequest(uid=i, image=images[i])
                                  for i in range(8)]))
    res["pool_completed"] = [len(r.completed) for r in pool.replicas]
    res["submesh_sizes"] = [int(m.size()) for m in subs]

    feng = VisionEngine(params, bn, ENGINE_CFG, max_batch=8, mesh=mesh,
                        launch_retries=0, faults=FaultInjector(FAULT_PLAN),
                        **kw)
    done = feng.run([VisionRequest(uid=i, image=images[i],
                                   arrival_tick=i // 4) for i in range(8)])
    res["faults"] = {"done": _done(done),
                     "failed": [(r.uid, r.failure) for r in feng.failed],
                     "launch_faults": feng.stats["launch_faults"]}

    plan = vision_plan_for(mesh)
    pipe = DataPipeline(
        SyntheticVWW(image_size=20, batch=8, seed=0), prefetch=0,
        sharding_fn=lambda k, v: batch_shardings({k: v}, plan)[k])
    res["pipeline"] = [next(pipe) for _ in range(2)]
    pipe.close()

    try:
        make_debug_mesh(2 * world, device="cpu")
    except ValueError as exc:
        res["wrong_size"] = str(exc)

    prod = make_production_mesh(model=2, device="cpu")
    pods = make_production_mesh(model=1, multi_pod=True, device="cpu")
    res["production"] = [(m.mesh_dim_names, tuple(m.shape))
                         for m in (prod, pods)]

    x = distribute_tensor(torch.arange(8.0 * 3).reshape(8, 3), mesh,
                          [Replicate(), Replicate()])
    with use_plan(plan):
        y = shard(x, "batch", None)
    res["dtensor"] = {"placements": repr(tuple(y.placements)),
                      "local": y.to_local().numpy().copy(),
                      "full": y.full_tensor().numpy().copy()}
    return res


def fails_on_rank_1(rank, world):
    """Rank 1 raises; rank 0 then waits in a collective for it."""
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    torch.distributed.barrier()


def scenarios(rank, world, dp_args, engine_args):
    """`dp_steps` and `engines` on one world (one spawn for both)."""
    return {"dp": dp_steps(rank, world, *dp_args),
            "engines": engines(rank, world, *engine_args)}
