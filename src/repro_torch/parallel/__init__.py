"""Distribution layer: mesh axes, logical-axis sharding rules, helpers;
port of `repro.parallel`.

Mesh axes: ``("data", "model")``, and ``("pod", "data", "model")``
across pods.  Models annotate activations and params with *logical* axis
names (``batch``, ``seq``, ``embed``, ``heads``, ``mlp``, ``vocab``,
``expert``, ``cache_seq``, …); a per-run :class:`ShardingPlan` maps them
to mesh axes, so DP/TP/FSDP/EP/SP are rule sets, not model rewrites.

How the reference's JAX sharding maps onto PyTorch here:

=====================================  ======================================
reference                              port
=====================================  ======================================
``jax.sharding.Mesh``                  ``torch.distributed.device_mesh.
(``("data", "model")``,                DeviceMesh`` with the same
``("pod", "data", "model")``)          ``mesh_dim_names``, over an
                                       initialised process group, one
                                       process a rank (`launch.mesh`,
                                       `launch.world.spawn_world`)
``PartitionSpec``                      `P`: a tuple of per-dimension axis
                                       names, equal to the reference's
                                       spec of the same entries
``NamedSharding(mesh, spec)``          `NamedSharding` ``(mesh, spec)``;
                                       ``.placements`` gives
                                       ``Shard(d)`` / ``Replicate()`` a
                                       mesh dimension
``jax.device_put(x, sharding)``        each rank takes its local slice
                                       (``NamedSharding.local``, a narrow
                                       by the rank's mesh coordinate;
                                       `sharding_utils.local_tree`)
``jax.jit(step, in_shardings=…)``      every rank runs the step on its
                                       local shards, as in ``shard_map``
the global reductions SPMD inserts     explicit collectives on the batch
                                       axes' groups (`collectives`),
                                       differentiable where a gradient
                                       flows through them
``shard(x, *logical_axes)``            a no-op outside a plan; under one it
                                       leaves a local tensor as it is and
                                       redistributes a ``DTensor`` whose
                                       placements differ from the plan's
TP: ``heads``/``kv_heads``/``mlp``/    Megatron-LM's pairs on the model
``vocab`` → ``"model"``, SPMD's        axis's group: *f* (`collectives.
all-reduces around the split products  copy_to_model`) where a replicated
                                       tensor enters a split product, *g*
                                       (`reduce_from_model`) where partial
                                       sums leave; vocab-parallel
                                       embedding, logits, cross-entropy and
                                       argmax (`models/layers.py`,
                                       `models/families.py`)
EP: ``expert`` → ``"model"``,          the local-experts body
``apply_moe_shard_map``'s ``psum``     (`models/moe.py`): positions from
                                       the global cumsum, one `reduce_from_
                                       model` of the token-granular sum
FSDP: ``embed`` → ``"data"``, SPMD's   `collectives.gather_fsdp` a layer
all-gathers on use and their           at a time (`gather_for_use`: its
reduce-scatter transposes              backward reduce-scatters); the
                                       train step sums each gradient over
                                       the batch axes its leaf is *not*
                                       sharded over (`train/step.py`)
split-KV: ``cache_seq`` → ``"model"``  each rank attends over its slice of
(``cache_seq_shard``), SPMD's          the cache (`models/attention.
reductions of the softmax              partial_attention`), the parts
                                       joined by `collectives.
                                       split_kv_combine`
=====================================  ======================================

The vision path (the paper's workload, DESIGN.md §7) is pure data
parallelism over `VISION_RULES`: the data-parallel VWW step
(`train.vision`), the sharded `VisionEngine` and `StreamEngine`, and
replica pools over `launch.mesh.make_submeshes`.  The LM path runs
under `plan_for`: every family trains tensor- and fully-sharded (the MoE
family expert-parallel too; `train/step.py`, `launch/train.py --world
--model-parallel`), heads the model axis does not divide run whole on
every rank from gathered columns (`models/layers.py::_tp_qkv`,
`models/rwkv6.py::_time_mix`), decode runs split-KV under
``cache_seq_shard`` or on a rank's KV heads, checkpoints save the global
tree and restore by the current plan (`checkpoint.manager`), and the
`ServeEngine`/`SessionEngine` split their slots over ``"data"``
(``mesh=``).  `launch/dryrun.py` runs every cell's step as one rank of a
fake world on ``meta`` tensors.
"""
from repro_torch.parallel.axes import (
    P,
    NamedSharding,
    ShardingPlan,
    current_plan,
    logical_sharding,
    logical_spec,
    sanitize_spec,
    shard,
    use_plan,
)
from repro_torch.parallel.plans import (
    BASE_RULES,
    VISION_RULES,
    plan_for,
    vision_plan_for,
)

__all__ = [
    "P",
    "NamedSharding",
    "ShardingPlan",
    "current_plan",
    "logical_spec",
    "logical_sharding",
    "shard",
    "use_plan",
    "sanitize_spec",
    "BASE_RULES",
    "VISION_RULES",
    "plan_for",
    "vision_plan_for",
]
