"""Rule tables: how logical axes map onto the mesh; port of
`repro.parallel.plans` (the tables as they are).

The baseline plan is TP over "model" and DP over ("pod", "data"); large
archs add FSDP ("embed" → "data"); long-context shapes add SP (sequence
over "data") and decode shapes shard the KV cache sequence over "model".
The vision plan is pure data parallelism.
"""
from __future__ import annotations

from typing import Any

from repro_torch.parallel.axes import ShardingPlan

# Baseline logical rules (training, moderate model size).
BASE_RULES: dict[str, Any] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "embed_act": None,
    "heads_act": "model",
    "mlp_act": "model",
    "vocab_act": "model",
    # params
    "embed": None,          # switched to "data" under FSDP
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "layers": None,
    "conv": None,
    # decode caches / recurrent state
    "cache_batch": ("pod", "data"),
    "cache_seq": None,
    "cache_heads": "model",
    "state": "model",
}


# Vision rules (VWW MobileNetV2 ± P²M stem, DESIGN.md §7): pure data
# parallelism.  The conv stacks are small (a few MB at width 1.0), so
# params, optimizer and BN state replicate whole; only the image batch
# dimension is split.  "model"-axis rules are absent: on a (data, model)
# mesh the vision plan leaves the model axis unused.
VISION_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "conv": None,
}


def vision_plan_for(mesh, *,
                    overrides: dict[str, Any] | None = None) -> ShardingPlan:
    """Data-parallel plan for the VWW/vision stack (see VISION_RULES)."""
    rules = dict(VISION_RULES)
    if overrides:
        rules.update(overrides)
    return ShardingPlan(mesh=mesh, rules=rules)


def plan_for(
    mesh,
    *,
    fsdp: bool = False,
    seq_shard: bool = False,
    cache_seq_shard: bool = False,
    cache_seq_axes: Any = "model",
    overrides: dict[str, Any] | None = None,
) -> ShardingPlan:
    """The sharding plan for an (arch × shape) cell.

    fsdp: shard the params' "embed" dimension over "data" (ZeRO-3).
    seq_shard: sequence parallelism for activations (long prefill).
    cache_seq_shard: shard the decode KV cache over ``cache_seq_axes``
      (split-KV decode; ("data", "model") when the batch is 1).
    """
    rules = dict(BASE_RULES)
    if fsdp:
        rules["embed"] = "data"
    if seq_shard:
        rules["seq"] = "data"
        rules["batch"] = "pod"
    if cache_seq_shard:
        rules["cache_seq"] = cache_seq_axes
    if overrides:
        rules.update(overrides)
    # optimizer-state axes mirror the param axes unless overridden
    # (ZeRO-1: optimizer sharded more than params)
    rules.setdefault("opt_embed", rules.get("embed"))
    rules.setdefault("opt_mlp", rules.get("mlp"))
    return ShardingPlan(mesh=mesh, rules=rules)
