"""Per-cell (arch × shape) abstract specs, sharding plans and step builders;
port of `repro.launch.specs`.

Everything here is allocation-free: parameters and optimizer state come
from the families' real init functions under `abstract_init` (``meta``
tensors), inputs are ``meta`` tensors, and decode caches use the
families' ``abstract=True`` path.  Each builder returns the step
function, the abstract values and their `NamedSharding` trees.  The step
function runs sharded under the cell's plan, as the reference's jit with
those shardings: called on a rank with its parts of the values
(`sharding_utils.local_tree` of the whole ones by the shardings), it
enters the plan itself, so the train step's gradients, the forward and
the decode (split-KV under ``cache_seq_shard``) are the sharded ones of
`train/step.py` and `models/` (the rglru, vlm and encdec families raise
under a plan with a model axis or FSDP: ROADMAP A12c).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.families import get_family
from repro_torch.models.init_utils import abstract_init
from repro_torch.optim import adamw, constant
from repro_torch.parallel import ShardingPlan, plan_for, use_plan
from repro_torch.parallel.sharding_utils import shardings_for
from repro_torch.train.state import state_logical_axes
from repro_torch.train.step import make_train_step

FSDP_THRESHOLD = 5e9  # params; above this, shard "embed" over "data"
WHISPER_DECODER_LEN = 448


def _abstract(shape: tuple[int, ...], dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


# ------------------------------------------------------------------ inputs


def input_specs(cfg: ModelConfig, spec: ShapeSpec) -> tuple[dict, dict]:
    """``meta`` stand-ins for every model input, and their logical axes."""
    b, s = spec.global_batch, spec.seq_len
    i32 = torch.int32
    act = cfg.dtype
    if spec.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            # seq applies to the (stub-embedded) audio frames; decoder
            # tokens are bounded by whisper's context.
            sd = min(s, WHISPER_DECODER_LEN)
            inputs = {
                "src_embeds": _abstract((b, s, cfg.d_model), act),
                "tokens": _abstract((b, sd), i32),
                "targets": _abstract((b, sd), i32),
            }
            axes = {
                "src_embeds": ("batch", "seq", "embed_act"),
                "tokens": ("batch", "seq"),
                "targets": ("batch", "seq"),
            }
        else:
            inputs = {
                "tokens": _abstract((b, s), i32),
                "targets": _abstract((b, s), i32),
            }
            axes = {
                "tokens": ("batch", "seq"),
                "targets": ("batch", "seq"),
            }
            if cfg.family == "vlm":
                inputs["image_embeds"] = _abstract(
                    (b, cfg.n_image_tokens, cfg.d_model), act)
                axes["image_embeds"] = ("batch", None, "embed_act")
        if spec.kind == "prefill":
            inputs.pop("targets")
            axes.pop("targets")
        return inputs, axes

    # decode: one new token against a seq_len-deep cache/state
    inputs = {"tokens": _abstract((b, 1), i32), "pos": _abstract((b,), i32)}
    axes = {"tokens": ("batch", None), "pos": ("batch",)}
    return inputs, axes


# ------------------------------------------------------------------ plans


def plan_for_cell(cfg: ModelConfig, spec: ShapeSpec, mesh,
                  overrides: dict | None = None) -> ShardingPlan:
    fsdp = cfg.param_count_estimate() > FSDP_THRESHOLD
    cache_seq_shard = spec.kind == "decode"
    cache_axes: Any = ("data", "model") if spec.global_batch == 1 else "model"
    return plan_for(
        mesh,
        fsdp=fsdp,
        cache_seq_shard=cache_seq_shard,
        cache_seq_axes=cache_axes,
        overrides=overrides,
    )


# ------------------------------------------------------------------ steps


def _under(plan: ShardingPlan, fn):
    """``fn`` run under ``plan``, on a rank's parts of its arguments."""
    def run(*args):
        with use_plan(plan):
            return fn(*args)
    return run


def _abstract_params(cfg: ModelConfig):
    with abstract_init():
        return get_family(cfg).init(torch.Generator(), cfg)


def build_train_cell(cfg: ModelConfig, spec: ShapeSpec, plan: ShardingPlan):
    """Abstract (state, batch) + shardings + step fn for a training cell."""
    optimizer = adamw(constant(1e-4))
    params, param_axes = _abstract_params(cfg)
    opt = optimizer.init(params)
    state = {"params": params, "opt": opt, "step": 0}
    state_axes = state_logical_axes(param_axes, opt)

    inputs, input_axes = input_specs(cfg, spec)
    step = _under(plan, make_train_step(cfg, optimizer))
    state_sh = shardings_for(state, state_axes, plan)
    input_sh = shardings_for(inputs, input_axes, plan)
    return step, (state, inputs), (state_sh, input_sh)


def build_prefill_cell(cfg: ModelConfig, spec: ShapeSpec, plan: ShardingPlan):
    """Forward-only (inference prefill) cell."""
    params, param_axes = _abstract_params(cfg)
    inputs, input_axes = input_specs(cfg, spec)

    from repro_torch.models import rglru, rwkv6, transformer, vlm, whisper

    if cfg.family in ("dense", "moe"):
        fwd = lambda p, b: transformer.forward(p, b["tokens"], cfg)[0]  # noqa: E731
    elif cfg.family == "rwkv":
        fwd = lambda p, b: rwkv6.forward(p, b["tokens"], cfg)[0]  # noqa: E731
    elif cfg.family == "rglru":
        fwd = lambda p, b: rglru.forward(p, b["tokens"], cfg)[0]  # noqa: E731
    elif cfg.family == "vlm":
        fwd = lambda p, b: vlm.forward(  # noqa: E731
            p, b["tokens"], b["image_embeds"], cfg)[0]
    else:
        fwd = lambda p, b: whisper.forward(  # noqa: E731
            p, b["src_embeds"], b["tokens"], cfg)[0]

    params_sh = shardings_for(params, param_axes, plan)
    input_sh = shardings_for(inputs, input_axes, plan)
    return _under(plan, fwd), (params, inputs), (params_sh, input_sh)


def build_decode_cell(cfg: ModelConfig, spec: ShapeSpec, plan: ShardingPlan):
    """serve_step: one token against a seq_len KV cache / recurrent state."""
    family = get_family(cfg)
    params, param_axes = _abstract_params(cfg)
    state, state_axes = family.init_decode_state(
        cfg, spec.global_batch, spec.seq_len, abstract=True)
    inputs, input_axes = input_specs(cfg, spec)

    state_sh = shardings_for(state, state_axes, plan)
    kw = ({"cache_shardings": state_sh} if cfg.family in ("dense", "moe")
          else {})

    def serve_step(params, state, tokens, pos):
        return family.decode(params, state, tokens, pos, cfg, **kw)

    shard_tuple = (
        shardings_for(params, param_axes, plan),
        state_sh,
        shardings_for(inputs["tokens"], input_axes["tokens"], plan),
        shardings_for(inputs["pos"], input_axes["pos"], plan),
    )
    abstract = (params, state, inputs["tokens"], inputs["pos"])
    return _under(plan, serve_step), abstract, shard_tuple
