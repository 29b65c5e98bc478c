"""Counts of one rank's step on ``meta`` tensors; the port's counterpart of
`repro.launch.hlo_analysis`, which reads the same numbers from XLA's
optimized, SPMD-partitioned HLO.

`count_step(fn, *args)` runs ``fn`` (a cell's step, `launch/specs.py`,
on one rank's ``meta`` parts under a process group, the fake one of
`launch/dryrun.py` included) once under a dispatch mode and returns:

* ``flops``: every aten op's FLOPs by `torch.utils.flop_counter`'s
  formulas, loop-aware as `hlo_analysis` is (ops inside `repeat(n)`
  count n times), plus B7's work by one analytic formula (`wkv_flops`,
  PERF.md §6's bound) where the model runs the WKV;
  ``flops_bodyonce``: `FlopCounterMode`'s own total of the ops the step
  issued (each op once, the WKV's forward not among them), as the
  reference keeps ``xla_cost_flops_bodyonce``;
* ``collectives``: operand bytes and counts by the reference's names
  (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute`` for broadcasts and point-to-point), from the
  ``c10d`` ops `parallel/collectives.py` issues, operand-side as
  `hlo_analysis` counts them (the port's reduce-scatter is an all-reduce
  and a narrow, so it counts as an all-reduce);
* ``temp_bytes``: the peak of live ``meta`` bytes the step allocates
  (storages made inside the step, freed when their last tensor goes),
  the counterpart of ``memory_analysis().temp_size_in_bytes``.

`argument_bytes` gives a rank's argument bytes from the plan's shard
shapes (`NamedSharding.shard_shape`), the counterpart of
``argument_size_in_bytes``.

Two loops of the models would take minutes on ``meta`` at full length,
one (q, kv) block of flash attention and one chunk of the WKV's plain
twin at a time.  Within `count_step` a ``meta`` flash attention runs one
block's forward and backward under `repeat` (its block count), through
an autograd Function that keeps the graph; the WKV's forward is counted
by its formula and not run.  Nothing here runs on the card.
"""
from __future__ import annotations

import contextlib
import math
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.models import attention
from repro_torch.kernels.rwkv_wkv import ops as wkv_ops
from repro_torch.kernels.rwkv_wkv.ops import WKV_CHUNK

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d op → (the reference's collective, index of its operand argument)
_C10D = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "allgather_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "alltoall_": ("all-to-all", 1),
    "alltoall_base_": ("all-to-all", 1),
    "broadcast_": ("collective-permute", 0),
    "send": ("collective-permute", 0),
    "recv_": ("collective-permute", 0),
}

_STATE = threading.local()
_flash_loop = attention.flash_attention  # the loop `count_step` stands in for


def _multiplier() -> int:
    return getattr(_STATE, "mult", 1)


@contextlib.contextmanager
def repeat(n: int):
    """Ops run inside count ``n`` times: a loop whose ``n`` bodies have
    the same shapes, run once (XLA's ``known_trip_count``)."""
    prev = _multiplier()
    _STATE.mult = prev * n
    try:
        yield
    finally:
        _STATE.mult = prev


def wkv_flops(b: int, s: int, h: int, d: int, chunk: int = WKV_CHUNK) -> int:
    """B7's FLOPs at (B, S, H, D) (PERF.md §6): per chunk and head the
    inter-chunk ``q @ S0`` and the state's ``kᵀ v`` (2·C·D² each), the
    strictly causal scores and their product with v (C(C−1)·D each), the
    decay's scale of S (D²) and the bonus diagonal (3·C·D)."""
    n_chunks = -(-s // chunk)
    return b * h * n_chunks * (4 * chunk * d * d
                               + 2 * chunk * (chunk - 1) * d + d * d
                               + 3 * chunk * d)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for a in x for t in _tensors(a)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Census(TorchDispatchMode):
    """FLOPs (loop-aware), collectives and live ``meta`` bytes of the ops
    dispatched under it."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.wkv_flops = 0
        self.coll = {c: {"bytes": 0, "count": 0} for c in COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._storages: dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def _track(self, out) -> None:
        for t in _tensors(out):
            if t.device.type != "meta":
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        mult = _multiplier()
        if func.namespace == "c10d":
            name = func._schema.name.split("::")[-1]
            kind = _C10D.get(name)
            if kind is not None:
                what, at = kind
                n = sum(_nbytes(t) for t in _tensors(args[at]))
                self.coll[what]["bytes"] += mult * n
                self.coll[what]["count"] += mult
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += mult * int(flop_registry[packet](
                *args, **kwargs, out_val=out))
        self._track(out)
        return out


class _FlashOnMeta(torch.autograd.Function):
    """Flash attention on ``meta`` tensors: one (q, kv) block's forward,
    and in the backward its recompute and gradients, each under
    `repeat(n_blocks)`; the outputs are empty ``meta`` tensors of the
    right shapes, so the graph and every count stay as the full loop's."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, kw):
        ctx.save_for_backward(q, k, v, q_pos, kv_pos)
        ctx.kw = kw
        with repeat(_blocks(q, k, kw)):
            _flash_loop(*_block_args(q, k, v, q_pos, kv_pos, kw), **kw)
        return torch.empty_like(q)

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_pos, kv_pos = ctx.saved_tensors
        kw = ctx.kw
        with repeat(_blocks(q, k, kw)), torch.enable_grad():
            qb, kb, vb, qp, kp = _block_args(q, k, v, q_pos, kv_pos, kw)
            live = [t.detach().requires_grad_(True) for t in (qb, kb, vb)]
            out = _flash_loop(*live, qp, kp, **kw)
            torch.autograd.grad(out, live, torch.empty_like(out))
        return (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
                None, None, None)


def _chunks(q, k, kw) -> tuple[int, int]:
    qc = min(kw["q_chunk"], q.shape[1])
    kc = min(kw["kv_chunk"], k.shape[1])
    return qc, kc


def _blocks(q, k, kw) -> int:
    qc, kc = _chunks(q, k, kw)
    return -(-q.shape[1] // qc) * -(-k.shape[1] // kc)


def _block_args(q, k, v, q_pos, kv_pos, kw):
    qc, kc = _chunks(q, k, kw)
    return (q[:, :qc], k[:, :kc], v[:, :kc], q_pos[:, :qc], kv_pos[:, :kc])


def _flash_counted(q, k, v, q_pos, kv_pos, *, causal=True, window=None,
                   kv_len=None, scale=None, q_chunk=1024, kv_chunk=1024):
    kw = dict(causal=causal, window=window, kv_len=kv_len, scale=scale,
              q_chunk=q_chunk, kv_chunk=kv_chunk)
    if q.device.type != "meta" or _blocks(q, k, kw) == 1:
        return _flash_loop(q, k, v, q_pos, kv_pos, **kw)
    return _FlashOnMeta.apply(q, k, v, q_pos, kv_pos, kw)


def _wkv_counted(census: _Census):
    real = wkv_ops.wkv_fused

    def fused(r, k, v, lw, u, state, *, chunk: int = WKV_CHUNK):
        if r.device.type != "meta":
            return real(r, k, v, lw, u, state, chunk=chunk)
        census.flops += _multiplier() * wkv_flops(*r.shape, chunk=chunk)
        census.wkv_flops += _multiplier() * wkv_flops(*r.shape, chunk=chunk)
        return torch.empty_like(r), torch.empty_like(state)

    return fused


def count_step(fn, *args) -> dict:
    """Run ``fn(*args)`` once on ``meta`` tensors and return its counts
    (module docstring)."""
    census = _Census()
    saved = attention.flash_attention, wkv_ops.wkv_fused
    attention.flash_attention = _flash_counted
    wkv_ops.wkv_fused = _wkv_counted(census)
    try:
        with FlopCounterMode(display=False) as raw, census:
            fn(*args)
    finally:
        attention.flash_attention, wkv_ops.wkv_fused = saved
    coll = {k: dict(v) for k, v in census.coll.items()}
    coll["total_bytes"] = sum(v["bytes"] for v in census.coll.values())
    return {"flops": float(census.flops),
            "flops_bodyonce": float(raw.get_total_flops()),
            "wkv_flops": float(census.wkv_flops),
            "collectives": coll,
            "temp_bytes": int(census.peak)}


def argument_bytes(values, shardings) -> int:
    """A rank's bytes of ``values`` (tensors or ints, in dicts, tuples
    and lists) as ``shardings`` (the matching `NamedSharding` tree) place
    them: each tensor leaf's shard shape times its element size.  A host
    int (a train state's ``step``) is not an argument of the rank's
    step."""
    if isinstance(values, dict):
        return sum(argument_bytes(values[k], shardings[k]) for k in values)
    if isinstance(values, (tuple, list)):
        return sum(argument_bytes(v, s) for v, s in zip(values, shardings))
    if not isinstance(values, torch.Tensor):
        return 0
    return math.prod(shardings.shard_shape(tuple(values.shape))) \
        * values.element_size()
