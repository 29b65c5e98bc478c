"""LM serving: batched decode with continuous batching; port of
`repro.serving.engine`.

``ServeEngine`` is a thin adapter over the shared scheduler core
(`serving/scheduler.py`): the core owns the arrival queue, the slot
table, the tick loop and the latency ledger; this module owns the decode
state and the step.  An LM slot lives many ticks — prefill then decode —
and finished or inactive slots keep stepping on a pad token (their
logits are ignored), so every step has the slot table's shape.

Prefill is token by token through the decode step by default.
``prefill_chunk=C`` enables the chunked path: one step advances every
prefilling slot by up to C prompt tokens a tick, through the family's
fused ``prefill`` hook where it has one (rwkv: one chunked-WKV forward
over the whole chunk, the CUDA kernel B7 on the card), else through the
masked decode scan (the KV-cache families: dense).

Steps are cached per config (``_decode_step_for`` / ``_chunk_step_for``,
metered by `obs.metrics.counted_lru_cache`).  PyTorch runs eagerly, so
the cache holds the step closures, not compilations.  The decode state
lives on the engine's device and is updated in place when a slot is
recycled (`_reset_slot`).

Scale-out (``mesh=``, as the reference's ``_slot_shardings``/``_jit_step``):
the slot table (axis 1 of every decode-state leaf, per
`validate_slot_layout`) is split over the mesh's batch axes (``"data"``),
and ``max_batch`` must divide over them.  Every rank of the world runs
the scheduler on the same requests; each holds and computes only its
slots' rows of the state (`parallel.collectives.SlotShards`), on the
whole params (replicated: the model axis is left unused, as the
reference's ``_jit_step`` leaves it), and the sampled tokens are
all-gathered, so every rank absorbs the same tokens.  A recycled slot is
zeroed on the rank that owns it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.families import get_family, validate_slot_layout
from repro_torch.obs.metrics import counted_lru_cache
from repro_torch.parallel.axes import current_plan
from repro_torch.parallel.collectives import SlotShards, batch_axes, group_size
from repro_torch.parallel.plans import vision_plan_for
from repro_torch.serving.scheduler import ScheduledRequest, SlotEngine
from repro_torch.serving.vision import _tree_to
from repro_torch.tree import tree_leaves, tree_map

#: Status ``submit`` returns for a request with a prompt token outside
#: the embedding table: it fails at the door, alone (see `submit`).
FAILED_TOKEN = "failed-token-out-of-range"


@dataclasses.dataclass
class Request(ScheduledRequest):
    uid: int
    prompt: list[int]
    max_new_tokens: int
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


@counted_lru_cache("decode_step")
def _decode_step_for(cfg: ModelConfig):
    """One-token decode step ``(params, state, tokens (B,1), pos) →
    (last_logits (B,V), state)``, one per config."""
    family = get_family(cfg)

    @torch.no_grad()
    def run(params, state, tokens, pos):
        logits, state = family.decode(params, state, tokens, pos, cfg)
        return logits[:, -1], state

    return run


@counted_lru_cache("chunk_step")
def _chunk_step_for(cfg: ModelConfig, chunk: int):
    """Chunked-prefill step ``(params, state, tokens (B,C), pos, n_active)
    → (last_logits, state)``: advance slot ``i`` by ``n_active[i] ∈ [0,
    C]`` tokens.  Two implementations behind one signature:

    * **Family prefill hook** (rwkv): one masked-prefix chunked forward
      over all C positions (`models/rwkv6.py::prefill_step`, the kernel
      B7 on the card).  Positionless families only.
    * **Masked decode scan** (KV-cache families): a loop over the
      one-token decode step in which slot i takes part at index ``j``
      iff ``j < n_active[i]``; a ``where`` select on axis 1 keeps a
      masked slot's state bit for bit, and its position does not
      advance, so the tokens are those of C separate decode steps.  The
      loop stops after ``max(n_active)`` steps: the reference's later
      steps mask every slot and change nothing.

    ``last_logits[i]`` is slot i's logits row at its final active step
    (step 0's for a slot at 0).  Batch sits at axis 1 of every state
    leaf, validated against the family's declared layout
    (`validate_slot_layout`)."""
    family = get_family(cfg)
    validate_slot_layout(cfg)

    if family.prefill is not None:
        @torch.no_grad()
        def run(params, state, tokens, pos, n_active):
            del pos  # prefill hook ⇒ positionless state
            return family.prefill(params, state, tokens, n_active, cfg)

        return run

    @torch.no_grad()
    def scan(params, state, tokens, pos, n_active):
        last_idx = torch.clamp(n_active - 1, 0, tokens.shape[1] - 1)
        last = None
        for j in range(max(int(n_active.max()), 1)):
            active = j < n_active  # (B,)
            logits, new_state = family.decode(params, state,
                                              tokens[:, j:j + 1], pos, cfg)

            def keep(new, old):  # batch axis 1, see validate_slot_layout
                m = active.reshape((1, -1) + (1,) * (new.ndim - 2))
                return torch.where(m, new, old)

            state = tree_map(keep, new_state, state)
            pos = torch.where(active, pos + 1, pos)
            row = logits[:, -1]
            last = row if last is None else torch.where(
                (last_idx == j)[:, None], row, last)
        return last, state

    return scan


def _device_of(params) -> torch.device:
    return tree_leaves(params)[0].device


def greedy_generate(params, cfg: ModelConfig, prompts, steps: int,
                    max_len: int | None = None, eos_id: int | None = None,
                    prefill_chunk: int | None = None) -> torch.Tensor:
    """Simple batched greedy decode (no slot management), on the device
    the params lie on.

    prompts: (B, P) ints.  Returns (B, steps) generated tokens.

    Prefill routes through the shared chunked step: ``prefill_chunk=None``
    (default) eats the whole prompt in one step; an explicit C prefills C
    tokens a step; ``prefill_chunk=1`` runs the token-by-token loop.

    Under a plan ``params`` are this rank's parts, and `_sharded_greedy`
    runs (prefill token by token).
    """
    family = get_family(cfg)
    dev = _device_of(params)
    prompts_np = np.asarray(torch.as_tensor(prompts).cpu(), np.int64)
    b, p = prompts_np.shape
    max_len = max_len or (p + steps)
    plan = current_plan()
    if plan is not None:
        return _sharded_greedy(params, cfg, prompts_np, steps, max_len, plan)
    state, _ = family.init_decode_state(cfg, b, max_len, device=dev)
    step_fn = _decode_step_for(cfg)

    def on_dev(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(dev)

    c = p if prefill_chunk is None else min(prefill_chunk, p)
    last = None
    if c > 1:
        chunk_fn = _chunk_step_for(cfg, c)
        for off in range(0, p, c):
            n = min(c, p - off)
            block = np.zeros((b, c), np.int64)
            block[:, :n] = prompts_np[:, off:off + n]
            last, state = chunk_fn(params, state, on_dev(block),
                                   on_dev(np.full(b, off)),
                                   on_dev(np.full(b, n)))
    else:
        for t in range(p):
            last, state = step_fn(params, state,
                                  on_dev(prompts_np[:, t:t + 1]),
                                  on_dev(np.full(b, t)))
    out = []
    tok = torch.argmax(last, dim=-1)[:, None]
    for i in range(steps):
        out.append(tok[:, 0])
        last, state = step_fn(params, state, tok, on_dev(np.full(b, p + i)))
        tok = torch.argmax(last, dim=-1)[:, None]
    return torch.stack(out, dim=1)


@torch.no_grad()
def _sharded_greedy(params, cfg: ModelConfig, prompts_np, steps: int,
                    max_len: int, plan) -> torch.Tensor:
    """`greedy_generate` under a plan: the decode state made whole and cut
    to this rank's part (`shardings_for` over the family's state axes:
    its rows of the batch, its slice of the KV cache's sequence under
    ``cache_seq_shard``, its WKV heads), the prompt fed token by token
    through the family's sharded decode (split-KV for the KV-cache
    families), the argmax taken across the vocab shards, and each rank's
    rows gathered: every rank returns the whole (B, steps)."""
    from repro_torch.models.layers import vocab_range
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel.axes import NamedSharding, logical_spec
    from repro_torch.parallel.sharding_utils import (
        local_tree,
        param_shardings,
        shardings_for,
    )

    family = get_family(cfg)
    dev = _device_of(params)
    b, p = prompts_np.shape
    state, axes = family.init_decode_state(cfg, b, max_len, device=dev)
    state_sh = shardings_for(state, axes, plan)
    state = local_tree(state, state_sh)
    by_row = NamedSharding(plan.mesh, logical_spec((b,), ("cache_batch",),
                                                   plan))
    rows = by_row.local(np.arange(b))
    row_groups = col.axis_groups(plan.mesh, col.leaf_axes(by_row)[0])
    kw = ({"cache_shardings": state_sh} if cfg.family in ("dense", "moe")
          else {})
    start, vgroups = vocab_range(cfg, param_shardings(cfg, plan)["embed"])

    def step(tokens, at):
        pos = torch.full((len(rows),), at, dtype=torch.int64, device=dev)
        logits, new = family.decode(params, state, tokens, pos, cfg, **kw)
        return logits[:, -1], new

    prompts = torch.from_numpy(prompts_np[rows]).to(dev)
    for t in range(p):
        last, state = step(prompts[:, t:t + 1], t)
    out = []
    for i in range(steps):
        tok = col.vocab_parallel_argmax(last, start, vgroups) if vgroups \
            else torch.argmax(last, dim=-1)
        out.append(tok)
        last, state = step(tok[:, None], p + i)
    return col.all_gather_batch(torch.stack(out, dim=1), row_groups)


class ServeEngine(SlotEngine):
    """Continuous-batching LM engine: scheduler core + decode adapter.

    The queue is unbounded by default (every accepted prompt is served);
    pass ``max_queue`` to bound it — overflow then sheds per ``evict``
    ("drop-newest" by default: an arriving request is rejected at the
    door rather than breaking a promise already queued).
    """

    request_type = Request

    def __init__(self, params, cfg: ModelConfig, *, max_batch: int = 8,
                 max_len: int = 2048, eos_id: int | None = None,
                 pad_id: int = 0, prefill_chunk: int = 1,
                 max_queue: int | None = None,
                 evict: str = "drop-newest", mesh=None, device=None,
                 **core):
        """``params``: the port's tree (`init_rwkv`, `init_lm`, or a
        reference tree through `compat.tree_from_reference`), moved to
        the device.
        ``mesh``: a mesh (`launch.mesh`) to split the slots over its
        ``data`` axis; ``max_batch`` must divide over it, and every rank
        of the world must drive the engine alike.
        ``device``: None ⇒ the GPU (raises when there is none).
        ``core`` forwards the scheduler's fault-tolerance and cadence
        knobs to `SlotEngine`."""
        self.device = resolve_device(device)
        super().__init__(max_batch, max_queue=max_queue, evict=evict, **core)
        validate_slot_layout(cfg)  # slot ops assume batch at state axis 1
        self.cfg = cfg
        self.params = _tree_to(params, self.device)
        self.family = get_family(cfg)
        self.max_len = max_len
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.prefill_chunk = prefill_chunk
        self.mesh = mesh
        self._shards = None
        rows = max_batch
        if mesh is not None:
            n = group_size(mesh.get_group(a)
                           for a in batch_axes(vision_plan_for(mesh)))
            if max_batch % n:
                raise ValueError(f"max_batch={max_batch} must divide over "
                                 f"the data axis ({n})")
            self._shards = SlotShards(mesh, max_batch)
            rows = len(self._shards.rows)
        self.state, _ = self.family.init_decode_state(
            cfg, rows, max_len, device=self.device)
        self._step = _decode_step_for(cfg)
        self._chunk_step = (_chunk_step_for(cfg, prefill_chunk)
                            if prefill_chunk > 1 else None)
        self._slot_pos = np.zeros(max_batch, np.int64)
        self._slot_cursor = np.zeros(max_batch, np.int64)  # prompt cursor

    def submit(self, req) -> str:
        """Enqueue as `SlotEngine.submit` does, after checking every
        prompt token against the embedding table's rows.

        A token ≥ ``cfg.padded_vocab`` or < −``cfg.padded_vocab`` fails
        the request here, onto the ``failed`` ledger with failure
        ``"token"``, and ``submit`` returns `FAILED_TOKEN`.  The index
        never reaches the device: torch indexing raises on the CPU, which
        would fail every request of the tick, and asserts on CUDA, which
        leaves the context unusable.  (The reference's ``jnp.take`` fills
        the row with NaN; here the request fails instead.)  Negative
        tokens wrap to the table's last rows, as in both frameworks."""
        v = self.cfg.padded_vocab
        for prompt in self._prompts(req):
            if any(not -v <= int(t) < v for t in prompt):
                req.submitted_tick = self.tick
                self._fail(None, req, "token")
                return FAILED_TOKEN
        return super().submit(req)

    # ------------------------------------------------- adapter hooks

    def _reset_slot(self, i: int) -> None:
        """Zero slot i's state (batch axis = 1 across all state leaves), in
        place, so a recycled slot never sees the previous request's
        recurrent state; under a mesh on the rank that holds its row."""
        if self._shards is not None:
            (at,) = np.nonzero(self._shards.rows == i)
            if not len(at):
                return
            i = int(at[0])
        for leaf in tree_leaves(self.state):
            leaf[:, i] = 0

    def _on_admit(self, i: int, req: Request) -> None:
        self._reset_slot(i)
        self._slot_pos[i] = 0
        self._slot_cursor[i] = 0

    # Per-request accessors the stateful session engine overrides
    # (`serving/sessions.py`): which token list is being prefilled and
    # which one generation appends to.
    def _prompt(self, req) -> list[int]:
        return req.prompt

    def _prompts(self, req) -> list[list[int]]:
        """Every prompt the request will feed the model."""
        return [req.prompt]

    def _gen(self, req) -> list[int]:
        return req.output

    def _launch(self, active):
        """One decode (or chunked-prefill) step over the slot table.

        Returns ``(nxt, adv)``: per-slot sampled next token and how many
        tokens each slot advanced this tick.
        """
        b = self.n_slots
        c = self.prefill_chunk if self._chunk_step is not None else 1
        tokens = np.full((b, c), self.pad_id, np.int64)
        pos = np.zeros(b, np.int64)
        adv = np.zeros(b, np.int64)
        for i, req in active:
            cur = int(self._slot_cursor[i])
            prompt = self._prompt(req)
            remaining = len(prompt) - cur
            if remaining > 0:  # prefilling: up to C prompt tokens
                n = min(c, remaining)
                tokens[i, :n] = prompt[cur:cur + n]
            else:  # generating: one token per tick, feed last output
                n = 1
                out = self._gen(req)
                if out:
                    tokens[i, 0] = out[-1]
            pos[i] = self._slot_pos[i]
            adv[i] = n

        rows = slice(None) if self._shards is None else self._shards.rows
        on_dev = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a[rows])).to(self.device)
        if self._chunk_step is not None and int(adv.max()) > 1:
            last, self.state = self._chunk_step(
                self.params, self.state, on_dev(tokens), on_dev(pos),
                on_dev(adv))
        else:
            # Pure-decode tick (every slot advancing ≤1 token): the plain
            # one-token step.
            last, self.state = self._step(self.params, self.state,
                                          on_dev(tokens[:, :1]), on_dev(pos))
        nxt = torch.argmax(last, dim=-1)
        if self._shards is not None:
            nxt = self._shards.gather(nxt, (b,), nxt.dtype, self.device)
        return nxt.cpu().numpy(), adv

    def _validate(self, i: int, req: Request, result) -> bool:
        """A sampled token is a non-negative vocab index; a corrupted slot
        row fails its own request, never the engine."""
        nxt, adv = result
        return int(nxt[i]) >= 0 and int(adv[i]) >= 0

    def _absorb(self, i: int, req: Request, result) -> bool:
        nxt, adv = result
        n = int(adv[i])
        self._slot_pos[i] += n
        cur = int(self._slot_cursor[i])
        prompt = self._prompt(req)
        if cur < len(prompt):
            self._slot_cursor[i] = cur + n
            if cur + n < len(prompt):
                return False  # prompt not consumed yet; nothing to emit
        tok = int(nxt[i])
        self._gen(req).append(tok)
        if (self.eos_id is not None and tok == self.eos_id) or \
                len(req.output) >= req.max_new_tokens or \
                self._slot_pos[i] >= self.max_len - 1:
            req.done = True
            return True
        return False
