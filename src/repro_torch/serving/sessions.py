"""Stateful streaming-LM sessions: long-lived conversations in slots;
port of `repro.serving.sessions` (imports rewritten, no mesh).

The LM twin of a video stream (DESIGN.md §9 → §12.4): a
``SessionRequest`` carries a *sequence of turns* and occupies its slot
for the whole conversation — the recurrent (token-shift, WKV) state
stays device-resident in the slot's batch row across every tick of
every turn, so turn t+1 continues from the state turn t left behind
instead of re-prefilling the conversation history.  This is only sound
for positionless O(1)-state recurrent families (rwkv): a KV-cache
family would need per-session position tracking and an O(history)
cache; the constructor rejects anything without a family ``prefill``
hook.

Scheduling semantics come free from the `SlotEngine` core: sessions
queue, admit, evict, deadline-shed, watchdog-recycle and quarantine
exactly like any other request (DESIGN.md §10–§11), and declare their
``request_type`` for a front door to route by.  Slot recycling inherits
`ServeEngine._reset_slot`'s zero-fill, so a recycled slot never sees a
previous conversation's state (pinned by the leak property test in
`tests/test_torch_lm_serving.py`).

Per-turn flow: turn t's prompt prefills through the shared chunked step
(the chunked-WKV path, the CUDA kernel B7 on the card), generation appends to ``outputs[t]`` one token
per tick until ``eos`` / ``max_new_tokens``, then the next turn's
prompt starts prefilling *without touching the state*.  The final
generated token of a turn is recorded but never fed back — the next
thing the model sees is the next user turn (a user interrupting with a
new message), matching the front-door event model.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig
from repro_torch.models.families import get_family
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.scheduler import ScheduledRequest


@dataclasses.dataclass
class SessionRequest(ScheduledRequest):
    """One conversation: ``turns[t]`` is turn t's prompt tokens;
    generation for turn t lands in ``outputs[t]``."""
    uid: int
    turns: list[list[int]]
    max_new_tokens: int = 16
    outputs: list[list[int]] = dataclasses.field(default_factory=list)
    turn: int = 0
    done: bool = False


class SessionEngine(ServeEngine):
    """Multi-turn streaming-LM engine over the `ServeEngine` adapter.

    Accepts every `ServeEngine` knob (``device``; ``prefill_chunk``
    routes turn prompts through the fused chunked-WKV prefill; ``core``
    kwargs reach the scheduler's fault-tolerance layer)."""

    request_type = SessionRequest

    def __init__(self, params, cfg: ModelConfig, **kw):
        if get_family(cfg).prefill is None:
            raise ValueError(
                f"stateful sessions need a positionless recurrent family "
                f"with a fused prefill hook (rwkv); {cfg.family!r} decodes "
                f"against a positional KV cache whose per-session history "
                f"a recycled slot cannot carry")
        super().__init__(params, cfg, **kw)

    # ------------------------------------------------- adapter hooks

    def _prompt(self, req: SessionRequest) -> list[int]:
        return req.turns[req.turn]

    def _gen(self, req: SessionRequest) -> list[int]:
        return req.outputs[req.turn]

    def _on_admit(self, i: int, req: SessionRequest) -> None:
        super()._on_admit(i, req)  # zero state + cursors: fresh session
        req.turn = 0
        req.outputs = [[]]

    def _absorb(self, i: int, req: SessionRequest, result) -> bool:
        nxt, adv = result
        n = int(adv[i])
        self._slot_pos[i] += n
        cur = int(self._slot_cursor[i])
        prompt = self._prompt(req)
        if cur < len(prompt):
            self._slot_cursor[i] = cur + n
            if cur + n < len(prompt):
                return False  # still prefilling this turn's prompt
        tok = int(nxt[i])
        out = self._gen(req)
        out.append(tok)
        if self._slot_pos[i] >= self.max_len - 1:
            req.done = True  # hard length stop ends the whole session
            return True
        if not ((self.eos_id is not None and tok == self.eos_id)
                or len(out) >= req.max_new_tokens):
            return False  # keep generating this turn
        if req.turn + 1 >= len(req.turns):
            req.done = True
            return True  # conversation over — slot recyclable
        # Next turn: new prompt cursor, SAME recurrent state — the whole
        # point of the session slot.
        req.turn += 1
        req.outputs.append([])
        self._slot_cursor[i] = 0
        if self.tracer is not None:
            self.tracer.tick_instant(self, "session_turn", self.tick, 0,
                                     uid=req.uid, turn=req.turn, slot=i)
        return False
