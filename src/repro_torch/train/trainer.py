"""Trainer loop: metrics, checkpointing, straggler monitoring, restart;
port of `repro.train.trainer`.

* checkpoints are written asynchronously every ``ckpt_every`` steps and
  at exit; the data-pipeline cursor is stored inside the checkpoint, so
  ``Trainer.restore()`` resumes bit-exact;
* the straggler monitor tracks a rolling step-time median; steps slower
  than ``k×median`` are logged and counted;
* any exception during a step triggers a checkpoint-backed restart path
  (``max_restarts``): restore from a checkpoint, else re-raise.  A step
  may update the state in place (`train/step.py`), so a failed step is
  only ever recovered from a checkpoint.

A step's time is the host clock around the step and a synchronize of
the state's device (the reference's ``jax.block_until_ready``).
"""
from __future__ import annotations

import collections
import statistics
import time
from typing import Callable

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.tree import tree_leaves


class StragglerMonitor:
    def __init__(self, window: int = 32, threshold: float = 3.0):
        self.window = window
        self.threshold = threshold
        self.times: collections.deque = collections.deque(maxlen=window)
        self.stragglers = 0
        self.last_flagged: int | None = None

    def observe(self, step: int, dt: float) -> bool:
        flagged = False
        if len(self.times) >= max(4, self.window // 4):
            med = statistics.median(self.times)
            if dt > self.threshold * med:
                self.stragglers += 1
                self.last_flagged = step
                flagged = True
        self.times.append(dt)
        return flagged


def _synchronize(tree) -> None:
    """Wait for the work queued on the devices of ``tree``'s tensors."""
    devices = {t.device for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)


class Trainer:
    def __init__(
        self,
        train_step: Callable,
        state: dict,
        pipeline,
        *,
        ckpt_manager: CheckpointManager | None = None,
        ckpt_every: int = 0,
        log_every: int = 10,
        log_fn: Callable[[str], None] = print,
        straggler: StragglerMonitor | None = None,
        max_restarts: int = 2,
    ):
        self.train_step = train_step
        self.state = state
        self.pipeline = pipeline
        self.ckpt = ckpt_manager
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        self.log = log_fn
        self.straggler = straggler or StragglerMonitor()
        self.max_restarts = max_restarts
        self.history: list[dict] = []

    def _save(self):
        if self.ckpt is None:
            return
        self.ckpt.save(int(self.state["step"]), self.state,
                       extra={"pipeline": self.pipeline.state_dict()})

    def restore(self) -> bool:
        if self.ckpt is None:
            return False
        restored = self.ckpt.restore_latest(self.state)
        if restored is None:
            return False
        self.state, extra = restored
        if "pipeline" in extra:
            self.pipeline.load_state_dict(extra["pipeline"])
        return True

    def run(self, num_steps: int) -> dict:
        restarts = 0
        done = 0
        while done < num_steps:
            try:
                batch = next(self.pipeline)
                t0 = time.perf_counter()
                self.state, metrics = self.train_step(self.state, batch)
                _synchronize(self.state["params"])
                dt = time.perf_counter() - t0
                step = int(self.state["step"])
                flagged = self.straggler.observe(step, dt)
                metrics = {k: float(v) for k, v in metrics.items()}
                metrics.update(step=step, step_time_s=dt, straggler=flagged)
                self.history.append(metrics)
                if self.log_every and step % self.log_every == 0:
                    self.log(f"step {step}: loss={metrics.get('loss', float('nan')):.4f} "
                             f"({dt*1e3:.1f} ms)" + ("  [STRAGGLER]" if flagged else ""))
                if self.ckpt_every and step % self.ckpt_every == 0:
                    self._save()
                done += 1
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:  # preemption / transient failure path
                restarts += 1
                self.log(f"step failed ({type(e).__name__}: {e}); "
                         f"restart {restarts}/{self.max_restarts}")
                if restarts > self.max_restarts or not self.restore():
                    raise
        self._save()
        if self.ckpt is not None:
            self.ckpt.wait()
        return self.history[-1] if self.history else {}
