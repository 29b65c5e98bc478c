"""Deterministic synthetic LM data with learnable structure; a copy of
`repro.data.lm` (numpy).

Sequences follow a noisy affine-recurrence language:
``x_{t+1} = (a·x_t + b + ε_t) mod V`` with per-sequence (a, b) drawn from
a small set.  The generator is stateless in ``(seed, step)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticLMDataset:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    noise: float = 0.05
    n_rules: int = 8

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Batch for a given global step (checkpoint-friendly addressing)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        b, s, v = self.batch, self.seq_len + 1, self.vocab
        a = rng.integers(1, self.n_rules + 1, (b, 1))
        c = rng.integers(0, self.n_rules, (b, 1))
        x = np.empty((b, s), np.int64)
        x[:, 0] = rng.integers(0, v, b)
        noise_mask = rng.random((b, s)) < self.noise
        noise_tok = rng.integers(0, v, (b, s))
        for t in range(1, s):
            nxt = (a[:, 0] * x[:, t - 1] + c[:, 0]) % v
            x[:, t] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
        return {
            "tokens": x[:, :-1].astype(np.int32),
            "targets": x[:, 1:].astype(np.int32),
        }
