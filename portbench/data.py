"""Inputs made from the seed: synthetic Visual Wake Words frames and
synthetic LM token streams.

`vww_images` is a copy of the port's `data/vww_synthetic.py` (soft
person-like figures on textured backgrounds), with the per-image numbers
drawn by numpy from (seed, index) as there, and the sensor noise and the
arithmetic on the device, so a pool of 560² frames takes milliseconds.
`lm_tokens` is a copy of `data/lm.py`: the noisy affine recurrence
``x_{t+1} = (a·x_t + b + ε) mod V``."""
from __future__ import annotations

import math

import numpy as np
import torch


def _rng(seed: int, index: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, index]))


def vww_image(seed: int, index: int, size: int, device):
    """One frame (size, size, 3) float32 in [0, 1] on ``device``, and its
    label (1: a figure is present)."""
    rng = _rng(seed, index)
    h = w = size
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    label = int(rng.integers(0, 2))
    gy, gx = rng.uniform(-1, 1), rng.uniform(-1, 1)
    freq, phase = rng.uniform(0.02, 0.1), rng.uniform(0, 1)
    bg = 0.4 + 0.2 * (gy * yy / h + gx * xx / w) + 0.15 * torch.sin(
        2 * math.pi * (xx * freq + phase))
    for _ in range(int(rng.integers(0, 4))):
        by, bx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(0.05, 0.2) * min(h, w)
        bg = bg + 0.3 * torch.exp(-((yy - by) ** 2 + (xx - bx) ** 2) / r**2)
    img = torch.stack([bg * rng.uniform(0.7, 1.3) for _ in range(3)], -1)
    if label:
        cy = rng.uniform(0.35, 0.65) * h
        cx = rng.uniform(0.25, 0.75) * w
        scale = rng.uniform(0.15, 0.35) * min(h, w)
        head = (((yy - (cy - 1.1 * scale)) ** 2 + (xx - cx) ** 2)
                / (0.45 * scale) ** 2)
        torso = ((yy - cy) ** 2 / (1.4 * scale) ** 2
                 + (xx - cx) ** 2 / (0.7 * scale) ** 2)
        m = torch.exp(-torch.clamp(torch.minimum(head, torso) - 1.0, min=0.0)
                      * 4.0)[..., None]
        color = torch.tensor(rng.uniform(0.3, 1.0, 3), dtype=torch.float32,
                             device=device)
        img = img * (1 - 0.8 * m) + m * color
    gen = torch.Generator(device).manual_seed(
        int(rng.integers(0, 2**63 - 1)))
    noise = torch.empty_like(img).normal_(0.0, 0.03, generator=gen)
    return torch.clamp(img + noise, 0.0, 1.0), label


def vww_images(seed: int, first: int, count: int, size: int, device):
    """Frames ``first .. first+count-1`` of the seed's stream, as host
    numpy arrays (the engines take frames from the host): images (count,
    size, size, 3) float32 and labels (count,) int32."""
    imgs, labels = zip(*(vww_image(seed, first + i, size, device)
                         for i in range(count)))
    images = torch.stack(imgs).cpu().numpy()
    return images, np.asarray(labels, np.int32)


def lm_tokens(seed: int, step: int, batch: int, length: int, vocab: int,
              noise: float = 0.05, n_rules: int = 8) -> np.ndarray:
    """(batch, length) int64 tokens of the recurrence, stateless in
    (seed, step)."""
    rng = _rng(seed, step)
    a = rng.integers(1, n_rules + 1, (batch,))
    c = rng.integers(0, n_rules, (batch,))
    x = np.empty((batch, length), np.int64)
    x[:, 0] = rng.integers(0, vocab, batch)
    noise_mask = rng.random((batch, length)) < noise
    noise_tok = rng.integers(0, vocab, (batch, length))
    for t in range(1, length):
        nxt = (a * x[:, t - 1] + c) % vocab
        x[:, t] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
    return x


class LMBatches:
    """The LM training stream in the shape of the port's dataset:
    ``batch_at(step)`` → tokens and next-token targets, int32."""

    def __init__(self, seed: int, batch: int, seq: int, vocab: int):
        self.seed, self.batch, self.seq, self.vocab = seed, batch, seq, vocab

    def batch_at(self, step: int) -> dict:
        x = lm_tokens(self.seed, step, self.batch, self.seq + 1, self.vocab)
        return {"tokens": x[:, :-1].astype(np.int32),
                "targets": x[:, 1:].astype(np.int32)}
