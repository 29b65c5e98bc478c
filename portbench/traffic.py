"""The general generators that read a traffic file: an open loop of
Poisson arrivals over a pool of inputs, a closed loop's set of requests,
and a training pool.  Each is a pure function of the seed and the file."""
from __future__ import annotations

import numpy as np


def _rng(seed: int, stream: str) -> np.random.Generator:
    tag = int.from_bytes(stream.encode()[:8].ljust(8, b"\0"), "little")
    return np.random.default_rng(np.random.SeedSequence([seed, tag]))


def open_loop(traffic: dict, seed: int,
              seconds: float) -> list[tuple[float, int]]:
    """(due second from the window's start, pool index) of every arrival
    due in ``[0, seconds)``: Poisson at ``rate_per_s``, each arrival a
    frame drawn from the pool of ``pool``."""
    rng = _rng(seed, "arrivals")
    rate = float(traffic["rate_per_s"])
    n = int(rate * seconds * 1.5) + 64
    due = np.cumsum(rng.exponential(1.0 / rate, n))
    while due[-1] < seconds:  # more arrivals than the first draw held
        due = np.concatenate([due, due[-1] + np.cumsum(
            rng.exponential(1.0 / rate, n))])
    due = due[due < seconds]
    frames = rng.integers(0, int(traffic["pool"]), len(due))
    return [(float(t), int(i)) for t, i in zip(due, frames)]


def closed_loop(traffic: dict, seed: int) -> list[dict]:
    """The requests the clients send, in order, in blocks of ``block``:
    every block holds the same sizes, prompt lengths at the quantiles of
    a log-uniform law over ``[prompt_min, prompt_max]`` and new-token
    counts at those of a uniform law over ``[new_min, new_max]``, paired
    and ordered by the seed anew in each block.  So a window that takes
    in some blocks does the same work for every seed.  Each request has
    ``prompt_len``, ``new_tokens`` and ``row``: its row of the token block
    (`data.lm_tokens`); ``requests`` of them in all."""
    n, block = int(traffic["requests"]), int(traffic["block"])
    q = (np.arange(block) + 0.5) / block
    lo, hi = np.log(traffic["prompt_min"]), np.log(traffic["prompt_max"])
    prompts = np.round(np.exp(lo + q * (hi - lo))).astype(int)
    lo_new, hi_new = traffic["new_min"], traffic["new_max"]
    news = np.round(lo_new + q * (hi_new - lo_new)).astype(int)
    rng = _rng(seed, "requests")
    out: list[dict] = []
    while len(out) < n:
        pairs = zip(prompts[rng.permutation(block)],
                    news[rng.permutation(block)])
        out += [{"row": len(out) + i, "prompt_len": int(p),
                 "new_tokens": int(t)} for i, (p, t) in enumerate(pairs)]
    return out[:n]


def sample(count: int, seed: int, n: int,
           always: int | None = None) -> list[int]:
    """``count`` distinct indices of ``range(n)`` drawn from the seed, with
    ``always`` among them."""
    rng = _rng(seed, "sample")
    picked = [int(i) for i in rng.permutation(n)[:count]]
    if always is not None and always not in picked:
        picked = picked[:-1] + [always] if picked else [always]
    return sorted(picked)
