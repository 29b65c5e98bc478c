"""Block and ring-depth tuner for the P²M kernels; port of
`repro.kernels.p2m_conv.tune` (DESIGN.md §5).

Picks ``(block_h, block_n, pipeline_depth)`` for the fused conv
(`conv.p2m_conv_fused`) and ``(block_m, block_n, block_k)`` for the P²M
product (`kernel.p2m_matmul_fused`) by enumerating the candidates under a
shared-memory budget and timing each on synthetic data of the call's
shape.  The port's meanings:

* conv, ``pipeline_depth`` 0: B1, persistent blocks over tiles of one
  output row, two pixels a thread, its tiling its own (`conv.b1_tiling`);
  it ignores ``block_h``, and ``block_n`` is the outputs a block stages
  W̃ for (`conv._n_tile`).  ``pipeline_depth`` ≥ 2: B2, a ring of
  ``min(depth, k)`` shared-memory slots over the kernel rows; ``block_h``
  rows of B·Ho a block (``block_h · Wo`` ≤ 512 pixels), several pixels of
  a row a thread (`conv.pipelined_launch`), and ``block_n`` ≤ 32 outputs
  a block, all live in a thread's registers.
  Candidates are the blocks the kernels run: a request B1 would ignore, or
  a depth that clamps to k, is not timed twice.
* product: ``block_m`` rows of x a tile (a persistent block walks
  several, `kernel.matmul_tiling`), ``block_n`` ≤ 32 outputs a block,
  ``block_k`` rows of K copied a time (all of K: a tile is one span).

Budget (`SMEM_BUDGET_BYTES`): an H100 block may opt in to 227 KB of
shared memory of its SM's 228 KB.  Half of that (100 KB, with the 1 KB a
block reserves) keeps at least two blocks on an SM, so one block's copies
and barrier waits overlap another's arithmetic; a candidate above it would
leave the SM one block.

Cache semantics: winners are memoized per signature — the problem shape,
the coefficient table (its nonzero pattern changes the instruction mix),
the epilogue mode, the device type and name the timing ran on, and (for
the conv) the depth menu swept.  A signature is timed once a process;
every later call is a dict lookup, so the tuner adds one-off latency to
the first call of a signature, never steady-state cost.  Tuning launches
are not the caller's: the kernels' launch counters are restored after.
Ranks that share one card would time candidates against each other and
could pick differently: one process tunes, and the ranks load its
entries (`cache_entries`, `load_cache_entries`).

Tuning is on by default on a CUDA device (`enabled`), and off elsewhere:
timing the plain twins on the CPU would say nothing of the kernels.  Off,
`get_*_blocks` return the static defaults at once and emit one structured
log per (kind, device).  ``REPRO_P2M_AUTOTUNE=1`` (or ``enable=True``)
forces tuning; the tests do, at toy shapes, to exercise the machinery.

Failures: a candidate that raises is recorded with its error in the
decision record and counted (``autotune.candidate_failed``); the others
are still timed.  A fault inside a kernel is sticky on CUDA and poisons
the context, so every later launch fails too: a decision record with a
failed candidate is a fault to chase, not a tuning result.
"""
from __future__ import annotations

import json
import logging
import os
import statistics
import time
from typing import Callable, Iterable

import torch

from repro_torch.kernels.p2m_conv import conv, kernel
from repro_torch.obs.log import structured
from repro_torch.obs.metrics import default_registry

logger = logging.getLogger(__name__)

#: Half of a block's opt-in shared memory on an H100 (module docstring).
SMEM_BUDGET_BYTES = 100 * 1024

#: Pipeline depths swept for the conv: 0 = B1, ≥ 2 = B2's ring with that
#: many slots (depth 1 would wait on its own copy and is refused).
CONV_PIPELINE_DEPTHS: tuple[int, ...] = (0, 2, 3)

_CACHE: dict[tuple, dict] = {}

# One-time "autotune disabled, serving defaults" notices, per (kind, device).
_DISABLED_LOGGED: set[tuple[str, str]] = set()


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _log_disabled_defaults(kind: str, device: str, default) -> None:
    """One structured notice per (kind, device) that the static defaults
    are served because tuning is off there; every such serve counts
    ``autotune.disabled_default``."""
    default_registry().counter("autotune.disabled_default").inc()
    token = (kind, device)
    if token in _DISABLED_LOGGED:
        return
    _DISABLED_LOGGED.add(token)
    structured(logger, "p2m_autotune_disabled_defaults", kind=kind,
               device=device, default=list(default),
               hint="set REPRO_P2M_AUTOTUNE=1 or pass enable=True to tune")


def enabled(device: torch.device, enable: bool | None = None) -> bool:
    """Tune on a CUDA device, or anywhere when ``REPRO_P2M_AUTOTUNE=1``
    or ``enable=True``."""
    if enable is not None:
        return enable
    if os.environ.get("REPRO_P2M_AUTOTUNE", "") == "1":
        return True
    return device.type == "cuda"


def _coeff_sig(coeffs) -> tuple:
    return tuple(tuple(float(v) for v in row) for row in coeffs)


# ---------------------------------------------------------------------------
# Candidates under the shared-memory budget
# ---------------------------------------------------------------------------


def conv_smem_bytes(cand: tuple, *, wo: int, c: int, kernel: int,
                    stride: int, dx: int) -> int:
    """Shared memory of one block of the conv candidate ``(block_h,
    block_n, depth)``: B1 its two band slots and W̃ of all k rows for its
    N tile (`conv.b1_smem_bytes` at its tile, `conv.b1_tile`); B2 its
    ring (`conv.pipelined_smem_bytes`)."""
    bh, bn, depth = cand
    if depth == 0:
        tile_px, _ = conv.b1_tile(wo, c, kernel, stride, dx, bn)
        return conv.b1_smem_bytes(tile_px, c, kernel, stride, dx, bn)
    return conv.pipelined_smem_bytes(wo, c, kernel, stride, dx, bh, bn,
                                     depth)


def conv_candidates(b: int, ho: int, wo: int, n: int, kc: int, *,
                    kernel: int, stride: int, dx: int = 3,
                    depths: tuple[int, ...] = CONV_PIPELINE_DEPTHS,
                    budget: int = SMEM_BUDGET_BYTES
                    ) -> list[tuple[int | None, int, int]]:
    """Conv candidates ``(block_h, block_n, depth)`` as the kernels run
    them: B1's ``(None, its N tile, 0)`` when its W̃ of all k rows fits
    its 48 KB for one register chunk (its tiles' bands then fit beside
    it within `conv.B1_SMEM_BYTES`, `conv.b1_tile`); B2's ``(block_h, N
    tile, min(depth, k))`` with ``block_h · Wo`` ≤ `conv.PIPE_THREADS`
    and its ring within ``budget``.  ``kc`` = k·C."""
    c = kc // kernel
    out, seen = [], set()
    for depth in depths:
        conv.check_pipeline_depth(depth)
        for bn in (None, 8, 16, 32):  # None: all of N the kernel takes
            if depth == 0:
                try:
                    cand = (None, conv._n_tile(n, kernel * dx * kc, bn), 0)
                except ValueError:  # B1 cannot stage W̃; B2 may
                    break
            else:
                cand = (None, conv.pipelined_tile(n, bn), min(depth, kernel))
            for bh in ((None,) if depth == 0 else (1, 2, 4, 8, 16, 32, 64)):
                if bh is not None:
                    bh = min(bh, b * ho)
                    if bh * wo > conv.PIPE_THREADS:
                        continue
                full = (bh, cand[1], cand[2])
                if full in seen:
                    continue
                seen.add(full)
                # B1 keeps itself within `conv.B1_SMEM_BYTES`
                if depth == 0 or conv_smem_bytes(
                        full, wo=wo, c=c, kernel=kernel, stride=stride,
                        dx=dx) <= budget:
                    out.append(full)
    return out


def matmul_smem_bytes(cand: tuple, *, dx: int, k: int) -> int:
    """Shared memory of one block of the product candidate ``(block_m,
    block_n, block_k)`` at K = ``k`` (`kernel.matmul_smem_bytes`)."""
    bm, bn, bk = cand
    return kernel.matmul_smem_bytes(bm, bk, dx, bn, k)


def matmul_candidates(m: int, k: int, n: int, *, dx: int = 3,
                      budget: int = SMEM_BUDGET_BYTES
                      ) -> list[tuple[int, int, int]]:
    """Product candidates ``(block_m, block_n, block_k)`` as the kernel
    runs them (``block_n`` its N tile, ``block_k`` at most K), within
    ``budget``."""
    out, seen = [], set()
    for bm in (64, 128, 256):
        for bn in (8, 16, 32):
            for bk in (32, 64, 128):
                cand = (min(bm, kernel.MATMUL_MAX_ROWS),
                        kernel.matmul_tile(n, bn), min(bk, k))
                if cand in seen:
                    continue
                seen.add(cand)
                if matmul_smem_bytes(cand, dx=dx, k=k) <= budget:
                    out.append(cand)
    return out


# ---------------------------------------------------------------------------
# Timing + memoization
# ---------------------------------------------------------------------------


#: Clock cycles the card first spins for a candidate's three timed groups
#: of launches (about 1 ms at the H100's clocks), while the host enqueues
#: them; doubled, up to `_HOLD_MAX` times, where the host was slower.
_HOLD_CYCLES = 2_000_000
_HOLD_MAX = 8


def _time_once(fn: Callable, cand, device: torch.device, *,
               iters: int) -> float:
    """Seconds a run of ``fn(cand)``: after one warm-up run, the median
    over three groups of ``iters`` runs back to back, each group timed
    whole (CUDA events on a CUDA device, the host clock elsewhere), so a
    kernel of tens of microseconds is not timed as one event pair.  On a
    CUDA device the stream spins once, for `_HOLD_CYCLES`, while the host
    enqueues all three groups: a wrapper's host time (tens of
    microseconds, more than a stem kernel's device time) then falls
    outside the events instead of between the launches.  Where the spin
    had ended before the host was done (the first event already
    reached), the groups are timed again with twice the spin."""
    fn(cand)
    if device.type != "cuda":
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(cand)
            times.append((time.perf_counter() - t0) / iters)
        return statistics.median(times)
    hold = _HOLD_CYCLES
    while True:
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda._sleep(hold)
        events[0].record()
        for end in events[1:]:
            for _ in range(iters):
                fn(cand)
            end.record()
        held = not events[0].query()
        events[-1].synchronize()
        if held or hold >= _HOLD_MAX * _HOLD_CYCLES:
            break
        hold *= 2
    return statistics.median(a.elapsed_time(b) / 1e3 / iters
                             for a, b in zip(events, events[1:]))


def autotune(key: tuple, setup: Callable[[], tuple[Iterable, Callable]],
             device: torch.device, *, iters: int = 5,
             smem: Callable | None = None) -> dict:
    """Time ``run(candidate)`` for each candidate, cache the winner.

    ``setup()`` returns ``(candidates, run)``; it is called on a cache miss
    only, so the synthetic inputs are built only when a signature is
    tuned.  Returns ``{"best": candidate, "timings": {candidate: seconds or
    inf}, "decision": record}``.  A candidate that raises is recorded
    with its error and counts ``autotune.candidate_failed``; the others
    are timed.  Every call counts ``autotune.cache_hit`` or
    ``autotune.cache_miss``; a miss stores a decision record (every
    candidate with its shared-memory bytes, time or error, and the
    winner: `decision_records`) and logs one structured
    ``p2m_autotune_decision`` line."""
    registry = default_registry()
    if key in _CACHE:
        registry.counter("autotune.cache_hit").inc()
        return _CACHE[key]
    registry.counter("autotune.cache_miss").inc()
    candidates, run = setup()
    timings: dict = {}
    errors: dict = {}
    for cand in candidates:
        try:
            timings[cand] = _time_once(run, cand, device, iters=iters)
        except Exception as exc:  # noqa: BLE001 - per-candidate isolation
            timings[cand] = float("inf")
            errors[cand] = f"{type(exc).__name__}: {exc}"
            registry.counter("autotune.candidate_failed").inc()
    viable = {c: t for c, t in timings.items() if c not in errors}
    if not viable:
        raise RuntimeError(f"autotune: no viable candidate for {key}: "
                           f"{errors}")
    best = min(viable, key=viable.get)
    decision = {
        "key": repr(key),
        "kind": key[0],
        "candidates": [list(c) for c in timings],
        "smem_bytes": ([int(smem(c)) for c in timings]
                       if smem is not None else None),
        "times_s": [None if c in errors else t for c, t in timings.items()],
        "errors": [errors.get(c) for c in timings],
        "best": list(best),
        "best_s": timings[best],
        "n_viable": len(viable),
        "n_failed": len(errors),
    }
    result = {"best": best, "timings": timings, "decision": decision}
    _CACHE[key] = result
    structured(logger, "p2m_autotune_decision", kind=decision["kind"],
               best=decision["best"], n_candidates=len(timings),
               n_viable=decision["n_viable"], n_failed=len(errors))
    return result


def decision_records() -> list[dict]:
    """Every tuning decision taken this process (cache misses only)."""
    return [v["decision"] for v in _CACHE.values()]


def set_winner(key: str, best: tuple) -> None:
    """Serve ``best`` from now on for the tuned signature whose printable
    key (as `decision_records` and `cache_info` show it) is ``key``, its
    decision record kept: how a caller makes a chosen kernel run behind
    the tuner, as the reference's tests do through its cache."""
    (sig,) = [k for k in _CACHE if repr(k) == key]
    _CACHE[sig] = {**_CACHE[sig], "best": tuple(best)}


def get_conv_blocks(b: int, h: int, w: int, c: int, n: int, kernel: int,
                    stride: int, coeffs, mode: str, *, device,
                    enable: bool | None = None,
                    depths: tuple[int, ...] = CONV_PIPELINE_DEPTHS,
                    iters: int = 5) -> tuple[int | None, int | None, int]:
    """``(block_h, block_n, pipeline_depth)`` for `conv.p2m_conv_fused` on
    ``device`` — tuned when enabled, ``(None, None, 0)`` (B1 with its own
    tiling) otherwise."""
    default = (None, None, 0)
    device = torch.device(device)
    name = _device_name(device)
    key = ("conv", b, h, w, c, n, kernel, stride, _coeff_sig(coeffs), mode,
           device.type, name, tuple(depths))
    if key not in _CACHE and not enabled(device, enable):
        _log_disabled_defaults("conv", name, default)
        return default
    wo = conv.conv_out_spatial(w, kernel, stride)
    dx = len(coeffs[0])

    def setup():
        gen = torch.Generator(device).manual_seed(0)
        imgs = torch.rand((b, h, w, c), generator=gen, device=device)
        wts = 2 * torch.rand((kernel * kernel * c, n), generator=gen,
                             device=device) - 1
        wrows = conv.premix_rows(wts, coeffs, kernel)
        zero = torch.zeros(n, device=device)

        def run(cand):
            bh, bn, depth = cand
            return conv.p2m_conv_fused(imgs, wrows, zero, kernel=kernel,
                                       stride=stride, mode=mode, block_h=bh,
                                       block_n=bn, pipeline_depth=depth)

        ho = conv.conv_out_spatial(h, kernel, stride)
        return conv_candidates(b, ho, wo, n, kernel * c, kernel=kernel,
                               stride=stride, dx=dx,
                               depths=tuple(depths)), run

    counted = (conv.p2m_conv_fused.launches,
               conv.p2m_conv_fused.launches_pipelined)
    try:
        return autotune(key, setup, device, iters=iters,
                        smem=lambda cd: conv_smem_bytes(
                            cd, wo=wo, c=c, kernel=kernel, stride=stride,
                            dx=dx))["best"]
    finally:
        (conv.p2m_conv_fused.launches,
         conv.p2m_conv_fused.launches_pipelined) = counted


def get_matmul_blocks(m: int, k: int, n: int, coeffs, mode: str, *, device,
                      enable: bool | None = None,
                      iters: int = 5) -> tuple[int, int, int]:
    """``(block_m, block_n, block_k)`` for `kernel.p2m_matmul_fused` on
    ``device`` — tuned when enabled, `kernel.MATMUL_DEFAULT_BLOCKS`
    otherwise."""
    default = kernel.MATMUL_DEFAULT_BLOCKS
    device = torch.device(device)
    name = _device_name(device)
    key = ("matmul", m, k, n, _coeff_sig(coeffs), mode, device.type, name)
    if key not in _CACHE and not enabled(device, enable):
        _log_disabled_defaults("matmul", name, default)
        return default
    dx = len(coeffs[0])

    def setup():
        gen = torch.Generator(device).manual_seed(0)
        x = torch.rand((m, k), generator=gen, device=device)
        wts = 2 * torch.rand((k, n), generator=gen, device=device) - 1
        zero = torch.zeros(n, device=device)

        def run(cand):
            bm, bn, bk = cand
            return kernel.p2m_matmul_fused(x, wts, zero, coeffs=coeffs,
                                           mode=mode, block_m=bm,
                                           block_n=bn, block_k=bk)

        return matmul_candidates(m, k, n, dx=dx), run

    counted = kernel.p2m_matmul_fused.launches
    try:
        return autotune(key, setup, device, iters=iters,
                        smem=lambda cd: matmul_smem_bytes(
                            cd, dx=dx, k=k))["best"]
    finally:
        kernel.p2m_matmul_fused.launches = counted


# ---------------------------------------------------------------------------
# Cache management
# ---------------------------------------------------------------------------


def cache_info() -> dict[str, tuple]:
    """{printable signature: winner} for every tuned entry."""
    return {repr(k): v["best"] for k, v in _CACHE.items()}


def cache_clear() -> None:
    _CACHE.clear()


def cache_entries() -> dict:
    """Every tuned entry (signature → winner, timings and decision
    record): what `load_cache_entries` installs in another process, so
    that ranks sharing one card take one process's decisions instead of
    timing candidates against each other."""
    return dict(_CACHE)


def load_cache_entries(entries: dict) -> None:
    """Serve the winners of ``entries`` (from `cache_entries`) from now
    on; their signatures are not timed again in this process."""
    _CACHE.update(entries)


def cache_dump(path: str) -> None:
    """Persist winners and timings as JSON, e.g. from a benchmark run."""
    payload = [
        {"key": list(map(repr, k)), "best": list(v["best"]),
         "timings_s": {repr(c): t for c, t in v["timings"].items()}}
        for k, v in _CACHE.items()
    ]
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
