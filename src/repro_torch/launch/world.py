"""Start a world of ranks on one host: one spawned process a rank, each
with its process group initialised, running one function.

    results = spawn_world(fn, 2, backend="gloo", args=(...,))

``fn(rank, world_size, *args)`` must be importable by the children (a
module-level function).  The rendezvous port comes from binding port 0,
so worlds started side by side do not collide.  Every world has a
deadline: a rank that fails, dies or hangs (its peers then wait in a
collective) ends the world, every rank is killed, and the call raises
with each rank's stderr.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import socket
import tempfile
import time
import traceback


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world_size, port, backend, timeout_s, cuda_index, fn,
               args, results, log_path):
    with open(log_path, "w") as log:
        os.dup2(log.fileno(), 2)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)  # ranks share the host's cores
    if cuda_index is not None:
        torch.cuda.set_device(cuda_index)
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}",
            world_size=world_size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((rank, False, traceback.format_exc()))


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError as exc:
        return f"(no log: {exc})"


def spawn_world(fn, world_size: int, *, backend: str = "gloo",
                args: tuple = (), timeout: float = 120.0,
                cuda_index: int | None = None) -> list:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` spawned ranks,
    one intra-op thread each, and return its results by rank.

    ``timeout``: seconds for the whole world (the process groups' own
    timeout too).  ``cuda_index``: the card every rank uses (None ⇒ none
    is set).
    """
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="world-") as logs:
        paths = [os.path.join(logs, f"rank{r}.stderr")
                 for r in range(world_size)]
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, world_size, port, backend, timeout, cuda_index, fn, args,
            results, paths[r])) for r in range(world_size)]
        for p in procs:
            p.start()
        try:
            reports, late = _collect(procs, results, timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
            results.close()
        failed = {r: out for r, (ok, out) in reports.items() if not ok}
        if late is None and not failed:
            return [reports[r][1] for r in range(world_size)]
        what = [late] if late else []
        what += [f"rank {r} raised:\n{out}"
                 for r, out in sorted(failed.items())]
        what += [f"--- rank {r} stderr:\n{_tail(path)}"
                 for r, path in enumerate(paths)]
    raise RuntimeError(f"world of {world_size} ({backend}): "
                       + "\n".join(what))


def _collect(procs, results, timeout: float, grace: float = 3.0):
    """Every rank's ``(ok, result)`` report, until all are in, or until
    ``grace`` seconds after the first failure or death (its peers may be
    stuck in a collective), or the deadline.  Returns (reports, what
    went wrong besides a raised error, or None)."""
    reports: dict[int, tuple] = {}
    start = time.monotonic()
    end = start + timeout
    ending = False
    while len(reports) < len(procs):
        now = time.monotonic()
        if now > end:
            missing = {r: procs[r].exitcode for r in range(len(procs))
                       if r not in reports}
            return reports, (f"rank(s) {sorted(missing)} gave no result in "
                             f"{now - start:.0f} s (exit codes "
                             f"{list(missing.values())})")
        try:
            rank, ok, out = results.get(timeout=0.2)
        except queue.Empty:
            dead = [r for r, p in enumerate(procs)
                    if r not in reports and p.exitcode is not None]
            if dead and not ending:
                ending, end = True, min(end, now + grace)
            continue
        reports[rank] = (ok, out)
        if not ok and not ending:
            ending, end = True, min(end, now + grace)
    return reports, None
