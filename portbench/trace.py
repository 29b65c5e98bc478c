"""The device trace of a traced sub-window (`torch.profiler`, CUPTI): the
seconds some operation ran on the card, each kernel's calls and device
time by name, and the idle gaps named by what the host was doing.

The trace is written by the profiler as Chrome JSON into ``TMPDIR``,
read once and deleted."""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
#: Host spans the harness records around the calls into each layer.
SPAN_PREFIX = "bench:"
#: Idle gaps shorter than this are one entry, not named one by one.
NAMED_GAP_US = 10.0


@contextlib.contextmanager
def span(torch, name: str):
    """A harness span in the trace (a no-op when nothing is traced)."""
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


class Trace:
    """What a traced window read: ``window_s``, ``busy_s``, ``kernels``
    (name → [calls, device seconds]), ``idle`` (host activity → idle
    seconds on the device)."""

    def __init__(self, window_s: float, events: list[dict]):
        self.window_s = window_s
        dev = sorted(((e["ts"], e["ts"] + e.get("dur", 0.0), e) for e in events
                      if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                     key=lambda x: x[:2])
        host = sorted((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"])
                      for e in events
                      if e.get("ph") == "X" and e.get("cat") in HOST_CATS)
        self.kernels: dict[str, list] = collections.defaultdict(
            lambda: [0, 0.0])
        for _, _, e in dev:
            if e.get("cat") == "kernel":
                k = self.kernels[e["name"]]
                k[0] += 1
                k[1] += e.get("dur", 0.0) * 1e-6
        busy, gaps = 0.0, []
        if dev:
            start = min([dev[0][0]] + [h[0] for h in host[:1]])
            end = max(d[1] for d in dev + host)
            cur_s, cur_e = dev[0][0], dev[0][1]
            if cur_s > start:
                gaps.append((start, cur_s))
            for s, e, _ in dev[1:]:
                if s > cur_e:
                    busy += cur_e - cur_s
                    gaps.append((cur_e, s))
                    cur_s, cur_e = s, e
                else:
                    cur_e = max(cur_e, e)
            busy += cur_e - cur_s
            if end > cur_e:
                gaps.append((cur_e, end))
        self.busy_s = busy * 1e-6
        self.idle = collections.Counter()
        spans = [h for h in host if h[2].startswith(SPAN_PREFIX)]
        ops = [h for h in host if not h[2].startswith(SPAN_PREFIX)]
        for a, b in gaps:
            name = (_host_name(spans, ops, (a + b) / 2)
                    if b - a >= NAMED_GAP_US else "gaps under 10 us")
            self.idle[name] += (b - a) * 1e-6

    def kernel_time(self, *needles: str) -> tuple[int, float]:
        """(calls, device seconds) of the kernels whose name holds one of
        ``needles``."""
        calls, secs = 0, 0.0
        for name, (n, s) in self.kernels.items():
            if any(x in name for x in needles):
                calls += n
                secs += s
        return calls, secs

    def breakdown(self) -> dict:
        ops = sorted(((n[:160], s) for n, (_, s) in self.kernels.items()),
                     key=lambda x: -x[1])[:10]
        gaps = sorted(self.idle.items(), key=lambda x: -x[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _covering(events, t: float, reach: int) -> str | None:
    """The latest-starting of ``events`` (sorted by start) that runs at
    ``t``, looking back ``reach`` events."""
    i = bisect.bisect_right(events, (t, float("inf"), ""))
    for j in range(i - 1, max(i - reach, -1), -1):
        if events[j][1] >= t:
            return events[j][2]
    return None


def _host_name(spans, ops, t: float) -> str:
    """The harness span and the innermost host op running at ``t``."""
    outer = _covering(spans, t, 8)
    inner = _covering(ops, t, 256)
    outer = outer[len(SPAN_PREFIX):] if outer else "harness"
    return f"{outer}/{inner or 'python'}"


class Profiler:
    """Traces one sub-window; ``warm()`` in set-up starts CUPTI once so
    the traced window does not pay for it."""

    def __init__(self, torch):
        self.torch = torch
        self.trace: Trace | None = None

    def _profile(self):
        prof = self.torch.profiler
        return prof.profile(activities=[prof.ProfilerActivity.CPU,
                                        prof.ProfilerActivity.CUDA])

    def warm(self) -> None:
        with self._profile():
            self.torch.zeros(1, device="cuda").add_(1)
            self.torch.cuda.synchronize()

    @contextlib.contextmanager
    def window(self):
        torch = self.torch
        torch.cuda.synchronize()
        p = self._profile()
        p.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
            p.__exit__(None, None, None)
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                p.export_chrome_trace(path)
                with open(path) as f:
                    events = json.load(f).get("traceEvents", [])
            finally:
                os.unlink(path)
            self.trace = Trace(window_s, events)
