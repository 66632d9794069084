"""The benchmark's own tracing: host spans around its calls into each layer
of the port, and a torch.profiler trace of a short steady slice of the
window, reduced to device busy time, idle gaps and device operations.

Spans are recorded only in a traced run (`--trace 1`), end in a
synchronize so that a span holds its layer's device work, and appear in
the profiler's trace as user annotations named ``gabench.<span>``.  The
device's idle time is split by what the host was doing meanwhile: each
stretch of an idle gap goes to the innermost span the host was in
(``harness`` outside every span; the part of ``run`` or ``chunk``
outside its ``segment`` is ``result`` or ``chunk_end``).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "gabench."
OUTSIDE = {"run": "result", "chunk": "chunk_end"}
TOP = 10


class Spans:
    """Durations by span name (host clock, seconds); no-ops unless traced.
    Durations are kept only while `counting`: the harness stops counting
    when the profiler starts, because starting it changes the host's
    speed for the rest of the process (the port's NumPy seed hash runs
    several times faster after it)."""

    def __init__(self, traced: bool, cuda: bool):
        self.traced, self.cuda = traced, cuda
        self.counting = True
        self.times = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.traced:
            yield
            return
        with torch.profiler.record_function(PREFIX + name):
            t = time.perf_counter()
            try:
                yield
            finally:
                if self.cuda:
                    torch.cuda.synchronize()
                if self.counting:
                    self.times[name].append(time.perf_counter() - t)

    def wrap(self, name: str, fn):
        def spanned(*args, **kw):
            with self.span(name):
                return fn(*args, **kw)
        return spanned


def warm_profiler(cuda: bool, device) -> None:
    """Profile one small device op, so that the profiler's own start-up
    (CUPTI's) falls before the traced slice and not in it."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        torch.ones(1, device=device).add_(1)
        if cuda:
            torch.cuda.synchronize()


class Slice:
    """A profiled stretch of the window: `start` before its first unit,
    `stop` after its last; `reduce` reads the trace."""

    def __init__(self):
        self.prof = None
        self.mark = None
        self.trace = None
        self.t0 = 0.0
        self.gens = 0
        self.units = 0
        self.launches = 0
        self.least_ms = 0.0
        self.host_s = 0.0
        self.done = False

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.done

    def start(self, cuda: bool, launches: int) -> None:
        self.launches = launches
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.mark = torch.profiler.record_function(PREFIX + "slice")
        self.mark.__enter__()
        self.t0 = time.perf_counter()

    def stop(self, cuda: bool, launches: int) -> None:
        if cuda:
            torch.cuda.synchronize()
        self.mark.__exit__(None, None, None)
        self.prof.stop()
        self.launches = launches - self.launches
        self.host_s = time.perf_counter() - self.t0
        self.done = True

    def reduce(self) -> dict:
        """busy_s, window_s, device ops and idle gaps of the slice."""
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        return reduce_events(events)


def reduce_events(events: list) -> dict:
    """The slice's device timeline from chrome-trace events (times in us)."""
    spans, device = [], []
    window = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        t0 = float(e["ts"])
        t1 = t0 + float(e.get("dur", 0.0))
        if cat == "user_annotation" and name.startswith(PREFIX):
            if name == PREFIX + "slice":
                window = (t0, t1)
            else:
                spans.append((t0, t1, name[len(PREFIX):]))
        elif cat in DEVICE_CATS:
            device.append((t0, t1, name))
    if window is None:
        return {"busy_s": 0.0, "window_s": 0.0, "device_ops": [],
                "idle_gaps": [], "names": []}
    w0, w1 = window
    clipped = sorted((max(a, w0), min(b, w1), n) for a, b, n in device
                     if b > w0 and a < w1)
    ops = defaultdict(float)
    busy, gaps, edge = 0.0, [], w0
    for a, b, n in clipped:
        ops[n] += b - a
        if a > edge:
            gaps.append((edge, a))
        if b > edge:
            busy += b - max(a, edge)
            edge = b
    if w1 > edge:
        gaps.append((edge, w1))
    idle = defaultdict(float)
    cuts = sorted({t for a, b, _ in spans for t in (a, b)})
    for g0, g1 in gaps:
        inner = [t for t in cuts if g0 < t < g1]
        for a, b in zip([g0] + inner, inner + [g1]):
            idle[_label(spans, (a + b) / 2)] += b - a
    top = lambda d: [[k, v / 1e6] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"busy_s": busy / 1e6, "window_s": (w1 - w0) / 1e6,
            "device_ops": top(ops), "idle_gaps": top(idle),
            "names": sorted(ops)}


def _label(spans: list, t: float) -> str:
    inner = None
    for a, b, name in spans:
        if a <= t < b and (inner is None or a >= inner[0]):
            inner = (a, b, name)
    if inner is None:
        return "harness"
    return OUTSIDE.get(inner[2], inner[2])
