"""The port's span and counter recorder: host spans at its layer
boundaries, each with its counters, kept in memory.

    from repro_torch import trace
    trace.enable()
    ga.solve(spec, "fused")
    for r in trace.records():
        print(r["name"], (r["t1"] - r["t0"]) / 1e6, "ms", r["attrs"])
    trace.disable()

Off by default and process-wide.  Off, `span` is one flag check that
returns a shared no-op.  On, each span records its name, its start and
end on `time.perf_counter_ns()`, its own id and its parent's (the span
open beneath it on the same thread), a run id, and a dict of counters
and attributes.  The run id is shared by every span of one request: an
engine's (`new_run()`, with `None` in place of a chunk) or one chunk's of
`Engine.run_chunked` (the engine's, with the chunk's number); a span
given none takes its parent's.  Spans are kept in the order they end, up
to `CAPACITY`; past it they are dropped and counted (`dropped()`).
Nothing is written to disk.

While a torch.profiler is recording, each span also enters
`torch.profiler.record_function("repro_torch." + name)`, so the profiler's
trace shows the port's layers on the same timeline as the device's
operations.  Outside a profiler no `record_function` is entered.

Tracing changes no result: a segment on a CUDA device adds two timing
events and waits on the second (`ga.backends.SegmentClock`), where
copying its results to the host would have waited anyway.
"""

from __future__ import annotations

import itertools
import threading
import time

import torch

CAPACITY = 1 << 17      # spans kept; later ones are dropped and counted
PREFIX = "repro_torch."

_on = False
_store: list = []
_dropped = 0
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_runs = itertools.count(1)


class _Off:
    """The span `span` returns while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def count(self, name, n=1):
        pass

    def set(self, name, value):
        pass


OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One open or finished span (`span` makes them)."""

    __slots__ = ("name", "id", "parent", "run", "t0", "t1", "attrs", "_rf")

    def __init__(self, name: str, run, attrs: dict):
        self.name = name
        self.id = next(_ids)
        self.parent = None
        self.run = run
        self.t0 = self.t1 = 0
        self.attrs = attrs
        self._rf = None

    def __enter__(self):
        stack = _stack()
        if stack:
            self.parent = stack[-1].id
            if self.run is None:
                self.run = stack[-1].run
        stack.append(self)
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(PREFIX + self.name)
            self._rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.t1 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
            self._rf = None
        _stack().pop()
        _keep(self)
        return False

    def count(self, name: str, n=1) -> None:
        """Add `n` to the span's counter `name`."""
        self.attrs[name] = self.attrs.get(name, 0) + n

    def set(self, name: str, value) -> None:
        """Set the span's attribute `name`."""
        self.attrs[name] = value


def _keep(sp: Span) -> None:
    global _dropped
    with _lock:
        if len(_store) < CAPACITY:
            _store.append(sp)
        else:
            _dropped += 1


def enable() -> None:
    """Start recording (what was recorded stays until `clear`)."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording; spans open now still finish and are kept."""
    global _on
    _on = False


def span(name: str, run=None, **attrs):
    """A context manager recording the span `name` while tracing is on
    (the shared no-op `OFF` while it is off); `run` is its run id, else its
    parent's, and `attrs` its first attributes."""
    if not _on:
        return OFF
    return Span(name, run, attrs)


def count(name: str, n=1) -> None:
    """Add `n` to the counter `name` of this thread's innermost open span
    (nothing while tracing is off or no span is open)."""
    if _on:
        stack = _stack()
        if stack:
            stack[-1].count(name, n)


def new_run() -> int:
    """A fresh engine id for run ids."""
    return next(_runs)


def records() -> list:
    """The kept spans in the order they ended, as dicts: name, id, parent
    (None at the top), run, t0 and t1 (`time.perf_counter_ns()`), attrs."""
    with _lock:
        kept = list(_store)
    return [{"name": s.name, "id": s.id, "parent": s.parent, "run": s.run,
             "t0": s.t0, "t1": s.t1, "attrs": dict(s.attrs)}
            for s in kept]


def dropped() -> int:
    """Spans that ended while the store was full."""
    return _dropped


def clear() -> None:
    """Forget the kept spans and the dropped count."""
    global _dropped
    with _lock:
        _store.clear()
        _dropped = 0

