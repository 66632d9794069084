"""The port's own spans (`repro_torch.trace`) for the metric readers.

A reader that reads them calls `enable()` when it is loaded, which turns
the port's recorder on with an empty store.  The harness loads readers
only in a traced run (`--trace 1`), and before it builds the system, so
an untraced run never records and a traced one records from its start.
Against a port without the recorder `enable` does nothing and `window`
gives no spans, so each reader reports nothing.

The readers' arithmetic takes a list of spans as `repro_torch.trace.
records()` gives them (dicts with name, id, parent, run, t0 and t1 in
`time.perf_counter_ns()`, attrs), so it can be fed without the port.
"""

from __future__ import annotations

import math

try:
    from repro_torch import trace as _trace
except ImportError:
    _trace = None

RUNS = ("engine.run", "engine.chunk")
GLOBAL_KERNELS = ("ga_ffm", "ga_best", "ga_generation:global")
BLOCK_KERNELS = ("ga_generation",)


def enable() -> None:
    if _trace is not None:
        _trace.clear()
        _trace.enable()


def window(rec, spans=None) -> list:
    """The spans that ended inside the window before the profiler started:
    after the set-up's first run or chunk (the jobs cell's warm job, a
    stream's first chunk) ended, and before the traced slice's start
    (`rec.slice.t0`, on the same host clock) where a slice started, since
    the profiler changes the host's speed.  `spans` defaults to the
    recorder's."""
    if spans is None:
        spans = _trace.records() if _trace is not None else []
    first = next((s for s in spans if s["name"] in RUNS), None)
    if first is None:
        return []
    sl = rec.slice
    cut = sl.t0 * 1e9 if sl is not None and sl.prof is not None else math.inf
    return [s for s in spans if first["t1"] < s["t1"] < cut]


def _ms(s) -> float:
    return (s["t1"] - s["t0"]) / 1e6


def per_run_ms(spans, name: str):
    """Mean over run ids of the milliseconds spent in spans `name`."""
    runs = {}
    for s in spans:
        if s["name"] == name:
            runs[s["run"]] = runs.get(s["run"], 0.0) + _ms(s)
    return sum(runs.values()) / len(runs) if runs else None


def segments(spans) -> list:
    """The `topology.segment` spans, in the order they started."""
    return sorted((s for s in spans if s["name"] == "topology.segment"),
                  key=lambda s: s["t0"])


def host_us_per_launch(spans, kernels):
    """Microseconds of `executor.launch` spans under the segments, over the
    launches of `kernels` the segments counted."""
    segs = segments(spans)
    ids = {s["id"] for s in segs}
    host_ms = sum(_ms(s) for s in spans
                  if s["name"] == "executor.launch" and s["parent"] in ids)
    n = sum(s["attrs"].get("kernel_launches." + k, 0)
            for s in segs for k in kernels)
    return 1e3 * host_ms / n if n > 0 else None


def boundary_idle_share(spans):
    """100 x the device's time between consecutive segments over that time
    plus the segments' own device time, from the segments' timing events
    (`gap_before_ms` of every segment after the first, `device_ms` of
    all)."""
    segs = [s for s in segments(spans) if "device_ms" in s["attrs"]]
    gaps = [s["attrs"]["gap_before_ms"] for s in segs[1:]
            if "gap_before_ms" in s["attrs"]]
    busy = sum(s["attrs"]["device_ms"] for s in segs)
    if not gaps or busy <= 0:
        return None
    return 100.0 * sum(gaps) / (sum(gaps) + busy)
