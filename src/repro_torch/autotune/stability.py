"""Repeat-until-stable replay timing.

One micro-benchmark sample is worthless on a shared host: the first call
pays compilation, the next few pay cache warmup, and any call can eat a
scheduler hiccup.  `replay_until_stable` runs the workload until the
coefficient of variation (std/mean) over a trailing window of repetitions
drops under a threshold — the replay-stability check from trace-replay
cost models — and reports the windowed mean plus whether stability was
actually reached before the repetition cap.

The clock is injectable (`timer=`), so tests drive the whole convergence
logic with a deterministic fake timer and zero real sleeping.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Replay:
    """Outcome of one replay-until-stable run (times are per-rep seconds;
    mean_s/cov describe the trailing window, not all reps)."""
    times: Tuple[float, ...]
    mean_s: float
    cov: float
    reps: int
    stable: bool


def _window_stats(times, window: int) -> Tuple[float, float]:
    tail = times[-window:]
    mean = sum(tail) / len(tail)
    if mean <= 0.0:
        return mean, math.inf
    var = sum((t - mean) ** 2 for t in tail) / len(tail)
    return mean, math.sqrt(var) / mean


def replay_until_stable(fn: Callable[[], object], *,
                        warmup: int = 1,
                        min_reps: int = 3,
                        max_reps: int = 16,
                        cov_threshold: float = 0.10,
                        window: Optional[int] = None,
                        timer: Callable[[], float] = time.perf_counter,
                        ) -> Replay:
    """Time `fn()` until the trailing-window CoV is <= cov_threshold.

    Runs `warmup` untimed calls, then timed repetitions: from `min_reps`
    onward the CoV over the last `window` (default: min_reps) samples is
    checked after every rep, and the first window that meets the threshold
    ends the run.  Hitting `max_reps` without converging still returns the
    trailing-window stats, flagged `stable=False` — callers decide whether
    an unstable measurement is worth persisting.
    """
    if min_reps < 2:
        raise ValueError("min_reps must be >= 2 (CoV of one sample)")
    if max_reps < min_reps:
        raise ValueError("max_reps must be >= min_reps")
    window = min_reps if window is None else window
    if window < 2:
        raise ValueError("window must be >= 2")

    for _ in range(warmup):
        fn()

    times = []
    while len(times) < max_reps:
        t0 = timer()
        fn()
        times.append(timer() - t0)
        if len(times) >= min_reps:
            mean, cov = _window_stats(times, window)
            if cov <= cov_threshold:
                return Replay(tuple(times), mean, cov, len(times), True)
    mean, cov = _window_stats(times, window)
    return Replay(tuple(times), mean, cov, len(times), False)
