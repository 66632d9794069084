"""How `correct` is decided: the program's output against the plain
reference's, word for word.

The port's contract is bit-exactness with the reference semantics (the
GA's uint32 state and its float32 fitness evaluated in a fixed order), so
every number compared here counts differences and has the limit 0: the
state words (population and the three LFSR banks, and the generation
counter), the replicas whose best value or best chromosome differ, and
the trajectory samples (best and mean) that differ.  Floats are compared
as their bit patterns.  `checked` counts the jobs or chunks replayed and
must reach the least the mix asks for.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class Out(NamedTuple):
    """What one job or chunk of the system under test produced."""

    state: Optional[tuple]      # (x, sel, cross, mut, k) tensors, or None
    best: np.ndarray            # float32 [R]
    best_x: np.ndarray          # uint32 [R, V]
    traj_best: np.ndarray       # float32 [R, T]
    traj_mean: np.ndarray       # float32 [R, T]
    gens: int


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _words(t) -> torch.Tensor:
    return t.to(torch.int32)


def differences(ref, out: Out) -> dict:
    """Counts of what differs between a reference `Run` and an `Out`."""
    state = 0
    for a, b in zip(ref.state, out.state):
        a, b = _words(a), _words(b).to(a.device)
        state += (int((a != b).sum()) if a.shape == b.shape
                  else max(a.numel(), b.numel()))
    rb, rx = _bits(ref.best.cpu().numpy()), \
        ref.best_x.cpu().numpy().view(np.uint32)
    ob, ox = _bits(out.best), np.asarray(out.best_x, np.uint32)
    if rb.shape == ob.shape and rx.shape == ox.shape:
        best = int(((rb != ob) | (rx != ox).any(axis=-1)).sum())
    else:
        best = max(rb.size, ob.size)
    traj = 0
    for r, o in ((ref.traj_best, out.traj_best),
                 (ref.traj_mean, out.traj_mean)):
        r, o = _bits(r.cpu().numpy()), _bits(o)
        traj += int((r != o).sum()) if r.shape == o.shape \
            else max(r.size, o.size)
    return {"state_words_differing": state, "best_differing": best,
            "traj_differing": traj}


LIMITS = {"state_words_differing": 0, "best_differing": 0,
          "traj_differing": 0}


def verdict(diffs: list, checked: int, least_checked: int,
            failed: int) -> tuple:
    """(correct, numbers): each number with its limit, in the order they
    are printed; `failed` units (raised or never came back) fail the run."""
    total = {k: sum(d[k] for d in diffs) for k in LIMITS}
    numbers = {k: {"value": v, "limit": LIMITS[k], "rule": "<="}
               for k, v in total.items()}
    numbers["checked"] = {"value": checked, "limit": least_checked,
                          "rule": ">="}
    numbers["failed"] = {"value": failed, "limit": 0, "rule": "<="}
    ok = all(n["value"] >= n["limit"] if n["rule"] == ">="
             else n["value"] <= n["limit"] for n in numbers.values())
    return ok, numbers
