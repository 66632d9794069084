"""The work of an island ring's generation on CEC 2017 F5's form (the
shifted and rotated Rastrigin), counted from the shapes alone: the
yardstick of a configuration whose islands K2's rastrigin_sr build runs.

Everything `work_islands.py` defines holds here but the form, "rotated",
and the least time: the island cell's operations with the problem read as
classic Rastrigin, plus the shift, scale and rotation of every evaluation,
2V^2 + V + 1 float32 operations (V subtractions and V products for the
shift and scale, V^2 products and V(V - 1) sums for the rotation, and the
bias).  Bytes are the island cell's: the rotation's data is read from
shared memory, and once a launch from HBM (3,720 bytes a block at V = 30,
not counted).  The configuration file names this module (`"work"`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gabench import work_islands as WI
from gabench.work import bound
from gabench.work_islands import *  # noqa: F401,F403
from gabench.work_islands import MAX_SM_CLOCK_HZ


def form(shape) -> str:
    """K2's resident form on its rastrigin_sr build."""
    return "rotated"


def rotation_ops(v: int) -> int:
    """float32 operations of one evaluation's shift, scale and rotation,
    and F5's bias: 2V^2 + V + 1."""
    return 2 * v * v + v + 1


def generations_bound(shape, replicas: int, gens: int, unit: int,
                      clock_hz: float = MAX_SM_CLOCK_HZ) -> dict:
    """Least time of `gens` generations of `replicas` replicas of
    `shape.n_islands` islands in launch units of `unit` generations:
    `work_islands.generations_bound` with the problem read as
    "rastrigin", plus `rotation_ops` float32 operations for each of the
    generations' R x I x N evaluations."""
    base = WI.generations_bound(dataclasses.replace(shape,
                                                    problem="rastrigin"),
                                replicas, gens, unit, clock_hz)
    ops = np.array([base["ops"][k] for k in ("int32", "fp32", "slow")])
    evals = gens * replicas * shape.n_islands * shape.n
    ops[1] += evals * rotation_ops(shape.v)
    return bound(base["bytes"], ops, clock_hz)
