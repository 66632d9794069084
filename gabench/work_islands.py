"""The work of an island ring's generation, counted from the shapes alone:
`gabench.work`'s yardstick for the K2 form, a replica's islands one
thread-block cluster with the ring inside the launch.

Everything `work.py` defines holds here; three names change.  A unit is
`gens_per_epoch` generations, the island's state on chip across its
migration intervals; the form is "resident"; and the least time of a run
counts R x I islands, each a population of `island_ops` with its
migrations.  Bytes are the islands' state read once and written once a
unit: the ring moves each elite through distributed shared memory, which
adds no bytes of HBM.  The configuration file names this module
(`"work"`).
"""

from __future__ import annotations

import numpy as np

from gabench.work import *  # noqa: F401,F403
from gabench.work import (MAX_SM_CLOCK_HZ, bound, ffm_ops, ffm_sass_ops,
                          island_ops)


def form(shape) -> str:
    """K2's resident form: one island a block, one replica a cluster."""
    return "resident"


def launch_unit(shape, spec: dict) -> int:
    """Generations an island's state stays on chip between one read and
    one write of it: a resident launch's, `gens_per_epoch`."""
    return spec["gens_per_epoch"]


def _unit_ops(shape, gens: int) -> np.ndarray:
    """One island's operations in a unit of `gens` generations, with a
    migration every `migrate_every`."""
    return island_ops(shape, gens, gens, gens // shape.migrate_every)


def generations_bound(shape, replicas: int, gens: int, unit: int,
                      clock_hz: float = MAX_SM_CLOCK_HZ) -> dict:
    """Least time of `gens` generations of `replicas` replicas of
    `shape.n_islands` islands in launch units of `unit` generations.
    Bytes: each island's state read once and written once a unit.
    Operations: a unit's as `island_ops` counts them with the unit's
    migrations, each evaluation's objective counted as its SASS
    (`ffm_sass_ops`), as `work.generations_bound` counts them."""
    islands = replicas * shape.n_islands
    full, rem = divmod(gens, unit)
    nbytes = (full + (rem > 0)) * islands * 2 * 4 * shape.state_words
    f32, slow = ffm_ops(shape.problem, shape.v)
    per_eval = ffm_sass_ops(shape.problem, shape.v) - np.array([0.0, f32,
                                                                 slow])
    ops = full * _unit_ops(shape, unit) + gens * shape.n * per_eval
    if rem:
        ops = ops + _unit_ops(shape, rem)
    return bound(nbytes, islands * ops, clock_hz)
