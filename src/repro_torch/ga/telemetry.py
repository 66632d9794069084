"""Typed run telemetry: how a run executed, in two facets.

  * `topology: TopologyInfo` — executor × topology names and the kernel
    launches the run made;
  * `per_repeat: ReplicaStats | None` — per-replica best/trajectory arrays
    when the run stacked `n_repeats` replicas.

The fields are the JAX package's that the single topology fills, under the
same names, so a consumer reads both packages the same way.  The epoch
plan and the island counters come with the topologies that fill them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

TELEMETRY_VERSION = 1


@dataclasses.dataclass
class TopologyInfo:
    """How the run was laid out and what it counted."""

    executor: str = "-"
    topology: str = "-"
    launches: int = 0          # fused executor: kernel launches made


@dataclasses.dataclass
class ReplicaStats:
    """Per-replica results of an `n_repeats`-stacked run (numpy arrays:
    best [R], best_x [R, V] uint32, traj_best/traj_mean [R, samples])."""

    best: Any = None
    best_x: Any = None
    traj_best: Any = None
    traj_mean: Any = None


@dataclasses.dataclass
class RunTelemetry:
    """Versioned telemetry for one segment / one engine result."""

    version: int = TELEMETRY_VERSION
    topology: TopologyInfo = dataclasses.field(default_factory=TopologyInfo)
    per_repeat: Optional[ReplicaStats] = None
    problem: Optional[str] = None
    n_vars: Optional[int] = None
