"""Typed run telemetry: how a run executed, in three facets.

  * `plan: PlanInfo` — the epoch-plan decision of an island-ring run
    (mode, provenance, fallback reason, launch fold shape, streamed tile,
    the shared memory one block of the plan takes);
  * `topology: TopologyInfo` — executor × topology names, the island
    count, the mesh shards it spans, and the launches and migrations the
    run made;
  * `per_repeat: ReplicaStats | None` — per-replica best/trajectory arrays
    when the run stacked `n_repeats` replicas.

`resumed_from` marks the first chunk of a run resumed from a checkpoint.

The fields are the JAX package's that the port's topologies fill, under
the same names, so a consumer reads both packages the same way; the one
byte field is `smem_estimate_bytes` where the JAX package has its VMEM
estimate; `population_bits`, `pair_threads` and `clusters_at_once` are
the port's own.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

TELEMETRY_VERSION = 1


@dataclasses.dataclass
class PlanInfo:
    """The epoch-plan decision a segment ran under.

    mode: "gridded" | "resident" | "resident-sharded" | "resident-free" |
    "streamed" | "-" (no plan: single topology).  source: "heuristic" | "measured" | "forced" |
    "-".
    fallback carries the Hopper limit that refused the resident shape (set
    for the gridded fallback and for the streamed lane, which exists
    because of that refusal).  tile_islands is the streamed mode's island
    tile; lane the selection lane the kernels ran; smem_estimate_bytes the
    dynamic shared memory one thread block of the plan's kernel takes, and
    population_bits the width of a population word there (16 in K2's
    layout at c <= 16, else 32) and pair_threads its threads a pair (2 in
    K2's two-lane form, `kernels.ga_step.pair_threads`, else 1);
    clusters_at_once the K2 clusters the card holds at once (a ring plan
    on a card); gens_per_s the measured rate
    that justified a "measured" choice."""

    mode: str = "-"
    source: str = "-"
    fallback: Optional[str] = None
    epochs_per_launch: int = 1
    gens_per_launch: int = 1
    tile_islands: Optional[int] = None
    lane: str = "-"
    smem_estimate_bytes: Optional[int] = None
    gens_per_s: Optional[float] = None
    population_bits: Optional[int] = None
    clusters_at_once: Optional[int] = None
    pair_threads: Optional[int] = None

    @classmethod
    def from_plan(cls, plan: Dict[str, Any]) -> "PlanInfo":
        """Build from an `IslandRingTopology._epoch_plan` dict."""
        return cls(mode=plan.get("mode", "-"),
                   source=plan.get("plan_source", "heuristic"),
                   fallback=plan.get("fallback"),
                   epochs_per_launch=int(plan.get("epochs_per_launch", 1)),
                   gens_per_launch=int(plan.get("gens_per_launch", 1)),
                   tile_islands=plan.get("tile_islands"),
                   lane=plan.get("lane", "-"),
                   smem_estimate_bytes=plan.get("smem_estimate_bytes"),
                   gens_per_s=plan.get("plan_gens_per_s"),
                   population_bits=plan.get("population_bits"),
                   clusters_at_once=plan.get("clusters_at_once"),
                   pair_threads=plan.get("pair_threads"))


@dataclasses.dataclass
class TopologyInfo:
    """How the run was laid out and what it counted."""

    executor: str = "-"
    topology: str = "-"
    n_islands: int = 1
    n_shards: int = 1          # mesh shards the island axis spans
    sharded: bool = False      # the run had a mesh (even of one shard)
    # runner calls (K1 wrapper calls on fused; the kernels they launched
    # are the `topology.segment` span's `kernel_launches.*` counters,
    # `repro_torch.trace`)
    launches: int = 0
    migrations: int = 0
    # generations represented by ONE trajectory sample (resident/streamed
    # launches fold many generations per sample)
    telemetry_unit_gens: int = 1


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
    plan: PlanInfo = dataclasses.field(default_factory=PlanInfo)
    topology: TopologyInfo = dataclasses.field(default_factory=TopologyInfo)
    per_repeat: Optional[ReplicaStats] = None
    problem: Optional[str] = None
    n_vars: Optional[int] = None
    resumed_from: Optional[int] = None   # ckpt step (gens) this segment
                                         # resumed from, first chunk only

    def job_view(self) -> "RunTelemetry":
        """Plan/topology facets without the per-repeat arrays — what a
        packed job's telemetry carries after its slots are sliced out."""
        return dataclasses.replace(self, per_repeat=None)
