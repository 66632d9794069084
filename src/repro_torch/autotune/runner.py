"""The autotune sweep: measure each feasible epoch-plan candidate.

For every spec in a sweep, the runner builds a probe engine (cost table
DISABLED, so measurement never depends on prior measurements), asks the
island topology for its feasible plan candidates — the exact list the
planner itself enumerates, so table points and planner queries cannot
drift apart — then times each candidate by forcing it with
`plan_override` and replaying one `segment` worth of generations until
the timing is stable (`stability.replay_until_stable`).  Results land in
a `table.CostTable` keyed by `ga.compile_cache.plan_point`.

What a replay times is what a run pays: the host clock
(`time.perf_counter`) around `segment` followed by
`torch.cuda.synchronize`, so the host work between launches — the gridded
plan's migration in PyTorch, the segment's read-back — is weighed with
the kernels, not only the device time a launch takes.  The first call,
which builds the kernels on a fresh host, stays out of the replay window.
Every replay starts from the same initial state: the runners never write
into their input tensors (each kernel wrapper writes fresh outputs, and
the plain operators and migration are functional), so the state needs no
copy between replays.

The sweep runs on the options' device, and over its mesh when the options
hold one: a sweep on a mesh measures the sharded candidates
(resident-sharded, the sharded gridded and streamed plans) under points
whose `shards` is the mesh's count.  A candidate that cannot launch there
raises.  A table only ever chooses among candidates the engine's
device can run: it never moves a run to another device or to a plain
version.

This module imports `repro_torch.ga` lazily inside functions:
`repro_torch.autotune.table` must stay importable from `ga/backends.py`
without a cycle.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

from repro_torch.autotune.stability import Replay, replay_until_stable
from repro_torch.autotune.table import CostTable, host_fingerprint


def _probe_options(options, *, plan_override=None, sel_lane=None):
    """The engine options a probe runs under: the caller's options (or the
    defaults) with the cost table DISABLED — a measurement must never
    depend on prior measurements — and optionally one mode and/or
    selection lane forced.  The rest rides along: an `smem_budget` makes
    the streamed mode a candidate at 8 islands or fewer."""
    from repro_torch.ga.options import resolve_options
    base = resolve_options(options)
    if sel_lane is None:
        sel_lane = base.sel_lane
    return dataclasses.replace(base, cost_table=False,
                               plan_override=plan_override,
                               sel_lane=sel_lane)


def sweep_lanes(spec) -> List[str]:
    """The selection lanes a sweep measures for `spec`: a pinned lane
    alone; for "auto" every lane the fused kernels could run (onehot under
    its N cap, gather on any power-of-two N), so the planner's cross-lane
    argmax has data on both sides.  On the card both lanes are one indexed
    read, so their rates differ by noise; the grid is the JAX package's so
    a table crosses between the packages."""
    from repro_torch.core.ga import ONEHOT_MAX_N
    if spec.sel_lane != "auto":
        return [spec.sel_lane]
    lanes = []
    if spec.n <= ONEHOT_MAX_N:
        lanes.append("onehot")
    if spec.n & (spec.n - 1) == 0:
        lanes.append("gather")
    return lanes or [spec.resolved_sel_lane]


def plan_candidates(spec, *, backend: str = "auto", options=None,
                    sel_lane=None) -> List[Dict[str, Any]]:
    """The feasible epoch-plan candidates an engine for `spec` would weigh
    (heuristic choice first), or [] for backends with no island planner.
    `sel_lane` forces the probe's selection lane (the candidates carry it
    in their "lane" field)."""
    from repro_torch import ga
    eng = ga.Engine(spec, backend,
                    options=_probe_options(options, sel_lane=sel_lane))
    topo = getattr(eng.backend, "topology", None)
    if topo is None or not hasattr(topo, "epoch_candidates"):
        return []
    return topo.epoch_candidates()


def measure_candidate(spec, mode: str, *, backend: str = "auto",
                      options=None, sel_lane: Optional[str] = None,
                      warmup: int = 1, min_reps: int = 3, max_reps: int = 8,
                      cov_threshold: float = 0.25,
                      timer: Callable[[], float] = time.perf_counter,
                      ) -> Dict[str, Any]:
    """Force one epoch mode via plan_override (and optionally one selection
    lane) and time a segment of `gens_per_epoch` generations until
    replay-stable.  Returns the table row: {"point", "gens_per_launch",
    "gens_per_s", "replay"}."""
    import torch

    from repro_torch import ga
    from repro_torch.ga import compile_cache as CC

    eng = ga.Engine(spec, backend,
                    options=_probe_options(options, plan_override=mode,
                                           sel_lane=sel_lane))
    topo = eng.backend.topology
    state = eng.init_state()
    seg_gens = max(spec.gens_per_epoch, spec.migrate_every)

    def once():
        seg = eng.backend.segment(state, seg_gens)
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        return seg

    first = once()          # the kernels' build and first launch, untimed
    replay = replay_until_stable(
        once, warmup=max(0, warmup - 1), min_reps=min_reps,
        max_reps=max_reps, cov_threshold=cov_threshold, timer=timer)
    point = CC.plan_point(spec, executor=topo.executor.name,
                          mode=topo.plan["mode"], n_shards=topo.n_shards,
                          lane=topo.plan.get("lane"))
    return {"point": point,
            "gens_per_launch": topo.plan["gens_per_launch"],
            "gens_per_s": first.gens / replay.mean_s,
            "replay": replay}


def sweep(specs: Iterable, *, backend: str = "auto", options=None,
          table: Optional[CostTable] = None,
          warmup: int = 1, min_reps: int = 3, max_reps: int = 8,
          cov_threshold: float = 0.25,
          timer: Callable[[], float] = time.perf_counter,
          log: Optional[Callable[[str], None]] = None) -> CostTable:
    """Measure every feasible candidate of every spec into one CostTable
    (reuses `table` when given, so sweeps accumulate across invocations).
    The streamed mode is a candidate only where the resident epoch does
    not fit the card (past 8 islands) or the options' `smem_budget`, as
    the planner offers it.  The table's point does not key on the budget:
    a budget changes which candidates exist, not a candidate's rate."""
    table = CostTable(host=host_fingerprint()) if table is None else table
    for spec in specs:
        measured_keys = set()
        for lane in sweep_lanes(spec):
            cands = plan_candidates(spec, backend=backend, options=options,
                                    sel_lane=lane)
            if not cands:
                if log:
                    log(f"skip {spec.problem or 'blackbox'}: no island "
                        f"planner for backend {backend!r}")
                continue
            for cand in cands:
                row = measure_candidate(
                    spec, cand["mode"], backend=backend, options=options,
                    sel_lane=lane, warmup=warmup, min_reps=min_reps,
                    max_reps=max_reps, cov_threshold=cov_threshold,
                    timer=timer)
                # a lane-forced probe that fell back to a non-fused executor
                # produces the same point for every lane — measure it once
                key = (tuple(sorted(row["point"].items())),
                       row["gens_per_launch"])
                if key in measured_keys:
                    continue
                measured_keys.add(key)
                rep: Replay = row["replay"]
                table.add(row["point"], row["gens_per_launch"],
                          row["gens_per_s"], reps=rep.reps, cov=rep.cov)
                if log:
                    stable = "stable" if rep.stable else "UNSTABLE"
                    log(f"  {spec.problem or 'blackbox'} n={spec.n} "
                        f"I={spec.n_islands} R={spec.n_repeats} "
                        f"gpe={spec.gens_per_epoch} {spec.migration} "
                        f"{cand['mode']:>16}/{cand.get('lane', '?')}: "
                        f"{row['gens_per_s']:9.1f} gens/s "
                        f"({rep.reps} reps, cov={rep.cov:.3f}, {stable})")
    return table


def estimate_gens_per_s(spec, table: Optional[CostTable], *,
                        backend: str = "auto",
                        options=None) -> Optional[float]:
    """What the measured planner expects for `spec` under `table` — the
    chosen plan's measured gens/s, or None when the table does not cover
    the spec (scheduler ordering treats those jobs as unknown-length)."""
    if table is None:
        return None
    from repro_torch import ga
    from repro_torch.ga.options import resolve_options
    try:
        eng = ga.Engine(spec, backend, options=dataclasses.replace(
            resolve_options(options), cost_table=table))
    except Exception:
        return None
    plan = getattr(getattr(eng.backend, "topology", None), "plan", None)
    if not plan:
        return None
    return plan.get("plan_gens_per_s")
