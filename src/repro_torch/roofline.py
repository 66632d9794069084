"""Measured roofline rows of the GA planner (the JAX package's
`repro.roofline.ga_measured_points`).

The JAX module's HLO analysis (FLOPs, bytes and collectives of a lowered
cell against TPU peaks) has no counterpart here yet; what is here needs
no compiler: the measured points of an autotune `CostTable`.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


def ga_measured_points(table) -> List[Dict]:
    """Flatten a `repro_torch.autotune.CostTable` into report rows: one
    row per (plan point, gens_per_launch) with `frac_of_best`, the
    fraction of the best throughput any epoch mode demonstrated for the
    same spec family (1.0 marks the winner the measured planner picks)."""
    rows = list(table.entries())

    # family = everything identifying the spec except the competing
    # mode/executor and the launch fold
    def fam(r):
        return (r["stage"], r["migration"], r["n"], r["i_local"], r["c"],
                r["shards"], r["E"])
    best: Dict[Tuple, float] = {}
    for r in rows:
        best[fam(r)] = max(best.get(fam(r), 0.0), r["gens_per_s"])
    return [{**r, "frac_of_best":
             r["gens_per_s"] / best[fam(r)] if best[fam(r)] else 0.0}
            for r in rows]
