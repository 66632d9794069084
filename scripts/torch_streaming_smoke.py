#!/usr/bin/env python
"""Smoke of the streamed epoch mode of the PyTorch port at 8 islands:
plan, stream, bit-match.

Runs an 8-island F3 spec whose resident epoch exceeds a planning
shared-memory budget (`EngineOptions.smem_budget`, sized to 5 islands'
K2 blocks), so the planner's heuristic picks the STREAMED mode: one K3
launch a 2 migration intervals with the ring inside, where the card's own
limits alone plan resident (K2) at 8 islands or fewer.  Asserts:

  * the plan really is streamed, at the port's tile (1 on the CPU, where
    the plain version ignores the tile; on a card the planner's
    `streamed_tile_islands` for the card's capacity), with the one K3
    block's shared memory within the budget;
  * the result is bit-identical to the `islands` reference backend — best
    fitness, best chromosome, and the best-trajectory at launch
    boundaries (a streamed launch folds several migration intervals, so
    the trajectory is one sample a launch);
  * a pinned `stream_tile_islands=1` run bit-matches too (the tile is a
    launch shape, never a result);
  * `plan_override="streamed"` without the budget, on a spec that fits
    resident, raises with the planner's hint.

The spec and the four assertions of the JAX package's
scripts/streaming_smoke.py, whose budget is VMEM bytes and whose tile is
the largest that fits the budget double-buffered.

    PYTHONPATH=src python scripts/torch_streaming_smoke.py [--device cpu]
"""

import argparse
import dataclasses
import os
import sys

# this smoke pins every plan explicitly; never consume an ambient table
os.environ["REPRO_GA_COST_TABLE"] = "off"

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np                                      # noqa: E402

from repro_torch import ga                              # noqa: E402
from repro_torch.kernels import ga_step as K            # noqa: E402

SPEC = ga.GASpec(problem="F3", n=16, bits_per_var=8, mode="arith",
                 mutation_rate=0.02, seed=1, generations=16, n_islands=8,
                 migrate_every=4, gens_per_epoch=8)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, the default) or 'cpu'")
    args = ap.parse_args(argv)
    opts = ga.EngineOptions(device=args.device, cost_table=False)
    ref = ga.solve(SPEC, backend="islands", options=opts)

    probe = ga.Engine(SPEC, "fused-islands", options=opts)
    topo = probe.backend.topology
    assert topo.plan["mode"] == "resident", topo.plan
    # below the 8-island epoch, above one K3 block
    budget = K.resident_smem_bytes(topo.cfg, 5)
    bopts = dataclasses.replace(opts, smem_budget=budget)
    res = ga.solve(SPEC, backend="fused-islands", options=bopts)

    plan = res.telemetry.plan
    tile = K.streamed_tile_islands(topo.cfg, SPEC.n_repeats, SPEC.n_islands,
                                   probe.device, budget)
    assert plan.mode == "streamed", plan
    assert plan.tile_islands == tile, (plan, tile)
    assert plan.smem_estimate_bytes <= budget, plan
    print(f"streamed plan on {probe.device}: tile={plan.tile_islands}, "
          f"{plan.smem_estimate_bytes} B a K3 block (budget {budget} B); "
          f"fallback: {plan.fallback}")

    assert res.best_fitness == ref.best_fitness, \
        (res.best_fitness, ref.best_fitness)
    assert np.array_equal(res.best_x, ref.best_x)
    # islands samples once per interval, streamed once per (multi-interval)
    # launch, the best over its intervals: fold islands' samples at the
    # launch boundaries
    stride = (res.telemetry.topology.telemetry_unit_gens
              // ref.telemetry.topology.telemetry_unit_gens)
    fold = np.min if SPEC.minimize else np.max
    assert np.array_equal(res.traj_best, fold(
        ref.traj_best.reshape(-1, stride), axis=1)), \
        (res.traj_best, ref.traj_best)
    print(f"bit-identical to islands reference: best={res.best_fitness}")

    pinned = ga.solve(SPEC, backend="fused-islands",
                      options=dataclasses.replace(bopts,
                                                  stream_tile_islands=1))
    assert pinned.telemetry.plan.tile_islands == 1, pinned.telemetry.plan
    assert pinned.best_fitness == ref.best_fitness
    assert np.array_equal(pinned.best_x, ref.best_x)
    print("pinned tile=1 bit-identical too")

    try:
        ga.solve(SPEC, backend="fused-islands",
                 options=dataclasses.replace(opts, plan_override="streamed"))
    except ValueError as e:
        assert "smem_budget" in str(e), e
        print(f"fitting spec refuses forced streaming: {e}")
    else:
        raise AssertionError("plan_override='streamed' on a fitting spec "
                             "should raise")
    print("streaming smoke OK")


if __name__ == "__main__":
    main()
