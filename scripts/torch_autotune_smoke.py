#!/usr/bin/env python
"""Smoke of the PyTorch port's autotuner: sweep, persist, consume.

Runs a tiny autotune sweep on one device (the card by default, `--device
cpu` for the CPU) over the spec shapes of the JAX package's
scripts/autotune_smoke.py, writes the cost table to --out, then asserts
the loop closes:

  * the sweep measured > 0 points, among them a resident-free one
    (migration="none" folding past migrate_every with no ring) and a
    streamed one (an 8-island spec under a planning `smem_budget` that
    refuses its resident epoch);
  * an engine pointed at the written table plans with
    plan_source="measured", and its result is bit-identical to the
    heuristic plan's;
  * with the table off the plan is exactly the heuristic candidate.

The JAX smoke runs on 8 fake XLA host devices only to host its platform:
its sweep passes no mesh, so this one needs none.  Its last check, that
the committed benchmarks/autotune_snapshot_fake8.json still steers the
planner, is left out: that snapshot holds the JAX package's rates on
another platform, which do not transfer.

    PYTHONPATH=src python scripts/torch_autotune_smoke.py \\
        [--device cpu] --out artifacts/torch_autotune_table.json
"""

import argparse
import dataclasses
import os
import sys

# this smoke pins every table explicitly; never consume an ambient one
os.environ["REPRO_GA_COST_TABLE"] = "off"

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import ga                              # noqa: E402
from repro_torch.autotune import sweep                  # noqa: E402
from repro_torch.kernels import ga_step as K            # noqa: E402

# the JAX smoke's shape (n=16, m=16, islands=2, E=4, gens_per_epoch=2*E)
BASE = dict(n=16, bits_per_var=8, mode="arith", mutation_rate=0.02, seed=1,
            generations=8, n_islands=2, migrate_every=4, gens_per_epoch=8)


def _plan(spec, options):
    return ga.Engine(spec, "fused-islands", options=options).backend \
        .topology.plan


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, the default) or 'cpu'")
    ap.add_argument("--out", default="artifacts/torch_autotune_table.json")
    args = ap.parse_args(argv)
    opts = ga.EngineOptions(device=args.device, cost_table=False)

    specs = [ga.GASpec(problem=p, **BASE) for p in ("F3", "rastrigin:4")]
    # resident-free coverage: no ring exchange, the whole epoch in one launch
    free_spec = ga.GASpec(problem="F3", migration="none",
                          **{**BASE, "generations": 16,
                             "gens_per_epoch": 16})
    table = sweep(specs + [free_spec], backend="fused-islands",
                  options=opts, log=print)
    # streamed coverage: an 8-island spec under a budget of 5 islands' K2
    # blocks -> candidates [streamed, gridded]
    stream_spec = ga.GASpec(problem="F3", **{**BASE, "n_islands": 8})
    cfg = stream_spec.ga_config()
    budget = K.resident_smem_bytes(cfg, 5)
    sweep([stream_spec], backend="fused-islands",
          options=dataclasses.replace(opts, smem_budget=budget),
          table=table, log=print)
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    table.save(args.out)
    print(f"wrote {len(table)} measured point(s) -> {args.out}")

    assert len(table) > 0, "sweep measured nothing"
    modes = {e["mode"] for e in table.entries()}
    assert "resident-free" in modes, f"no resident-free point (got {modes})"
    assert "streamed" in modes, f"no streamed point (got {modes})"

    # the planner consumes the table it just wrote (path form, trusted load)
    measured = dataclasses.replace(opts, cost_table=args.out)
    plan = _plan(specs[0], measured)
    assert plan["plan_source"] == "measured", plan
    assert plan.get("plan_gens_per_s"), plan
    print(f"measured plan: {plan['mode']} "
          f"({plan['plan_gens_per_s']:.1f} gens/s expected)")

    # measured and heuristic plans differ only in launch shape, never in
    # results
    out_meas = ga.solve(specs[0], backend="fused-islands", options=measured)
    out_heur = ga.solve(specs[0], backend="fused-islands", options=opts)
    assert out_meas.best_fitness == out_heur.best_fitness, \
        (out_meas.best_fitness, out_heur.best_fitness)
    assert (out_meas.best_x == out_heur.best_x).all()
    assert out_heur.telemetry.plan.source == "heuristic"

    # no table -> exactly the heuristic candidate
    eng = ga.Engine(specs[0], "fused-islands", options=opts)
    heur = eng.backend.topology.epoch_candidates()[0]
    got = {k: eng.backend.topology.plan[k] for k in heur}
    assert got == heur, (got, heur)
    print("autotune smoke OK")


if __name__ == "__main__":
    main()
