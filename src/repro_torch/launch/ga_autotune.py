"""Autotune launcher — measure epoch-plan costs and persist the table.

    # sweep the default shapes on the card into the per-host cache
    PYTHONPATH=src python -m repro_torch.launch.ga_autotune

    # a wider sweep, written to an explicit file
    PYTHONPATH=src python -m repro_torch.launch.ga_autotune \
        --problems F3,rastrigin:4 --islands 8 --gens-per-epoch 16,32,64 \
        --out artifacts/cost_table.json

    # the same machinery on the CPU (the kernels' plain versions)
    PYTHONPATH=src python -m repro_torch.launch.ga_autotune --device cpu \
        --out /tmp/cpu_table.json

For every (problem, gens_per_epoch, migration) shape this times each
feasible epoch mode — gridded, resident, resident-sharded (with --mesh),
resident-free (migration=none), streamed (past 8 islands a shard, where
the resident epoch does not fit the card) — by forcing it with `plan_override` and replaying segments until the
timing is stable.  The resulting `repro_torch.autotune.CostTable` is what
`Engine(..., options=EngineOptions(cost_table=...))`, the serving
scheduler and `ga_run --cost-table` consume: among the feasible modes the
planner then picks the best *measured* gens/s instead of the static
heuristic.  By default the table lands in the per-host cache
(`repro_torch.autotune.default_table_path()`), where every later engine
in this environment discovers it; `--merge` folds the new points into an
existing table instead of replacing it.

The port of the JAX package's `repro.launch.ga_autotune`, with the same
grid and flags; `--device` picks the card (the default) or the CPU, and
`--mesh` the devices of that kind the sweep shards over.
"""

from __future__ import annotations

import argparse


def build_specs(problems, *, n, bits_per_var, n_islands, migrate_every,
                gens_per_epoch, migrations, seed=1):
    """The sweep grid: one GASpec per (problem, gpe, migration) point."""
    from repro_torch import ga
    specs = []
    for prob in problems:
        for gpe in gens_per_epoch:
            for migration in migrations:
                specs.append(ga.GASpec(
                    problem=prob, n=n, bits_per_var=bits_per_var,
                    mode="arith", seed=seed, generations=gpe,
                    n_islands=n_islands, migrate_every=migrate_every,
                    gens_per_epoch=gpe, migration=migration))
    return specs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--problems", default="F3,rastrigin:4",
                    help="comma list of registered problems to sweep")
    ap.add_argument("--n", type=int, default=32, help="population per island")
    ap.add_argument("--m", type=int, default=20,
                    help="chromosome bits (c = m/2 bits per variable)")
    ap.add_argument("--islands", type=int, default=8)
    ap.add_argument("--migrate-every", type=int, default=16)
    ap.add_argument("--gens-per-epoch", default="16,32",
                    help="comma list of epoch folds to measure")
    ap.add_argument("--migration", default="both",
                    choices=["ring", "none", "both"],
                    help="which migration regimes to cover (none adds the "
                         "resident-free mode to the sweep)")
    ap.add_argument("--backend", default="fused-islands")
    ap.add_argument("--mesh", default=None,
                    help="also measure sharded plans: 'auto', '4', '2x4', "
                         "... (devices of --device's kind)")
    ap.add_argument("--reps", type=int, default=8,
                    help="max replay repetitions per candidate")
    ap.add_argument("--cov", type=float, default=0.25,
                    help="coefficient-of-variation stability threshold")
    ap.add_argument("--out", default=None,
                    help="table path (default: the per-host cache file)")
    ap.add_argument("--merge", action="store_true",
                    help="fold new points into an existing table at --out "
                         "instead of replacing it")
    ap.add_argument("--seed", type=int, default=1)
    from repro_torch.ga.options import EngineOptions
    EngineOptions.add_cli_args(ap)   # --device etc. (the sweep itself
    args = ap.parse_args(argv)       # forces cost_table/plan_override)

    from repro_torch.autotune import (CostTable, default_table_path,
                                      host_fingerprint, sweep)
    from repro_torch.launch.mesh import mesh_from_args

    problems = [p for p in args.problems.split(",") if p]
    gpes = [int(g) for g in args.gens_per_epoch.split(",")]
    migrations = (["ring", "none"] if args.migration == "both"
                  else [args.migration])
    specs = build_specs(problems, n=args.n, bits_per_var=args.m // 2,
                        n_islands=args.islands,
                        migrate_every=args.migrate_every,
                        gens_per_epoch=gpes, migrations=migrations,
                        seed=args.seed)

    mesh = mesh_from_args(args, ap)

    out = args.out or default_table_path()
    table = None
    if args.merge:
        table = CostTable.load(out)
        if table is not None:
            print(f"merging into {len(table)} existing point(s) from {out}")
    if table is None:
        table = CostTable(host=host_fingerprint())

    options = EngineOptions.from_args(args, mesh=mesh)
    print(f"sweeping {len(specs)} spec(s) x feasible modes "
          f"(backend={args.backend}, device={options.torch_device()})")
    sweep(specs, backend=args.backend, options=options, table=table,
          max_reps=args.reps, cov_threshold=args.cov, log=print)
    table.save(out)
    print(f"wrote {len(table)} measured point(s) -> {out}")
    print("engines discover it automatically when this is the per-host "
          "cache; otherwise set REPRO_GA_COST_TABLE or pass cost_table=.")


if __name__ == "__main__":
    main()
