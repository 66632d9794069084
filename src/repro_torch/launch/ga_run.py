"""GA launcher — run the paper's experiments (and beyond) from the CLI.

    PYTHONPATH=src python -m repro_torch.launch.ga_run --problem F1 --n 32 \
        --m 26 --backend reference
    PYTHONPATH=src python -m repro_torch.launch.ga_run --problem F3 \
        --backend fused
    PYTHONPATH=src python -m repro_torch.launch.ga_run --problem rastrigin:8 \
        --n 1024 --m 32 --mode arith --islands 8 --repeats 16 \
        --gens-per-epoch 64 --k 1024 --backend fused-islands \
        --cost-table table.json
    PYTHONPATH=src python -m repro_torch.launch.ga_run --problem F3 \
        --backend eager --device cpu
    PYTHONPATH=src python -m repro_torch.launch.ga_run --problem F3 \
        --islands 8 --backend fused-islands --mesh auto --gens-per-epoch 16
    PYTHONPATH=src python -m repro_torch.launch.ga_run --problem F3 \
        --chunk 25 --metrics-port 9100   # scrape localhost:9100/metrics

`--problem` takes any registered problem name (repro_torch.core.fitness
.PROBLEMS: F1/F2/F3 pin the paper's two-variable layout; sphere/
rastrigin/rosenbrock/ackley take an optional `:V` variable-count suffix).
Any registered backend (reference | fused | islands | fused-islands |
eager | auto — each a topology × executor composition, eager a host loop)
runs any problem the capability matrix allows; the fused executors run the
hand-written CUDA kernels on the built-in problems.  `--gens-per-epoch`
folds generations inside one launch; `--cost-table` hands the island
planner a measured table (`repro_torch.launch.ga_autotune` writes one);
`--metrics-port` exposes live GA_METRICS as a Prometheus /metrics
endpoint while the run streams; `--kernel` is kept as a deprecated alias
for `--backend fused`.

`--mesh` shards the island axis over devices of `--device`'s kind
(repro_torch.launch.mesh.parse_mesh), the ring crossing shards through
the boundary elites, bit-identical to the run on one device.

The port of the JAX package's `repro.launch.ga_run`, with the same flags;
`--device` picks the card (the default) or the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    from repro_torch.launch.mesh import MESH_HELP, mesh_from_args

    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="F3",
                    help="registered problem, optionally 'name:V' "
                         "(F1 | F2 | F3 | sphere | rastrigin | rosenbrock "
                         "| ackley; e.g. 'rastrigin:8')")
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--m", type=int, default=20,
                    help="paper chromosome bits for V=2 problems (c = m/2 "
                         "bits per variable)")
    ap.add_argument("--k", type=int, default=100, help="generations")
    ap.add_argument("--mode", default="lut", choices=["lut", "arith"])
    ap.add_argument("--mutation-rate", type=float, default=0.02)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "reference", "fused", "islands",
                             "fused-islands", "eager"])
    ap.add_argument("--topology", default="auto",
                    choices=["auto", "single", "island_ring"],
                    help="population layout (auto derives from --islands)")
    ap.add_argument("--selection", default="tournament",
                    help="registered selection scheme (see "
                         "repro_torch.ga.SELECTION)")
    ap.add_argument("--islands", type=int, default=0,
                    help=">1 runs the island model (implies an island_ring "
                         "backend)")
    ap.add_argument("--migration", default="ring", choices=["ring", "none"],
                    help="inter-island exchange (none = isolated ablation)")
    ap.add_argument("--migrate-every", type=int, default=16)
    ap.add_argument("--repeats", type=int, default=1,
                    help="independent replicas stacked into one run")
    ap.add_argument("--mesh", default=None, help=MESH_HELP)
    ap.add_argument("--gens-per-epoch", type=int, default=1,
                    help=">1 folds generations inside one kernel launch "
                         "(fused executors; amortizes launch overhead); "
                         ">= migrate_every engages the resident or "
                         "streamed epoch kernel with the ring inside "
                         "(whole multiples fold several intervals per "
                         "launch)")
    ap.add_argument("--kernel", action="store_true",
                    help="deprecated: same as --backend fused")
    ap.add_argument("--chunk", type=int, default=0,
                    help="stream telemetry every CHUNK generations")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint/resume directory for chunked runs")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="opt-in: serve GA_METRICS as Prometheus text at "
                         "http://0.0.0.0:PORT/metrics for the run's duration")
    ap.add_argument("--seed", type=int, default=1)
    from repro_torch.ga.options import EngineOptions
    EngineOptions.add_cli_args(ap)   # --device/--cost-table/--plan-...
    args = ap.parse_args(argv)

    from repro_torch import ga
    from repro_torch.core import fitness as F

    backend = args.backend
    if args.kernel:
        backend = "fused"
    n_islands = max(args.islands, 1)
    pdef, _ = F.resolve_problem(args.problem)   # fail fast on unknown names
    mode = args.mode
    if backend in ("fused", "fused-islands") and mode == "lut":
        mode = "arith"   # the kernel's FFM is arithmetic-only
    if mode == "lut" and not pdef.separable:
        print(f"note: {pdef.name} has no LUT (ROM) lowering; using arith")
        mode = "arith"

    spec = ga.GASpec(problem=args.problem, n=args.n, bits_per_var=args.m // 2,
                     mode=mode, mutation_rate=args.mutation_rate,
                     seed=args.seed, generations=args.k, n_islands=n_islands,
                     migrate_every=args.migrate_every,
                     n_repeats=args.repeats, selection=args.selection,
                     gens_per_epoch=args.gens_per_epoch,
                     topology=None if args.topology == "auto"
                     else args.topology,
                     migration=args.migration)
    options = EngineOptions.from_args(args, mesh=mesh_from_args(args, ap))

    server = None
    if args.metrics_port is not None:
        from repro_torch.serve.metrics_http import start_metrics_server
        server = start_metrics_server(args.metrics_port)
        print(f"metrics: http://0.0.0.0:{server.server_address[1]}/metrics")

    if args.chunk > 0 or server is not None:
        from repro_torch.serve.engine import GA_METRICS
        eng = ga.Engine(spec, backend, options=options)
        last = None
        job = GA_METRICS.start_job(
            GA_METRICS.allocate_job_id(spec.problem), backend=eng.backend_name,
            gens_total=spec.generations, problem=spec.problem,
            n_vars=spec.v)
        try:
            for tele in eng.run_chunked(
                    chunk_generations=args.chunk or None,
                    ckpt_dir=args.ckpt_dir):
                GA_METRICS.record_chunk(job.job_id, tele)
                print(f"[{tele['backend']}] chunk {tele['chunk']}: "
                      f"{tele['gens_done']}/{tele['gens_total']} gens, "
                      f"best={tele['best_fitness']:.4f}, "
                      f"{tele['gens_per_s']:.0f} gens/s, "
                      f"{tele.get('migrations', 0)} migrations")
                last = tele
            GA_METRICS.finish_job(job.job_id)
        except BaseException as e:   # mirror run_ga_job: /metrics must not
            GA_METRICS.finish_job(job.job_id, error=repr(e))   # stay "running"
            raise
        finally:
            if server is not None:
                server.shutdown()
                server.server_close()
        if last is not None:
            print(f"decoded vars: {np.round(last['best_params'], 4)}")
        return

    out = ga.solve(spec, backend=backend, options=options)
    tele = out.telemetry
    comp = (f" ({tele.topology.executor} x {tele.topology.topology})"
            if tele.topology.executor != "-" else "")
    print(f"backend: {out.backend}{comp}")
    print(f"device: {options.torch_device()}")
    print(f"problem: {tele.problem or spec.problem or 'blackbox'} "
          f"({spec.v} variable(s), mode={mode})")
    if tele.plan.mode != "-":
        tile = (f", tile={tele.plan.tile_islands}"
                if tele.plan.tile_islands else "")
        lane = f", lane={tele.plan.lane}" if tele.plan.lane != "-" else ""
        print(f"epoch plan: {tele.plan.mode} "
              f"({tele.plan.source}{lane}{tile})")
    if tele.topology.sharded:
        shards = max(1, tele.topology.n_shards)
        print(f"shards: {shards} "
              f"({spec.n_islands // shards} island(s) each)")
    if tele.topology.migrations:
        print(f"migrations: {tele.topology.migrations}")
    print(f"best fitness: {out.best_fitness:.4f}")
    print(f"decoded vars: {np.round(out.best_params, 4)}")
    traj = np.asarray(out.traj_best)
    if traj.size:
        print(f"trajectory (best, every 10 entries): {traj[::10]}")
    total_gens = out.generations * max(n_islands, args.repeats, 1)
    print(f"{out.wall_s*1e3:.1f} ms total -> {total_gens/out.wall_s:.0f} "
          f"generations/s (wall)")


if __name__ == "__main__":
    main()
