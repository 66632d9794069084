"""GA serving launcher — run the multi-tenant scheduler from the CLI.

    # four demo jobs (two packable pairs) with live streaming + metrics,
    # on the card
    PYTHONPATH=src python -m repro_torch.launch.ga_serve --demo 4 --port 9100

    # the same on the CPU
    PYTHONPATH=src python -m repro_torch.launch.ga_serve --demo 4 \
        --device cpu --port 0

    # jobs from a JSON file
    PYTHONPATH=src python -m repro_torch.launch.ga_serve --jobs jobs.json \
        --max-pack 8 --chunk 16

The jobs file is a JSON list of objects; each object's keys are GASpec
fields plus optional "backend", "priority", "deadline_s" (wall-clock
budget → DEADLINE_EXCEEDED) and "max_retries" (per-job retry budget):

    [{"problem": "F3", "n": 32, "bits_per_var": 10, "generations": 100},
     {"problem": "F3", "n": 32, "bits_per_var": 10, "generations": 100,
      "seed": 7},
     {"problem": "rastrigin:4", "n": 64, "generations": 200, "priority": 5}]

Jobs sharing a spec shape (same `GASpec.compile_key()` and generations) are
packed down the replica axis into one launch — results stay bit-identical
to solo runs — and repeat shapes hit the process-global engine cache.
`--port` serves /metrics, /jobs, /jobs/<id> (long-poll) and
/jobs/<id>/stream (SSE) while jobs run; `--demo K` submits K F3 jobs with
distinct seeds (and, for K >= 3, one higher-priority rastrigin job that
preempts them) without needing a file.

The port of the JAX package's `repro.launch.ga_serve`, with the same
flags, `--vmem-budget` as `--smem-budget` (see
`EngineOptions.add_cli_args`); `--device`
picks the card (the default) or the CPU, `--mesh` shards the island axis
of every job over devices of that kind (`repro_torch.launch.mesh`), and
`--cost-table` a measured table (`python -m
repro_torch.launch.ga_autotune` writes one).
"""

from __future__ import annotations

import argparse
import json


def _spec_from(obj: dict):
    from repro_torch import ga
    obj = dict(obj)
    backend = obj.pop("backend", None)
    priority = int(obj.pop("priority", 0))
    deadline_s = obj.pop("deadline_s", None)
    max_retries = obj.pop("max_retries", None)
    return (ga.GASpec(**obj), backend, priority,
            None if deadline_s is None else float(deadline_s),
            None if max_retries is None else int(max_retries))


def _demo_jobs(k: int):
    # long enough (16 chunks of 16) that the later arrival finds the pack
    # running on a loaded host too
    base = dict(problem="F3", n=32, bits_per_var=10, generations=256)
    jobs = [dict(base, seed=11 + i) for i in range(k)]
    if k >= 3:
        # a later high-priority arrival that preempts the running pack
        jobs[-1] = dict(problem="rastrigin:4", n=32, bits_per_var=10,
                        generations=64, seed=5, priority=10)
    return jobs


def main():
    from repro_torch.launch.mesh import MESH_HELP, mesh_from_args

    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", default=None,
                    help="JSON file: list of GASpec-field objects "
                         "(+ optional 'backend'/'priority' keys)")
    ap.add_argument("--demo", type=int, default=0, metavar="K",
                    help="submit K built-in demo jobs instead of --jobs")
    ap.add_argument("--backend", default="auto",
                    help="default backend for jobs that don't name one")
    ap.add_argument("--mesh", default=None, help=MESH_HELP)
    ap.add_argument("--max-pack", type=int, default=8,
                    help="max replica slots per packed launch")
    ap.add_argument("--chunk", type=int, default=None,
                    help="telemetry/preemption granularity in generations")
    ap.add_argument("--ckpt-root", default=None,
                    help="pack checkpoint directory (temp dir by default)")
    ap.add_argument("--port", type=int, default=None,
                    help="serve /metrics, /jobs and SSE streams at PORT "
                         "(0 picks an ephemeral port)")
    ap.add_argument("--job-ttl", type=float, default=None, metavar="S",
                    help="evict DONE/FAILED jobs S seconds after they "
                         "finish (default: keep forever)")
    ap.add_argument("--recover", action="store_true",
                    help="replay the scheduler journal under --ckpt-root: "
                         "re-enqueue pending jobs (packs resume from their "
                         "checkpoints) and restore finished results")
    ap.add_argument("--max-retries", type=int, default=3, metavar="N",
                    help="per-job retry budget for transient failures")
    ap.add_argument("--retry-backoff", type=float, default=0.05, metavar="S",
                    help="base of the exponential retry backoff")
    ap.add_argument("--stream", default="first",
                    choices=["first", "none"],
                    help="print the first job's live telemetry feed")
    from repro_torch.ga.options import EngineOptions
    EngineOptions.add_cli_args(ap)   # --device/--plan-override/--sel-lane/...
    args = ap.parse_args()

    if args.jobs is not None and args.demo > 0:
        ap.error("use only one of --jobs FILE or --demo K")
    if args.jobs is None and args.demo <= 0 and not args.recover:
        ap.error("one of --jobs FILE or --demo K is required "
                 "(or --recover alone to only resume journaled jobs)")
    job_dicts = _demo_jobs(args.demo) if args.demo > 0 else []
    if args.jobs is not None:
        with open(args.jobs) as f:
            job_dicts = json.load(f)
    if not job_dicts and not args.recover:
        ap.error("no jobs to run")

    options = EngineOptions.from_args(args, mesh=mesh_from_args(args, ap))

    from repro_torch.serve.scheduler import GAScheduler
    if args.recover and args.ckpt_root is None:
        ap.error("--recover needs --ckpt-root (the journal lives there)")
    sched = GAScheduler(backend=args.backend,
                        max_pack=args.max_pack,
                        chunk_generations=args.chunk,
                        ckpt_root=args.ckpt_root,
                        job_ttl_s=args.job_ttl,
                        max_retries=args.max_retries,
                        retry_backoff_s=args.retry_backoff,
                        recover=args.recover,
                        options=options)
    print(f"device: {sched.device}")
    if sched.cost_table is not None:
        print(f"cost table: {len(sched.cost_table)} measured point(s)")
    if args.recover:
        print(f"recovered {sched.recovered_total} pending job(s) "
              "from the journal")

    server = None
    if args.port is not None:
        from repro_torch.serve.metrics_http import start_metrics_server
        server = start_metrics_server(args.port, registry=sched.registry)
        port = server.server_address[1]
        print(f"metrics:  http://0.0.0.0:{port}/metrics")
        print(f"jobs:     http://0.0.0.0:{port}/jobs")
        print(f"streams:  http://0.0.0.0:{port}/jobs/<id>/stream  (SSE)")

    ids = []

    def submit(obj):
        spec, backend, priority, deadline_s, max_retries = _spec_from(obj)
        job_id = sched.submit(spec, backend=backend, priority=priority,
                              deadline_s=deadline_s, max_retries=max_retries)
        ids.append(job_id)
        print(f"submitted {job_id}: {spec.problem or 'blackbox'} "
              f"gens={spec.generations} priority={priority}"
              + (f" deadline={deadline_s}s" if deadline_s else ""))

    # the demo's high-priority job arrives once the first pack is running
    # (after its first chunk when streaming), so it preempts that pack
    late = [obj for obj in job_dicts[1:]
            if args.demo > 0 and obj.get("priority", 0) > 0]
    for obj in job_dicts:
        if not any(obj is o for o in late):
            submit(obj)

    try:
        if args.stream == "first" and ids:
            for event in sched.stream(ids[0]):
                if event.get("event") != "chunk":
                    continue
                print(f"[{event['job_id']}] chunk {event['chunk']}: "
                      f"{event['gens_done']}/{event['gens_total']} gens, "
                      f"best={event['best_fitness']:.4f}, "
                      f"pack={event.get('pack_size', 1)}")
                while late:
                    submit(late.pop(0))
        while late:
            submit(late.pop(0))
        sched.wait_all(timeout=600)
        for job_id in ids:
            res = sched.result(job_id)
            print(f"{job_id}: best={res['best_fitness']:.6f} "
                  f"backend={res['backend']} pack={res.get('pack_size', 1)} "
                  f"({res['gens_per_s']:.0f} gens/s)")
        stats = sched.stats()
        print(f"packs={stats['packs_launched']} "
              f"packed_jobs={stats['jobs_packed']} "
              f"preemptions={stats['preemptions']} "
              f"cache: {stats['cache_hits']} hit(s) / "
              f"{stats['cache_misses']} miss(es), "
              f"{stats['cache_entries']} entries")
        print(f"plans: {stats['plans_measured']} measured / "
              f"{stats['plans_heuristic']} heuristic "
              f"(table points={stats['plan_table_entries']}, "
              f"evicted jobs={stats['jobs_evicted']})")
        print(f"faults: retries={stats['retries']} "
              f"quarantined={stats['quarantined']} "
              f"recovered={stats['recovered']} "
              f"deadline_exceeded={stats['deadline_exceeded']}")
    finally:
        sched.shutdown()
        if server is not None:
            server.shutdown()
            server.server_close()


if __name__ == "__main__":
    main()
