#!/usr/bin/env python
"""Smoke of GA-as-a-service in the PyTorch port: the multi-tenant
scheduler on a mesh.

Builds a mesh of 8 logical shards of one device (the card by default,
`--device cpu` for the CPU), submits heterogeneous jobs — two
shape-compatible island jobs (packed down the replica axis), an
incompatible rastrigin job, and a late high-priority arrival that preempts
the running low-priority pack — then asserts:

  * every per-job best is bit-identical to its solo `ga.solve` run on the
    same mesh (packing and checkpoint/resume preemption change
    scheduling, never results);
  * at least one pack held >= 2 jobs and at least one preemption happened;
  * the resubmitted spec shape hit the runner cache;
  * /metrics serves the `repro_ga_sched_*` and runner-cache gauges, and
    every job's `shards` is the mesh's 8.

The scenario and assertions of the JAX package's
scripts/scheduler_smoke.py, which runs on 8 fake XLA host devices.

    PYTHONPATH=src python scripts/torch_scheduler_smoke.py [--device cpu]
"""

import argparse
import os
import re
import subprocess
import sys
import time
import urllib.request

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import ga                                   # noqa: E402
from repro_torch.launch.mesh import Mesh, make_island_mesh   # noqa: E402
from repro_torch.serve.engine import GAMetricsRegistry       # noqa: E402
from repro_torch.serve.metrics_http import start_metrics_server  # noqa
from repro_torch.serve.scheduler import GAScheduler          # noqa: E402


def _spec(**kw):
    base = dict(problem="F3", n=32, bits_per_var=10, mode="arith",
                mutation_rate=0.05, seed=11, generations=24,
                n_islands=8, migrate_every=4)
    base.update(kw)
    return ga.GASpec(**base)


def device_line(device) -> str:
    """The device a time was taken on: a card's name and power limit (as
    nvidia-smi reports them), or the CPU."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"{device} (nvidia-smi failed)"


def logical_mesh(device: str, shards: int = 8) -> Mesh:
    """`shards` logical shards of the one device of the kind asked for."""
    dev = make_island_mesh(1, device=device).first_device
    return Mesh([dev] * shards, ("islands",))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, the default) or 'cpu'")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    mesh = logical_mesh(args.device)
    print(f"mesh: {mesh.shape} ({mesh.devices.size} logical shard(s) of "
          f"{mesh.first_device})")
    opts = ga.EngineOptions(mesh=mesh)
    reg = GAMetricsRegistry()
    sched = GAScheduler(mesh=mesh, registry=reg, backend="islands",
                        chunk_generations=8)
    server = start_metrics_server(0, registry=reg, host="127.0.0.1")
    port = server.server_address[1]
    try:
        # a long low-priority job the hot job will preempt mid-run
        lo_spec = _spec(seed=3, generations=96)
        lo = sched.submit(lo_spec, priority=0)
        # two shape-compatible jobs -> one packed launch (submitted while
        # lo runs, so they queue together and pack at dispatch)
        pa_spec, pb_spec = _spec(seed=11), _spec(seed=40)
        pa, pb = sched.submit(pa_spec), sched.submit(pb_spec)
        # heterogeneous: different problem/shape, cannot pack with the pair
        ra_spec = _spec(problem="rastrigin:4", seed=5)
        ra = sched.submit(ra_spec)
        # the preemptor: submitted only once lo has streamed a chunk (i.e.
        # is demonstrably mid-run), so the strictly higher priority must
        # park lo between chunks rather than just winning the initial race
        hot_spec = _spec(problem="ackley:4", seed=7)
        hot = None
        for event in sched.stream(lo, timeout=600):
            if event.get("event") == "chunk" and hot is None:
                hot = sched.submit(hot_spec, priority=10)
                break
        assert hot is not None, "lo ended before streaming a single chunk"

        results = {j: sched.result(j, timeout=600)
                   for j in (lo, pa, pb, ra, hot)}

        # 1) bit-identical to solo runs, packing and preemption included
        for job_id, spec in ((lo, lo_spec), (pa, pa_spec), (pb, pb_spec),
                             (ra, ra_spec), (hot, hot_spec)):
            solo = ga.solve(spec, backend="islands", options=opts)
            got = results[job_id]["best_fitness"]
            assert got == solo.best_fitness, \
                f"{job_id}: packed/preempted best {got} != solo " \
                f"{solo.best_fitness}"
            shards = reg.metrics()["jobs"][job_id]["shards"]
            assert shards == 8, f"{job_id}: /metrics shards {shards}"
            print(f"{job_id}: best={got:.6f} "
                  f"pack={results[job_id]['pack_size']} shards={shards} "
                  "(== solo)")

        # 2) packing + preemption actually exercised
        stats = sched.stats()
        print(f"stats: {stats}")
        assert stats["worker_alive"] is True, "worker thread died mid-run"
        assert max(r["pack_size"] for r in results.values()) >= 2, \
            "no pack held >= 2 jobs"
        assert stats["jobs_packed"] >= 2
        assert stats["preemptions"] >= 1, "no preemption happened"
        assert reg.metrics()["jobs"][lo]["preemptions"] >= 1

        # 3) identical spec shape resubmitted -> runner cache hit
        hits0 = stats["cache_hits"]
        again = sched.submit(_spec(seed=77))
        sched.result(again, timeout=600)
        assert sched.stats()["cache_hits"] > hits0, \
            "resubmitted spec shape missed the runner cache"

        # 4) the gauges are scrapeable
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
        for gauge in ("repro_ga_sched_queue_depth",
                      "repro_ga_sched_jobs_running",
                      "repro_ga_sched_packs_launched",
                      "repro_ga_sched_preemptions",
                      "repro_ga_compile_cache_hits"):
            assert gauge in text, f"missing gauge {gauge}"
        hits = float(re.search(r"^repro_ga_compile_cache_hits (\S+)$",
                               text, re.M).group(1))
        assert hits > 0
        print(f"/metrics OK (compile_cache_hits={hits:g})")
        print(f"scheduler smoke OK in {time.perf_counter() - t0:.2f} s "
              f"[{device_line(mesh.first_device)}]")
    finally:
        server.shutdown()
        sched.shutdown()
        assert sched.stats()["worker_alive"] is False, \
            "worker thread survived shutdown"


if __name__ == "__main__":
    main()
