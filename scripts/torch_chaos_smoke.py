#!/usr/bin/env python
"""Chaos smoke of the PyTorch port: deterministic fault injection against
the GA scheduler on a mesh.

Builds a mesh of 8 logical shards of one device (the card by default,
`--device cpu` for the CPU) and drives one scheduler through the full
failure menagerie — every fault injected through `repro_torch.faults`
(occurrence counters + seeded hashes, never wall-clock or `random`), so a
failing run replays bit-for-bit:

  * a POISON job that crashes every chunk after its first: the pack it
    shares a launch with retries once, then splits — survivors resume from
    checkpoints sliced out of the pack's (`ga.repack_checkpoint`) and the
    poison job is quarantined as FAILED;
  * a FLAKY job hit by one injected compile failure, one corrupt
    checkpoint shard (caught by manifest checksums; resume falls back a
    step) and one chunk crash — three transient strikes, still finishes;
  * a forced PREEMPTION (late high-priority arrival parks a long run
    mid-flight), then a scheduler shutdown with the parked pack and the
    preemptor still pending;
  * a RESTART with `recover=True`: the journal replays, finished results
    are served without recomputation, the parked pack resumes from its
    checkpoint, and the pending jobs run to completion.

Every job that should finish must match its undisturbed solo `ga.solve`
run on the same mesh bit-identically; /metrics must export the fault
gauges.  The scenario and assertions of the JAX package's
scripts/chaos_smoke.py, which runs on 8 fake XLA host devices.

    PYTHONPATH=src python scripts/torch_chaos_smoke.py [--device cpu]
"""

import argparse
import os
import re
import shutil
import sys
import tempfile
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import faults as FLT                # noqa: E402
from repro_torch import ga                           # noqa: E402
from repro_torch.serve.engine import GAMetricsRegistry   # noqa: E402
from repro_torch.serve.metrics_http import start_metrics_server  # noqa
from repro_torch.serve.scheduler import (FAILED, PREEMPTED,  # noqa: E402
                                         GAScheduler)
from torch_scheduler_smoke import device_line, logical_mesh  # noqa: E402


def _spec(**kw):
    base = dict(problem="F3", n=32, bits_per_var=10, mode="arith",
                mutation_rate=0.05, seed=11, generations=48,
                n_islands=8, migrate_every=4)
    base.update(kw)
    return ga.GASpec(**base)


def _wait_state(sched, job_id, state, timeout=120.0):
    deadline = time.monotonic() + timeout
    while sched.job(job_id).state != state:
        if time.monotonic() > deadline:
            raise TimeoutError(f"{job_id} never reached {state!r} "
                               f"(stuck at {sched.job(job_id).state!r})")
        time.sleep(0.02)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, the default) or 'cpu'")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    mesh = logical_mesh(args.device)
    root = tempfile.mkdtemp(prefix="ga-chaos-")
    try:
        chaos(mesh, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"chaos smoke OK in {time.perf_counter() - t0:.2f} s "
          f"[{device_line(mesh.first_device)}]")


def chaos(mesh, root):
    print(f"mesh: {mesh.shape} ({mesh.devices.size} logical shard(s) of "
          f"{mesh.first_device})  ckpt_root: {root}")
    opts = ga.EngineOptions(mesh=mesh)

    specs = {
        "pack_a": _spec(seed=11), "pack_b": _spec(seed=40),
        "poison": _spec(seed=7),
        "flaky": _spec(problem="rastrigin:4", seed=5),
        "long": _spec(seed=3, generations=96),
        "hot": _spec(problem="ackley:4", seed=9),
    }
    # undisturbed expectations: the chaos run must match these bit-for-bit
    want = {k: ga.solve(s, backend="islands", options=opts)
            for k, s in specs.items()}

    inj = FLT.FaultInjector()
    reg = GAMetricsRegistry()
    sched = GAScheduler(registry=reg, backend="islands", chunk_generations=8,
                        ckpt_root=root, retry_backoff_s=0.01, paused=True,
                        options=ga.EngineOptions(mesh=mesh, faults=inj))
    j = {}
    try:
        # ---- phase 1: crash retry, corrupt ckpt, pack quarantine --------
        # paused: rules armed against job ids BEFORE anything dispatches
        for k in ("pack_a", "pack_b", "poison", "flaky"):
            j[k] = sched.submit(specs[k],
                                max_retries=1 if k == "poison" else None)
        inj.add_rule(f"chunk_crash@{j['poison']}:after=1:times=inf")
        inj.add_rule(f"compile_fail@{j['flaky']}:at=1")
        inj.add_rule(f"ckpt_corrupt@{j['flaky']}:at=2")
        inj.add_rule(f"chunk_crash@{j['flaky']}:at=3")
        sched.resume_dispatch()

        for k in ("pack_a", "pack_b", "flaky"):
            res = sched.result(j[k], timeout=600)
            assert res["best_fitness"] == want[k].best_fitness, \
                f"{k}: chaos best {res['best_fitness']} != undisturbed " \
                f"{want[k].best_fitness}"
            print(f"{j[k]} ({k}): best={res['best_fitness']:.6f} "
                  f"retries={sched.job(j[k]).retries} (== solo)")
        try:
            sched.result(j["poison"], timeout=600)
            raise AssertionError("poison job finished?!")
        except RuntimeError as e:
            assert "injected chunk crash" in str(e)
        pj = sched.job(j["poison"])
        assert pj.state == FAILED and pj.quarantined, \
            f"poison not quarantined: {pj.state} {pj.quarantined}"
        print(f"{j['poison']} (poison): quarantined after "
              f"{pj.retries} retry(s)")

        stats = sched.stats()
        fired = inj.stats()
        print(f"stats: retries={stats['retries']} "
              f"quarantined={stats['quarantined']}  fired={fired}")
        # pack retry (3 jobs) + flaky compile_fail + flaky chunk_crash
        assert stats["retries"] == 5, stats
        assert stats["quarantined"] == 1
        assert fired["chunk_crash"] >= 3 and fired["compile_fail"] == 1 \
            and fired["ckpt_corrupt"] == 1

        # ---- phase 2: forced preemption, shutdown with work pending ----
        j["long"] = sched.submit(specs["long"])
        hot = None
        for event in sched.stream(j["long"], timeout=600):
            if event.get("event") == "chunk":
                hot = sched.submit(specs["hot"], priority=10)
                j["hot"] = hot
                sched.pause()   # the park happens; nothing new dispatches
                break
        assert hot is not None, "long job ended before its first chunk"
        _wait_state(sched, j["long"], PREEMPTED)
        assert sched.stats()["preemptions"] >= 1
        print(f"{j['long']} parked mid-run; shutting the scheduler down "
              f"with it and {hot} pending")
    finally:
        sched.shutdown()
    assert sched.stats()["worker_alive"] is False

    # ---- phase 3: restart + journal recovery ----------------------------
    reg2 = GAMetricsRegistry()
    sched2 = GAScheduler(registry=reg2, backend="islands",
                         chunk_generations=8, ckpt_root=root, recover=True,
                         options=ga.EngineOptions(mesh=mesh))
    server = start_metrics_server(0, registry=reg2, host="127.0.0.1")
    port = server.server_address[1]
    try:
        assert sched2.recovered_total == 2, sched2.recovered_total  # long+hot
        # finished results come back from the journal, no recomputation
        for k in ("pack_a", "pack_b", "flaky"):
            got = sched2.result(j[k], timeout=5)
            assert got["best_fitness"] == want[k].best_fitness
        try:
            sched2.result(j["poison"], timeout=5)
            raise AssertionError("poison job revived?!")
        except RuntimeError as e:
            assert "injected chunk crash" in str(e)
        # the parked pack resumes from its checkpoint; the preemptor runs
        for k in ("long", "hot"):
            res = sched2.result(j[k], timeout=600)
            assert res["best_fitness"] == want[k].best_fitness, \
                f"{k} after restart: {res['best_fitness']} != " \
                f"{want[k].best_fitness}"
            assert sched2.job(j[k]).recovered
            print(f"{j[k]} ({k}): best={res['best_fitness']:.6f} "
                  "(recovered, == solo)")

        text = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
        for gauge in ("repro_ga_sched_retries_total",
                      "repro_ga_sched_quarantined_total",
                      "repro_ga_sched_recovered_total",
                      "repro_ga_sched_deadline_exceeded_total",
                      "repro_ga_sched_worker_alive"):
            assert gauge in text, f"missing gauge {gauge}"
        rec = float(re.search(r"^repro_ga_sched_recovered_total (\S+)$",
                              text, re.M).group(1))
        assert rec == 2.0, rec
        print(f"/metrics OK (recovered_total={rec:g})")
    finally:
        server.shutdown()
        sched2.shutdown()


if __name__ == "__main__":
    main()
