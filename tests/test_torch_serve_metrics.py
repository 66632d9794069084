"""The serving telemetry of the port (`repro_torch.serve.engine`'s
`GAMetricsRegistry` and `run_ga_job`, `repro_torch.serve.metrics_http`)
against the JAX package's: the same sequence of registry calls gives the
same `metrics()` snapshot and the same Prometheus text; `run_ga_job` gives
the same job dict but for its wall times; and the HTTP surface (/metrics,
/healthz, /jobs, /jobs/<id> with its long-poll, SSE) serves the port's
scheduler on the CPU."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import ga as JGA  # noqa: E402
from repro.ga import telemetry as JRT  # noqa: E402
from repro.serve import engine as JENG  # noqa: E402
from repro.serve import metrics_http as JHTTP  # noqa: E402
from repro_torch import ga  # noqa: E402
from repro_torch.ga import telemetry as TRT  # noqa: E402
from repro_torch.serve import engine as TENG  # noqa: E402
from repro_torch.serve import metrics_http as THTTP  # noqa: E402
from repro_torch.serve.scheduler import GAScheduler  # noqa: E402


@pytest.fixture(autouse=True)
def _no_ambient_cost_table(monkeypatch):
    """The plans here are the heuristic's: no cost table found on the host
    may move them."""
    monkeypatch.setenv("REPRO_GA_COST_TABLE", "off")


CPU = ga.EngineOptions(device="cpu")
WALL_KEYS = ("wall_s", "generations_per_s", "generations_per_s_per_shard")

SCHED_STATS = {
    "queue_depth": 3, "jobs_running": 2, "packs_launched": 4,
    "preemptions": 1, "jobs_packed": 2, "max_pack": 8, "cache_hits": 5,
    "cache_misses": 2, "cache_entries": 2, "jobs_evicted": 1,
    "plans_measured": 0, "plans_heuristic": 3, "plan_table_entries": 0,
    "retries": 2, "quarantined": 1, "recovered": 0, "deadline_exceeded": 1,
    "worker_alive": True}


def _tele(rt_mod, mode="-", **plan):
    return rt_mod.RunTelemetry(
        plan=rt_mod.PlanInfo(mode=mode, **plan),
        topology=rt_mod.TopologyInfo(n_islands=4 if mode != "-" else 1,
                                     launches=2, migrations=3))


def _script(eng, rt_mod):
    """One fixed sequence of registry calls; returns the registry."""
    reg = eng.GAMetricsRegistry()
    a = reg.allocate_job_id("F3")
    b = reg.allocate_job_id("rastrigin")
    reg.ensure_next_id(7)
    c = reg.allocate_job_id("blackbox")
    reg.queue_job(a, problem="F3", gens_total=40, n_vars=2, priority=1)
    reg.queue_job(b, problem="rastrigin", gens_total=60, n_vars=4,
                  priority=10, deadline_s=3.5)
    reg.queue_job(c, problem="blackbox", gens_total=20, n_vars=1)
    reg.start_job(a, backend="fused", gens_total=40, problem="F3", n_vars=2)
    reg.record_chunk(a, {"gens_done": 20, "gens_total": 40, "wall_s": 0.25,
                         "best_fitness": 1.5, "migrations": 0,
                         "pack_size": 2, "backend": "fused",
                         "telemetry": _tele(rt_mod)})
    reg.set_status(a, "preempted")
    reg.set_status(a, "preempted")
    reg.start_job(b, backend="fused-islands")
    reg.record_chunk(b, {"gens_done": 30, "wall_s": 0.5,
                         "best_fitness": np.float32(0.75), "migrations": 6,
                         "telemetry": _tele(rt_mod, "streamed",
                                            source="heuristic",
                                            tile_islands=2, lane="gather",
                                            fallback="cluster limit")})
    reg.note_retry(a)
    reg.set_status(a, "queued")
    reg.start_job(a)
    reg.record_chunk(a, {"gens_done": 40, "wall_s": 0.125,
                         "best_fitness": 1.25, "migrations": 0})
    reg.finish_job(a)
    reg.finish_job(b, error="RuntimeError('boom')", quarantined=True)
    reg.finish_job(c, error="deadline", status="deadline_exceeded")
    d = reg.allocate_job_id("F3")
    reg.start_job(d, backend="reference", gens_total=10, problem="F3",
                  n_vars=2)
    reg.evict_job(c)
    reg.attach_scheduler_stats(lambda: dict(SCHED_STATS))
    return reg


def test_registry_snapshot_matches_jax():
    got = _script(TENG, TRT).metrics()
    want = _script(JENG, JRT).metrics()
    assert got == want
    assert got["scheduler"] == SCHED_STATS
    assert got["jobs"]["ga-0-F3"]["preemptions"] == 1
    assert got["jobs"]["ga-1-rastrigin"]["epoch_mode"] == "streamed"


def test_prometheus_text_matches_jax():
    got_snap = _script(TENG, TRT).metrics()
    want_snap = _script(JENG, JRT).metrics()
    text = THTTP.render_prometheus(got_snap)
    assert text == JHTTP.render_prometheus(want_snap)
    assert text == JHTTP.render_prometheus(got_snap)
    for gauge in ("repro_ga_sched_queue_depth", "repro_ga_sched_retries_total",
                  "repro_ga_sched_quarantined_total",
                  "repro_ga_sched_deadline_exceeded_total",
                  "repro_ga_plan_info", "repro_ga_job_status",
                  "repro_ga_compile_cache_hits"):
        assert gauge in text, gauge


def test_scrape_survives_a_failing_stats_callable():
    for eng in (TENG, JENG):
        reg = eng.GAMetricsRegistry()
        reg.attach_scheduler_stats(lambda: 1 / 0)
        assert "scheduler" not in reg.metrics()


def test_abort_streams_releases_only_live_jobs():
    reg = TENG.GAMetricsRegistry()
    live, done = reg.allocate_job_id("a"), reg.allocate_job_id("b")
    reg.start_job(live)
    reg.start_job(done)
    reg.finish_job(done)
    q_live, q_done = reg.subscribe(live), reg.subscribe(done)
    reg.abort_streams("worker died")
    assert q_live.get(timeout=5) == {"event": "end", "job_id": live,
                                     "status": "aborted",
                                     "error": "worker died"}
    assert q_done.empty()
    assert reg.evict_job(done) and not reg.evict_job(done)


def test_registry_thread_safe_under_concurrent_writers():
    """N writer threads hammering start/record/finish against concurrent
    metrics() readers: no exceptions, no lost chunks."""
    reg = TENG.GAMetricsRegistry()
    n_threads, n_chunks = 8, 50
    errors = []

    def writer(i):
        try:
            job_id = reg.allocate_job_id(f"w{i}")
            reg.start_job(job_id, backend="reference",
                          gens_total=n_chunks, problem="F3", n_vars=2)
            for c in range(n_chunks):
                reg.record_chunk(job_id, {
                    "gens_done": c + 1, "chunk_gens": 1, "wall_s": 1e-4,
                    "best_fitness": float(c), "migrations": 0})
                reg.metrics()
            reg.finish_job(job_id)
        except Exception as e:      # noqa: BLE001 — collected for the assert
            errors.append(repr(e))

    threads = [threading.Thread(target=writer, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errors, errors
    snap = reg.metrics()
    assert snap["job_count"] == n_threads
    assert snap["jobs_done"] == n_threads
    assert all(j["chunks"] == n_chunks for j in snap["jobs"].values())
    assert snap["generations_total"] == n_threads * n_chunks


def test_registry_pubsub_delivers_chunks_and_end():
    reg = TENG.GAMetricsRegistry()
    job_id = reg.allocate_job_id("F3")
    reg.start_job(job_id, backend="reference", gens_total=2,
                  problem="F3", n_vars=2)
    sub = reg.subscribe(job_id)
    reg.record_chunk(job_id, {"gens_done": 1, "chunk_gens": 1,
                              "wall_s": 1e-4, "best_fitness": 1.0,
                              "best_params": [0.0], "telemetry": None})
    reg.finish_job(job_id)
    events = [sub.get(timeout=5), sub.get(timeout=5)]
    assert events[0]["event"] == "chunk" and events[0]["gens_done"] == 1
    assert "best_params" not in events[0] and "telemetry" not in events[0]
    assert events[1]["event"] == "end" and events[1]["status"] == "done"
    reg.unsubscribe(job_id, sub)


def _strip_wall(job):
    return {k: v for k, v in job.items() if k not in WALL_KEYS}


@pytest.mark.parametrize("backend,kw", [
    ("reference", {}),
    ("islands", dict(n_islands=4, migrate_every=5)),
])
def test_run_ga_job_matches_jax(tmp_path, backend, kw):
    spec_kw = dict(problem="F3", n=32, bits_per_var=8, mode="lut",
                   mutation_rate=0.05, seed=11, generations=30, **kw)
    reg_t, reg_j = TENG.GAMetricsRegistry(), JENG.GAMetricsRegistry()
    got = TENG.run_ga_job(ga.GASpec(**spec_kw), backend,
                          chunk_generations=10, registry=reg_t, options=CPU,
                          ckpt_dir=str(tmp_path / "t"))
    want = JENG.run_ga_job(JGA.GASpec(**spec_kw), backend,
                           chunk_generations=10, registry=reg_j,
                           ckpt_dir=str(tmp_path / "j"))
    assert _strip_wall(got) == _strip_wall(want)
    assert got["status"] == "done" and got["chunks"] == 3
    solo = ga.solve(ga.GASpec(**spec_kw), backend=backend, options=CPU)
    assert got["best_fitness"] == solo.best_fitness


def test_run_ga_job_failure_lands_in_the_registry():
    reg = TENG.GAMetricsRegistry()

    def boom(x):
        raise ValueError("bad fitness")

    spec = ga.GASpec(fitness=boom, bounds=((-1.0, 1.0),), generations=4)
    with pytest.raises(ValueError, match="bad fitness"):
        TENG.run_ga_job(spec, "reference", registry=reg, options=CPU)
    (job,) = reg.metrics()["jobs"].values()
    assert job["status"] == "failed" and "bad fitness" in job["error"]


def test_json_default_turns_tensors_into_numbers():
    obj = {"y": torch.tensor(1.5), "x": torch.arange(3, dtype=torch.int32),
           "n": np.float32(2.5), "a": np.arange(2)}
    assert json.loads(json.dumps(obj, default=THTTP._json_default)) == {
        "y": 1.5, "x": [0, 1, 2], "n": 2.5, "a": [0, 1]}


def _spec(**kw):
    base = dict(problem="F3", n=32, bits_per_var=10, mode="arith",
                mutation_rate=0.05, seed=11, generations=20)
    base.update(kw)
    return ga.GASpec(**base)


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read()


def test_metrics_http_streaming_endpoints(tmp_path):
    """Per-chunk telemetry streams to an HTTP client while the job runs
    (SSE), the long-poll endpoint blocks until new chunks land, and
    /metrics exports the scheduler and engine-cache gauges."""
    reg = TENG.GAMetricsRegistry()
    sched = GAScheduler(registry=reg, ckpt_root=str(tmp_path),
                        chunk_generations=8, paused=True, options=CPU)
    server = THTTP.start_metrics_server(0, registry=reg, host="127.0.0.1")
    port = server.server_address[1]
    url = f"http://127.0.0.1:{port}"
    try:
        a = sched.submit(_spec(seed=3, generations=48))
        events, primed = [], threading.Event()

        def read_sse():
            with urllib.request.urlopen(f"{url}/jobs/{a}/stream",
                                        timeout=60) as req:
                buf = b""
                while True:
                    line = req.readline()
                    if not line:
                        return
                    buf += line
                    if line == b"\n":
                        for ln in buf.split(b"\n"):
                            if ln.startswith(b"data: "):
                                events.append(
                                    json.loads(ln[len(b"data: "):]))
                        primed.set()
                        if b"event: end" in buf:
                            return
                        buf = b""

        t = threading.Thread(target=read_sse)
        t.start()
        assert primed.wait(30)       # the snapshot: subscribed before dispatch
        assert events[0]["status"] == "queued"
        sched.resume_dispatch()
        sched.result(a, timeout=120)
        t.join(30)
        assert not t.is_alive()
        assert events and events[-1].get("event") == "end"
        chunks = [e for e in events if e.get("event") == "chunk"]
        assert [e["gens_done"] for e in chunks] == list(range(8, 49, 8))

        b = sched.submit(_spec(seed=99, generations=48))
        lp = json.loads(_get(f"{url}/jobs/{b}?after=0&timeout=30", 60))
        assert lp["chunks"] > 0
        sched.result(b, timeout=120)
        # a finished job's stream is its snapshot alone
        done_sse = _get(f"{url}/jobs/{b}/stream")
        assert done_sse.startswith(b"event: snapshot\ndata: ")

        jobs = json.loads(_get(f"{url}/jobs"))
        assert a in jobs["jobs"] and b in jobs["jobs"]
        one = json.loads(_get(f"{url}/jobs/{a}"))
        assert one["status"] == "done" and one["chunks"] == 6
        text = _get(f"{url}/metrics").decode()
        for gauge in ("repro_ga_sched_queue_depth",
                      "repro_ga_sched_packs_launched",
                      "repro_ga_compile_cache_hits",
                      "repro_ga_sched_worker_alive",
                      "repro_ga_job_status", "repro_ga_pack_size"):
            assert gauge in text, gauge
        assert _get(f"{url}/healthz") == b"ok\n"
        for path in ("/jobs/nope", "/jobs/nope?after=0", "/jobs/nope/stream",
                     "/elsewhere"):
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(url + path)
            err.value.close()
            assert err.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        sched.shutdown()
