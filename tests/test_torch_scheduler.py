"""The port's `GAScheduler` (`repro_torch.serve.scheduler`) on the CPU:
packing, the engine cache, preemption, failed jobs, retry with backoff,
pack splitting and quarantine, permanent errors, deadlines on an injected
clock, TTL eviction, the journal and recovery from it, and worker death —
every surviving job bit-identical to its solo run, on `reference` and on
`fused` (the kernel's plain version here).  Then the same jobs through the
JAX package's scheduler and the port's (bit-identical, `lut` fitness), a
JAX scheduler's root recovered by the port's, and the `ga_serve` CLI.
Every wait has a timeout; faults are injected, never timed."""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import faults as JFLT  # noqa: E402
from repro import ga as JGA  # noqa: E402
from repro.serve import engine as JENG  # noqa: E402
from repro.serve import scheduler as JSCHED  # noqa: E402
from repro_torch import faults as FLT  # noqa: E402
from repro_torch import ga  # noqa: E402
from repro_torch.serve import journal as JRN  # noqa: E402
from repro_torch.serve.engine import GAMetricsRegistry  # noqa: E402
from repro_torch.serve.scheduler import (DEADLINE_EXCEEDED, DONE,  # noqa: E402
                                         FAILED, PREEMPTED, QUEUED,
                                         GAScheduler, retry_backoff)


@pytest.fixture(autouse=True)
def _no_ambient_cost_table(monkeypatch):
    """The plans here are the heuristic's: no cost table found on the host
    may move them."""
    monkeypatch.setenv("REPRO_GA_COST_TABLE", "off")


ROOT = Path(__file__).resolve().parents[1]
CPU = ga.EngineOptions(device="cpu")
BACKENDS = ["reference", "fused"]
T = 120          # seconds any single wait may take


def _kw(**kw):
    base = dict(problem="F3", n=32, bits_per_var=10, mode="arith",
                mutation_rate=0.05, seed=11, generations=20,
                gens_per_epoch=4)
    base.update(kw)
    return base


def _spec(**kw):
    return ga.GASpec(**_kw(**kw))


def _solo(spec, backend="reference"):
    return ga.solve(spec, backend=backend, options=CPU)


def _same_as_solo(res, spec, backend="reference"):
    want = _solo(spec, backend)
    assert res["best_fitness"] == want.best_fitness
    np.testing.assert_array_equal(np.asarray(res["best_params"]),
                                  np.asarray(want.best_params))


class FakeClock:
    """Injectable monotonic clock: deadline, backoff and TTL tests advance
    time explicitly instead of sleeping."""

    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class Gate(FLT.FaultInjector):
    """An injector that holds the worker before the first chunk whose
    fault tag contains a given match until that match's `go` is set:
    `gate[match]` is its (reached, go) pair.  Tests order events by it."""

    def __init__(self, *matches):
        super().__init__()
        self.holds = {m: (threading.Event(), threading.Event())
                      for m in matches}

    def __getitem__(self, match):
        return self.holds[match]

    def inject(self, site, tag=""):
        if site == "slow_chunk":
            for match, (reached, go) in self.holds.items():
                if match in tag and not reached.is_set():
                    reached.set()
                    assert go.wait(T)
        return super().inject(site, tag)


def _sched(tmp_path, faults=None, **kw):
    kw.setdefault("registry", GAMetricsRegistry())
    kw.setdefault("backend", "reference")
    kw.setdefault("ckpt_root", str(tmp_path / "root"))
    kw.setdefault("options", ga.EngineOptions(device="cpu", faults=faults))
    return GAScheduler(**kw)


# ---------------------------------------------------------------------------
# Packing, the engine cache, preemption
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_scheduler_packs_and_matches_solo(tmp_path, backend):
    """Shape-compatible jobs share one launch and every per-job result is
    bit-identical to its solo run."""
    reg = GAMetricsRegistry()
    sched = _sched(tmp_path, registry=reg, backend=backend,
                   chunk_generations=8, paused=True)
    try:
        sa, sb = _spec(seed=11, generations=24), _spec(seed=40,
                                                       generations=24)
        sc = _spec(problem="rastrigin:4", seed=5, generations=24)
        a, b, c = (sched.submit(s) for s in (sa, sb, sc))
        sched.resume_dispatch()
        ra, rb, rc = (sched.result(i, timeout=T) for i in (a, b, c))
        assert ra["pack_size"] == 2 and rb["pack_size"] == 2
        assert rc["pack_size"] == 1
        for spec, res in ((sa, ra), (sb, rb), (sc, rc)):
            assert res["backend"] == backend
            _same_as_solo(res, spec, backend)
        stats = sched.stats()
        assert stats["jobs_packed"] == 2 and stats["packs_launched"] == 2
        assert stats["cache_misses"] >= 1
        assert sched.job(a).state == DONE
        snap = reg.metrics()
        assert snap["jobs_done"] == 3
        assert snap["scheduler"]["packs_launched"] == stats["packs_launched"]
    finally:
        sched.shutdown()


def test_scheduler_respects_max_pack(tmp_path):
    sched = _sched(tmp_path, max_pack=3, paused=True)
    try:
        specs = [_spec(seed=s, n_repeats=r, generations=8)
                 for s, r in ((1, 2), (2, 1), (3, 2), (4, 1))]
        ids = [sched.submit(s) for s in specs]
        sched.resume_dispatch()
        res = [sched.result(i, timeout=T) for i in ids]
        assert [r["pack_size"] for r in res] == [2, 2, 2, 2]
        assert sched.stats()["packs_launched"] == 2
        for r, s in zip(res, specs):
            _same_as_solo(r, s)
    finally:
        sched.shutdown()


def test_scheduler_compile_cache_hit_on_resubmit(tmp_path):
    ga.RUNNER_CACHE.reset()
    sched = _sched(tmp_path)
    try:
        sched.result(sched.submit(_spec(seed=1)), timeout=T)
        h0 = sched.stats()["cache_hits"]
        sched.result(sched.submit(_spec(seed=2)), timeout=T)
        assert sched.stats()["cache_hits"] > h0
    finally:
        sched.shutdown()


@pytest.mark.parametrize("backend", BACKENDS)
def test_scheduler_preempts_and_resumes_bit_identically(tmp_path, backend):
    """A higher-priority arrival parks the running pack between chunks; the
    parked job reports PREEMPTED, resumes from its checkpoint, and finishes
    with the same result as an undisturbed run."""
    reg = GAMetricsRegistry()
    pack, hot_chunk = f"F3|{backend}|chunk=2", f"rastrigin|{backend}|chunk=1"
    gate = Gate(pack, hot_chunk)
    sched = _sched(tmp_path, registry=reg, backend=backend,
                   chunk_generations=8, faults=gate)
    try:
        lo_spec = _spec(seed=11, generations=32)
        lo = sched.submit(lo_spec, priority=0)
        assert gate[pack][0].wait(T)       # chunk 1 done, chunk 2 held
        hot = sched.submit(_spec(problem="rastrigin:4", seed=5,
                                 generations=8), priority=10)
        seen = reg.subscribe(lo)
        gate[pack][1].set()
        assert gate[hot_chunk][0].wait(T)  # parked; the hot job held
        assert sched.job(lo).state == PREEMPTED
        assert reg.metrics()["jobs"][lo]["status"] == "preempted"
        gate[hot_chunk][1].set()
        sched.result(hot, timeout=T)
        rlo = sched.result(lo, timeout=T)
        assert sched.stats()["preemptions"] == 1
        assert reg.metrics()["jobs"][lo]["preemptions"] == 1
        # chunk 2, parked; chunks 3 and 4 after the resume from step 16
        events = [seen.get(timeout=T) for _ in range(4)]
        assert [e.get("gens_done") for e in events] == [16, 24, 32, None]
        assert [e.get("resumed_from") for e in events[:3]] == [None, 16,
                                                                None]
        assert events[3]["event"] == "end"
        _same_as_solo(rlo, lo_spec, backend)
        events = JRN.read_journal(sched._journal_path)
        assert "park" in [e["ev"] for e in events]
    finally:
        sched.shutdown()


def test_scheduler_failed_job_raises(tmp_path):
    reg = GAMetricsRegistry()
    sched = _sched(tmp_path, registry=reg)
    try:
        def boom(x):
            raise ValueError("bad fitness")

        bad = sched.submit(ga.GASpec(fitness=boom, bounds=((-1.0, 1.0),),
                                     generations=8))
        with pytest.raises(RuntimeError, match="failed"):
            sched.result(bad, timeout=T)
        assert reg.metrics()["jobs"][bad]["status"] == "failed"
        assert sched.job(bad).retries == 0
    finally:
        sched.shutdown()


# ---------------------------------------------------------------------------
# Retry, quarantine, permanent errors, deadlines, TTL
# ---------------------------------------------------------------------------


def test_retry_backoff_is_the_jax_schedule():
    for attempt in range(5):
        for token in ("unit-0", "unit-17"):
            assert retry_backoff(0.05, attempt, token) == \
                JSCHED.retry_backoff(0.05, attempt, token)
    assert retry_backoff(1.0, 3, "u") >= 4.0


def test_scheduler_retries_transient_crash(tmp_path):
    inj = FLT.FaultInjector()
    sched = _sched(tmp_path, chunk_generations=8, paused=True, faults=inj)
    try:
        spec = _spec(seed=11, generations=32)
        job = sched.submit(spec)
        inj.add_rule(f"chunk_crash@{job}:at=2")
        sched.resume_dispatch()
        _same_as_solo(sched.result(job, timeout=T), spec)
        assert sched.job(job).retries == 1
        assert sched.stats()["retries"] == 1
        assert sched.registry.metrics()["jobs"][job]["retries"] == 1
    finally:
        sched.shutdown()


def test_scheduler_retries_compile_fail(tmp_path):
    """The compile_fail site fires before the engine is built; the retry
    builds it and the job finishes."""
    inj = FLT.FaultInjector()
    sched = _sched(tmp_path, paused=True, faults=inj)
    try:
        spec = _spec(seed=3, generations=16)
        job = sched.submit(spec)
        inj.add_rule(f"compile_fail@{job}:at=1")
        sched.resume_dispatch()
        _same_as_solo(sched.result(job, timeout=T), spec)
        assert sched.job(job).retries == 1
        assert inj.stats()["compile_fail"] == 1
    finally:
        sched.shutdown()


@pytest.mark.parametrize("backend", BACKENDS)
def test_scheduler_quarantines_poison_job_pack_survives(tmp_path, backend):
    inj = FLT.FaultInjector()
    sched = _sched(tmp_path, backend=backend, chunk_generations=8,
                   paused=True, max_retries=1, faults=inj)
    try:
        specs = [_spec(seed=11, generations=32),
                 _spec(seed=40, generations=32),
                 _spec(seed=7, generations=32)]
        jobs = [sched.submit(s) for s in specs]
        poison = jobs[1]
        # fires on EVERY chunk after the first: the first chunk checkpoints,
        # so the split resumes survivors from the sliced pack state
        inj.add_rule(f"chunk_crash@{poison}:after=1:times=inf")
        sched.resume_dispatch()
        for job, spec in zip(jobs, specs):
            if job != poison:
                _same_as_solo(sched.result(job, timeout=T), spec, backend)
        with pytest.raises(RuntimeError, match="injected chunk crash"):
            sched.result(poison, timeout=T)
        pj = sched.job(poison)
        assert pj.state == FAILED and pj.quarantined
        assert sched.stats()["quarantined"] == 1
        assert sched.registry.metrics()["jobs"][poison]["quarantined"] == 1
        requeues = [e for e in JRN.read_journal(sched._journal_path)
                    if e["ev"] == "requeue"]
        assert sum(bool(e.get("isolated")) for e in requeues) == 3
    finally:
        sched.shutdown()


def test_scheduler_permanent_error_fails_without_retry(tmp_path):
    sched = _sched(tmp_path)
    try:
        # BackendUnsupported is a ValueError: the work is wrong, not the
        # world — the job must fail immediately without burning retries
        job = sched.submit(_spec(generations=8), backend="no_such_backend")
        with pytest.raises(RuntimeError, match="unknown backend"):
            sched.result(job, timeout=T)
        assert sched.job(job).state == FAILED
        assert sched.job(job).retries == 0
        assert sched.stats()["retries"] == 0
    finally:
        sched.shutdown()


def test_scheduler_deadline_exceeded_before_dispatch(tmp_path):
    clock = FakeClock()
    sched = _sched(tmp_path, paused=True, clock=clock)
    try:
        job = sched.submit(_spec(generations=40), deadline_s=10.0)
        keep = sched.submit(_spec(seed=3, generations=8), deadline_s=100.0)
        clock.advance(11.0)          # blows the first budget while queued
        sched.resume_dispatch()
        with pytest.raises(RuntimeError, match="deadline"):
            sched.result(job, timeout=T)
        _same_as_solo(sched.result(keep, timeout=T),
                      _spec(seed=3, generations=8))
        assert sched.job(job).state == DEADLINE_EXCEEDED
        assert sched.stats()["deadline_exceeded"] == 1
        assert (sched.registry.metrics()["jobs"][job]["status"]
                == DEADLINE_EXCEEDED)
    finally:
        sched.shutdown()


def test_scheduler_ttl_evicts_finished_jobs(tmp_path):
    clock = FakeClock()
    sched = _sched(tmp_path, job_ttl_s=5.0, clock=clock)
    try:
        job = sched.submit(_spec(generations=8))
        sched.result(job, timeout=T)
        assert sched.gc_now() == 0
        clock.advance(6.0)
        # the worker's own sweep may win the race: either way it is gone
        sched.gc_now()
        assert sched.stats()["jobs_evicted"] == 1
        assert job not in sched.registry.metrics()["jobs"]
        with pytest.raises(KeyError):
            sched.job(job)
    finally:
        sched.shutdown()


def test_scheduler_takes_a_table_path_and_orders_by_it(tmp_path):
    """A cost-table path is resolved once and estimates every submit; within
    one priority the group with the shorter estimated wall dispatches first,
    though it was submitted second, and every job equals its solo run."""
    from repro_torch.autotune import CostTable
    from repro_torch.ga import compile_cache as CC
    kw = dict(n_islands=2, migrate_every=4, gens_per_epoch=8)
    long = [_spec(generations=48, seed=s, **kw) for s in (1, 2)]
    short = [_spec(generations=16, seed=s, **kw) for s in (3, 4)]
    table = CostTable()
    for mode, g, rate in (("resident", 8, 50.0), ("gridded", 4, 10.0)):
        table.add(CC.plan_point(long[0], executor="fused", mode=mode,
                                n_shards=1), g, rate)
    path = table.save(str(tmp_path / "table.json"))
    sched = _sched(tmp_path, backend="fused-islands", cost_table=path,
                   paused=True)
    try:
        assert len(sched.cost_table) == 2
        ids = [sched.submit(s) for s in long + short]
        assert [sched.job(i).est_gens_per_s for i in ids] == [50.0] * 4
        sched.resume_dispatch()
        for jid, spec in zip(ids, long + short):
            _same_as_solo(sched.result(jid, timeout=T), spec,
                          "fused-islands")
        stats = sched.stats()
        assert stats["plan_table_entries"] == 2
        assert stats["plans_measured"] == 2 and stats["packs_launched"] == 2
        with open(tmp_path / "root" / JRN.JOURNAL_NAME) as f:
            order = [ev["job_ids"] for ev in map(json.loads, f)
                     if ev["ev"] == "dispatch"]
        assert order == [ids[2:], ids[:2]]
    finally:
        sched.shutdown()
    sched = _sched(tmp_path / "off", cost_table=False)
    try:
        assert sched.cost_table is None
        assert sched.stats()["plan_table_entries"] == 0
    finally:
        sched.shutdown()


def test_a_card_scheduler_refuses_to_start_without_a_card(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        GAScheduler(registry=GAMetricsRegistry(),
                    ckpt_root=str(tmp_path / "root"))
    assert not os.path.exists(tmp_path / "root" / JRN.JOURNAL_NAME)


# ---------------------------------------------------------------------------
# The journal and recovery
# ---------------------------------------------------------------------------


def test_scheduler_journal_records_lifecycle(tmp_path):
    sched = _sched(tmp_path)
    try:
        job = sched.submit(_spec(generations=16))
        sched.result(job, timeout=T)
    finally:
        sched.shutdown()
    events = JRN.read_journal(sched._journal_path)
    kinds = [e["ev"] for e in events]
    assert kinds == ["submit", "dispatch", "done"]
    done = events[-1]
    assert done["job_id"] == job
    assert "best_fitness" in done["result"]
    assert len(done["result"]["best_params"]) == 2


def test_scheduler_recovery_restores_done_and_requeues_pending(tmp_path):
    root = str(tmp_path / "root")
    spec_done = _spec(seed=11, generations=16)
    spec_pend = _spec(seed=40, generations=16)
    sched = _sched(tmp_path, ckpt_root=root)
    done_id = sched.submit(spec_done)
    res = sched.result(done_id, timeout=T)
    sched.shutdown()

    # a crash mid-life: journal a submit the old process never ran
    j = JRN.SchedulerJournal(os.path.join(root, JRN.JOURNAL_NAME))
    pend_id = "ga-99-F3"
    j.append({"ev": "submit", "job_id": pend_id,
              "spec": JRN.spec_to_json(spec_pend), "backend": "reference",
              "priority": 0, "deadline_s": None, "max_retries": None})
    j.close()

    sched2 = _sched(tmp_path, ckpt_root=root, recover=True)
    try:
        assert sched2.recovered_total == 1
        got = sched2.result(done_id, timeout=T)
        assert got["best_fitness"] == res["best_fitness"]
        assert got["best_params"] == res["best_params"]
        _same_as_solo(sched2.result(pend_id, timeout=T), spec_pend)
        assert sched2.job(pend_id).recovered
        fresh = sched2.submit(_spec(seed=7, generations=8))
        assert fresh not in (done_id, pend_id)
        assert int(fresh.split("-")[1]) == 100
        sched2.result(fresh, timeout=T)
    finally:
        sched2.shutdown()


@pytest.mark.parametrize("backend", BACKENDS)
def test_recovery_resumes_a_parked_pack_from_its_checkpoint(tmp_path,
                                                            backend):
    """Shut down with a frozen pack pending (retry backoff on a clock that
    never reaches it): the restart resumes the pack from its checkpoint and
    every job ends equal to its solo run."""
    root = str(tmp_path / "root")
    inj = FLT.FaultInjector()
    specs = [_spec(seed=11, generations=32), _spec(seed=40, generations=32)]
    sched = _sched(tmp_path, ckpt_root=root, backend=backend, faults=inj,
                   chunk_generations=8, paused=True, clock=FakeClock(),
                   retry_backoff_s=1000.0)
    ids = [sched.submit(s) for s in specs]
    inj.add_rule(f"chunk_crash@{ids[0]}:at=3")
    sched.resume_dispatch()
    with sched._cv:
        assert sched._cv.wait_for(
            lambda: any(u.attempts for u in sched._queue), timeout=T)
    sched.shutdown()
    assert [sched.job(i).state for i in ids] == [QUEUED, QUEUED]

    sched2 = _sched(tmp_path, ckpt_root=root, backend=backend,
                    chunk_generations=8, recover=True, paused=True)
    try:
        assert sched2.recovered_total == 2
        feed = sched2.registry.subscribe(ids[0])
        sched2.resume_dispatch()
        # the first chunk after the resume from step 16 is the third
        first = feed.get(timeout=T)
        assert (first["chunk"], first["gens_done"]) == (3, 24)
        for i, spec in zip(ids, specs):
            res = sched2.result(i, timeout=T)
            assert res["pack_size"] == 2
            _same_as_solo(res, spec, backend)
    finally:
        sched2.shutdown()


def test_scheduler_recovery_fails_blackbox_jobs_clearly(tmp_path):
    root = str(tmp_path / "root")
    os.makedirs(root, exist_ok=True)
    j = JRN.SchedulerJournal(os.path.join(root, JRN.JOURNAL_NAME))
    j.append({"ev": "submit", "job_id": "ga-1-blackbox", "spec": None,
              "backend": "reference", "priority": 0, "deadline_s": None,
              "max_retries": None})
    j.close()
    sched = _sched(tmp_path, ckpt_root=root, recover=True)
    try:
        job = sched.job("ga-1-blackbox")
        assert job.state == FAILED
        assert "not recoverable" in job.error
    finally:
        sched.shutdown()


# ---------------------------------------------------------------------------
# Shutdown and worker death release blocked streams
# ---------------------------------------------------------------------------


def _consume(sched, job, got):
    try:
        for _ in sched.stream(job, timeout=60):
            pass
    except RuntimeError as e:
        got["err"] = str(e)


def test_scheduler_worker_alive_and_stream_abort(tmp_path):
    sched = _sched(tmp_path, paused=True)
    assert sched.stats()["worker_alive"] is True
    job = sched.submit(_spec(generations=40))
    got = {}
    t = threading.Thread(target=_consume, args=(sched, job, got))
    t.start()
    sched.shutdown()            # job never dispatched: no organic end event
    t.join(timeout=30)
    assert not t.is_alive()
    assert "aborted" in got["err"] and "shut down" in got["err"]
    assert sched.stats()["worker_alive"] is False
    assert sched.job(job).state == QUEUED    # survives for recover=True
    with pytest.raises(RuntimeError, match="shut down"):
        sched.submit(_spec())


def test_worker_death_aborts_streams(tmp_path, monkeypatch):
    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    sched = _sched(tmp_path, paused=True)
    job = sched.submit(_spec(generations=40))
    q = sched.registry.subscribe(job)

    def die(ready):
        raise RuntimeError("dispatcher bug")

    sched._take_unit = die
    sched.resume_dispatch()
    end = q.get(timeout=T)
    assert end["status"] == "aborted" and "worker died" in end["error"]
    sched._worker.join(T)
    assert sched.stats()["worker_alive"] is False
    sched.shutdown()
    assert sched.job(job).state == QUEUED


# ---------------------------------------------------------------------------
# Against the JAX package's scheduler
# ---------------------------------------------------------------------------


def _lut(**kw):
    return _kw(mode="lut", bits_per_var=8, gens_per_epoch=1, **kw)


JOBS = [_lut(seed=11, generations=30), _lut(seed=40, generations=30),
        _lut(seed=7, n_repeats=2, generations=30),
        _lut(problem="F1", seed=5, generations=30),
        _lut(seed=9, generations=30, n_islands=2, migrate_every=5)]


def _run_jax(tmp_path):
    sched = JSCHED.GAScheduler(registry=JENG.GAMetricsRegistry(),
                               backend="reference", max_pack=4,
                               chunk_generations=10, paused=True,
                               ckpt_root=str(tmp_path / "jax"),
                               options=JGA.EngineOptions(cost_table=False,
                                                         faults=False))
    try:
        ids = [sched.submit(JGA.GASpec(**kw),
                            backend="islands" if "n_islands" in kw else None)
               for kw in JOBS]
        sched.resume_dispatch()
        return [sched.result(i, timeout=T) for i in ids], sched.stats()
    finally:
        sched.shutdown()


def test_scheduler_matches_the_jax_scheduler(tmp_path):
    sched = _sched(tmp_path, max_pack=4, chunk_generations=10, paused=True,
                   faults=False)
    try:
        ids = [sched.submit(ga.GASpec(**kw),
                            backend="islands" if "n_islands" in kw else None)
               for kw in JOBS]
        sched.resume_dispatch()
        got = [sched.result(i, timeout=T) for i in ids]
        stats = sched.stats()
    finally:
        sched.shutdown()
    want, jstats = _run_jax(tmp_path)
    for g, w in zip(got, want):
        assert g["pack_size"] == w["pack_size"]
        assert g["backend"] == w["backend"]
        assert g["best_fitness"] == w["best_fitness"]
        assert g["best_params"] == w["best_params"]
        assert g["migrations"] == w["migrations"]
    assert [g["pack_size"] for g in got] == [3, 3, 3, 1, 1]
    for key in ("packs_launched", "jobs_packed", "preemptions", "retries"):
        assert stats[key] == jstats[key], key


def test_a_jax_scheduler_root_recovers_in_the_port(tmp_path):
    """A JAX scheduler shut down with a frozen pack pending (a crash, then a
    backoff its clock never reaches) leaves its journal and its pack
    checkpoint; the port's scheduler on the same root resumes the pack and
    ends equal to the port's solo runs and the JAX ones."""
    root = str(tmp_path / "root")
    kws = [_lut(seed=11, generations=30), _lut(seed=40, generations=30)]
    inj = JFLT.FaultInjector()
    jsched = JSCHED.GAScheduler(registry=JENG.GAMetricsRegistry(),
                                backend="reference", chunk_generations=10,
                                paused=True, ckpt_root=root,
                                clock=FakeClock(), retry_backoff_s=1000.0,
                                options=JGA.EngineOptions(cost_table=False,
                                                          faults=inj))
    ids = [jsched.submit(JGA.GASpec(**kw)) for kw in kws]
    done_id = jsched.submit(JGA.GASpec(**_lut(problem="F1", seed=5,
                                              generations=10)))
    inj.add_rule(f"chunk_crash@{ids[0]}:at=2")
    jsched.resume_dispatch()
    jdone = jsched.result(done_id, timeout=T)
    with jsched._cv:
        assert jsched._cv.wait_for(
            lambda: any(u.attempts for u in jsched._queue), timeout=T)
    jsched.shutdown()

    sched = _sched(tmp_path, ckpt_root=root, chunk_generations=10,
                   recover=True, paused=True)
    try:
        assert sched.recovered_total == 2
        assert sched.result(done_id, timeout=T)["best_fitness"] == \
            jdone["best_fitness"]
        feed = sched.registry.subscribe(ids[0])
        sched.resume_dispatch()
        # the first chunk after the resume from the JAX step 10
        first = feed.get(timeout=T)
        assert (first["chunk"], first["gens_done"]) == (2, 20)
        for i, kw in zip(ids, kws):
            res = sched.result(i, timeout=T)
            _same_as_solo(res, ga.GASpec(**kw))
            want = JGA.solve(JGA.GASpec(**kw), backend="reference")
            assert res["best_fitness"] == want.best_fitness
            np.testing.assert_array_equal(res["best_params"],
                                          want.best_params)
    finally:
        sched.shutdown()


# ---------------------------------------------------------------------------
# The ga_serve CLI
# ---------------------------------------------------------------------------


def _serve(*args, timeout=T):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("REPRO_GA_FAULTS", None)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.ga_serve", *args],
        capture_output=True, text=True, timeout=timeout, env=env,
        cwd=str(ROOT))


def test_ga_serve_demo_on_the_cpu(tmp_path):
    out = _serve("--demo", "4", "--device", "cpu", "--port", "0",
                 "--chunk", "16", "--ckpt-root", str(tmp_path / "root"))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert "device: cpu" in lines
    assert sum(" best=" in ln and "backend=" in ln for ln in lines) == 4
    assert any(ln.startswith("packs=") and "preemptions=1" in ln
               for ln in lines), out.stdout

    # --recover alone restores the four results from the journal
    again = _serve("--recover", "--device", "cpu", "--ckpt-root",
                   str(tmp_path / "root"), "--stream", "none")
    assert again.returncode == 0, again.stderr
    assert "recovered 0 pending job(s) from the journal" in again.stdout


def test_ga_serve_jobs_file_and_refusals(tmp_path):
    jobs = tmp_path / "jobs.json"
    jobs.write_text(json.dumps([
        dict(problem="F3", n=32, bits_per_var=10, generations=16, seed=3),
        dict(problem="F3", n=32, bits_per_var=10, generations=16, seed=4,
             backend="reference", priority=1, deadline_s=600,
             max_retries=2)]))
    out = _serve("--jobs", str(jobs), "--device", "cpu", "--stream", "none",
                 "--faults", "off", "--sel-lane", "gather")
    assert out.returncode == 0, out.stderr
    assert "deadline=600.0s" in out.stdout
    assert out.stdout.count("backend=reference") == 2
    for args in ((), ("--demo", "2", "--jobs", str(jobs)),
                 ("--recover",), ("--demo", "2", "--mesh", "2")):
        bad = _serve(*args, "--device", "cpu")
        assert bad.returncode == 2, (args, bad.stdout)
