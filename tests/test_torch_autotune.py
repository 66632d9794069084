"""The port's autotune (`repro_torch.autotune`) against the JAX package's,
case for case with `tests/test_autotune.py` wherever the port has the
mechanism: replay stability on a fake timer (never sleeping), cost-table
lookup and persistence gates, `resolve_table`, the two-tier planner
(heuristic without a table, the measured argmax flipping and keeping,
interpolation, the uncovered fallback, `plan_override`), measured plans
bit-identical to the heuristic, plan fields in job metrics and /metrics,
the scheduler's ordering, counters and gauge, `estimate_gens_per_s` and
`plan_point`.  Then parity: a table file crosses between the packages,
and for one synthetic table both planners pick the same plan (JAX engines
are only constructed), and the sweep on the CPU."""

import dataclasses
import itertools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import autotune as JAT  # noqa: E402
from repro import ga as JGA  # noqa: E402
from repro.autotune import runner as JRUN  # noqa: E402
from repro.ga import compile_cache as JCC  # noqa: E402
from repro_torch import convert, ga  # noqa: E402
from repro_torch.autotune import (CostTable, Replay,  # noqa: E402
                                  replay_until_stable, resolve_table)
from repro_torch.autotune import runner as RUN  # noqa: E402
from repro_torch.autotune import table as table_mod  # noqa: E402
from repro_torch.ga import compile_cache as CC  # noqa: E402
from repro_torch.serve.engine import GAMetricsRegistry  # noqa: E402
from repro_torch.serve.scheduler import GAScheduler, Job, _Unit  # noqa: E402

CPU = ga.EngineOptions(device="cpu")
T = 300          # seconds any single wait may take


@pytest.fixture(autouse=True)
def _no_ambient_cost_table(monkeypatch):
    """No table found on the host reaches these engines: the ambient
    default is pinned off unless a test sets it itself."""
    monkeypatch.setenv("REPRO_GA_COST_TABLE", "off")


def _kw(**kw):
    base = dict(problem="F3", n=16, bits_per_var=8, mode="arith",
                mutation_rate=0.02, seed=1, generations=8,
                n_islands=2, migrate_every=4, gens_per_epoch=8)
    base.update(kw)
    return base


def _spec(**kw):
    return ga.GASpec(**_kw(**kw))


def _point(spec, mode, lane=None):
    return CC.plan_point(spec, executor="fused", mode=mode, n_shards=1,
                         lane=lane)


def _opts(**kw):
    return ga.EngineOptions(device="cpu", **kw)


def _topo(spec, **kw):
    return ga.Engine(spec, "fused-islands",
                     options=_opts(**kw)).backend.topology


# ---------------------------------------------------------------------------
# Replay-until-stable (deterministic fake timer)
# ---------------------------------------------------------------------------


class FakeTimer:
    """perf_counter stand-in fed a script of per-call durations."""

    def __init__(self, durations):
        self.durations = list(durations)
        self.now = 0.0
        self.i = 0

    def __call__(self):
        # replay calls the timer before and after each rep; advance on the
        # "after" call by consuming the next scripted duration
        if self.i % 2 == 1:
            self.now += self.durations.pop(0)
        self.i += 1
        return self.now


def test_replay_stops_at_min_reps_when_stable():
    calls = []
    timer = FakeTimer([1.0, 1.0, 1.0, 1.0])
    rep = replay_until_stable(lambda: calls.append(1), warmup=1,
                              min_reps=3, max_reps=16, cov_threshold=0.10,
                              timer=timer)
    assert isinstance(rep, Replay)
    assert rep.stable and rep.reps == 3
    assert rep.mean_s == pytest.approx(1.0)
    assert rep.cov == pytest.approx(0.0)
    assert len(calls) == 4            # 1 warmup (untimed) + 3 timed


def test_replay_keeps_going_until_cov_settles():
    timer = FakeTimer([1.0, 3.0, 1.0, 1.0, 1.0, 1.0])
    rep = replay_until_stable(lambda: None, warmup=0, min_reps=3,
                              max_reps=16, cov_threshold=0.05, window=3,
                              timer=timer)
    assert rep.stable
    assert rep.reps > 3
    assert rep.mean_s == pytest.approx(1.0)


def test_replay_gives_up_at_max_reps():
    timer = FakeTimer([1.0, 5.0] * 4)
    rep = replay_until_stable(lambda: None, warmup=0, min_reps=2,
                              max_reps=8, cov_threshold=0.01, timer=timer)
    assert not rep.stable
    assert rep.reps == 8
    assert rep.cov > 0.01


def test_replay_validates_arguments():
    with pytest.raises(ValueError):
        replay_until_stable(lambda: None, min_reps=1)
    with pytest.raises(ValueError):
        replay_until_stable(lambda: None, min_reps=4, max_reps=2)


@pytest.mark.parametrize("durations", [[1.0] * 4, [1.0, 3.0, 1.0, 1.0, 1.0,
                                                    1.0], [1.0, 5.0] * 8])
def test_replay_equals_jax_on_the_same_clock(durations):
    kw = dict(warmup=0, min_reps=3, max_reps=8, cov_threshold=0.05)
    got = replay_until_stable(lambda: None, timer=FakeTimer(durations), **kw)
    want = JAT.replay_until_stable(lambda: None,
                                   timer=FakeTimer(durations), **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---------------------------------------------------------------------------
# CostTable: lookup semantics + persistence gates
# ---------------------------------------------------------------------------


def test_lookup_exact_interpolated_and_out_of_range():
    spec = _spec()
    pt = _point(spec, "resident")
    t = CostTable(host={"platform": "cpu", "device_count": 1})
    t.add(pt, 4, 100.0)
    t.add(pt, 12, 200.0)
    assert t.lookup(pt, 4) == 100.0                      # exact
    assert t.lookup(pt, 8) == pytest.approx(150.0)       # linear midpoint
    assert t.lookup(pt, 6) == pytest.approx(125.0)
    assert t.lookup(pt, 2) is None                       # no extrapolation
    assert t.lookup(pt, 16) is None
    assert t.lookup(_point(spec, "gridded"), 4) is None  # unknown point
    assert len(t) == 2


def test_table_roundtrip_and_merge(tmp_path):
    spec = _spec()
    t = CostTable(host={"platform": "cuda", "device_count": 1})
    t.add(_point(spec, "resident"), 8, 123.4, reps=5, cov=0.02)
    path = t.save(str(tmp_path / "table.json"))
    back = CostTable.load(path)
    assert back is not None
    assert back.lookup(_point(spec, "resident"), 8) == 123.4
    assert back.host == t.host
    other = CostTable()
    other.add(_point(spec, "resident"), 8, 999.0)
    other.add(_point(spec, "gridded"), 4, 50.0)
    back.merge(other)
    assert back.lookup(_point(spec, "resident"), 8) == 999.0  # other wins
    assert len(back) == 2


def test_load_rejects_stale_version_and_foreign_host(tmp_path):
    spec = _spec()
    t = CostTable(host={"platform": "cuda", "device_count": 8})
    t.add(_point(spec, "resident"), 8, 1.0)
    path = str(tmp_path / "t.json")
    t.save(path)
    # strict (ambient) load: host mismatch -> silently None
    assert CostTable.load(path, expect_host={"platform": "cuda",
                                             "device_count": 4}) is None
    assert CostTable.load(path, expect_host={"platform": "cpu",
                                             "device_count": 8}) is None
    # trusted load ignores the host
    assert CostTable.load(path) is not None
    obj = json.load(open(path))
    obj["version"] = -99
    json.dump(obj, open(path, "w"))
    with pytest.warns(UserWarning, match="version"):
        assert CostTable.load(path) is None


def test_resolve_table_forms(tmp_path, monkeypatch):
    assert resolve_table(False) is None
    t = CostTable()
    assert resolve_table(t) is t
    with pytest.raises(TypeError):
        resolve_table(42)
    for off in ("", "off", "none", "0"):
        monkeypatch.setenv("REPRO_GA_COST_TABLE", off)
        assert resolve_table(None) is None
    spec = _spec()
    t2 = CostTable(host={"platform": "weird", "device_count": 3})
    t2.add(_point(spec, "resident"), 8, 7.0)
    path = t2.save(str(tmp_path / "pinned.json"))
    monkeypatch.setenv("REPRO_GA_COST_TABLE", path)
    got = resolve_table(None)          # env pin is trusted: host ignored
    assert got is not None and got.lookup(_point(spec, "resident"), 8) == 7.0
    assert resolve_table(path) is not None     # explicit path, same deal


def test_ambient_discovery_reads_the_ports_file_not_the_jax_one(
        tmp_path, monkeypatch):
    """One cache directory, two files: a JAX table beside the port's is
    never read, and the port's own loads strictly (its host must match)."""
    monkeypatch.delenv("REPRO_GA_COST_TABLE")
    monkeypatch.setenv("REPRO_GA_AUTOTUNE_CACHE", str(tmp_path))
    assert table_mod.default_table_path() == str(
        tmp_path / "torch_cost_table.json")
    assert JAT.default_table_path() == str(tmp_path / "cost_table.json")
    spec = _spec()
    jt = JAT.CostTable(host=JAT.host_fingerprint())
    jt.add(JCC.plan_point(JGA.GASpec(**_kw()), executor="fused",
                          mode="resident", n_shards=1), 8, 5.0)
    jt.save(JAT.default_table_path())
    assert resolve_table(None) is None          # the JAX file stays unread
    mine = CostTable(host=table_mod.host_fingerprint())
    mine.add(_point(spec, "resident"), 8, 6.0)
    mine.save(table_mod.default_table_path())
    assert resolve_table(None).lookup(_point(spec, "resident"), 8) == 6.0
    foreign = CostTable(host={"platform": "cuda", "device_count": 99})
    foreign.add(_point(spec, "resident"), 8, 7.0)
    foreign.save(table_mod.default_table_path())
    os.utime(table_mod.default_table_path(), ns=(1, 1))   # a fresh memo key
    assert resolve_table(None) is None


def test_host_fingerprint_reads_torch(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert table_mod.host_fingerprint() == {
        "platform": "cpu", "device_kind": "cpu", "device_count": 1}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "H100")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    fp = table_mod.host_fingerprint()
    assert fp == {"platform": "cuda", "device_kind": "H100",
                  "device_count": 4}
    assert table_mod.hosts_match(fp, dict(fp, device_kind="other"))
    assert not table_mod.hosts_match(fp, dict(fp, device_count=1))


# ---------------------------------------------------------------------------
# Planner decision matrix (tier 2: measured argmax over feasible modes)
# ---------------------------------------------------------------------------


def test_no_table_plan_is_exactly_the_heuristic():
    topo = _topo(_spec(), cost_table=False)
    heur = topo.epoch_candidates()[0]
    assert topo.plan["plan_source"] == "heuristic"
    assert {k: topo.plan[k] for k in heur} == heur
    assert "plan_gens_per_s" not in topo.plan


def test_measured_argmax_flips_the_mode():
    spec = _spec()
    t = CostTable()
    t.add(_point(spec, "resident"), 8, 10.0)
    t.add(_point(spec, "gridded"), 4, 100.0)
    topo = _topo(spec, cost_table=t)
    assert topo.plan["mode"] == "gridded"
    assert topo.plan["plan_source"] == "measured"
    assert topo.plan["plan_gens_per_s"] == 100.0


def test_measured_argmax_keeps_heuristic_winner():
    spec = _spec()
    t = CostTable()
    t.add(_point(spec, "resident"), 8, 100.0)
    t.add(_point(spec, "gridded"), 4, 10.0)
    topo = _topo(spec, cost_table=t)
    assert topo.plan["mode"] == "resident"
    assert topo.plan["plan_source"] == "measured"


def test_partial_table_interpolates_on_the_launch_axis():
    spec = _spec()
    t = CostTable()
    # resident measured at brackets of its g=8 launch; gridded exact
    t.add(_point(spec, "resident"), 4, 100.0)
    t.add(_point(spec, "resident"), 12, 300.0)
    t.add(_point(spec, "gridded"), 4, 150.0)
    topo = _topo(spec, cost_table=t)
    # resident interpolates to 200 at g=8 and beats gridded's 150
    assert topo.plan["mode"] == "resident"
    assert topo.plan["plan_gens_per_s"] == pytest.approx(200.0)


def test_table_not_covering_heuristic_falls_back_bit_identically():
    spec = _spec()
    t = CostTable()
    t.add(_point(spec, "gridded"), 4, 9999.0)   # only the alternative
    topo = _topo(spec, cost_table=t)
    heur = _topo(spec, cost_table=False).plan
    assert topo.plan == heur
    assert topo.plan["plan_source"] == "heuristic"


def test_cross_lane_pick_rebuilds_what_the_runners_close_over():
    """sel_lane="auto": the other lane's measured-only candidate wins, and
    the topology then runs that lane — without touching the executor the
    runner cache shares with other engines."""
    spec = _spec()
    t = CostTable()
    t.add(_point(spec, "resident"), 8, 10.0)
    t.add(_point(spec, "resident", lane="gather"), 8, 50.0)
    eng = ga.Engine(spec, "fused-islands", options=_opts(cost_table=t))
    topo = eng.backend.topology
    assert (topo.plan["lane"], topo.plan["plan_source"]) == ("gather",
                                                            "measured")
    assert topo.cfg.sel_lane == topo.icfg.ga.sel_lane == "gather"
    assert topo.executor.cfg.sel_lane == "gather"
    assert eng.backend.executor is topo.executor
    shared = ga.Engine(spec, "fused-islands",
                       options=_opts(cost_table=False)).backend
    assert shared.executor is not topo.executor
    assert shared.executor.cfg.sel_lane == "onehot"
    assert topo.spec.compile_key() != shared.spec.compile_key()
    # a pinned lane never crosses
    pinned = _topo(dataclasses.replace(spec, sel_lane="onehot"),
                   cost_table=t)
    assert pinned.plan["lane"] == "onehot"


@pytest.mark.parametrize("migration", ["ring", "none"])
def test_measured_plan_results_bit_identical_to_heuristic(migration):
    spec = _spec(migration=migration, generations=16)
    t = CostTable()
    heur_mode = "resident" if migration == "ring" else "gridded"
    other = "gridded" if migration == "ring" else "resident-free"
    t.add(_point(spec, heur_mode), 8 if migration == "ring" else 4, 10.0)
    t.add(_point(spec, other), 4 if migration == "ring" else 8, 100.0)
    meas = ga.solve(spec, backend="fused-islands",
                    options=_opts(cost_table=t))
    heur = ga.solve(spec, backend="fused-islands",
                    options=_opts(cost_table=False))
    assert (meas.telemetry.plan.mode, meas.telemetry.plan.source) == (
        other, "measured")
    assert meas.telemetry.plan.gens_per_s == 100.0
    assert heur.telemetry.plan.mode == heur_mode
    assert meas.best_fitness == heur.best_fitness
    np.testing.assert_array_equal(meas.best_x, heur.best_x)
    for a, b in zip(convert.state_to_numpy(meas.state),
                    convert.state_to_numpy(heur.state)):
        np.testing.assert_array_equal(a, b)


def test_plan_override_forces_and_validates():
    spec = _spec()
    t = CostTable()
    t.add(_point(spec, "resident"), 8, 10.0)
    t.add(_point(spec, "gridded"), 4, 100.0)
    topo = _topo(spec, cost_table=t, plan_override="resident")
    assert topo.plan["mode"] == "resident"     # the table is skipped
    assert topo.plan["plan_source"] == "forced"
    assert "plan_gens_per_s" not in topo.plan
    with pytest.raises(ValueError, match="not feasible"):
        _topo(spec, cost_table=False, plan_override="streamed")
    with pytest.raises(ValueError, match="plan_override"):
        _topo(spec, cost_table=False, plan_override="resident-sharded")


def test_segments_replay_from_one_state():
    """The runners never write into their input: replaying `segment` from
    one state (as the sweep does) gives the same result every time and
    leaves the state as it was, under every plan."""
    spec = _spec(generations=16)
    for mode in ("resident", "gridded"):
        eng = ga.Engine(spec, "fused-islands",
                        options=_opts(cost_table=False, plan_override=mode))
        state = eng.init_state()
        before = [t.clone() for t in state]
        a = eng.backend.segment(state, 8)
        b = eng.backend.segment(state, 8)
        for x, y in zip(before, state):
            assert torch.equal(x, y)
        assert a.best_y == b.best_y
        for x, y in zip(a.state, b.state):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# Plan provenance through job telemetry
# ---------------------------------------------------------------------------


def test_plan_fields_flow_into_job_metrics():
    reg = GAMetricsRegistry()
    spec = _spec()
    eng = ga.Engine(spec, "fused-islands", options=_opts(cost_table=False))
    jid = reg.allocate_job_id("F3")
    reg.start_job(jid, backend=eng.backend_name, gens_total=spec.generations)
    for tele in eng.run_chunked():
        reg.record_chunk(jid, tele)
    reg.finish_job(jid)
    m = reg.metrics()["jobs"][jid]
    assert m["epoch_mode"] == "resident"
    assert m["plan_source"] == "heuristic"
    assert m["plan_fallback"] is None


def test_metrics_http_renders_autotune_gauges():
    from repro_torch.serve.metrics_http import render_prometheus
    text = render_prometheus({
        "jobs": {},
        "scheduler": {"queue_depth": 0, "jobs_evicted": 3,
                      "plans_measured": 2, "plans_heuristic": 5,
                      "plan_table_entries": 6}})
    for gauge in ("repro_ga_sched_evicted_total 3",
                  "repro_ga_plan_measured_total 2",
                  "repro_ga_plan_heuristic_total 5",
                  "repro_ga_plan_table_entries 6"):
        assert gauge in text


# ---------------------------------------------------------------------------
# Scheduler: cost-table-aware dispatch ordering
# ---------------------------------------------------------------------------


def _sched(tmp_path, **kw):
    kw.setdefault("registry", GAMetricsRegistry())
    kw.setdefault("backend", "reference")
    kw.setdefault("options", _opts(faults=False))
    return GAScheduler(ckpt_root=str(tmp_path / "root"), **kw)


def test_unit_ordering_shortest_estimated_wall_first(tmp_path):
    sched = _sched(tmp_path, cost_table=False)
    try:
        seq = itertools.count()

        def unit(gens, est, priority=0):
            j = Job(job_id=f"j{next(seq)}", spec=_spec(generations=gens),
                    priority=priority, est_gens_per_s=est)
            return _Unit(seq=next(seq), jobs=[j])

        a, b, c = unit(100, 10.0), unit(100, 50.0), unit(100, None)
        # estimated units outrank unestimated; shorter wall wins among them
        assert max([a, b, c], key=sched._unit_order_key) is b
        # without any estimate the key reduces to (priority, FIFO)
        u0, u1 = unit(100, None), unit(100, None)
        assert max([u1, u0], key=sched._unit_order_key) is u0
        # priority still dominates every estimate
        hot = unit(100, None, priority=10)
        assert max([a, b, hot], key=sched._unit_order_key) is hot
        # the same ordering as the JAX scheduler's key on the same units
        from repro.serve import scheduler as JSCHED
        for us in ([a, b, c], [u1, u0], [a, b, hot]):
            want = [JSCHED._Unit(seq=u.seq, jobs=[JSCHED.Job(
                job_id=j.job_id, spec=j.spec, priority=j.priority,
                est_gens_per_s=j.est_gens_per_s) for j in u.jobs])
                for u in us]
            assert ([sched._unit_order_key(u) for u in us]
                    == [JSCHED.GAScheduler._unit_order_key(None, u)
                        for u in want])
    finally:
        sched.shutdown()


def test_scheduler_plan_counters_and_table_gauge(tmp_path):
    spec = _spec()
    t = CostTable()
    t.add(_point(spec, "resident"), 8, 10.0)
    t.add(_point(spec, "gridded"), 4, 100.0)
    reg = GAMetricsRegistry()
    sched = _sched(tmp_path, registry=reg, backend="fused-islands",
                   cost_table=t)
    try:
        jid = sched.submit(spec)
        res = sched.result(jid, timeout=T)
        stats = sched.stats()
        assert stats["plans_measured"] == 1
        assert stats["plans_heuristic"] == 0
        assert stats["plan_table_entries"] == 2
        assert sched.job(jid).est_gens_per_s == 100.0
        assert reg.metrics()["jobs"][jid]["plan_source"] == "measured"
        assert reg.metrics()["jobs"][jid]["epoch_mode"] == "gridded"
        # measured plan, identical result
        solo = ga.solve(spec, backend="fused-islands",
                        options=_opts(cost_table=False))
        assert res["best_fitness"] == solo.best_fitness
    finally:
        sched.shutdown()


@pytest.mark.parametrize("cost_table,source", [(False, "heuristic"),
                                                (None, "measured")])
def test_scheduler_engines_follow_its_table_not_discovery(
        tmp_path, monkeypatch, cost_table, source):
    """An ambient table on the host reaches the packs only when the
    scheduler discovers it (None): False pins every engine it builds to
    the heuristic, so its counters and its gauge agree with its plans."""
    spec = _spec()
    t = CostTable()
    t.add(_point(spec, "resident"), 8, 10.0)
    t.add(_point(spec, "gridded"), 4, 100.0)
    monkeypatch.setenv("REPRO_GA_COST_TABLE",
                       t.save(str(tmp_path / "ambient.json")))
    reg = GAMetricsRegistry()
    sched = _sched(tmp_path, registry=reg, backend="fused-islands",
                   cost_table=cost_table)
    try:
        jid = sched.submit(spec)
        sched.result(jid, timeout=T)
        stats = sched.stats()
        measured = source == "measured"
        assert stats["plans_measured"] == int(measured)
        assert stats["plans_heuristic"] == int(not measured)
        assert stats["plan_table_entries"] == (2 if measured else 0)
        assert reg.metrics()["jobs"][jid]["plan_source"] == source
    finally:
        sched.shutdown()


def test_scheduler_refuses_two_tables(tmp_path):
    with pytest.raises(ValueError, match="both"):
        _sched(tmp_path, cost_table=CostTable(),
               options=_opts(cost_table=CostTable()))


def test_estimate_gens_per_s(monkeypatch):
    from repro_torch.autotune import estimate_gens_per_s
    spec = _spec()
    assert estimate_gens_per_s(spec, None) is None
    t = CostTable()
    t.add(_point(spec, "resident"), 8, 42.0)
    t.add(_point(spec, "gridded"), 4, 1.0)
    assert estimate_gens_per_s(spec, t, backend="fused-islands",
                               options=CPU) == pytest.approx(42.0)
    # an engine that cannot be built (a card asked for on a host without
    # one) has no estimate, never an error
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert estimate_gens_per_s(spec, t, backend="fused-islands",
                               options=ga.EngineOptions()) is None


# ---------------------------------------------------------------------------
# plan_point identity discipline
# ---------------------------------------------------------------------------


def test_plan_point_excludes_seed_generations_and_repeats():
    a = _point(_spec(seed=1, generations=8), "resident")
    b = _point(_spec(seed=99, generations=800, n_repeats=4), "resident")
    assert a == b
    assert _point(_spec(n=32), "resident") != a
    assert a["stage"].startswith("F3:v")
    assert a == JCC.plan_point(JGA.GASpec(**_kw()), executor="fused",
                               mode="resident", n_shards=1)


# ---------------------------------------------------------------------------
# Parity: tables cross, and one table plans the same in both packages
# ---------------------------------------------------------------------------


def _synthetic(mod_table, plan_point, spec_cls):
    """One table written through either package's API: points of the
    shapes the parity cases use, both lanes, several launch depths."""
    t = mod_table.CostTable(host={"platform": "cpu", "device_count": 1})
    rates = {("resident", "onehot"): 120.0, ("resident", "gather"): 90.0,
             ("gridded", "onehot"): 150.0, ("gridded", "gather"): 160.0,
             ("resident-free", "onehot"): 200.0,
             ("resident-free", "gather"): 210.0}
    for islands, gpe, migration in ((2, 8, "ring"), (4, 16, "ring"),
                                    (8, 8, "ring"), (4, 16, "none")):
        spec = spec_cls(**_kw(n_islands=islands, gens_per_epoch=gpe,
                              generations=gpe, migration=migration))
        for (mode, lane), v in rates.items():
            pt = plan_point(spec, executor="fused", mode=mode, n_shards=1,
                            lane=lane)
            for g in (4, 8, 16):
                t.add(pt, g, v * (1 + g / 64) + islands, reps=3, cov=0.01)
    return t


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_table_crosses_between_the_packages(tmp_path, writer):
    jt = _synthetic(JAT.table, JCC.plan_point, JGA.GASpec)
    tt = _synthetic(table_mod, CC.plan_point, ga.GASpec)
    assert jt.to_json() == tt.to_json()
    path = str(tmp_path / "t.json")
    (jt if writer == "jax" else tt).save(path)
    j_back, t_back = JAT.CostTable.load(path), CostTable.load(path)
    assert j_back.to_json() == t_back.to_json()
    for e in t_back.entries():
        pt = {f: e[f] for f in table_mod.POINT_FIELDS}
        for g in (4, 6, 8, 12, 16, 20):
            assert t_back.lookup(pt, g) == j_back.lookup(pt, g)


PARITY = [dict(), dict(n_islands=4, gens_per_epoch=16, generations=16),
          dict(n_islands=8), dict(n_islands=4, gens_per_epoch=16,
                                  generations=16, migration="none"),
          dict(sel_lane="gather"), dict(sel_lane="onehot", n_islands=4,
                                        gens_per_epoch=16, generations=16),
          dict(n=32)]


@pytest.mark.parametrize("kw", PARITY, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()) or "base")
def test_planners_pick_the_same_plan_as_jax(kw):
    """With one synthetic table (and, for the last case, a spec it does not
    cover) the port's planner and the JAX package's pick the same mode,
    lane, source and rate; the JAX engine is only constructed."""
    jt = _synthetic(JAT.table, JCC.plan_point, JGA.GASpec)
    tt = _synthetic(table_mod, CC.plan_point, ga.GASpec)
    got = _topo(_spec(**kw), cost_table=tt).plan
    want = JGA.Engine(JGA.GASpec(**_kw(**kw)), "fused-islands",
                      options=JGA.EngineOptions(cost_table=jt)
                      ).backend.topology.plan
    keys = ("mode", "lane", "plan_source", "plan_gens_per_s",
            "gens_per_launch", "epochs_per_launch")
    assert {k: got.get(k) for k in keys} == {k: want.get(k) for k in keys}


# ---------------------------------------------------------------------------
# The sweep (CPU, fake timer)
# ---------------------------------------------------------------------------


def test_sweep_lanes_as_in_jax():
    for kw in (dict(), dict(sel_lane="gather"), dict(n=2048),
               dict(n=48, n_islands=1)):
        assert RUN.sweep_lanes(_spec(**kw)) == JRUN.sweep_lanes(
            JGA.GASpec(**_kw(**kw)))


def test_plan_candidates_are_the_planners_list():
    spec = _spec()
    cands = RUN.plan_candidates(spec, backend="fused-islands", options=CPU)
    assert [c["mode"] for c in cands] == ["resident", "gridded"]
    assert cands == _topo(spec, cost_table=False).epoch_candidates()
    assert RUN.plan_candidates(_spec(n_islands=1), backend="reference",
                               options=CPU) == []


def test_sweep_measures_every_candidate_of_both_lanes():
    specs = [_spec(), _spec(migration="none")]
    lines = []
    timer = FakeTimer([0.125] * 200)     # exact in binary: equal rates
    table = RUN.sweep(specs, backend="fused-islands", options=CPU,
                      min_reps=2, max_reps=4, timer=timer, log=lines.append)
    assert table.host == table_mod.host_fingerprint()
    modes = sorted((e["mode"], e["lane"], e["migration"])
                   for e in table.entries())
    assert modes == sorted(
        (m, lane, mig) for lane in ("gather", "onehot")
        for m, mig in (("resident", "ring"), ("gridded", "ring"),
                       ("gridded", "none"), ("resident-free", "none")))
    for e in table.entries():
        # a segment of gens_per_epoch=8 generations, 0.125 s a replay
        assert e["gens_per_s"] == 64.0
        assert e["reps"] == 2 and e["cov"] == 0.0
    assert len(lines) == 8 and all("stable" in ln for ln in lines)
    # the table plans: every rate equal, so the heuristic's point wins ties
    topo = _topo(specs[0], cost_table=table)
    assert (topo.plan["mode"], topo.plan["plan_source"]) == ("resident",
                                                            "measured")


def test_measure_candidate_row():
    spec = _spec()
    row = RUN.measure_candidate(spec, "gridded", backend="fused-islands",
                                options=CPU, min_reps=2, max_reps=2,
                                timer=FakeTimer([0.5, 0.5]))
    assert row["point"] == _point(spec, "gridded")
    assert row["gens_per_launch"] == 4
    assert row["gens_per_s"] == pytest.approx(16.0)
    assert isinstance(row["replay"], Replay) and row["replay"].reps == 2
