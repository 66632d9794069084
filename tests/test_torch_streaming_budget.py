"""The planning shared-memory budget of the port (`EngineOptions.
smem_budget`, the JAX package's `vmem_budget`) and the streamed mode it
reaches at 8 islands or fewer, on the CPU, held against the JAX package's
tests/test_streaming.py from the same specs and seeds.

* The candidate lists around the budget: the modes, their order and their
  `gens_per_launch` are JAX's under the same forcing (JAX's budget in VMEM
  bytes of `resident_vmem_bytes`, the port's in shared-memory bytes of
  `resident_smem_bytes`, each sized to 5 of the spec's 8 islands).  The
  tile is the port's own: 1 on the CPU.
* Every budgeted run against JAX's `islands` backend: the uint32 state
  (population and the three LFSR banks) and `best_x` bit-exact; F1-F3's
  best and trajectory exact, rastrigin's within ``1e-6 * max|y|`` (hazard
  H1: XLA's CPU jit contracts the decode into an FMA, as in
  tests/test_torch_islands.py).  Against the port's own `islands` every
  plan is bit-exact, trajectory folded at the launch boundaries.
* With no budget every candidate list is the card's own limits' list, as
  before the budget existed; a budgeted and an unbudgeted engine of one
  spec share the runner cache in either order without taking each
  other's runner.
"""

import argparse
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import ga as JGA  # noqa: E402
from repro.kernels import ga_step as JK  # noqa: E402
from repro_torch import convert, ga  # noqa: E402
from repro_torch.autotune import runner as RUN  # noqa: E402
from repro_torch.core import ga as TG  # noqa: E402
from repro_torch.ga import compile_cache as CC  # noqa: E402
from repro_torch.ga.options import EngineOptions  # noqa: E402
from repro_torch.kernels import ga_step as K  # noqa: E402

Y_TOL = 1e-6
EXACT = ("F1", "F2", "F3")


@pytest.fixture(autouse=True)
def _no_ambient_cost_table(monkeypatch):
    """The plans here are the heuristic's or forced: no cost table found on
    the host may move them."""
    monkeypatch.setenv("REPRO_GA_COST_TABLE", "off")


def _kw(**kw):
    """The spec of tests/test_streaming.py: F3, N 16, 8 islands."""
    base = dict(problem="F3", n=16, bits_per_var=8, mode="arith",
                mutation_rate=0.02, seed=1, generations=16, n_islands=8,
                migrate_every=4, gens_per_epoch=8)
    base.update(kw)
    return base


def _budget(kw, islands=5):
    """A planning budget of `islands` islands' K2 blocks: under the 8-island
    epoch, so the streamed lane engages."""
    return K.resident_smem_bytes(ga.GASpec(**kw).ga_config(), islands)


def _opts(**kw):
    return ga.EngineOptions(device="cpu", cost_table=False, **kw)


def _segment(kw, backend, gens, **opts):
    eng = ga.Engine(ga.GASpec(**kw), backend, options=_opts(**opts))
    return eng.backend.segment(eng.init_state(), gens)


def _jax_segment(kw, gens):
    eng = JGA.Engine(JGA.GASpec(**kw), "islands",
                     options=JGA.EngineOptions(cost_table=False))
    return eng.backend.segment(eng.init_state(), gens)


def _jax_state(s):
    return tuple(np.asarray(t) for t in (s.x, s.sel_lfsr, s.cross_lfsr,
                                         s.mut_lfsr, s.k))


def _shape(cands):
    return [(c["mode"], c["epochs_per_launch"], c["gens_per_launch"])
            for c in cands]


def _fold(traj, per, minimize):
    t = np.asarray(traj).reshape(-1, per)
    return t.min(axis=1) if minimize else t.max(axis=1)


def _assert_matches_jax(seg, kw, jseg):
    """State and best_x bit-exact against JAX's islands; best and the
    trajectory (folded at the port's launch boundaries) exact on F1-F3,
    within the H1 bound elsewhere."""
    for name, a, b in zip(("x", "sel", "cross", "mut", "k"),
                          convert.state_to_numpy(seg.state),
                          _jax_state(jseg.state)):
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(seg.best_x, np.asarray(jseg.best_x))
    per = (seg.telemetry.topology.telemetry_unit_gens
           // jseg.telemetry.topology.telemetry_unit_gens)
    want = _fold(jseg.traj_best, per, ga.GASpec(**kw).minimize)
    if kw["problem"] in EXACT:
        assert seg.best_y == float(jseg.best_y)
        np.testing.assert_array_equal(seg.traj_best, want)
    else:
        jy = np.asarray(JGA.GASpec(**kw).program().stage(jseg.state.x))
        bound = Y_TOL * np.max(np.abs(jy))
        assert abs(seg.best_y - float(jseg.best_y)) <= bound
        assert np.max(np.abs(seg.traj_best - want)) <= bound


def _assert_same_run(a, b, per=1):
    """a and b bit-identical in state, best and best_x; a's trajectory is
    b's folded `per` samples at a time (the specs here minimize)."""
    for name, x, y in zip(("x", "sel", "cross", "mut", "k"),
                          convert.state_to_numpy(a.state),
                          convert.state_to_numpy(b.state)):
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert a.best_y == b.best_y
    np.testing.assert_array_equal(a.best_x, b.best_x)
    np.testing.assert_array_equal(a.traj_best, _fold(b.traj_best, per, True))


# ---------------------------------------------------------------------------
# the planner around the budget (tests/test_streaming.py:39, :66)
# ---------------------------------------------------------------------------


RING = dict(executor="fused", migration="ring", gens_per_epoch=8,
            migrate_every=4)


def test_candidate_boundaries_around_the_budget():
    """Resident at the budget, streamed one byte under it, gridded alone
    when not even one K3 block fits; the shapes are JAX's under the same
    forcing."""
    cfg = ga.GASpec(**_kw()).ga_config()
    fit = K.resident_smem_bytes(cfg, 8)
    # K2 holds 16-bit population words at c = 8; K3 (below) 32-bit ones
    assert fit == 8 * K.epoch_smem_bytes(cfg.n, cfg.v, cfg.p, 16)
    cands = K.epoch_mode_candidates(cfg, 8, budget=fit, **RING)
    assert [c["mode"] for c in cands] == ["resident", "gridded"]
    cands = K.epoch_mode_candidates(cfg, 8, budget=fit - 1, **RING)
    assert [c["mode"] for c in cands] == ["streamed", "gridded"]
    s = cands[0]
    assert s["tile_islands"] == 1
    assert "smem_budget" in s["fallback"] and str(fit) in s["fallback"]
    assert s["epochs_per_launch"] == 2 and s["gens_per_launch"] == 8
    jcfg = JGA.GASpec(**_kw()).ga_config()
    jc = JK.epoch_mode_candidates(jcfg, 8, sharded=False,
                                  budget=JK.resident_vmem_bytes(jcfg, 5),
                                  **RING)
    assert _shape(cands) == _shape(jc)
    # one K3 block is the floor: at it a tile of 1, below it gridded only
    floor = K.epoch_smem_bytes(cfg.n, cfg.v, cfg.p)
    assert K.streamed_tile_islands(cfg, 1, 8, budget=floor) == 1
    assert K.streamed_tile_islands(cfg, 1, 8, budget=floor - 1) is None
    cands = K.epoch_mode_candidates(cfg, 8, budget=floor - 1, **RING)
    assert [c["mode"] for c in cands] == ["gridded"]
    assert "smem_budget" in cands[0]["fallback"]
    jc = JK.epoch_mode_candidates(jcfg, 8, sharded=False,
                                  budget=2 * JK.resident_vmem_bytes(jcfg, 1)
                                  - 1, **RING)
    assert _shape(cands) == _shape(jc)


def test_budget_weighs_each_kernel_at_its_own_layout():
    """The budget weighs K2's 16-bit blocks (c = 8) against the resident
    epoch and one 32-bit K3 block against the streamed lane: at two
    islands one K2 block is under one K3 block, so a budget of one
    island's K2 blocks plans gridded alone, and one byte short of the
    two islands' plans streamed."""
    cfg = ga.GASpec(**_kw(n_islands=2)).ga_config()
    k2, k3 = K.resident_block_bytes(cfg), K.epoch_smem_bytes(cfg.n, cfg.v,
                                                             cfg.p)
    assert k2 < k3 < 2 * k2
    one = K.epoch_mode_candidates(cfg, 2, budget=K.resident_smem_bytes(
        cfg, 1), **RING)
    assert [c["mode"] for c in one] == ["gridded"]
    short = K.epoch_mode_candidates(cfg, 2, budget=K.resident_smem_bytes(
        cfg, 2) - 1, **RING)
    assert [c["mode"] for c in short] == ["streamed", "gridded"]


def test_migration_none_keeps_gridded_heuristic():
    """Without a ring the streamed candidate is offered for a table or an
    override to pick, and gridded stays the heuristic, as in JAX."""
    kw = _kw()
    cfg = ga.GASpec(**kw).ga_config()
    args = dict(executor="fused", migration="none", gens_per_epoch=16,
                migrate_every=4)
    cands = K.epoch_mode_candidates(cfg, 8, budget=_budget(kw), **args)
    assert [c["mode"] for c in cands] == ["gridded", "streamed"]
    jcfg = JGA.GASpec(**kw).ga_config()
    jc = JK.epoch_mode_candidates(jcfg, 8, sharded=False,
                                  budget=JK.resident_vmem_bytes(jcfg, 5),
                                  **args)
    assert _shape(cands) == _shape(jc)


def test_plan_override_streamed_on_fitting_spec_errors():
    """Streamed forced on a spec that fits resident is refused with the
    hint to lower the budget, as JAX's names vmem_budget."""
    with pytest.raises(ValueError, match="smem_budget"):
        ga.Engine(ga.GASpec(**_kw()), "fused-islands",
                  options=_opts(plan_override="streamed"))


# ---------------------------------------------------------------------------
# the streamed runs (tests/test_streaming.py:93, :123, :150)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("problem", ["F1", "F2", "F3", "rastrigin:4"])
def test_streamed_bit_identical_to_islands_reference(problem):
    """The four problems through the streamed lane at 8 islands: against
    JAX's islands (see the module docstring) and bit-exact against the
    port's islands and its resident plan."""
    kw = _kw(problem=problem)
    eng = ga.Engine(ga.GASpec(**kw), "fused-islands",
                    options=_opts(smem_budget=_budget(kw)))
    plan = eng.backend.topology.plan
    assert plan["mode"] == "streamed" and plan["tile_islands"] == 1, plan
    seg = eng.backend.segment(eng.init_state(), 16)
    assert seg.telemetry.topology.launches == 2
    _assert_matches_jax(seg, kw, _jax_segment(kw, 16))
    _assert_same_run(seg, _segment(kw, "islands", 16), per=2)
    res = _segment(kw, "fused-islands", 16)
    assert res.telemetry.plan.mode == "resident"
    _assert_same_run(seg, res)


def test_pinned_tile_is_a_launch_shape_knob_only():
    """Every tile that divides the 8 islands gives the same run (the port's
    K3 block walks its islands in turn, so the budget bounds no tile); one
    that does not divide them is refused."""
    kw = _kw()
    budget = _budget(kw)
    base = _segment(kw, "fused-islands", 16, smem_budget=budget)
    assert base.telemetry.plan.mode == "streamed"
    _assert_matches_jax(base, kw, _jax_segment(kw, 16))
    for t in (1, 2, 4, 8):
        seg = _segment(kw, "fused-islands", 16, smem_budget=budget,
                       stream_tile_islands=t)
        assert seg.telemetry.plan.tile_islands == t
        _assert_same_run(seg, base)
    with pytest.raises(ValueError, match="feasible tile"):
        ga.Engine(ga.GASpec(**kw), "fused-islands",
                  options=_opts(smem_budget=budget, stream_tile_islands=3))


def test_streamed_migration_none_bit_identical_via_override():
    """The isolated-islands ablation through the streamed lane, forced
    (gridded is its heuristic), equals the gridded run and JAX's."""
    kw = _kw(migration="none", generations=16, gens_per_epoch=16)
    budget = _budget(kw)
    res = _segment(kw, "fused-islands", 16, smem_budget=budget,
                   plan_override="streamed")
    assert (res.telemetry.plan.mode, res.telemetry.plan.source) == \
        ("streamed", "forced")
    assert res.telemetry.topology.migrations == 0
    grid = _segment(kw, "fused-islands", 16, smem_budget=budget)
    assert grid.telemetry.plan.mode == "gridded"
    assert res.best_y == grid.best_y
    np.testing.assert_array_equal(res.best_x, grid.best_x)
    _assert_matches_jax(res, kw, _jax_segment(kw, 16))


# ---------------------------------------------------------------------------
# no budget: today's candidate lists; the runner cache in both orders
# ---------------------------------------------------------------------------


# (i_local, migration, gens_per_epoch, executor, sharded) -> the modes the
# card's own limits give (N 1024, V 8 fits one block; a ring past 8
# islands is past the cluster)
NO_BUDGET = [
    ((1, "ring", 32, "fused", False), ["resident", "gridded"]),
    ((8, "ring", 32, "fused", False), ["resident", "gridded"]),
    ((9, "ring", 32, "fused", False), ["streamed", "gridded"]),
    ((16, "ring", 64, "fused", False), ["streamed", "gridded"]),
    ((4, "ring", 32, "fused", True), ["resident-sharded", "gridded"]),
    ((16, "ring", 32, "fused", True), ["streamed", "gridded"]),
    ((4, "ring", 8, "fused", False), ["gridded"]),
    ((4, "ring", 32, "reference", False), ["gridded"]),
    ((16, "none", 32, "fused", False), ["gridded", "resident-free"]),
    ((4, "none", 16, "fused", False), ["gridded"]),
    ((4, "none", 32, "fused", True), ["gridded"]),
]


@pytest.mark.parametrize("case,modes", NO_BUDGET)
def test_no_budget_keeps_every_candidate_list(case, modes):
    """budget=None gives exactly the list the call without the keyword
    gives, the modes the card's limits alone allow, and the same list as a
    budget every shape fits."""
    i_local, migration, gpe, executor, sharded = case
    cfg = TG.GAConfig(n=1024, c=16, v=8, mode="arith", sel_lane="gather")
    kw = dict(executor=executor, migration=migration, gens_per_epoch=gpe,
              migrate_every=16, sharded=sharded)
    today = K.epoch_mode_candidates(cfg, i_local, **kw)
    assert [c["mode"] for c in today] == modes
    assert K.epoch_mode_candidates(cfg, i_local, budget=None, **kw) == today
    roomy = K.resident_smem_bytes(cfg, i_local)
    assert K.epoch_mode_candidates(cfg, i_local, budget=roomy, **kw) == today


@pytest.mark.parametrize("budget_first", [True, False])
def test_runner_cache_keeps_budgeted_and_unbudgeted_plans_apart(
        monkeypatch, budget_first):
    """One spec, with and without the budget, in either order: each engine
    runs its own plan's kernel (streamed K3, resident K2), and both equal
    the islands run."""
    calls = {"ga_epoch_kernel": 0, "ga_streamed_epoch_kernel": 0}
    for name in calls:
        real = getattr(K, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(K, name, counted)
    CC.RUNNER_CACHE.reset()
    kw = _kw()
    ref = _segment(kw, "islands", 16)
    order = [_budget(kw), None] if budget_first else [None, _budget(kw)]
    for budget in order:
        before = dict(calls)
        seg = _segment(kw, "fused-islands", 16, smem_budget=budget)
        ran = {k: calls[k] - before[k] for k in calls}
        if budget is None:
            assert seg.telemetry.plan.mode == "resident"
            assert ran == {"ga_epoch_kernel": 2,
                           "ga_streamed_epoch_kernel": 0}
        else:
            assert seg.telemetry.plan.mode == "streamed"
            assert ran == {"ga_epoch_kernel": 0,
                           "ga_streamed_epoch_kernel": 2}
        _assert_same_run(seg, ref, per=2)
    # a second build of each hits the cache and still runs its own kernel
    misses = CC.RUNNER_CACHE.stats()["misses"]
    for budget in order:
        seg = _segment(kw, "fused-islands", 16, smem_budget=budget)
        assert seg.telemetry.plan.mode == ("resident" if budget is None
                                           else "streamed")
    assert CC.RUNNER_CACHE.stats()["misses"] == misses
    assert calls == {"ga_epoch_kernel": 4, "ga_streamed_epoch_kernel": 4}


# ---------------------------------------------------------------------------
# the option: validation, the shared CLI parser, every carrier
# ---------------------------------------------------------------------------


def test_smem_budget_validation_and_cli():
    with pytest.raises(ValueError, match="smem_budget must be >= 1"):
        ga.EngineOptions(device="cpu", smem_budget=0)
    ap = argparse.ArgumentParser()
    EngineOptions.add_cli_args(ap)
    assert EngineOptions.from_args(ap.parse_args([])) == EngineOptions()
    opts = EngineOptions.from_args(ap.parse_args(
        ["--device", "cpu", "--smem-budget", "5700"]))
    assert opts == EngineOptions(device="cpu", smem_budget=5700)


@pytest.mark.parametrize("launcher,argv", [
    ("ga_run", []), ("ga_serve", ["--demo", "1"]), ("ga_autotune", [])])
def test_launchers_keep_their_defaults(launcher, argv, monkeypatch):
    """Each launcher's parser takes --smem-budget, and without it builds
    the options it built before the flag existed."""
    import importlib
    import sys
    mod = importlib.import_module(f"repro_torch.launch.{launcher}")
    seen = []
    build = EngineOptions.from_args

    def spy(args, **kw):
        seen.append(args)
        raise SystemExit(0)

    monkeypatch.setattr(EngineOptions, "from_args", staticmethod(spy))
    for extra in ([], ["--smem-budget", "4096"]):
        full = ["--device", "cpu"] + argv + extra
        monkeypatch.setattr(sys, "argv", [launcher] + full)
        with pytest.raises(SystemExit):
            mod.main() if launcher == "ga_serve" else mod.main(full)
    plain, budgeted = (build(a) for a in seen)
    assert plain == EngineOptions(device="cpu")
    assert budgeted == EngineOptions(device="cpu", smem_budget=4096)


def test_budget_rides_every_carrier():
    """A packed engine, an autotune probe and a sweep plan under the
    budget as a solo engine does; the sweep's points carry no budget."""
    kw = _kw()
    budget = _budget(kw)
    opts = _opts(smem_budget=budget)
    specs = [ga.GASpec(**dict(kw, seed=s)) for s in (1, 2)]
    pe = ga.PackedEngine(specs, "fused-islands", options=opts)
    assert pe.backend.topology.plan["mode"] == "streamed"
    assert RUN._probe_options(opts, plan_override="gridded").smem_budget \
        == budget
    cands = RUN.plan_candidates(specs[0], backend="fused-islands",
                                options=opts)
    assert [c["mode"] for c in cands] == ["streamed", "gridded"]
    table = RUN.sweep([specs[0]], backend="fused-islands", options=opts,
                      min_reps=2, max_reps=2)
    modes = {e["mode"] for e in table.entries()}
    assert "streamed" in modes
    for e in table.entries():
        assert not any("budget" in k for k in e)
