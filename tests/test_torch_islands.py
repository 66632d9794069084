"""The island ring of the port (`repro_torch.core.islands`, the `islands` and
`fused-islands` backends and the Hopper epoch planner) on the CPU, held
against the JAX package from the same seeds and against itself across
plans.

* `init_islands_fast` and the migration rule set are integer work or
  exact selects: bit-exact against the JAX functions on the same inputs.
* `islands` against the JAX `islands` backend: bit-exact in LUT mode
  (integer ROMs) in state, best, best_x, traj_best and migrations.  In
  arith mode XLA's CPU jit contracts the decode into an FMA (hazard H1), so
  fitness differs in the last bits: the state stays bit-exact on F1, F3,
  sphere, rastrigin, rosenbrock and ackley on the seeds tested (F2's linear
  decode flips a tournament, so it is left out), and fitness is within
  ``1e-6 * max|y|`` (ackley ``4e-6``, the bound of tests/test_torch_fitness.py).
  Trajectory means are float32 sums over N in another order, within
  ``1e-6 * max(|mean|, |best|)`` as in tests/test_torch_engine.py.
* Every fused plan (gridded, resident, resident-free, streamed, any
  streamed tile) against the port's `islands`: bit-exact on all seven
  problems, since on the CPU each kernel wrapper runs its plain version.
* The streamed plan's launch count and the planner's tile, from a card's
  capacity (pretended here: the capacity query needs a card).
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import ga as JGA  # noqa: E402
from repro.core import ga as JG  # noqa: E402
from repro.core import islands as JISL  # noqa: E402
from repro_torch import convert, ga  # noqa: E402
from repro_torch.core import ga as TG  # noqa: E402
from repro_torch.core import islands as TISL  # noqa: E402
from repro_torch.kernels import ga_step as K  # noqa: E402


@pytest.fixture(autouse=True)
def _no_ambient_cost_table(monkeypatch):
    """The plans here are the heuristic's: no cost table found on the host
    may move them."""
    monkeypatch.setenv("REPRO_GA_COST_TABLE", "off")


CPU = ga.EngineOptions(device="cpu")
ALL_PROBLEMS = ["F1", "F2", "F3", "sphere:4", "rastrigin:6", "ackley:4",
                "rosenbrock:5"]
STATE_NAMES = ("x", "sel", "cross", "mut", "k")


def _kw(**kw):
    """The base spec of tests/test_topology.py."""
    base = dict(problem="F3", n=32, bits_per_var=10, mode="arith",
                mutation_rate=0.05, seed=11, generations=15,
                n_islands=4, migrate_every=5)
    base.update(kw)
    return base


def _jax_segment(kw, gens):
    eng = JGA.Engine(JGA.GASpec(**kw), "islands")
    return eng.backend.segment(eng.init_state(), gens)


def _segment(kw, backend, gens, **opts):
    eng = ga.Engine(ga.GASpec(**kw), backend,
                    options=ga.EngineOptions(device="cpu", **opts))
    return eng.backend.segment(eng.init_state(), gens)


def _jax_state(s):
    return tuple(np.asarray(t) for t in (s.x, s.sel_lfsr, s.cross_lfsr,
                                         s.mut_lfsr, s.k))


def _np(t):
    """A port tensor as the JAX package's dtype (words as np.uint32)."""
    return (convert.words_to_numpy(t) if t.dtype == torch.int32
            else t.numpy())


def _assert_same_state(a, b):
    for name, x, y in zip(STATE_NAMES, a, b):
        np.testing.assert_array_equal(x, y, err_msg=name)


# ---------------------------------------------------------------------------
# init and the migration rule set
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,v,islands,seed", [(16, 2, 4, 3), (32, 3, 5, 11),
                                              (64, 8, 2, 1234)])
def test_init_islands_fast_matches_jax(n, v, islands, seed):
    kw = dict(n=n, c=10, v=v, seed=seed, mode="arith")
    j = JISL.init_islands_fast(JISL.IslandConfig(ga=JG.GAConfig(**kw),
                                                 n_islands=islands))
    t = TISL.init_islands_fast(TISL.IslandConfig(ga=TG.GAConfig(**kw),
                                                 n_islands=islands),
                               device="cpu")
    _assert_same_state(_jax_state(j), convert.state_to_numpy(t))


def test_init_islands_matches_jax():
    kw = dict(n=16, c=8, v=2, seed=5, mode="arith")
    j = JISL.init_islands(JISL.IslandConfig(ga=JG.GAConfig(**kw),
                                            n_islands=3))
    t = TISL.init_islands(TISL.IslandConfig(ga=TG.GAConfig(**kw),
                                            n_islands=3), device="cpu")
    _assert_same_state(_jax_state(j), convert.state_to_numpy(t))


def _fed_y(kind, islands=5, n=16, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(islands, n)).astype(np.float32)
    if kind == "ties":
        # every island holds its min and its max twice, at two places
        y = np.round(y, 1).astype(np.float32)
        for i in range(islands):
            y[i, [2, 9]] = y[i].min()
            y[i, [4, 11]] = y[i].max()
    elif kind == "nan":
        y[1, 3] = np.nan            # one island with a NaN: no slot matches
    return y


@pytest.mark.parametrize("minimize", [True, False])
@pytest.mark.parametrize("kind", ["random", "ties", "nan"])
def test_migration_rule_set_matches_jax(kind, minimize):
    islands, n, v = 5, 16, 3
    y = _fed_y(kind, islands, n)
    x = np.random.default_rng(1).integers(0, 2 ** 32, size=(islands, n, v),
                                          dtype=np.uint32)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx = convert.words_from_numpy(x, device="cpu")
    ty = torch.from_numpy(y)
    for fn in (JISL.best_slot, JISL.worst_slot):
        got = getattr(TISL, fn.__name__)(ty, minimize=minimize)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(fn(jy, minimize=minimize)))
    slot = np.asarray(JISL.worst_slot(jy, minimize=minimize))
    tslot = torch.from_numpy(slot.astype(np.int64))
    np.testing.assert_array_equal(
        convert.words_to_numpy(TISL.take_slot(tx, tslot)),
        np.asarray(JISL.take_slot(jx, jnp.asarray(slot))))
    rows = x[:, 0, :][::-1].copy()
    mask = np.arange(islands)[:, None] >= 2
    for m in (None, mask):
        want = JISL.splice_at(jx, jnp.asarray(slot), jnp.asarray(rows),
                              island_mask=None if m is None
                              else jnp.asarray(m))
        got = TISL.splice_at(tx, tslot,
                             convert.words_from_numpy(rows, device="cpu"),
                             island_mask=None if m is None
                             else torch.from_numpy(m))
        np.testing.assert_array_equal(convert.words_to_numpy(got),
                                      np.asarray(want))
    for a, b in zip(TISL.elites_stack(tx, ty, minimize=minimize),
                    JISL.elites_stack(jx, jy, minimize=minimize)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    got = TISL.ring_migrate_stack(tx, ty, minimize=minimize)
    want = JISL.ring_migrate_stack(jx, jy, minimize=minimize)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    # the state-level forms, and a replica stack ([R, I, ...])
    st = TG.GAState(tx, tx, tx, tx, torch.zeros(islands))
    jst = JG.GAState(jx, jx, jx, jx, jnp.zeros(islands))
    new, ex, _ = TISL.migrate_ring(st, ty, minimize=minimize)
    np.testing.assert_array_equal(convert.words_to_numpy(new.x),
                                  np.asarray(want[0]))
    for a, b in zip(TISL.best_of(st, ty, minimize=minimize),
                    JISL.best_of(jst, jy, minimize=minimize)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    got = TISL.splice_elites(st, ty, convert.words_from_numpy(
        rows, device="cpu"), minimize=minimize)
    np.testing.assert_array_equal(
        convert.words_to_numpy(got.x),
        np.asarray(JISL.splice_elites(jst, jy, jnp.asarray(rows),
                                      minimize=minimize).x))
    stacked = TISL.ring_migrate_stack(torch.stack([tx, tx]),
                                      torch.stack([ty, ty]),
                                      minimize=minimize)[0]
    for r in range(2):
        np.testing.assert_array_equal(convert.words_to_numpy(stacked[r]),
                                      np.asarray(want[0]))


def test_nan_island_splice_is_a_no_op():
    y = torch.from_numpy(_fed_y("nan"))
    assert int(TISL.best_slot(y, minimize=True)[1]) == y.shape[1]
    x = torch.arange(5 * 16 * 2, dtype=torch.int32).reshape(5, 16, 2)
    x2, ex, _ = TISL.ring_migrate_stack(x, y, minimize=True)
    torch.testing.assert_close(x2[1], x[1], rtol=0, atol=0)
    assert torch.equal(ex[1], torch.zeros(2, dtype=torch.int32))


def test_make_local_step_is_the_islands_backend():
    """One epoch of the plain oracle equals one gridded epoch of the
    `islands` backend."""
    kw = _kw(problem="F1", generations=5)
    spec = ga.GASpec(**kw)
    eng = ga.Engine(spec, "islands", options=CPU)
    st0 = eng.init_state()
    seg = eng.backend.segment(st0, 5)
    icfg = TISL.IslandConfig(ga=spec.ga_config(), n_islands=4,
                             migrate_every=5)
    oracle, _, _ = TISL.make_local_step(icfg, spec.fitness_fn())(st0)
    _assert_same_state(convert.state_to_numpy(seg.state),
                       convert.state_to_numpy(oracle))


# ---------------------------------------------------------------------------
# islands against the JAX islands backend
# ---------------------------------------------------------------------------


def _assert_means_close(got, want, best):
    scale = np.maximum(np.abs(want), np.abs(best))
    assert np.all(np.abs(got - want) <= 1e-6 * scale)


@pytest.mark.parametrize("migration", ["ring", "none"])
@pytest.mark.parametrize("n_repeats", [1, 3])
@pytest.mark.parametrize("problem", ["F1", "F2", "F3", "sphere:4"])
def test_islands_match_jax_islands_lut(problem, n_repeats, migration):
    kw = _kw(problem=problem, mode="lut", n_repeats=n_repeats,
             migration=migration)
    js = _jax_segment(kw, 15)
    ts = _segment(kw, "islands", 15)
    _assert_same_state(convert.state_to_numpy(ts.state), _jax_state(js.state))
    assert ts.best_y == js.best_y
    np.testing.assert_array_equal(ts.best_x, np.asarray(js.best_x))
    np.testing.assert_array_equal(ts.traj_best, np.asarray(js.traj_best))
    _assert_means_close(ts.traj_mean, np.asarray(js.traj_mean),
                        np.asarray(js.traj_best))
    jt, tt = js.telemetry.topology, ts.telemetry.topology
    assert (tt.migrations, tt.launches, tt.n_islands,
            tt.telemetry_unit_gens) == (jt.migrations, jt.launches,
                                        jt.n_islands, jt.telemetry_unit_gens)
    assert tt.migrations == (3 if migration == "ring" else 0)
    assert (ts.telemetry.plan.mode, ts.telemetry.plan.source) == \
        (js.telemetry.plan.mode, js.telemetry.plan.source)


@pytest.mark.parametrize("n_repeats", [1, 3])
@pytest.mark.parametrize("problem", ["F1", "F3", "sphere:4", "rastrigin:6",
                                     "rosenbrock:5", "ackley:4"])
def test_islands_match_jax_islands_arith(problem, n_repeats):
    kw = _kw(problem=problem, n_repeats=n_repeats)
    js = _jax_segment(kw, 15)
    ts = _segment(kw, "islands", 15)
    got = convert.state_to_numpy(ts.state)
    _assert_same_state(got, _jax_state(js.state))
    tol = (4e-6 if problem.startswith("ackley") else 1e-6)
    prog = ga.GASpec(**kw).program()
    y = prog.stage(ts.state.x).numpy()
    jy = np.asarray(JGA.GASpec(**kw).program().stage(js.state.x))
    assert np.max(np.abs(y - jy)) <= tol * np.max(np.abs(jy))
    bound = tol * np.max(np.abs(jy))       # the population's max|y|
    assert np.max(np.abs(ts.traj_best - np.asarray(js.traj_best))) <= bound
    assert abs(ts.best_y - js.best_y) <= bound


# ---------------------------------------------------------------------------
# every fused plan against the port's islands backend
# ---------------------------------------------------------------------------


def _assert_same_run(a, b, traj=True):
    _assert_same_state(convert.state_to_numpy(a.state),
                       convert.state_to_numpy(b.state))
    assert a.best_y == b.best_y
    np.testing.assert_array_equal(a.best_x, b.best_x)
    if traj:
        np.testing.assert_array_equal(a.traj_best, b.traj_best)


@pytest.mark.parametrize("problem", ALL_PROBLEMS)
def test_every_fused_plan_matches_islands(problem):
    # one interval a launch: every plan samples once an epoch, like islands
    kw = _kw(problem=problem, gens_per_epoch=5)
    ref = _segment(kw, "islands", 15)
    for plan in ("resident", "gridded"):
        seg = _segment(kw, "fused-islands", 15, plan_override=plan)
        assert seg.telemetry.plan.mode == plan
        _assert_same_run(seg, ref)
    heur = _segment(kw, "fused-islands", 15)
    assert (heur.telemetry.plan.mode, heur.telemetry.plan.source) == \
        ("resident", "heuristic")

    # 12 islands: past the cluster, so the heuristic is streamed
    kw12 = _kw(problem=problem, n_islands=12, n_repeats=2, gens_per_epoch=5)
    ref12 = _segment(kw12, "islands", 15)
    for opts in ({}, {"stream_tile_islands": 3},
                 {"stream_tile_islands": 12}, {"plan_override": "gridded"}):
        seg = _segment(kw12, "fused-islands", 15, **opts)
        want = "gridded" if opts.get("plan_override") else "streamed"
        assert seg.telemetry.plan.mode == want
        if want == "streamed":
            assert seg.telemetry.plan.tile_islands == \
                opts.get("stream_tile_islands", 1)
            assert "cluster" in seg.telemetry.plan.fallback
        _assert_same_run(seg, ref12)

    # two intervals a launch: a sample is the best of two epochs' samples
    kw2 = _kw(problem=problem, n_repeats=2, gens_per_epoch=10,
              generations=20)
    ref2 = _segment(kw2, "islands", 20)
    fold = (np.minimum if ga.GASpec(**kw2).minimize else np.maximum)(
        ref2.traj_best[0::2], ref2.traj_best[1::2])
    for extra in ({}, {"n_islands": 12}):
        seg = _segment(dict(kw2, **extra), "fused-islands", 20)
        if extra:
            seg_ref = _segment(dict(kw2, **extra), "islands", 20)
        else:
            seg_ref = ref2
        assert seg.telemetry.plan.mode == ("streamed" if extra
                                           else "resident")
        assert seg.telemetry.topology.launches == 2
        _assert_same_run(seg, seg_ref, traj=False)
        if not extra:
            np.testing.assert_array_equal(seg.traj_best, fold)

    # no ring: resident-free folds the whole gens_per_epoch
    kwn = _kw(problem=problem, migration="none", gens_per_epoch=10,
              generations=20)
    refn = _segment(kwn, "islands", 20)
    for plan in (None, "resident-free"):
        seg = _segment(kwn, "fused-islands", 20, plan_override=plan)
        assert seg.telemetry.plan.mode == (plan or "gridded")
        _assert_same_run(seg, refn, traj=plan is None)
    assert seg.telemetry.topology.migrations == 0


def test_plan_override_streamed_on_fitting_spec_errors():
    kw = _kw(gens_per_epoch=5)
    with pytest.raises(ValueError, match="streamed is only offered"):
        _segment(kw, "fused-islands", 5, plan_override="streamed")
    with pytest.raises(ValueError, match="not feasible"):
        _segment(_kw(), "islands", 5, plan_override="resident")
    with pytest.raises(ValueError, match="plan_override must be one of"):
        ga.EngineOptions(device="cpu", plan_override="sharded")
    with pytest.raises(ValueError, match="resident-sharded needs a mesh"):
        _segment(kw, "fused-islands", 5, plan_override="resident-sharded")
    seg = _segment(kw, "fused-islands", 5, plan_override={"mode": "gridded"})
    assert (seg.telemetry.plan.mode, seg.telemetry.plan.source) == \
        ("gridded", "forced")


def test_pinned_tile_must_divide_the_islands():
    kw = _kw(n_islands=12, gens_per_epoch=5)
    with pytest.raises(ValueError, match="must divide the island count 12"):
        _segment(kw, "fused-islands", 5, stream_tile_islands=5)
    with pytest.raises(ValueError, match="must be >= 1"):
        ga.EngineOptions(device="cpu", stream_tile_islands=0)


# ---------------------------------------------------------------------------
# the Hopper planner
# ---------------------------------------------------------------------------


def _modes(cfg, i_local, **kw):
    args = dict(executor="fused", migration="ring", gens_per_epoch=32,
                migrate_every=16)
    args.update(kw)
    return [c["mode"] for c in K.epoch_mode_candidates(cfg, i_local, **args)]


def test_planner_cluster_limit():
    cfg = TG.GAConfig(n=1024, c=16, v=8, mode="arith", sel_lane="gather")
    assert _modes(cfg, 8) == ["resident", "gridded"]
    assert _modes(cfg, 9) == ["streamed", "gridded"]
    c9 = K.epoch_mode_candidates(cfg, 9, executor="fused", migration="ring",
                                 gens_per_epoch=64, migrate_every=16)
    assert c9[0]["tile_islands"] == 1 and c9[0]["gens_per_launch"] == 64
    assert "portable cluster size of 8" in c9[0]["fallback"]
    # no ring: no cluster, so any island count runs resident-free
    assert _modes(cfg, 16, migration="none") == ["gridded", "resident-free"]
    # gens_per_epoch below migrate_every, or the reference executor: gridded
    assert _modes(cfg, 4, gens_per_epoch=8) == ["gridded"]
    assert _modes(cfg, 4, executor="reference") == ["gridded"]
    ref = K.epoch_mode_candidates(cfg, 4, executor="reference",
                                  migration="ring", gens_per_epoch=64,
                                  migrate_every=16)
    assert ref[0]["gens_per_launch"] == 16


@pytest.mark.parametrize("over", [False, True])
def test_planner_shared_memory_limit(monkeypatch, over):
    """A K2/K3 block just under and just over the shared memory of one
    Hopper block: at 32-bit words (c = 17) resident and streamed go
    together; at c = 10 K2's 16-bit block is the smaller, so resident
    outlasts streamed (K3 keeps 32-bit words) until its own block is over;
    gridded (K1, a smaller block) stays."""
    def modes(cfg):
        ring = K.epoch_mode_candidates(cfg, 4, executor="fused",
                                       migration="ring", gens_per_epoch=32,
                                       migrate_every=16)
        return ring, _modes(cfg, 4, migration="none")

    wide = TG.GAConfig(n=64, c=17, v=2, mode="arith")
    cfg = TG.GAConfig(n=64, c=10, v=2, mode="arith")
    need = K.epoch_smem_bytes(64, 2, cfg.p)
    assert need - K.smem_bytes(64, 2, cfg.p) == 4 * (2 + 1)
    assert K.resident_block_bytes(wide) == need
    need16 = K.resident_block_bytes(cfg)
    assert need - need16 == 4 * 64 * 2
    monkeypatch.setattr(K, "SMEM_LIMIT", need - 1 if over else need)
    if over:
        ring, free = modes(wide)
        assert [c["mode"] for c in ring] == ["gridded"]
        assert f"{need} bytes of shared memory" in ring[0]["fallback"]
        assert free == ["gridded"]
        assert K.streamed_tile_islands(wide) is None
        ring, free = modes(cfg)
        assert [c["mode"] for c in ring] == ["resident", "gridded"]
        assert free == ["gridded", "resident-free"]
        assert K.streamed_tile_islands(cfg) is None
        monkeypatch.setattr(K, "SMEM_LIMIT", need16 - 1)
        ring, free = modes(cfg)
        assert [c["mode"] for c in ring] == ["gridded"]
        assert f"{need16} bytes of shared memory" in ring[0]["fallback"]
        assert free == ["gridded"]
    else:
        for c in (wide, cfg):
            ring, free = modes(c)
            assert [c["mode"] for c in ring] == ["resident", "gridded"]
            assert free == ["gridded", "resident-free"]
            assert K.streamed_tile_islands(c) == 1


def test_plan_telemetry_reports_block_bytes():
    kw = _kw(gens_per_epoch=5)
    tele = _segment(kw, "fused-islands", 5).telemetry
    cfg = ga.GASpec(**kw).ga_config()
    p = cfg.p                                  # ceil(32 * 0.05) = 2
    # K2 at c <= 16: 16-bit population words, 4NV bytes under K3's block
    assert tele.plan.smem_estimate_bytes == K.resident_block_bytes(cfg) \
        == K.epoch_smem_bytes(32, 2, p, 16) \
        == K.epoch_smem_bytes(32, 2, p) - 4 * 32 * 2
    assert tele.plan.population_bits == 16
    # no card: no clusters to count
    assert tele.plan.clusters_at_once is None
    assert tele.plan.lane == "onehot" and tele.plan.epochs_per_launch == 1
    tele = _segment(kw, "fused-islands", 5,
                    plan_override="gridded").telemetry
    assert tele.plan.smem_estimate_bytes == K.smem_bytes(32, 2, p)
    assert tele.plan.population_bits == 32
    plan = _segment(kw, "islands", 5).telemetry.plan
    assert plan.smem_estimate_bytes is None and plan.population_bits is None


@pytest.mark.parametrize("groups,islands,cap,tile,waves", [
    (8, 16, 264, 1, 1), (20, 16, 264, 2, 1), (20, 12, 264, 1, 1),
    (40, 16, 264, 4, 1), (1, 9, 264, 1, 1), (300, 16, 264, 16, 2),
    (3, 9, 16, 3, 1)])
def test_streamed_tile_from_capacity(groups, islands, cap, tile, waves):
    """The least divisor of I whose G * I / T blocks the card holds at
    once; past that, T = I with whole groups in waves."""
    assert K.tile_for_capacity(groups, islands, cap) == tile
    assert K.streamed_waves(groups, islands, tile, cap) == waves


def test_streamed_waves_refuse_a_group_that_does_not_fit():
    assert K.streamed_waves(4, 16, 1, 15) == 0
    assert K.streamed_waves(4, 16, 1, 16) == 4
    assert K.streamed_waves(4, 16, 2, 16) == 2


def _on_card(monkeypatch, cap=264):
    """The planner as on a card that holds `cap` K3 blocks at once."""
    monkeypatch.setattr(K, "streamed_capacity", lambda cfg, device, *a: cap)
    return torch.device("cuda")


def test_planner_tile_follows_the_card(monkeypatch):
    cfg = TG.GAConfig(n=1024, c=16, v=8, mode="arith", sel_lane="gather")
    args = dict(executor="fused", migration="ring", gens_per_epoch=64,
                migrate_every=16)
    # on the CPU the tile is 1 whatever the stack: the plain version
    # ignores it
    assert K.epoch_mode_candidates(cfg, 16, groups=20, device="cpu",
                                   **args)[0]["tile_islands"] == 1
    dev = _on_card(monkeypatch)
    for groups, tile in ((8, 1), (20, 2), (40, 4)):
        c = K.epoch_mode_candidates(cfg, 16, groups=groups, device=dev,
                                    **args)
        assert (c[0]["mode"], c[0]["tile_islands"]) == ("streamed", tile)
    assert K.streamed_tile_reason(cfg, 20, 16, 2, dev) is None
    assert K.streamed_tile_reason(cfg, 20, 16, 4, dev) is None
    assert "cannot co-reside" in K.streamed_tile_reason(cfg, 20, 16, 1, dev)
    assert "must divide" in K.streamed_tile_reason(cfg, 20, 16, 5, dev)
    assert K.streamed_tile_reason(cfg, 20, 16, 1, "cpu") is None


def test_pinned_tile_that_cannot_coreside_is_refused(monkeypatch):
    """A pinned tile whose cooperative launch the card cannot hold at once
    raises when the engine plans, before anything runs."""
    dev = _on_card(monkeypatch)
    spec = ga.GASpec(**_kw(problem="rastrigin:8", n=1024, bits_per_var=16,
                           n_repeats=20, n_islands=16, migrate_every=16,
                           gens_per_epoch=64, generations=64))
    ex = ga.backends.FusedExecutor(spec)
    topo = ga.backends.IslandRingTopology(spec, ex, device=dev)
    assert (topo.plan["mode"], topo.plan["tile_islands"]) == ("streamed", 2)
    with pytest.raises(ValueError, match="cannot co-reside"):
        ga.backends.IslandRingTopology(spec, ex, device=dev,
                                       stream_tile_islands=1)


@pytest.mark.parametrize("generations,gens_per_epoch,launches", [
    (20, 10, 2), (25, 10, 3), (30, 15, 2), (15, 20, 1)])
def test_streamed_plan_launches_once_per_k_intervals(
        monkeypatch, generations, gens_per_epoch, launches):
    """ceil(epochs / k) K3 calls, each of k intervals with the ring inside
    (splice=True), and the run equals `islands`."""
    calls = []
    real = K.ga_streamed_epoch_kernel

    def counted(*a, **kw):
        calls.append((kw["intervals"], kw["splice"]))
        return real(*a, **kw)

    monkeypatch.setattr(K, "ga_streamed_epoch_kernel", counted)
    kw = _kw(n_islands=12, n_repeats=2, gens_per_epoch=gens_per_epoch,
             generations=generations)
    seg = _segment(kw, "fused-islands", generations)
    epochs, k = generations // 5, gens_per_epoch // 5
    assert seg.telemetry.plan.mode == "streamed"
    assert seg.telemetry.topology.launches == launches == len(calls)
    assert [c[0] for c in calls] == [min(k, epochs - k * j)
                                     for j in range(launches)]
    assert all(c[1] for c in calls)
    _assert_same_run(seg, _segment(kw, "islands", generations), traj=False)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def test_auto_routing_of_island_specs(monkeypatch):
    spec = ga.GASpec(**_kw())
    caps = ga.capability_matrix(spec)
    assert caps["islands"] is None and caps["fused-islands"] is None
    for name in ("reference", "fused"):
        assert "use an island_ring backend" in caps[name]
    assert ga.resolve_backend(spec, "auto", "cuda") == "fused-islands"
    assert ga.resolve_backend(spec, "auto", "cpu") == "islands"
    lut = ga.GASpec(**_kw(mode="lut"))
    assert "mode='arith'" in ga.capability_matrix(lut)["fused-islands"]
    assert ga.resolve_backend(lut, "auto", "cuda") == "islands"
    with pytest.warns(UserWarning, match="falling back to 'islands'"):
        assert ga.resolve_backend(lut, "fused-islands", "cuda") == "islands"
    single = ga.GASpec(**_kw(n_islands=1, topology="single"))
    assert "pins topology='single'" in ga.capability_matrix(single)["islands"]
    with pytest.warns(UserWarning, match="falling back to 'fused'"):
        assert ga.resolve_backend(single, "islands", "cuda") == "fused"
    res = ga.solve(spec, options=CPU)
    assert res.backend == "islands" and res.generations == 15
    # without a card the island backends raise unless the CPU is asked for
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: ga.solve(spec),
                 lambda: ga.Engine(spec, "fused-islands"),
                 lambda: ga.Engine(spec, "islands")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = ga.solve(spec, "fused-islands", options=CPU)
    assert res.backend == "fused-islands"


def test_fused_islands_count_no_launches_on_cpu():
    before = dict(K.LAUNCHES)
    for plan in ("resident", "gridded"):
        _segment(_kw(gens_per_epoch=5), "fused-islands", 5,
                 plan_override=plan)
    _segment(_kw(n_islands=12, gens_per_epoch=5), "fused-islands", 5)
    assert K.LAUNCHES == before


def test_replica_zero_matches_solo_island_run():
    solo = _segment(_kw(problem="F2"), "islands", 10)
    rep = _segment(_kw(problem="F2", n_repeats=3), "islands", 10)
    for a, b in zip(convert.state_to_numpy(rep.state)[:4],
                    convert.state_to_numpy(solo.state)[:4]):
        np.testing.assert_array_equal(a[0], b)
    assert rep.telemetry.per_repeat.best[0] == solo.best_y
    np.testing.assert_array_equal(rep.telemetry.per_repeat.best_x[0],
                                  solo.best_x)
    assert dataclasses.asdict(rep.telemetry.topology)["n_islands"] == 4


def test_tied_islands_keep_the_islands_best_x_under_every_plan():
    """rastrigin's optimum is symmetric, so at c=4 islands reach the same
    best fitness with mirrored chromosomes at different intervals.  Folding
    a resident launch's intervals first (the JAX package's order) would
    pick another best_x than `islands`; the port folds per interval, so
    every plan gives `islands`' best_x."""
    kw = _kw(problem="rastrigin:2", n=16, bits_per_var=4, seed=2,
             generations=40, gens_per_epoch=20)
    ref = _segment(kw, "islands", 40)
    for plan in ("resident", "gridded"):
        _assert_same_run(_segment(kw, "fused-islands", 40,
                                  plan_override=plan), ref, traj=False)
    # the tie is there: fold each launch's intervals first, then islands
    eng = ga.Engine(ga.GASpec(**kw), "fused-islands", options=CPU)
    st, launch_best = eng.init_state(), None
    for runner in eng.backend.topology._schedule(8)[0]:
        (st,), (by,), (bx,), _tm = runner([st])
        fy, fx = by[0], bx[0]
        for t in range(1, by.shape[0]):
            fy, fx = TG.fold_best(fy, fx, by[t], bx[t], True)
        i = int(torch.argmin(fy))
        if launch_best is None or fy[i] < launch_best[0]:
            launch_best = (fy[i], convert.words_to_numpy(fx[i]))
    assert float(launch_best[0]) == ref.best_y
    assert not np.array_equal(launch_best[1], ref.best_x)
