"""Tenant packing (`PackedEngine`, `repack_checkpoint`) and the engine
cache (`RUNNER_CACHE`) of the port, against solo runs and against the JAX
package.

Every packed slot must be bit-identical to the job it came from run alone:
best, best_params and the final state slice, on every backend and (for
fused-islands) every epoch plan.  On the CPU the fused backends run their
kernels' plain versions; the streamed plan is reached with 12 islands (past
the 8-island cluster), as in tests/test_torch_islands.py.
"""

import dataclasses
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import ga as JGA  # noqa: E402
from repro.ga import compile_cache as JCC  # noqa: E402
from repro_torch import faults as FLT  # noqa: E402
from repro_torch import ga  # noqa: E402
from repro_torch.ckpt import checkpoint as CKPT  # noqa: E402
from repro_torch.ga import compile_cache as CC  # noqa: E402


@pytest.fixture(autouse=True)
def _no_ambient_cost_table(monkeypatch):
    """The plans here are the heuristic's: no cost table found on the host
    may move them."""
    monkeypatch.setenv("REPRO_GA_COST_TABLE", "off")


CPU = ga.EngineOptions(device="cpu")


def _kw(**kw):
    base = dict(problem="F3", n=32, bits_per_var=10, mode="arith",
                mutation_rate=0.05, seed=11, generations=20)
    base.update(kw)
    return base


def _spec(**kw):
    return ga.GASpec(**_kw(**kw))


ISL = dict(n_islands=4, migrate_every=5, gens_per_epoch=10)
CASES = {
    "reference": ("reference", {}, None),
    "islands": ("islands", ISL, None),
    "fused": ("fused", dict(gens_per_epoch=4), None),
    "fused-islands-resident": ("fused-islands", ISL, None),
    "fused-islands-gridded": ("fused-islands", ISL, "gridded"),
    "fused-islands-resident-free": (
        "fused-islands", dict(ISL, migration="none"), "resident-free"),
    "fused-islands-streamed": ("fused-islands", dict(ISL, n_islands=12),
                               None),
}


def _jobs(kw):
    return [_spec(seed=11, **kw), _spec(seed=40, **kw),
            _spec(seed=7, n_repeats=2, **kw)]


def _final_state(ckpt_dir, like):
    return CKPT.restore(ckpt_dir, CKPT.latest_step(ckpt_dir), like)[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_engine_bit_identical_to_solo(tmp_path, case):
    backend, kw, plan = CASES[case]
    opts = ga.EngineOptions(device="cpu", plan_override=plan)
    specs = _jobs(kw)
    pe = ga.PackedEngine(specs, backend, options=opts)
    assert pe.backend_name == backend and pe.n_slots == 4
    teles = list(pe.run_chunked(chunk_generations=10,
                                ckpt_dir=str(tmp_path)))
    assert [t["gens_done"] for t in teles] == [10, 20]
    if plan is not None:
        assert pe.backend.topology.plan["mode"] == plan
    elif "streamed" in case:
        assert pe.backend.topology.plan["mode"] == "streamed"
    packed = _final_state(str(tmp_path), pe.init_state())
    for j, (spec, jt) in enumerate(zip(specs, teles[-1]["jobs"])):
        solo = ga.solve(spec, backend=backend, options=opts)
        assert jt["best_fitness"] == solo.best_fitness, j
        np.testing.assert_array_equal(jt["best_params"], solo.best_params)
        assert jt["migrations"] == solo.telemetry.topology.migrations
        assert jt["job_index"] == j and jt["pack_size"] == 3
        off, cnt = jt["slots"]
        for name, a, b in zip(ga.backends.G.GAState._fields, packed,
                              solo.state):
            np.testing.assert_array_equal(
                a[off:off + cnt].reshape(b.shape).numpy(), b.numpy(),
                err_msg=f"job {j} {name}")


def test_packed_reference_matches_the_jax_pack():
    kw = dict(mode="lut", bits_per_var=8)
    specs = _jobs(kw)
    got = ga.PackedEngine(specs, "reference", options=CPU).run(
        chunk_generations=10)
    jspecs = [JGA.GASpec(**_kw(seed=s.seed, n_repeats=s.n_repeats, **kw))
              for s in specs]
    want = JGA.PackedEngine(jspecs, "reference").run(chunk_generations=10)
    for g, w in zip(got, want):
        assert g["best_fitness"] == w["best_fitness"]
        np.testing.assert_array_equal(g["best_params"], w["best_params"])
        np.testing.assert_array_equal(g["traj_best"], w["traj_best"])
        assert g["slots"] == w["slots"] and g.keys() == w.keys()


@pytest.mark.parametrize("backend,kw", [("reference", {}), ("islands", ISL),
                                        ("fused", {})])
def test_init_packed_slots_are_solo_inits(backend, kw):
    spec = _spec(n_repeats=3, **kw)
    eng = ga.Engine(spec, backend, options=CPU)
    packed = eng.backend.init_packed([5, 9, 2])
    for i, seed in enumerate((5, 9, 2)):
        solo = ga.Engine(_spec(seed=seed, **kw), backend,
                         options=CPU).init_state()
        for a, b in zip(packed, solo):
            np.testing.assert_array_equal(a[i].reshape(b.shape).numpy(),
                                          b.numpy())
    with pytest.raises(ValueError, match="2 seeds packed"):
        eng.backend.init_packed([1, 2])


def test_single_job_delegates():
    spec = _spec(seed=3)
    pe = ga.PackedEngine([spec], "reference", options=CPU)
    assert pe._solo is not None
    packed = pe.run()
    solo = ga.solve(spec, backend="reference", options=CPU)
    assert packed[0]["best_fitness"] == solo.best_fitness
    assert packed[0]["pack_size"] == 1 and packed[0]["slots"] == (0, 1)
    # one job of two repeats has a stack axis: it packs
    assert ga.PackedEngine([_spec(n_repeats=2)], "reference",
                           options=CPU)._solo is None


def test_incompatible_specs_refused():
    with pytest.raises(ga.BackendUnsupported, match="compile_key"):
        ga.PackedEngine([_spec(), _spec(n=64)], "reference", options=CPU)
    with pytest.raises(ga.BackendUnsupported, match="generations"):
        ga.PackedEngine([_spec(), _spec(generations=30)], "reference",
                        options=CPU)
    with pytest.raises(ValueError, match="at least one"):
        ga.PackedEngine([], "reference", options=CPU)


def test_mismatched_pack_refused_on_resume(tmp_path):
    ck = str(tmp_path / "pack")
    it = ga.PackedEngine([_spec(seed=11), _spec(seed=40)], "reference",
                         options=CPU).run_chunked(chunk_generations=10,
                                                  ckpt_dir=ck)
    next(it)
    del it
    other = ga.PackedEngine([_spec(seed=40), _spec(seed=11)], "reference",
                            options=CPU)
    with pytest.raises(ValueError, match="same jobs in the same order"):
        next(other.run_chunked(chunk_generations=10, ckpt_dir=ck))


@pytest.mark.parametrize("backend,kw", [("reference", {}),
                                        ("fused-islands", ISL)])
def test_packed_preempt_resume_bit_identical(tmp_path, backend, kw):
    specs = [_spec(seed=11, **kw), _spec(seed=40, **kw)]
    full = ga.PackedEngine(specs, backend, options=CPU).run(
        chunk_generations=10)
    ck = str(tmp_path / "pack")
    it = ga.PackedEngine(specs, backend, options=CPU).run_chunked(
        chunk_generations=10, ckpt_dir=ck)
    next(it)
    del it
    resumed = list(ga.PackedEngine(specs, backend, options=CPU).run_chunked(
        chunk_generations=10, ckpt_dir=ck))
    assert [t["gens_done"] for t in resumed] == [20]
    assert resumed[0]["resumed_from"] == 10
    for jt_full, jt_res in zip(full, resumed[-1]["jobs"]):
        assert jt_res["best_fitness"] == jt_full["best_fitness"]
        np.testing.assert_array_equal(jt_res["best_params"],
                                      jt_full["best_params"])
        assert jt_res["telemetry"].resumed_from == 10
        assert jt_res["telemetry"].per_repeat is None
    done = list(ga.PackedEngine(specs, backend, options=CPU).run_chunked(
        chunk_generations=10, ckpt_dir=ck))
    assert len(done) == 1 and done[0]["already_complete"]
    assert [j["best_fitness"] for j in done[0]["jobs"]] == \
        [j["best_fitness"] for j in full]


def test_packed_chunk_crash_and_corrupt_step(tmp_path):
    specs = [_spec(seed=11, generations=40), _spec(seed=40, generations=40)]
    want = ga.PackedEngine(specs, "reference", options=CPU).run(
        chunk_generations=10)
    ck = str(tmp_path / "pack")
    inj = FLT.parse_faults("ckpt_corrupt:at=2;chunk_crash:at=3")
    seen = []
    with pytest.raises(FLT.ChunkCrash) as e:
        for tele in ga.PackedEngine(specs, "reference", options=dataclasses
                                    .replace(CPU, faults=inj)).run_chunked(
                chunk_generations=10, ckpt_dir=ck, fault_tag="ga-1,ga-2"):
            seen.append(tele["gens_done"])
    assert seen == [10, 20] and e.value.tag == "ga-1,ga-2|reference|chunk=3"
    with pytest.warns(UserWarning, match="failed validation"):
        resumed = list(ga.PackedEngine(specs, "reference",
                                       options=CPU).run_chunked(
            chunk_generations=10, ckpt_dir=ck))
    assert resumed[0]["resumed_from"] == 10     # past the corrupt step 20
    for w, g in zip(want, resumed[-1]["jobs"]):
        assert g["best_fitness"] == w["best_fitness"]


@pytest.mark.parametrize("backend,kw", [("reference", {}), ("islands", ISL),
                                        ("fused", {}),
                                        ("fused-islands", ISL)])
def test_repack_checkpoint_slices_bit_identically(tmp_path, backend, kw):
    specs = [_spec(seed=11, generations=40, **kw),
             _spec(seed=40, generations=40, **kw),
             _spec(seed=7, generations=40, **kw)]
    pack_dir = str(tmp_path / "pack")
    for tele in ga.PackedEngine(specs, backend, options=CPU).run_chunked(
            chunk_generations=10, ckpt_dir=pack_dir):
        if tele["gens_done"] >= 20:
            break                       # pack parked at generation 20

    solo_dir = str(tmp_path / "solo1")
    assert ga.repack_checkpoint(pack_dir, specs, [1], solo_dir, backend,
                                options=CPU) == 20
    teles = list(ga.Engine(specs[1], backend, options=CPU).run_chunked(
        chunk_generations=10, ckpt_dir=solo_dir))
    assert teles[0]["resumed_from"] == 20
    want = ga.solve(specs[1], backend=backend, options=CPU)
    assert teles[-1]["best_fitness"] == want.best_fitness
    np.testing.assert_array_equal(teles[-1]["best_params"], want.best_params)

    pair_dir = str(tmp_path / "pair")
    assert ga.repack_checkpoint(pack_dir, specs, [0, 2], pair_dir, backend,
                                options=CPU) == 20
    pe2 = ga.PackedEngine([specs[0], specs[2]], backend, options=CPU)
    last = list(pe2.run_chunked(chunk_generations=10,
                                ckpt_dir=pair_dir))[-1]
    final = _final_state(pair_dir, pe2.init_state())
    for spec, jt in zip((specs[0], specs[2]), last["jobs"]):
        solo = ga.solve(spec, backend=backend, options=CPU)
        assert jt["best_fitness"] == solo.best_fitness
        off, cnt = jt["slots"]
        np.testing.assert_array_equal(
            final.x[off:off + cnt].reshape(solo.state.x.shape).numpy(),
            solo.state.x.numpy())


def test_repack_refuses_other_specs(tmp_path):
    specs = [_spec(seed=11), _spec(seed=40)]
    pack_dir = str(tmp_path / "pack")
    next(ga.PackedEngine(specs, "reference", options=CPU).run_chunked(
        chunk_generations=10, ckpt_dir=pack_dir))
    with pytest.raises(ValueError, match="original specs"):
        ga.repack_checkpoint(pack_dir, specs[::-1], [0],
                             str(tmp_path / "x"), "reference", options=CPU)
    assert ga.repack_checkpoint(str(tmp_path / "none"), specs, [0],
                                str(tmp_path / "y"), "reference",
                                options=CPU) is None


# ---------------------------------------------------------------------------
# RUNNER_CACHE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,kw", [("reference", {}), ("fused", {}),
                                        ("islands", ISL),
                                        ("fused-islands", ISL)])
def test_second_engine_of_a_shape_builds_nothing(backend, kw):
    first = ga.Engine(_spec(seed=1, **kw), backend, options=CPU)
    r1 = first.run()
    before = CC.RUNNER_CACHE.stats()
    second = ga.Engine(_spec(seed=2, **kw), backend, options=CPU)
    r2 = second.run()
    after = CC.RUNNER_CACHE.stats()
    assert after["misses"] == before["misses"]
    assert after["hits"] > before["hits"]
    assert second.backend.executor is first.backend.executor
    assert second.spec.program() is first.spec.program()
    assert r2.best_fitness == ga.solve(_spec(seed=2, **kw), backend=backend,
                                       options=CPU).best_fitness
    assert r1.generations == r2.generations


def test_cache_keys_hold_shape_composition_and_device():
    a, b = _spec(seed=1), _spec(seed=2)
    key = CC.runner_key(a, "single", "reference", "cpu", "block", 5, True)
    assert key == CC.runner_key(b, "single", "reference", "cpu", "block", 5,
                                True)
    assert key != CC.runner_key(_spec(n=64), "single", "reference", "cpu",
                                "block", 5, True)
    assert key != CC.runner_key(a, "single", "fused", "cpu", "block", 5,
                                True)
    assert key != CC.runner_key(dataclasses.replace(a, n_repeats=2),
                                "single", "reference", "cpu", "block", 5,
                                True)
    assert CC.device_fingerprint("cpu") != CC.device_fingerprint("cuda:1")


def test_lru_counts_hits_misses_evictions():
    cache = CC.CompileCache(max_entries=2)
    built = []
    for k in ("a", "b", "a", "c", "b"):
        cache.get_or_build(k, lambda k=k: built.append(k) or k)
    assert built == ["a", "b", "c", "b"]
    assert cache.stats() == {"entries": 2, "hits": 1, "misses": 4,
                             "evictions": 2}
    cache.reset()
    assert cache.stats() == {"entries": 0, "hits": 0, "misses": 0,
                             "evictions": 0}


def test_cache_under_contention():
    """More threads than cores, a short switch interval: every resolution
    is counted once and every caller gets the one stored part."""
    cache = CC.CompileCache(max_entries=8)
    n_threads, rounds = 32, 200
    got, errors = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(i):
        try:
            for r in range(rounds):
                got.append(cache.get_or_build(r % 4, lambda r=r: object()))
        except Exception as e:          # reported below
            errors.append(e)

    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    st = cache.stats()
    assert st["hits"] + st["misses"] == n_threads * rounds
    assert st["entries"] == 4 and st["misses"] == 4
    assert len({id(o) for o in got}) == 4


def test_plan_point_has_the_jax_fields():
    kw = _kw(n_islands=8, migrate_every=5, gens_per_epoch=10)
    want = JCC.plan_point(JGA.GASpec(**kw), executor="fused",
                          mode="resident", n_shards=2)
    got = CC.plan_point(ga.GASpec(**kw), executor="fused", mode="resident",
                        n_shards=2)
    assert got == want
    assert CC.stage_fingerprint(ga.GASpec(**kw)) == \
        JCC.stage_fingerprint(JGA.GASpec(**kw))
