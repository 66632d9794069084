"""The port's `eager` backend and `core.ga.run_eager` against the JAX
package's on the CPU: the fitness crosses to the host every generation and
the operators run as the plain tensor step, so state, best, best_x and
both trajectories are bit-identical to JAX `eager` (both take the best and
the mean with numpy), for 1 and 4 replicas, with the pooled host fitness,
and through every registered operator.  Then the thin fitness builders,
routing, refusals and a chunked eager run that resumes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import ga as JGA  # noqa: E402
from repro.core import fitness as JF  # noqa: E402
from repro.core import ga as JG  # noqa: E402
from repro_torch import convert, ga  # noqa: E402
from repro_torch.core import fitness as TF  # noqa: E402
from repro_torch.core import ga as TG  # noqa: E402

CPU = ga.EngineOptions(device="cpu")


def _kw(**kw):
    base = dict(problem="F1", n=64, bits_per_var=10, mode="arith",
                mutation_rate=0.05, seed=11, generations=20)
    base.update(kw)
    return base


def _assert_same(j, t):
    """A JAX eager result and the port's: bit for bit."""
    for name, a, b in zip(("x", "sel", "cross", "mut", "k"),
                          (j.state.x, j.state.sel_lfsr, j.state.cross_lfsr,
                           j.state.mut_lfsr, j.state.k),
                          convert.state_to_numpy(t.state)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)
    assert t.best_y == j.best_y
    np.testing.assert_array_equal(t.best_x, np.asarray(j.best_x))
    np.testing.assert_array_equal(t.traj_best, np.asarray(j.traj_best))
    np.testing.assert_array_equal(t.traj_mean, np.asarray(j.traj_mean))


def _segments(kw, workers=1):
    je = JGA.Engine(JGA.GASpec(**kw), "eager",
                    options=JGA.EngineOptions(fitness_workers=workers))
    te = ga.Engine(ga.GASpec(**kw), "eager",
                   options=ga.EngineOptions(device="cpu",
                                            fitness_workers=workers))
    gens = kw["generations"]
    return (je.backend.segment(je.init_state(), gens),
            te.backend.segment(te.init_state(), gens))


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("n_repeats", [1, 4])
@pytest.mark.parametrize("problem,mode", [("F1", "arith"), ("F3", "lut"),
                                          ("sphere:4", "arith")])
def test_eager_matches_jax_eager_bit_for_bit(problem, mode, n_repeats,
                                             workers):
    kw = _kw(problem=problem, mode=mode, n_repeats=n_repeats)
    js, ts = _segments(kw, workers)
    _assert_same(js, ts)
    if n_repeats > 1:
        np.testing.assert_array_equal(ts.telemetry.per_repeat.best,
                                      js.telemetry.per_repeat.best)


@pytest.mark.parametrize("selection", ["tournament4", "roulette", "rank",
                                       "tournament_elite"])
def test_eager_matches_jax_eager_under_other_operators(selection):
    kw = _kw(problem="F2", n=16, selection=selection, crossover="uniform",
             generations=12)
    js, ts = _segments(kw)
    _assert_same(js, ts)


def test_pooled_fitness_equals_the_serial_call():
    spec = ga.GASpec(**_kw(problem="rastrigin:6", n=66))
    runs = [ga.solve(spec, backend="eager",
                     options=ga.EngineOptions(device="cpu",
                                              fitness_workers=w))
            for w in (1, 3, 7)]
    for r in runs[1:]:
        assert r.best_fitness == runs[0].best_fitness
        np.testing.assert_array_equal(r.traj_mean, runs[0].traj_mean)
        for a, b in zip(convert.state_to_numpy(r.state),
                        convert.state_to_numpy(runs[0].state)):
            np.testing.assert_array_equal(a, b)


def test_fitness_pool_lives_with_the_backend(monkeypatch):
    """One pool a backend, reused by every generation and every run, shut
    down when the backend is collected."""
    import concurrent.futures as cf
    import gc

    pools = []

    class Counted(cf.ThreadPoolExecutor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            pools.append(self)

    monkeypatch.setattr(cf, "ThreadPoolExecutor", Counted)
    spec = ga.GASpec(**_kw(problem="rastrigin:6", n=66, generations=6))
    eng = ga.Engine(spec, "eager",
                    options=ga.EngineOptions(device="cpu",
                                             fitness_workers=3))
    first, again = eng.run(), eng.run()
    assert first.best_fitness == again.best_fitness
    assert len(pools) == 1 and not pools[0]._shutdown
    del eng
    gc.collect()
    assert pools[0]._shutdown


def test_run_eager_places_a_fresh_state_only_where_asked():
    cfg = TG.GAConfig(n=16, c=10, v=2, seed=3, mode="arith")
    fit = TG.fitness_for_problem("F2", cfg)
    with pytest.raises(TypeError, match="device"):
        TG.run_eager(cfg, fit, 2)
    st = TG.init_state(cfg, device="cpu")
    with pytest.raises(ValueError, match="lies on"):
        TG.run_eager(cfg, fit, 2, st, device="meta")
    out = TG.run_eager(cfg, fit, 2, st, device="cpu")
    assert out.state.x.device.type == "cpu" and int(out.state.k) == 2


@pytest.mark.parametrize("minimize", [True, False])
def test_run_eager_matches_jax_run_eager(minimize):
    cfg_kw = dict(n=32, c=10, v=2, mutation_rate=0.05, minimize=minimize,
                  seed=5, mode="arith")
    jcfg, tcfg = JG.GAConfig(**cfg_kw), TG.GAConfig(**cfg_kw)
    jfit = JG.fitness_for_problem("F2", jcfg)
    tfit = TG.fitness_for_problem("F2", tcfg)
    j = JG.run_eager(jcfg, jfit, 15)
    t = TG.run_eager(tcfg, tfit, 15, device="cpu")
    assert float(t.best_y) == float(j.best_y)
    np.testing.assert_array_equal(convert.words_to_numpy(t.best_x),
                                  np.asarray(j.best_x))
    np.testing.assert_array_equal(t.traj_best.numpy(), np.asarray(j.traj_best))
    np.testing.assert_array_equal(t.traj_mean.numpy(), np.asarray(j.traj_mean))
    np.testing.assert_array_equal(convert.words_to_numpy(t.state.x),
                                  np.asarray(j.state.x))


def _words(shape, seed, c):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << c, size=shape, dtype=np.uint32)


@pytest.mark.parametrize("problem,mode", [("F1", "lut"), ("F3", "lut"),
                                          ("F2", "arith"),
                                          ("rastrigin:5", "arith")])
def test_fitness_for_problem_matches_jax(problem, mode):
    """Bit for bit, except rastrigin's cos, which XLA and PyTorch may round
    an ulp apart: there within the port's stated 1e-6 * max|y| (H1)."""
    v = 5 if ":" in problem else 2
    cfg_kw = dict(n=64, c=9, v=v, mode=mode, minimize=True)
    x = _words((64, v), 3, 9)
    want = np.asarray(JG.fitness_for_problem(problem, JG.GAConfig(**cfg_kw))(
        jnp.asarray(x)))
    got = TG.fitness_for_problem(problem, TG.GAConfig(**cfg_kw))(
        convert.words_from_numpy(x, device="cpu"))
    if problem.startswith("rastrigin"):
        bound = 1e-6 * float(np.max(np.abs(want)))
        assert float(np.max(np.abs(got.numpy() - want))) <= bound
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    pdef = TF.PROBLEMS[problem.split(":")[0]]
    by_def = TG.fitness_for_problem(pdef, TG.GAConfig(**cfg_kw))(
        convert.words_from_numpy(x, device="cpu"))
    np.testing.assert_array_equal(by_def.numpy(), got.numpy())


def test_make_lut_fitness_matches_jax():
    x = _words((32, 2), 4, 10)
    want = JG.make_lut_fitness(JF.build_tables(JF.PROBLEMS["F1"], 10, 2))(
        jnp.asarray(x))
    got = TG.make_lut_fitness(TF.build_tables(TF.PROBLEMS["F1"], 10, 2))(
        convert.words_from_numpy(x, device="cpu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_make_blackbox_fitness_matches_jax():
    bounds = ((-2.0, 3.0), (0.5, 4.0), (-1.0, 1.0))
    x = _words((40, 3), 5, 12)
    want = JG.make_blackbox_fitness(
        lambda p: p[:, 0] * p[:, 1] + p[:, 2], 12, bounds)(jnp.asarray(x))
    got = TG.make_blackbox_fitness(
        lambda p: p[:, 0] * p[:, 1] + p[:, 2], 12, bounds)(
        convert.words_from_numpy(x, device="cpu"))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_routing_and_refusals_as_in_jax():
    host = ga.GASpec(**_kw(jit_fitness=False))
    jhost = JGA.GASpec(**_kw(jit_fitness=False))
    assert ga.resolve_backend(host, "auto", "cpu") == "eager"
    assert JGA.resolve_backend(jhost, "auto") == "eager"
    caps, jcaps = ga.capability_matrix(host), JGA.capability_matrix(jhost)
    assert caps["eager"] is None and jcaps["eager"] is None
    for name in ("reference", "fused", "islands", "fused-islands"):
        assert "'eager'" in caps[name] and "'eager'" in jcaps[name]
    with pytest.warns(UserWarning, match="falling back to 'eager'"):
        assert ga.resolve_backend(host, "reference", "cpu") == "eager"
    isl = ga.GASpec(**_kw(n_islands=2))
    assert ga.capability_matrix(isl)["eager"] == \
        JGA.capability_matrix(JGA.GASpec(**_kw(n_islands=2)))["eager"]
    with pytest.raises(NotImplementedError, match="packed"):
        ga.PackedEngine([ga.GASpec(**_kw(n_repeats=2))], "eager",
                        options=CPU).init_state()


def test_eager_chunked_run_resumes_bit_identically(tmp_path):
    spec = ga.GASpec(**_kw(generations=24, jit_fitness=False))
    whole = ga.solve(spec, options=CPU)
    assert whole.backend == "eager"
    eng = ga.Engine(spec, options=ga.EngineOptions(
        device="cpu", faults="chunk_crash:at=2"))
    from repro_torch import faults as FLT
    with pytest.raises(FLT.ChunkCrash):
        for _ in eng.run_chunked(chunk_generations=8, ckpt_dir=str(tmp_path)):
            pass
    last = None
    for last in ga.Engine(spec, options=CPU).run_chunked(
            chunk_generations=8, ckpt_dir=str(tmp_path)):
        pass
    assert last["gens_done"] == 24
    assert last["best_fitness"] == whole.best_fitness
    np.testing.assert_array_equal(last["best_params"], whole.best_params)
