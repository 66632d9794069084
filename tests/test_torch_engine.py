"""The slice as a whole: the port's `ga.solve` / `ga.Engine` on the CPU
against the JAX package's engine, and the port's two backends against each
other.

* Against the JAX ``eager`` backend (fitness evaluated op by op, operators
  integer-only) the port's ``reference`` matches bit for bit on F1, F2 and
  sphere:8 — state, best and trajectory of population bests.  The
  trajectory MEANS are float32 sums over N taken in another order (numpy's
  pairwise sum there, PyTorch's here); they agree within
  ``1e-6 * max(|mean|, |best|)`` per sample — relative to the larger of
  the two because mixed-sign fitness (F1) cancels in the mean.
* The port's ``fused`` matches its ``reference`` bit for bit on all seven
  problems (rosenbrock:5 included): on the CPU both run the same plain
  operators, and on the card the kernel repeats their arithmetic.
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import ga as JGA  # noqa: E402
from repro_torch import convert, ga  # noqa: E402
from repro_torch.kernels import ga_step as K  # noqa: E402

CPU = ga.EngineOptions(device="cpu")
ALL_PROBLEMS = ["F1", "F2", "F3", "sphere:4", "rastrigin:6", "ackley:4",
                "rosenbrock:5"]


def _kw(**kw):
    base = dict(problem="F3", n=64, bits_per_var=10, mode="arith",
                mutation_rate=0.05, seed=11, generations=20)
    base.update(kw)
    return base


def _segment(engine, gens):
    return engine.backend.segment(engine.init_state(), gens)


@pytest.mark.parametrize("n_repeats", [1, 3])
@pytest.mark.parametrize("problem", ["F1", "F2", "sphere:8"])
def test_reference_matches_jax_eager_backend(problem, n_repeats):
    kw = _kw(problem=problem, n_repeats=n_repeats)
    je = JGA.Engine(JGA.GASpec(**kw), "eager")
    js = _segment(je, 20)
    te = ga.Engine(ga.GASpec(**kw), "reference", options=CPU)
    ts = _segment(te, 20)
    got = convert.state_to_numpy(ts.state)
    for name, a, b in zip(("x", "sel", "cross", "mut", "k"),
                          (js.state.x, js.state.sel_lfsr, js.state.cross_lfsr,
                           js.state.mut_lfsr, js.state.k), got):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)
    assert ts.best_y == js.best_y
    np.testing.assert_array_equal(ts.best_x, np.asarray(js.best_x))
    np.testing.assert_array_equal(ts.traj_best, np.asarray(js.traj_best))
    jm = np.asarray(js.traj_mean)
    scale = np.maximum(np.abs(jm), np.abs(np.asarray(js.traj_best)))
    assert np.all(np.abs(ts.traj_mean - jm) <= 1e-6 * scale)


@pytest.mark.parametrize("problem", ALL_PROBLEMS)
def test_fused_matches_reference_bit_exact(problem):
    spec = ga.GASpec(**_kw(problem=problem, generations=12))
    r = ga.solve(spec, backend="reference", options=CPU)
    f = ga.solve(spec, backend="fused", options=CPU)
    assert (r.backend, f.backend) == ("reference", "fused")
    for a, b in zip(convert.state_to_numpy(r.state)[:4],
                    convert.state_to_numpy(f.state)[:4]):
        np.testing.assert_array_equal(a[None], b)
    assert r.best_fitness == f.best_fitness
    np.testing.assert_array_equal(r.best_x, f.best_x)
    np.testing.assert_array_equal(r.traj_best, f.traj_best)
    np.testing.assert_array_equal(r.traj_mean, f.traj_mean)


@pytest.mark.parametrize("problem", ["F1", "rastrigin:4"])
def test_gens_per_epoch_keeps_state_and_best(problem):
    base = ga.GASpec(**_kw(problem=problem, generations=18, n_repeats=2))
    outs = {g: ga.solve(dataclasses.replace(base, gens_per_epoch=g),
                        backend="fused", options=CPU) for g in (1, 4)}
    a, b = outs[1], outs[4]
    for x, y in zip(convert.state_to_numpy(a.state),
                    convert.state_to_numpy(b.state)):
        np.testing.assert_array_equal(x, y)
    assert a.best_fitness == b.best_fitness
    np.testing.assert_array_equal(a.best_x, b.best_x)
    assert len(a.traj_best) == 18 and len(b.traj_best) == 5   # 4+4+4+4+2
    assert a.telemetry.topology.launches == 18
    assert b.telemetry.topology.launches == 5
    # each launch's sample is its last generation's population best
    np.testing.assert_array_equal(b.traj_best, a.traj_best[[3, 7, 11, 15,
                                                            17]])


def test_repeats_replica_zero_matches_solo_run():
    spec = ga.GASpec(**_kw(problem="F2"))
    solo = _segment(ga.Engine(spec, "reference", options=CPU), 20)
    rep = _segment(ga.Engine(dataclasses.replace(spec, n_repeats=3),
                             "reference", options=CPU), 20)
    np.testing.assert_array_equal(convert.words_to_numpy(rep.state.x)[0],
                                  convert.words_to_numpy(solo.state.x))
    np.testing.assert_array_equal(rep.telemetry.per_repeat.best_x[0],
                                  solo.best_x)
    assert rep.telemetry.per_repeat.best[0] == solo.best_y


def test_entry_points_need_cuda_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ga.GASpec(**_kw(generations=2))
    for call in (lambda: ga.solve(spec),
                 lambda: ga.solve(spec, backend="reference"),
                 lambda: ga.Engine(spec, "fused"),
                 lambda: ga.solve(spec, options=ga.EngineOptions())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert ga.solve(spec, options=CPU).backend == "reference"
    with pytest.raises(ValueError):
        ga.EngineOptions(device="meta")


def test_gaspec_fields_match_jax_package():
    """The two GASpecs cannot drift: same field names, order, defaults."""
    jf = [(f.name, f.default) for f in dataclasses.fields(JGA.GASpec)]
    tf = [(f.name, f.default) for f in dataclasses.fields(ga.GASpec)]
    assert tf == jf
    for bad in (dict(problem="nope"), dict(problem="F3:4"),
                dict(sel_lane="onehot", n=2048), dict(n_repeats=0),
                dict(problem="ackley", mode="lut"),
                dict(topology="island_ring")):
        with pytest.raises(ValueError):
            JGA.GASpec(**_kw(**bad))
        with pytest.raises(ValueError):
            ga.GASpec(**_kw(**bad))
    a = ga.GASpec(**_kw(problem="rastrigin:8"))
    assert (a.problem, a.n_vars, a.v) == ("rastrigin", 8, 8)
    assert ga.paper_spec("F3", n=64, m=20).bits_per_var == 10


def test_capability_matrix_and_fallback():
    ok = ga.GASpec(**_kw())
    assert ga.capability_matrix(ok) == {"reference": None, "fused": None}
    assert ga.resolve_backend(ok, "auto", "cuda") == "fused"
    assert ga.resolve_backend(ok, "auto", "cpu") == "reference"
    cases = {
        "mode='arith'": dict(mode="lut"),
        "power-of-two": dict(n=48),
        "bytes of shared memory": dict(problem="sphere:8", n=4096),
        "no Hopper FFM stage": dict(problem=None, bounds=((-1.0, 1.0),) * 2,
                                    fitness=lambda p: (p * p).sum(-1)),
    }
    for needle, bad in cases.items():
        spec = ga.GASpec(**_kw(**bad))
        assert needle in ga.capability_matrix(spec)["fused"]
        with pytest.warns(UserWarning, match="falling back to 'reference'"):
            assert ga.resolve_backend(spec, "fused", "cuda") == "reference"
    with pytest.raises(ga.BackendUnsupported):
        ga.resolve_backend(ok, "islands")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        r = ga.solve(ga.GASpec(**_kw(mode="lut", generations=5)), "reference",
                     options=CPU)
    assert np.isfinite(r.best_fitness)


def test_blackbox_and_lut_run_on_reference():
    target = torch.tensor([0.25, -1.5, 2.0])
    spec = ga.GASpec(fitness=lambda p: ((p - target) ** 2).sum(-1),
                     bounds=((-4.0, 4.0),) * 3, n=32, bits_per_var=12,
                     mutation_rate=0.05, seed=13, generations=30)
    with pytest.warns(UserWarning):
        r = ga.solve(spec, backend="fused", options=CPU)
    assert r.backend == "reference" and r.best_params.shape == (3,)
    assert r.best_fitness < 1.0
    lut = ga.GASpec(**_kw(problem="F1", mode="lut", generations=20))
    jr = JGA.solve(JGA.GASpec(**_kw(problem="F1", mode="lut",
                                    generations=20)), backend="reference")
    tr = ga.solve(lut, backend="reference", options=CPU)
    assert tr.best_fitness == jr.best_fitness    # integer ROMs: exact
    np.testing.assert_array_equal(tr.best_x, jr.best_x)


def test_fused_counts_no_launches_on_cpu():
    before = K.LAUNCHES["ga_generation"]
    ga.solve(ga.GASpec(**_kw(generations=3)), backend="fused", options=CPU)
    assert K.LAUNCHES["ga_generation"] == before
