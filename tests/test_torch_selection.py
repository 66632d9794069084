"""The port's operator registries (`repro_torch.core.selection`,
`repro_torch.ga.operators`) against the JAX package's, fed the same x, y
and LFSR words made with numpy from a seed.

Tolerance and its reason (hazard H5): `roulette` and `rank` build a cdf
from a float32 prefix sum and total, and the jitted JAX reference
computes them in XLA's CPU orders: a blocked scan of base 16 and a
reduce-window of 32-wide windows with the padding split around the row.
The port writes those orders out (`blocked_cumsum`, `blocked_sum`), so
the cdf is held bit-exact at the power-of-two sizes N in {16, 64, 1024}
and at the odd sizes {66, 100, 130, 200, 1000}, where a window of
ceil(n / k) elements would differ; so are the picks and the state, also
inside the jitted scan of a generation.  A fed-cdf test pins
the pick itself: JAX's own cdf and draws through the port's searchsorted
and clip give JAX's picks bit for bit.  Everything else is integer work
and bit-exact.  Runs use LUT fitness (integer ROM reads) so the state
comparison is not blurred by H1.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import ga as JGA  # noqa: E402
from repro.core import ga as JG  # noqa: E402
from repro.core import lfsr as JL  # noqa: E402
from repro.core import selection as JS  # noqa: E402
from repro.ga import operators as JOPS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import ga as TGA  # noqa: E402
from repro_torch.core import ga as TG  # noqa: E402
from repro_torch.core import selection as TS  # noqa: E402
from repro_torch.ga import operators as TOPS  # noqa: E402


@pytest.fixture(autouse=True)
def _no_ambient_cost_table(monkeypatch):
    """The plans here are the heuristic's: no cost table found on the host
    may move them."""
    monkeypatch.setenv("REPRO_GA_COST_TABLE", "off")


SIZES = (16, 64, 1024)
ODD_SIZES = (66, 100, 130, 200, 1000)
CPU = TGA.EngineOptions(device="cpu")


def _cfgs(n, minimize=True, v=3, c=10, rate=0.05):
    kw = dict(n=n, c=c, v=v, mutation_rate=rate, minimize=minimize, seed=5)
    return JG.GAConfig(**kw), TG.GAConfig(**kw)


def _inputs(n, v=3, c=10, reps=3, seed=0):
    rng = np.random.default_rng(seed + n)
    x = rng.integers(0, 1 << c, (reps, n, v), dtype=np.uint32)
    scale = rng.choice([1.0, 50.0, 1e4])
    y = (rng.standard_normal((reps, n)) * scale).astype(np.float32)
    y[:, ::7] = y[:, :1]                    # ties for the stable orders
    sel = rng.integers(0, 2 ** 32, (reps, 2, n),
                       dtype=np.uint64).astype(np.uint32)
    cross = rng.integers(0, 2 ** 32, (reps, v, n // 2),
                         dtype=np.uint64).astype(np.uint32)
    mut = rng.integers(0, 2 ** 32, (reps, v, n),
                       dtype=np.uint64).astype(np.uint32)
    return x, y, sel, cross, mut


def _w(a):
    return convert.words_from_numpy(a, device="cpu")


def _np(t):
    return convert.words_to_numpy(t)


@pytest.mark.parametrize("n", SIZES + ODD_SIZES + (33, 3000))
def test_blocked_scan_and_sum_are_xla_orders(n):
    rng = np.random.default_rng(n)
    w = (rng.random((4, n)) * rng.choice([1.0, 100.0, 1e4],
                                         (4, 1))).astype(np.float32) + \
        np.float32(1e-9)
    want_cs = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(w))
    want_s = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=-1))(w))
    np.testing.assert_array_equal(TS.blocked_cumsum(torch.from_numpy(w))
                                  .numpy(), want_cs)
    np.testing.assert_array_equal(TS.blocked_sum(torch.from_numpy(w))
                                  .numpy(), want_s)
    # one row alone, as the JAX operators see it under vmap
    np.testing.assert_array_equal(
        TS.blocked_cumsum(torch.from_numpy(w[0])).numpy(),
        np.asarray(jax.jit(jnp.cumsum)(w[0])))


@pytest.mark.parametrize("n", SIZES + ODD_SIZES)
@pytest.mark.parametrize("minimize", [True, False])
@pytest.mark.parametrize("name", ["roulette", "rank"])
def test_cdf_bit_exact(name, minimize, n):
    jc, tc = _cfgs(n, minimize)
    _x, y, _s, _c, _m = _inputs(n)

    def jcdf(yy):
        yf = yy.astype(jnp.float32)
        if name == "roulette":
            w = (jnp.max(yf) - yf) if minimize else (yf - jnp.min(yf))
            w = w + 1e-9
        else:
            order = jnp.argsort(yf) if minimize else jnp.argsort(-yf)
            w = jnp.zeros((n,), jnp.float32).at[order].set(
                jnp.arange(n, 0, -1, dtype=jnp.float32))
        return jnp.cumsum(w) / jnp.sum(w)

    want = np.asarray(jax.jit(jax.vmap(jcdf))(jnp.asarray(y)))
    fn = TS.roulette_cdf if name == "roulette" else TS.rank_cdf
    np.testing.assert_array_equal(fn(torch.from_numpy(y), tc).numpy(), want)


@pytest.mark.parametrize("n", SIZES)
def test_fed_cdf_picks_bit_exact(n):
    """JAX's cdf and draws into the port's searchsorted and clip."""
    jc, tc = _cfgs(n)
    _x, y, sel, _c, _m = _inputs(n, seed=3)

    def jpieces(yy, s):
        yf = yy.astype(jnp.float32)
        w = (jnp.max(yf) - yf) + 1e-9
        cdf = jnp.cumsum(w) / jnp.sum(w)
        _st, r = JL.draw(s, jc.steps_per_draw)
        u = r[0].astype(jnp.float32) / jnp.float32(2 ** 32)
        return cdf, u, jnp.clip(jnp.searchsorted(cdf, u), 0, n - 1)

    cdf, u, pick = (np.array(a) for a in jax.jit(jax.vmap(jpieces))(
        jnp.asarray(y), jnp.asarray(sel)))
    np.testing.assert_array_equal(
        TS.pick(torch.from_numpy(cdf), torch.from_numpy(u), n).numpy(), pick)
    _st, tu = TS.unit_draw(_w(sel), tc)
    np.testing.assert_array_equal(tu.numpy(), u)
    # draws past the last cdf entry clip to the last slot, as in JAX
    top = torch.full((1, n), 1.5, dtype=torch.float32)
    assert TS.pick(torch.from_numpy(cdf[:1]), top, n).max().item() == n - 1


@pytest.mark.parametrize("n", SIZES + ODD_SIZES)
@pytest.mark.parametrize("minimize", [True, False])
@pytest.mark.parametrize("name", ["tournament", "tournament4", "roulette",
                                  "rank", "tournament_elite"])
def test_selection_bit_exact(name, minimize, n):
    jc, tc = _cfgs(n, minimize)
    x, y, sel, _c, _m = _inputs(n, seed=1)
    jf = jax.jit(jax.vmap(lambda a, b, s: JOPS.SELECTION[name](a, b, s, jc)))
    jw, js = jf(jnp.asarray(x), jnp.asarray(y), jnp.asarray(sel))
    tw, ts = TOPS.SELECTION[name](_w(x), torch.from_numpy(y), _w(sel), tc)
    np.testing.assert_array_equal(_np(tw), np.asarray(jw))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))


def test_elitism_falls_back_to_the_front_when_p_fills_n():
    jc, tc = _cfgs(16, rate=1.0)            # P = N: the elite goes to slot 0
    x, y, sel, _c, _m = _inputs(16, seed=2)
    jw, _ = jax.jit(jax.vmap(lambda a, b, s: JOPS.SELECTION[
        "tournament_elite"](a, b, s, jc)))(jnp.asarray(x), jnp.asarray(y),
                                           jnp.asarray(sel))
    tw, _ = TOPS.SELECTION["tournament_elite"](_w(x), torch.from_numpy(y),
                                               _w(sel), tc)
    np.testing.assert_array_equal(_np(tw), np.asarray(jw))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind,name", [("crossover", "uniform"),
                                       ("crossover", "none"),
                                       ("crossover", "single_point"),
                                       ("mutation", "none"),
                                       ("mutation", "xor")])
def test_variation_ops_bit_exact(kind, name, n):
    jc, tc = _cfgs(n)
    x, _y, _s, cross, mut = _inputs(n, seed=4)
    bank = cross if kind == "crossover" else mut
    jreg = JOPS.CROSSOVER if kind == "crossover" else JOPS.MUTATION
    treg = TOPS.CROSSOVER if kind == "crossover" else TOPS.MUTATION
    jz, jb = jax.jit(jax.vmap(lambda a, b: jreg[name](a, b, jc)))(
        jnp.asarray(x), jnp.asarray(bank))
    tz, tb = treg[name](_w(x), _w(bank), tc)
    np.testing.assert_array_equal(_np(tz), np.asarray(jz))
    np.testing.assert_array_equal(_np(tb), np.asarray(jb))


PIPELINES = [("tournament4", "single_point", "xor"),
             ("tournament_elite", "single_point", "xor"),
             ("tournament", "uniform", "xor"),
             ("tournament", "none", "none"),
             ("roulette", "single_point", "xor"),
             ("rank", "uniform", "none")]


@pytest.mark.parametrize("n", (16, 64) + ODD_SIZES)
@pytest.mark.parametrize("ops", PIPELINES, ids="-".join)
def test_make_generation_through_run_scan_bit_exact(ops, n):
    """`make_generation` driven by `run_scan` over a replica stack: the
    whole state, best and trajectory bit-exact (LUT fitness)."""
    from repro.core import fitness as JF
    from repro_torch.core import fitness as TF
    jc, tc = _cfgs(n, v=2, c=8)
    jc = dataclasses.replace(jc, mode="lut")
    tc = dataclasses.replace(tc, mode="lut")
    kw = dict(problem="rastrigin", n_vars=2, bits_per_var=8, mode="lut")
    jfit = JF.compile_program(**kw).fitness("lut")
    tfit = TF.compile_program(**kw).fitness("lut")
    seeds = [5, 6, 7]
    jst = jax.tree.map(lambda *a: jnp.stack(a), *[
        JG.init_state(dataclasses.replace(jc, seed=s)) for s in seeds])
    tst = TG.init_states(tc, seeds, device="cpu")
    jgen, tgen = JOPS.make_generation(*ops), TOPS.make_generation(*ops)
    jrun = jax.jit(jax.vmap(lambda s: JG.run_scan(jc, jfit, 12, s, jgen)))(
        jst)
    trun = TG.run_scan(tc, tfit, 12, tst, tgen)
    for a, b in zip(jrun.state, convert.state_to_numpy(trun.state)):
        np.testing.assert_array_equal(b, np.asarray(a))
    np.testing.assert_array_equal(trun.best_y.numpy(),
                                  np.asarray(jrun.best_y))
    np.testing.assert_array_equal(_np(trun.best_x), np.asarray(jrun.best_x))
    np.testing.assert_array_equal(trun.traj_best.numpy(),
                                  np.asarray(jrun.traj_best))


@pytest.mark.parametrize("backend,kw", [
    ("reference", dict(n_repeats=2)),
    ("islands", dict(n_islands=4, migrate_every=5))])
@pytest.mark.parametrize("ops", [
    dict(selection="tournament4"), dict(selection="roulette"),
    dict(selection="rank"), dict(selection="tournament_elite"),
    dict(crossover="uniform"), dict(crossover="none", mutation="none")],
    ids=lambda d: "-".join(d.values()))
def test_solve_with_registered_operators_matches_jax(backend, kw, ops):
    """`GASpec(selection=...)` through `solve` on the CPU: best, best_x and
    traj_best equal the JAX package's run (LUT fitness)."""
    spec_kw = dict(problem="F3", n=32, bits_per_var=8, mode="lut",
                   generations=15, seed=9, **kw, **ops)
    want = JGA.solve(JGA.GASpec(**spec_kw), backend=backend)
    got = TGA.solve(TGA.GASpec(**spec_kw), backend=backend, options=CPU)
    assert got.backend == backend
    assert got.best_fitness == want.best_fitness
    np.testing.assert_array_equal(got.best_x, want.best_x)
    np.testing.assert_array_equal(got.traj_best, want.traj_best)


def test_fused_refuses_non_paper_operators_with_the_jax_reason():
    spec = TGA.GASpec(problem="F3", n=32, selection="roulette")
    jspec = JGA.GASpec(problem="F3", n=32, selection="roulette")
    reason = TGA.capability_matrix(spec)["fused"]
    assert reason == JGA.capability_matrix(jspec)["fused"]
    assert TGA.capability_matrix(spec)["fused-islands"] == reason
    assert TGA.capability_matrix(spec)["reference"] is None
    with pytest.warns(UserWarning, match="falling back to 'reference'"):
        r = TGA.solve(dataclasses.replace(spec, generations=3),
                      backend="fused", options=CPU)
    assert r.backend == "reference"


def test_registries_match():
    assert sorted(TOPS.SELECTION) == sorted(JOPS.SELECTION)
    assert sorted(TOPS.CROSSOVER) == sorted(JOPS.CROSSOVER)
    assert sorted(TOPS.MUTATION) == sorted(JOPS.MUTATION)
    assert sorted(TS.SELECTORS) == sorted(JS.SELECTORS)
    with pytest.raises(ValueError, match="unknown selection"):
        TOPS.make_generation("nope")
