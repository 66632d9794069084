"""The port's GA datapath (`repro_torch.core.ga`) against the JAX package's.

`init_state` is bit-exact.  The operators are pinned by the fed-y test: both
packages' `generation_with_y` get the SAME fitness vector (JAX's own y), so
the selection, crossover and mutation must agree bit for bit whatever the
two FFMs round to (hazard H1 is then out of the picture).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import fitness as JF  # noqa: E402
from repro.core import ga as JG  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import ga as TG  # noqa: E402

PROBLEMS = [("F1", 2), ("F2", 2), ("F3", 2), ("sphere", 4),
            ("rastrigin", 4), ("rosenbrock", 4), ("ackley", 4)]


def _cfgs(n, v, c, minimize, seed, mr=0.05):
    kw = dict(n=n, c=c, v=v, mutation_rate=mr, minimize=minimize, seed=seed,
              mode="arith")
    return JG.GAConfig(**kw), TG.GAConfig(**kw)


# the JAX operators, jitted per config (one compile instead of one per op)
_jax_ops = jax.jit(JG.generation_with_y, static_argnums=2)


def _feed(y):
    return torch.from_numpy(np.array(y))


def _assert_state_equal(jst, tst):
    got = convert.state_to_numpy(tst)
    for name, a, b in zip(("x", "sel", "cross", "mut", "k"), jst, got):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)


@pytest.mark.parametrize("n,v,c,seed", [(16, 2, 10, 1), (64, 2, 10, 7),
                                        (256, 4, 16, 12345),
                                        (1024, 8, 6, 2**32 - 1)])
def test_init_state_bit_exact(n, v, c, seed):
    jcfg, tcfg = _cfgs(n, v, c, True, seed)
    _assert_state_equal(JG.init_state(jcfg),
                        TG.init_state(tcfg, device="cpu"))


@pytest.mark.parametrize("minimize", [True, False])
@pytest.mark.parametrize("n", [16, 64, 256])
@pytest.mark.parametrize("problem,v", PROBLEMS)
def test_fed_y_operators_bit_exact(problem, v, n, minimize):
    """20 chained generations of SM+CM+MM from JAX's own fitness."""
    jcfg, tcfg = _cfgs(n, v, 10, minimize, seed=n + v)
    stage = jax.jit(JF.compile_program(problem=problem, n_vars=v,
                                       bits_per_var=10).stage)
    jst = JG.init_state(jcfg)
    tst = convert.state_from_numpy(*jst, device="cpu")
    for _ in range(20):
        y = stage(jst.x)
        jst = _jax_ops(jst, y, jcfg)
        tst = TG.generation_with_y(tst, _feed(y), tcfg)
    _assert_state_equal(jst, tst)


def test_fed_y_stacked_replicas_match_solo():
    """A leading replica axis evolves each replica exactly as alone."""
    jcfg, tcfg = _cfgs(64, 2, 10, True, seed=3)
    stage = jax.jit(JF.compile_program(problem="F3",
                                       bits_per_var=10).stage)
    seeds = [3, 4, 5]
    solos = [JG.init_state(dataclasses.replace(jcfg, seed=s)) for s in seeds]
    tst = TG.stack_states([convert.state_from_numpy(*s, device="cpu")
                           for s in solos])
    for _ in range(10):
        ys = [stage(s.x) for s in solos]
        solos = [_jax_ops(s, y, jcfg) for s, y in zip(solos, ys)]
        tst = TG.generation_with_y(
            tst, _feed(np.stack([np.asarray(y) for y in ys])),
            tcfg)
    got = convert.state_to_numpy(tst)
    for r, s in enumerate(solos):
        np.testing.assert_array_equal(got[0][r], np.asarray(s.x))
        np.testing.assert_array_equal(got[1][r], np.asarray(s.sel_lfsr))


def test_fed_y_non_power_of_two_population():
    """N=48 folds tournament indices modulo N, as the JAX reference does."""
    jcfg, tcfg = _cfgs(48, 2, 10, True, seed=9)
    stage = jax.jit(JF.compile_program(problem="F2",
                                       bits_per_var=10).stage)
    jst = JG.init_state(jcfg)
    tst = convert.state_from_numpy(*jst, device="cpu")
    for _ in range(10):
        y = stage(jst.x)
        jst = _jax_ops(jst, y, jcfg)
        tst = TG.generation_with_y(tst, _feed(y), tcfg)
    _assert_state_equal(jst, tst)


@pytest.mark.parametrize("minimize", [True, False])
def test_gen_best_first_occurrence_and_strict_fold(minimize):
    y = torch.tensor([[3.0, 1.0, 1.0, 5.0, 5.0, 1.0]])
    x = torch.arange(12, dtype=torch.int32).reshape(1, 6, 2)
    gb, gx = TG.gen_best(x, y, minimize)
    want = int(np.argmin(y[0].numpy()) if minimize
               else np.argmax(y[0].numpy()))
    assert float(gb[0]) == float(y[0, want])
    assert gx[0].tolist() == x[0, want].tolist()
    # an equal later best does not replace the running best
    by, bx = TG.fold_best(gb, gx, gb, gx + 100, minimize)
    assert bx[0].tolist() == gx[0].tolist()


def test_config_validation_and_derived_fields():
    for kw in (dict(n=64, c=10, v=3, mutation_rate=0.07),
               dict(n=1024, c=15, v=8, mutation_rate=0.01)):
        j, t = JG.GAConfig(**kw), TG.GAConfig(**kw)
        assert (j.p, j.idx_bits, j.cut_bits, j.var_mask, j.m) == \
            (t.p, t.idx_bits, t.cut_bits, t.var_mask, t.m)
    with pytest.raises(ValueError):
        TG.GAConfig(n=15, c=10)
    with pytest.raises(ValueError):
        TG.GAConfig(n=16, c=10, sel_lane="auto")


def test_decode_best_matches():
    jcfg, tcfg = _cfgs(16, 2, 10, True, seed=1)
    bx = np.array([17, 1000], np.uint32)
    jrun = JG.GARun(None, None, jnp.asarray(bx), None, None)
    trun = TG.GARun(None, None, convert.words_from_numpy(bx, device="cpu"),
                    None, None)
    np.testing.assert_array_equal(
        TG.decode_best(trun, tcfg, (-128.0, 127.0)),
        JG.decode_best(jrun, jcfg, (-128.0, 127.0)))
