"""The port's FFM (`repro_torch.core.fitness`) against the JAX package's.

Tolerance and its reason (hazard H1): XLA's CPU jit contracts the decode
``lo + u * span`` and parts of the objectives into fused multiply-adds,
which round once where the plain expression rounds twice.  The port never
contracts, so it matches the JAX stage evaluated EAGERLY bit for bit where
the JAX and torch libraries agree (F1, F2, sphere), and the jitted stage
that both JAX executors run within ``|Δy| <= 1e-6 * max|y|`` over the
batch.  Ackley alone gets ``4e-6 * max|y|``: XLA's CPU exp and cos are
polynomial approximations a few ulp away from the C library's, and
ackley's ``20 + e - 20 exp(..) - exp(..)`` cancels near its optimum, so
those ulp of the ~22.7 constant terms reach 1.5e-6 * max|y| at V=2.  The
LUT stage is integer ROM reads: bit-exact always.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import fitness as JF  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import fitness as TF  # noqa: E402

JIT_TOL = {"ackley": 4e-6}      # |Δy| <= tol * max|y|, the H1 bound
DEFAULT_JIT_TOL = 1e-6


def _cases():
    out = []
    for name in ("F1", "F2", "F3"):
        out.append((name, 2))
    for name in ("sphere", "rastrigin", "rosenbrock", "ackley"):
        for v in (2, 4, 8):
            out.append((name, v))
    return out


CASES = _cases()
EAGER_EXACT = [("F1", 2), ("F2", 2), ("sphere", 8)]


def _bits(c, v, n=4096, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << c, size=(n, v), dtype=np.uint32)


def _progs(name, v, c, mode="arith"):
    kw = dict(problem=name, n_vars=v, bits_per_var=c, mode=mode)
    return JF.compile_program(**kw), TF.compile_program(**kw)


@pytest.mark.parametrize("name,v", EAGER_EXACT)
@pytest.mark.parametrize("c", [10, 16])
def test_stage_bit_exact_vs_eager_jax(name, v, c):
    jp, tp = _progs(name, v, c)
    x = _bits(c, v)
    xt = convert.words_from_numpy(x, device="cpu")
    np.testing.assert_array_equal(tp.decode(xt).numpy(),
                                  np.asarray(jp.decode(jnp.asarray(x))))
    np.testing.assert_array_equal(tp.stage(xt).numpy(),
                                  np.asarray(jp.stage(jnp.asarray(x))))


@pytest.mark.parametrize("name,v", CASES)
def test_stage_within_h1_bound_of_jitted_jax(name, v):
    c = 12
    jp, tp = _progs(name, v, c)
    x = _bits(c, v, seed=v)
    want = np.asarray(jax.jit(jp.stage)(jnp.asarray(x)))
    got = tp.stage(convert.words_from_numpy(x, device="cpu")).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    bound = JIT_TOL.get(name, DEFAULT_JIT_TOL) * np.max(np.abs(want))
    assert np.max(np.abs(got - want)) <= bound


@pytest.mark.parametrize("name,v", [(n, v) for n, v in CASES
                                    if n not in ("rosenbrock", "ackley")])
def test_lut_stage_bit_exact(name, v):
    c = 10
    jp, tp = _progs(name, v, c, mode="lut")
    np.testing.assert_array_equal(tp.tables.var_t, jp.tables.var_t)
    x = _bits(c, v, n=1024, seed=1)
    got = tp.lut_stage(convert.words_from_numpy(x, device="cpu"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jp.lut_stage(jnp.asarray(x))))
    assert tp.scale("lut") == jp.scale("lut")


def test_registry_and_validation_match():
    assert sorted(TF.PROBLEMS) == sorted(JF.PROBLEMS)
    for name, jdef in JF.PROBLEMS.items():
        tdef = TF.PROBLEMS[name]
        assert (tdef.domain, tdef.fixed_vars, tdef.default_vars,
                tdef.min_vars, tdef.separable) == \
            (jdef.domain, jdef.fixed_vars, jdef.default_vars, jdef.min_vars,
             jdef.separable)
    for bad in ("nope", "F3:4", "rosenbrock:1"):
        with pytest.raises(ValueError):
            JF.compile_program(problem=bad, bits_per_var=8)
        with pytest.raises(ValueError):
            TF.compile_program(problem=bad, bits_per_var=8)
    with pytest.raises(ValueError, match="separable"):
        TF.compile_program(problem="ackley", bits_per_var=8, mode="lut")


def test_blackbox_program():
    target = torch.tensor([0.25, -1.5, 2.0])
    prog = TF.compile_program(
        fitness=lambda p: ((p - target) ** 2).sum(-1),
        bounds=((-4.0, 4.0),) * 3, bits_per_var=12)
    assert prog.name == "blackbox" and prog.modes == ("arith",)
    x = convert.words_from_numpy(_bits(12, 3, n=8), device="cpu")
    assert prog.stage(x).shape == (8,)
    with pytest.raises(ValueError, match="LUT"):
        TF.compile_program(fitness=lambda p: p.sum(-1), bounds=((0, 1),),
                           bits_per_var=4, mode="lut")
