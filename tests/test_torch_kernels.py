"""K1 of the port (`repro_torch.kernels.ga_step`): the wrapper on CPU runs
the plain version, held here against `repro.kernels.ref.ga_generation_ref`
— the oracle the JAX tests hold the Pallas kernel to — over the sweeps of
tests/test_kernels.py.  The uint32 state is bit-exact.  The fitness y is
within ``|Δy| <= 1e-6 * max|y|``: the oracle runs jitted, and XLA's FMA
contraction and its sqrt/cos/exp round differently from PyTorch's (hazard
H1); the state stays exact on these inputs because no tournament compares
two fitness values closer than that.

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py holds
it against this plain version there.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import fitness as JF  # noqa: E402
from repro.core import ga as JG  # noqa: E402
from repro.core import islands as JISL  # noqa: E402
from repro.kernels import ops as JOPS  # noqa: E402
from repro.kernels import ref as JREF  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import fitness as TF  # noqa: E402
from repro_torch.core import ga as TG  # noqa: E402
from repro_torch.kernels import ga_step as K  # noqa: E402

Y_TOL = 1e-6            # |Δy| <= Y_TOL * max|y|, the H1 bound


def _cfgs(**kw):
    kw.setdefault("mode", "arith")
    return JG.GAConfig(**kw), TG.GAConfig(**kw)


def _setup(problem, jcfg, n_islands=2):
    """Island stack from the JAX package, carried over to the port."""
    st = JISL.init_islands_fast(JISL.IslandConfig(ga=jcfg,
                                                  n_islands=n_islands))
    jprog = JF.compile_program(problem=problem, n_vars=jcfg.v,
                               bits_per_var=jcfg.c)
    tprog = TF.compile_program(problem=problem, n_vars=jcfg.v,
                               bits_per_var=jcfg.c)
    tst = convert.state_from_numpy(st.x, st.sel_lfsr, st.cross_lfsr,
                                   st.mut_lfsr, 0, device="cpu")
    return st, jprog, tst, tprog


def _ref(jcfg, jprog):
    """The JAX oracle, jitted (one compile per shape instead of one per
    primitive)."""
    return jax.jit(functools.partial(JREF.ga_generation_ref, cfg=jcfg,
                                     ffm=jprog.stage))


def _check_against_ref(problem, jcfg, tcfg, n_islands=2):
    st, jprog, tst, tprog = _setup(problem, jcfg, n_islands)
    r = _ref(jcfg, jprog)(st.x, st.sel_lfsr, st.cross_lfsr, st.mut_lfsr)
    k = K.ga_generation_kernel(tst.x, tst.sel_lfsr, tst.cross_lfsr,
                               tst.mut_lfsr, cfg=tcfg, program=tprog)
    for a, b in zip(r[:4], k[:4]):          # state: bit-exact
        np.testing.assert_array_equal(np.asarray(a), convert.words_to_numpy(b))
    want = np.asarray(r[4])
    assert k[4].dtype == torch.float32
    assert np.max(np.abs(k[4].numpy() - want)) <= Y_TOL * np.max(np.abs(want))


@pytest.mark.parametrize("n", [16, 64, 256, 1024])
@pytest.mark.parametrize("problem", ["F1", "F2", "F3"])
def test_plain_matches_ref_population_sweep(n, problem):
    jcfg, tcfg = _cfgs(n=n, c=10, v=2, mutation_rate=0.03, seed=n)
    _check_against_ref(problem, jcfg, tcfg)


@pytest.mark.parametrize("problem,v", [("sphere", 4), ("rastrigin", 6),
                                       ("rosenbrock", 4), ("ackley", 8)])
def test_plain_nvar_suite_matches_ref(problem, v):
    jcfg, tcfg = _cfgs(n=64, c=10, v=v, mutation_rate=0.03, seed=v)
    _check_against_ref(problem, jcfg, tcfg, n_islands=3)


@pytest.mark.parametrize("c", [6, 10, 14, 15])
@pytest.mark.parametrize("mr", [0.01, 0.1])
def test_plain_matches_ref_width_sweep(c, mr):
    jcfg, tcfg = _cfgs(n=64, c=c, v=2, mutation_rate=mr, seed=c)
    _check_against_ref("F3", jcfg, tcfg, n_islands=3)


@pytest.mark.parametrize("minimize", [True, False])
@pytest.mark.parametrize("problem", ["F1", "F2", "F3"])
def test_plain_minimize_maximize(problem, minimize):
    jcfg, tcfg = _cfgs(n=128, c=10, v=2, mutation_rate=0.02, seed=5,
                       minimize=minimize)
    _check_against_ref(problem, jcfg, tcfg)


@pytest.mark.parametrize("minimize", [True, False])
@pytest.mark.parametrize("gens", [1, 4, 16])
def test_track_best_matches_per_generation_fold(gens, minimize):
    """track_best folds the running best over the in-call generations with
    strict improvement and the first-occurrence rule: re-running one
    generation at a time and folding outside gives the same best."""
    jcfg, tcfg = _cfgs(n=32, c=10, v=2, mutation_rate=0.05, seed=3,
                       minimize=minimize)
    st, jprog, tst, tprog = _setup("F1", jcfg, n_islands=3)
    args = (tst.x, tst.sel_lfsr, tst.cross_lfsr, tst.mut_lfsr)
    out = K.ga_generation_kernel(*args, cfg=tcfg, program=tprog, gens=gens,
                                 track_best=True)
    by = np.full((3,), np.inf if minimize else -np.inf, np.float32)
    bx = np.zeros((3, tcfg.v), np.uint32)
    cur = args
    for _ in range(gens):
        step = K.ga_generation_kernel(*cur, cfg=tcfg, program=tprog)
        y, x = step[4].numpy(), convert.words_to_numpy(cur[0])
        idx = np.argmin(y, axis=1) if minimize else np.argmax(y, axis=1)
        gb = y[np.arange(3), idx]
        better = gb < by if minimize else gb > by
        by = np.where(better, gb, by)
        bx = np.where(better[:, None], x[np.arange(3), idx], bx)
        cur = step[:4]
    np.testing.assert_array_equal(out[5].numpy(), by)
    np.testing.assert_array_equal(convert.words_to_numpy(out[6]), bx)
    for a, b in zip(out[:5], cur[:4] + (step[4],)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # and the state after `gens` generations is the JAX oracle's
    x, sel, cross, mut = st.x, st.sel_lfsr, st.cross_lfsr, st.mut_lfsr
    ref = _ref(jcfg, jprog)
    for _ in range(gens):
        x, sel, cross, mut, _y = ref(x, sel, cross, mut)
    np.testing.assert_array_equal(np.asarray(x),
                                  convert.words_to_numpy(out[0]))


def test_plain_matches_interpret_mode_pallas_kernel():
    """One case against the JAX package's Pallas kernel itself, run in
    interpret mode as the JAX tests run it on a CPU."""
    jcfg, tcfg = _cfgs(n=16, c=10, v=2, mutation_rate=0.05, seed=16)
    st, jprog, tst, tprog = _setup("F1", jcfg)
    j = JOPS.ga_generation(st.x, st.sel_lfsr, st.cross_lfsr, st.mut_lfsr,
                           cfg=jcfg, ffm=jprog.stage, gens=3,
                           track_best=True)
    t = K.ga_generation_kernel(tst.x, tst.sel_lfsr, tst.cross_lfsr,
                               tst.mut_lfsr, cfg=tcfg, program=tprog, gens=3,
                               track_best=True)
    for i in (0, 1, 2, 3, 6):
        np.testing.assert_array_equal(np.asarray(j[i]),
                                      convert.words_to_numpy(t[i]))
    for i in (4, 5):
        want = np.asarray(j[i])
        assert np.max(np.abs(t[i].numpy() - want)) <= \
            Y_TOL * np.max(np.abs(want))


def test_wrapper_rejects_non_pow2_population():
    tcfg = TG.GAConfig(n=30, c=10, v=2, seed=1, mode="arith")
    prog = TF.compile_program(problem="F3", bits_per_var=10)
    st = TG.stack_states([TG.init_state(tcfg, device="cpu")])
    with pytest.raises(ValueError, match="power-of-two"):
        K.ga_generation_kernel(st.x, st.sel_lfsr, st.cross_lfsr,
                               st.mut_lfsr, cfg=tcfg, program=prog)


def test_wrapper_rejects_population_past_shared_memory():
    """N=8192, V=2 needs more shared memory than a Hopper block has; the
    wrapper names the bytes and the limit instead of clipping."""
    tcfg = TG.GAConfig(n=8192, c=10, v=2, seed=1, mode="arith",
                       sel_lane="gather")
    assert K.smem_bytes(8192, 2) > K.SMEM_LIMIT >= K.smem_bytes(4096, 2)
    assert K.smem_bytes(1024, 8) <= K.SMEM_LIMIT
    prog = TF.compile_program(problem="F3", bits_per_var=10)
    st = TG.stack_states([TG.init_state(tcfg, device="cpu")])
    with pytest.raises(ValueError, match=f"{K.smem_bytes(8192, 2)} bytes"):
        K.ga_generation_kernel(st.x, st.sel_lfsr, st.cross_lfsr,
                               st.mut_lfsr, cfg=tcfg, program=prog)


def test_wrapper_rejects_fitness_without_hopper_stage():
    tcfg = TG.GAConfig(n=16, c=8, v=2, seed=1, mode="arith")
    st = TG.stack_states([TG.init_state(tcfg, device="cpu")])
    blackbox = TF.compile_program(fitness=lambda p: p.sum(-1),
                                  bounds=((-1.0, 1.0),) * 2, bits_per_var=8)
    custom = dataclasses.replace(
        TF.compile_program(problem="sphere:2", bits_per_var=8),
        fn=lambda v: (v * v).sum(-1))
    for prog in (blackbox, custom):
        assert K.problem_id(prog) is None
        with pytest.raises(ValueError, match="no Hopper FFM stage"):
            K.ga_generation_kernel(st.x, st.sel_lfsr, st.cross_lfsr,
                                   st.mut_lfsr, cfg=tcfg, program=prog)


def test_wrapper_onehot_cap_and_launch_counter_on_cpu():
    """The onehot pin keeps the JAX package's N cap; CPU calls run the
    plain version and never count as kernel launches."""
    prog = TF.compile_program(problem="F2", bits_per_var=8)
    with pytest.raises(ValueError, match="sel_lane='gather'"):
        K.check_kernel_lane(TG.GAConfig(n=2048, c=10, mode="arith"), prog)
    tcfg = TG.GAConfig(n=16, c=8, v=2, seed=1, mode="arith")
    st = TG.stack_states([TG.init_state(tcfg, device="cpu")])
    before = K.LAUNCHES["ga_generation"]
    K.ga_generation_kernel(st.x, st.sel_lfsr, st.cross_lfsr, st.mut_lfsr,
                           cfg=tcfg, program=prog, gens=2)
    assert K.LAUNCHES["ga_generation"] == before
