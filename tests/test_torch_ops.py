"""The port's public kernel wrappers (`repro_torch.kernels.ops`) on the CPU,
held against the JAX package's `repro.kernels.ops` (its Pallas kernels in
interpret mode, as the JAX tests run them on a CPU) from the same
numpy-seeded states.

On a CPU tensor each wrapper runs its kernel's plain twin and counts no
launch; tests/test_torch_cuda.py holds the same wrappers on a card tensor
against a CPU tensor.  Tolerance, as tests/test_torch_kernels.py: the
uint32 words (state, best_x) bit-exact; f32 fitness and best within
``1e-6 * max|y|`` (hazard H1: XLA's CPU jit contracts the decode into an
FMA).  N <= 64 and gens <= 4 keep interpret mode quick.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import ga_paper as JP  # noqa: E402
from repro.core import fitness as JF  # noqa: E402
from repro.core import islands as JISL  # noqa: E402
from repro.core import lfsr as JL  # noqa: E402
from repro.kernels import ops as JOPS  # noqa: E402
from repro_torch import convert, ga  # noqa: E402
from repro_torch.configs import ga_paper as TP  # noqa: E402
from repro_torch.core import fitness as TF  # noqa: E402
from repro_torch.ga.backends import FusedBackend  # noqa: E402
from repro_torch.kernels import ga_step as K  # noqa: E402
from repro_torch.kernels import lfsr_kernel as K4  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

Y_TOL = 1e-6


def _stack(n, m, problem, islands):
    """The same replica stack for both packages: JAX's `init_islands_fast`
    of the paper configuration (arith), carried over as int32 words."""
    jcfg = JP.paper_config(n=n, m=m, mode="arith")
    tcfg = TP.paper_config(n=n, m=m, mode="arith")
    st = JISL.init_islands_fast(JISL.IslandConfig(ga=jcfg,
                                                  n_islands=islands))
    jst = (st.x, st.sel_lfsr, st.cross_lfsr, st.mut_lfsr)
    tst = tuple(convert.words_from_numpy(np.asarray(t), device="cpu")
                for t in jst)
    jprog = JF.compile_program(problem=problem, bits_per_var=jcfg.c)
    tprog = TF.compile_program(problem=problem, bits_per_var=tcfg.c)
    return jcfg, tcfg, jst, tst, jprog, tprog


def _same(got, want, floats):
    """Words bit-exact; the outputs at `floats` within the H1 bound."""
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        if i in floats:
            assert a.dtype == torch.float32
            assert np.max(np.abs(a.numpy() - b)) <= \
                Y_TOL * np.max(np.abs(b)), f"output {i}"
        else:
            np.testing.assert_array_equal(convert.words_to_numpy(a), b,
                                          err_msg=f"output {i}")


# every population of the paper's grid, each at one of its bit widths
GRID = [(n, m, p) for (n, m) in zip(TP.POPULATIONS, TP.BIT_WIDTHS)
        for p in ("F1", "F2", "F3")]


@pytest.mark.parametrize("n,m,problem", GRID)
def test_ga_generation_matches_jax_ops(n, m, problem):
    jcfg, tcfg, jst, tst, jprog, tprog = _stack(n, m, problem, 3)
    launches = dict(K.LAUNCHES)
    got = ops.ga_generation(*tst, cfg=tcfg, program=tprog, gens=4,
                            track_best=True)
    want = JOPS.ga_generation(*jst, cfg=jcfg, ffm=jprog.stage, gens=4,
                              track_best=True)
    _same(got, want, floats=(4, 5))
    assert K.LAUNCHES == launches


def test_ga_generation_without_best_matches_jax_ops():
    jcfg, tcfg, jst, tst, jprog, tprog = _stack(32, 24, "F3", 2)
    got = ops.ga_generation(*tst, cfg=tcfg, program=tprog, gens=2)
    want = JOPS.ga_generation(*jst, cfg=jcfg, ffm=jprog.stage, gens=2)
    _same(got, want, floats=(4,))


def _fold(out, minimize):
    """The port's per-interval best folded over the launch with strict
    improvement (the earliest interval wins ties): the TPU kernel's
    output, which `ops.ga_epoch` returns a migration interval at a
    time."""
    by, bx = out[5][0], out[6][0]
    for t in range(1, out[5].shape[0]):
        better = out[5][t] < by if minimize else out[5][t] > by
        by = torch.where(better, out[5][t], by)
        bx = torch.where(better[..., None], out[6][t], bx)
    return out[:5] + (by, bx) + out[7:]


@pytest.mark.parametrize("boundary", [False, True])
def test_ga_epoch_matches_jax_ops(boundary):
    jcfg, tcfg, jst, tst, jprog, tprog = _stack(16, 20, "F1", 8)
    jst = tuple(jnp.reshape(t, (2, 4) + t.shape[1:]) for t in jst)
    tst = tuple(t.reshape((2, 4) + t.shape[1:]) for t in tst)
    kw = dict(migrate_every=2, intervals=1 if boundary else 2,
              boundary=boundary)
    launches = dict(K.LAUNCHES)
    got = ops.ga_epoch(*tst, cfg=tcfg, program=tprog, **kw)
    assert got[5].shape == (kw["intervals"], 2, 4)
    want = JOPS.ga_epoch(*jst, cfg=jcfg, ffm=jprog.stage, **kw)
    _same(_fold(got, tcfg.minimize), want, floats=(4, 5))
    assert K.LAUNCHES == launches


@pytest.mark.parametrize("shape", [(7,), (3, 5), (2, 130)])
@pytest.mark.parametrize("steps", [1, 3, 40])
def test_lfsr_advance_matches_jax_ops(shape, steps):
    s = JL.seeds(99, int(np.prod(shape))).reshape(shape)
    launches = dict(K4.LAUNCHES)
    got = ops.lfsr_advance(
        convert.words_from_numpy(np.asarray(s), device="cpu"), steps)
    np.testing.assert_array_equal(convert.words_to_numpy(got),
                                  np.asarray(JOPS.lfsr_advance(s, steps)))
    assert K4.LAUNCHES == launches


def test_lut_configs_are_refused():
    """The kernels' FFM stage is arith only: a LUT config raises with the
    reason `fused` gives, instead of running arith on it."""
    _, tcfg, _, tst, _, tprog = _stack(16, 20, "F3", 2)
    lut = TP.paper_config(n=16, m=20)
    assert lut.mode == "lut"
    reason = FusedBackend.supports(ga.GASpec(problem="F3", n=16,
                                             bits_per_var=10, mode="lut"))
    with pytest.raises(ValueError) as err:
        ops.ga_generation(*tst, cfg=lut, program=tprog)
    assert str(err.value) == reason
    grouped = tuple(t.reshape((1, 2) + t.shape[1:]) for t in tst)
    with pytest.raises(ValueError) as err:
        ops.ga_epoch(*grouped, cfg=lut, program=tprog, migrate_every=2)
    assert str(err.value) == reason


def test_wrappers_dispatch_by_device():
    """A CPU tensor takes the plain twin; a tensor on neither the CPU nor
    a card is refused rather than sent anywhere else."""
    _, tcfg, _, tst, _, tprog = _stack(16, 20, "F2", 2)
    got = ops.ga_generation(*tst, cfg=tcfg, program=tprog, gens=3,
                            track_best=True)
    want = K.ga_generation_plain(*tst, cfg=tcfg, program=tprog, gens=3,
                                 track_best=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(ops.lfsr_advance(tst[1], 5),
                       K4.lfsr_advance_plain(tst[1], 5))
    meta = tuple(t.to("meta") for t in tst)
    with pytest.raises(ValueError, match="CPU or CUDA tensors"):
        ops.ga_generation(*meta, cfg=tcfg, program=tprog)
    with pytest.raises(ValueError, match="CPU or CUDA tensors"):
        ops.lfsr_advance(meta[1], 5)
