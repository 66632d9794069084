"""The port's epoch kernels K2 (`ga_epoch_kernel`) and K3
(`ga_streamed_epoch_kernel`) and the bulk LFSR kernel K4
(`lfsr_advance_kernel`) on the CPU, where each wrapper runs its plain
version.

* The plain versions against the JAX package's Pallas kernels in interpret
  mode, one tiny case each (N=16, I=4, migrate_every=2): these hold the
  kernel-only outputs no XLA path returns — the boundary elite, island 0's
  worst slot, the streamed pre-splice elites and worst slots.  Words are
  bit-exact; fitness is within ``1e-6 * max|y|`` (hazard H1: XLA's CPU jit
  contracts the decode into an FMA).
* K2's plain version against the port's own between-launch oracle
  (`islands.make_local_step`), bit-exact: one launch of three intervals is
  three oracle epochs.
* K3's splice form (k intervals, the ring inside) against k one-interval
  passes with the splice between them, and against K2's plain version,
  bit-exact.
* `lfsr_advance_plain` against `repro.kernels.ref.lfsr_advance_ref` over the
  shapes and clocks of tests/test_kernels.py, bit-exact.
* What the wrappers refuse, on every device, and the kernel build's cache
  key.  The CUDA kernels themselves run only on a card
  (tests/test_torch_cuda.py).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import fitness as JF  # noqa: E402
from repro.core import ga as JG  # noqa: E402
from repro.core import islands as JISL  # noqa: E402
from repro.core import lfsr as JL  # noqa: E402
from repro.kernels import ga_step as JK  # noqa: E402
from repro.kernels import ref as JREF  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import fitness as TF  # noqa: E402
from repro_torch.core import ga as TG  # noqa: E402
from repro_torch.core import islands as TISL  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ga_step as K  # noqa: E402
from repro_torch.kernels import lfsr_kernel as K4  # noqa: E402

Y_TOL = 1e-6


def _case(problem="F1", n=16, islands=4, groups=1, minimize=True, seed=16):
    """A [G, I] island stack from the JAX package, carried to the port."""
    kw = dict(n=n, c=10, v=2, mutation_rate=0.05, seed=seed, mode="arith",
              minimize=minimize)
    jcfg, tcfg = JG.GAConfig(**kw), TG.GAConfig(**kw)
    st = JISL.init_islands_fast(JISL.IslandConfig(ga=jcfg,
                                                  n_islands=groups * islands))
    jst = [jnp.reshape(t, (groups, islands) + t.shape[1:])
           for t in (st.x, st.sel_lfsr, st.cross_lfsr, st.mut_lfsr)]
    tst = [convert.words_from_numpy(np.asarray(t), device="cpu")
           for t in jst]
    jprog = JF.compile_program(problem=problem, bits_per_var=10)
    tprog = TF.compile_program(problem=problem, bits_per_var=10)
    return jcfg, tcfg, jst, tst, jprog, tprog


def _launch_fold(out, minimize):
    """K2's per-interval best folded over the launch with strict
    improvement (earliest interval wins ties): the TPU kernel's output."""
    by, bx = out[5][0], out[6][0]
    for t in range(1, out[5].shape[0]):
        by, bx = TG.fold_best(by, bx, out[5][t], out[6][t], minimize)
    return out[:5] + (by, bx) + out[7:]


def _same(got, want, floats=(4,)):
    """Words bit-exact; float outputs at `floats` within the H1 bound."""
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        if i in floats:
            assert a.dtype == torch.float32
            assert np.max(np.abs(a.numpy() - b)) <= \
                Y_TOL * np.max(np.abs(b))
        elif a.dtype == torch.int32 and b.dtype == np.uint32:
            np.testing.assert_array_equal(convert.words_to_numpy(a), b,
                                          err_msg=f"output {i}")
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f"output {i}")


@pytest.mark.parametrize("mode", ["ring", "free", "boundary"])
def test_epoch_plain_matches_interpret_mode_pallas_kernel(mode):
    jcfg, tcfg, jst, tst, jprog, tprog = _case()
    kw = dict(migrate_every=2, intervals=1 if mode == "boundary" else 2,
              boundary=mode == "boundary", migrate=mode != "free")
    want = JK.ga_epoch_kernel(*jst, cfg=jcfg, ffm=jprog.stage,
                              interpret=True, **kw)
    got = K.ga_epoch_kernel(*tst, cfg=tcfg, program=tprog, **kw)
    assert got[5].shape == (kw["intervals"], 1, 4)
    _same(_launch_fold(got, tcfg.minimize), want, floats=(4, 5))


@pytest.mark.parametrize("migrate", [True, False])
def test_streamed_plain_matches_interpret_mode_pallas_kernel(migrate):
    jcfg, tcfg, jst, tst, jprog, tprog = _case(problem="F3")
    want = JK.ga_streamed_epoch_kernel(*jst, cfg=jcfg, ffm=jprog.stage,
                                       migrate_every=2, tile_islands=2,
                                       migrate=migrate, interpret=True)
    got = K.ga_streamed_epoch_kernel(*tst, cfg=tcfg, program=tprog,
                                     migrate_every=2, tile_islands=2,
                                     migrate=migrate)
    _same(got, want, floats=(4, 5))


@pytest.mark.parametrize("minimize", [True, False])
@pytest.mark.parametrize("problem", ["F1", "F3", "rastrigin:4"])
def test_epoch_plain_is_local_step_epochs(problem, minimize):
    """One K2 launch of three intervals (two replica groups) is three epochs
    of the plain oracle, bit for bit, and its best of each interval is the
    best of that epoch's generations, folded per island."""
    _, tcfg, _, tst, _, tprog = _case(problem, n=32, islands=3, groups=2,
                                      minimize=minimize)
    tcfg = dataclasses.replace(tcfg, v=tprog.n_vars)
    st = TISL.init_islands_fast(TISL.IslandConfig(ga=tcfg, n_islands=6),
                                device="cpu")
    grouped = [t.reshape((2, 3) + t.shape[1:])
               for t in (st.x, st.sel_lfsr, st.cross_lfsr, st.mut_lfsr)]
    out = K.ga_epoch_kernel(*grouped, cfg=tcfg, program=tprog,
                            migrate_every=4, intervals=3)
    icfg = TISL.IslandConfig(ga=tcfg, n_islands=3, migrate_every=4)
    epoch = TISL.make_local_step(icfg, tprog.stage)
    oracle = TG.GAState(*grouped, torch.zeros((2, 3), dtype=torch.int32))
    for t in range(3):
        # the best over the epoch's generations, then the epoch itself
        by = torch.full((2, 3), np.inf if minimize else -np.inf)
        bx = torch.zeros((2, 3, tcfg.v), dtype=torch.int32)
        cur = oracle
        for _ in range(4):
            nxt, y = TG.generation(cur, tcfg, tprog.stage)
            by, bx = TG.fold_best(by, bx, *TG.gen_best(cur.x, y, minimize),
                                  minimize)
            cur = nxt
        ymig = tprog.stage(cur.x)
        oracle, _, _ = epoch(oracle)
        assert torch.equal(out[5][t], by) and torch.equal(out[6][t], bx)
    for a, b in zip(out[:4], oracle[:4]):
        assert torch.equal(a, b)
    assert torch.equal(out[4], ymig)


def test_streamed_tile_is_a_launch_shape_only():
    _, tcfg, _, tst, _, tprog = _case(islands=4, groups=2)
    outs = [K.ga_streamed_epoch_kernel(*tst, cfg=tcfg, program=tprog,
                                       migrate_every=3, tile_islands=t)
            for t in (1, 2, 4)]
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="must divide the island count 4"):
        K.ga_streamed_epoch_kernel(*tst, cfg=tcfg, program=tprog,
                                   migrate_every=3, tile_islands=3)


def _island_stack(tcfg, tprog, groups, islands):
    tcfg = dataclasses.replace(tcfg, v=tprog.n_vars)
    st = TISL.init_islands_fast(TISL.IslandConfig(
        ga=tcfg, n_islands=groups * islands), device="cpu")
    return tcfg, [t.reshape((groups, islands) + t.shape[1:])
                  for t in (st.x, st.sel_lfsr, st.cross_lfsr, st.mut_lfsr)]


@pytest.mark.parametrize("migrate", [True, False])
@pytest.mark.parametrize("intervals", [1, 2, 4])
@pytest.mark.parametrize("islands", [9, 12, 16])
@pytest.mark.parametrize("problem", ["F1", "F2", "F3", "rastrigin:4"])
def test_streamed_splice_form_is_passes_with_splices(problem, islands,
                                                     intervals, migrate):
    """K3's splice form (k intervals, the ring inside) is k one-interval
    passes with `splice_at` of the shifted elites between them, bit for
    bit, and so K2's plain function: the post-splice state, the last
    interval's pre-splice y and the best of every interval."""
    _, tcfg, _, _, _, tprog = _case(problem, n=16)
    tcfg, grouped = _island_stack(tcfg, tprog, 2, islands)
    run = dict(cfg=tcfg, program=tprog, migrate_every=2, migrate=migrate)
    got = K.ga_streamed_epoch_kernel(*grouped, intervals=intervals,
                                     splice=True, **run)
    x, sel, cross, mut = grouped
    bys, bxs = [], []
    for _ in range(intervals):
        out = K.ga_streamed_epoch_kernel(x, sel, cross, mut, **run)
        x, sel, cross, mut, y, by, bx = out[:7]
        if migrate:
            x = TISL.splice_at(x, out[8], torch.roll(out[7], 1, dims=1))
        bys.append(by)
        bxs.append(bx)
    want = (x, sel, cross, mut, y, torch.stack(bys), torch.stack(bxs))
    k2 = K.ga_epoch_plain(*grouped, cfg=tcfg, program=tprog,
                          migrate_every=2, intervals=intervals,
                          migrate=migrate)
    assert got[5].shape == (intervals, 2, islands)
    for a, b, c in zip(got, want, k2):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_streamed_wrapper_runs_several_intervals_only_with_splice():
    _, tcfg, _, tst, _, tprog = _case(islands=4, groups=2)
    run = dict(cfg=tcfg, program=tprog, migrate_every=2)
    with pytest.raises(ValueError, match="without splice=True"):
        K.ga_streamed_epoch_kernel(*tst, intervals=2, **run)
    with pytest.raises(ValueError, match="must be >= 1"):
        K.ga_streamed_epoch_kernel(*tst, intervals=0, splice=True, **run)
    one = K.ga_streamed_epoch_kernel(*tst, splice=True, **run)
    assert len(one) == 7 and one[5].shape == (1, 2, 4)


def test_epoch_wrappers_refuse_what_the_kernels_cannot_take():
    _, tcfg, _, tst, _, tprog = _case(islands=9)
    run = dict(cfg=tcfg, program=tprog, migrate_every=2)
    with pytest.raises(ValueError, match="thread-block cluster"):
        K.ga_epoch_kernel(*tst, **run)
    K.ga_epoch_kernel(*tst, migrate=False, **run)    # no ring, no cluster
    four = [t[:, :4] for t in tst]
    with pytest.raises(ValueError, match="one interval"):
        K.ga_epoch_kernel(*four, intervals=2, boundary=True, **run)
    with pytest.raises(ValueError, match="need migrate=True"):
        K.ga_epoch_kernel(*four, boundary=True, migrate=False, **run)
    with pytest.raises(TypeError, match="int32 words"):
        K.ga_epoch_kernel(four[0].to(torch.int64), *four[1:], **run)
    with pytest.raises(ValueError, match=r"x must be \[G, I, 16, 2\]"):
        K.ga_streamed_epoch_kernel(four[0][0], *four[1:], **run)
    with pytest.raises(ValueError, match="sel must be"):
        K.ga_epoch_kernel(four[0], four[1][:, :3], *four[2:], **run)
    blackbox = TF.compile_program(fitness=lambda p: p.sum(-1),
                                  bounds=((-1.0, 1.0),) * 2, bits_per_var=10)
    for fn in (K.ga_epoch_kernel, K.ga_streamed_epoch_kernel):
        with pytest.raises(ValueError, match="no Hopper FFM stage"):
            fn(*four, cfg=tcfg, program=blackbox, migrate_every=2)
    big = TG.GAConfig(n=4096, c=10, v=3, mode="arith", sel_lane="gather")
    assert K.smem_bytes(4096, 3, big.p) <= K.SMEM_LIMIT \
        < K.epoch_smem_bytes(4096, 5, big.p)
    st = TISL.init_islands_fast(TISL.IslandConfig(
        ga=dataclasses.replace(big, v=5), n_islands=1), device="cpu")
    with pytest.raises(ValueError, match="bytes of shared memory"):
        K.ga_epoch_kernel(*(t[None] for t in st[:4]),
                          cfg=dataclasses.replace(big, v=5),
                          program=TF.compile_program(problem="sphere:5",
                                                     bits_per_var=10),
                          migrate_every=1)


def test_epoch_wrappers_count_no_launches_on_cpu():
    _, tcfg, _, tst, _, tprog = _case()
    before = dict(K.LAUNCHES)
    K.ga_epoch_kernel(*tst, cfg=tcfg, program=tprog, migrate_every=2)
    K.ga_streamed_epoch_kernel(*tst, cfg=tcfg, program=tprog,
                               migrate_every=2)
    assert K.LAUNCHES == before


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(7,), (128,), (3, 5), (2, 130)])
@pytest.mark.parametrize("steps", [1, 3, 13, 40])
def test_lfsr_advance_plain_matches_ref(shape, steps):
    s = JL.seeds(99, int(np.prod(shape))).reshape(shape)
    want = np.asarray(JREF.lfsr_advance_ref(s, steps))
    got = K4.lfsr_advance_kernel(
        convert.words_from_numpy(np.asarray(s), device="cpu"), steps)
    assert got.shape == shape
    np.testing.assert_array_equal(convert.words_to_numpy(got), want)


def test_lfsr_advance_wrapper_checks():
    s = torch.arange(1, 9, dtype=torch.int32)
    before = K4.LAUNCHES["lfsr_advance"]
    assert torch.equal(K4.lfsr_advance_kernel(s, 0), s)
    assert K4.LAUNCHES["lfsr_advance"] == before
    with pytest.raises(TypeError, match="int32 words"):
        K4.lfsr_advance_kernel(s.to(torch.int64), 3)
    with pytest.raises(ValueError, match="steps must be >= 0"):
        K4.lfsr_advance_kernel(s, -1)


# ---------------------------------------------------------------------------
# the build's cache key
# ---------------------------------------------------------------------------


def test_library_path_covers_headers(tmp_path, monkeypatch):
    """An edited header under csrc/ changes every library's path, so no
    stale library is loaded; the repository's own sources have a path."""
    for name in ("ga_step", "lfsr_advance"):
        assert build.library_path(name).name.startswith(name + "-")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    first = build.library_path("k")
    assert build.library_path("k") == first
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert build.library_path("k") != first
