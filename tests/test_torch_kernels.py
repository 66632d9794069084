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
    """N=8192, V=2 needs more shared memory than a Hopper block has:
    `block_reason` names the bytes and the limit, and the wrapper runs K1's
    global form instead (on the CPU, the plain version).  P (here
    ceil(0.01 N)) counts where its rows fit."""
    tcfg = TG.GAConfig(n=8192, c=10, v=2, seed=1, mode="arith",
                       sel_lane="gather")
    assert (tcfg.p, dataclasses.replace(tcfg, n=4096).p) == (82, 41)
    assert K.smem_bytes(8192, 2, 82) > K.SMEM_LIMIT >= K.smem_bytes(4096, 2,
                                                                     41)
    assert K.smem_bytes(1024, 8, 1024) <= K.SMEM_LIMIT
    prog = TF.compile_program(problem="F3", bits_per_var=10)
    assert K.hopper_reason(tcfg, prog) is None
    assert f"{K.smem_bytes(8192, 2, 82)} bytes" in K.block_reason(tcfg, prog)
    st = TG.stack_states([TG.init_state(tcfg, device="cpu")])
    args = (st.x, st.sel_lfsr, st.cross_lfsr, st.mut_lfsr)
    got = K.ga_generation_kernel(*args, cfg=tcfg, program=prog, gens=2,
                                 track_best=True)
    want = K.ga_generation_plain(*args, cfg=tcfg, program=prog, gens=2,
                                 track_best=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# The largest V a block takes at N in {1024, 2048, 4096}, at any mutation
# rate; the layout with a full offspring buffer and the whole mutation bank
# took V=15, 7 and 3 there.
NEWLY_ADMITTED = ((4096, 4), (2048, 9), (1024, 21))


@pytest.mark.parametrize("n,v", NEWLY_ADMITTED)
def test_footprint_admits_the_largest_shape_at_any_mutation_rate(n, v):
    """The mutation rows below P stay in global memory where they do not
    fit, so the largest V at N runs at P = ceil(0.02 N) and at P = N alike,
    and V + 1 is refused at both with its byte count."""
    for rate in (0.02, 1.0):
        prog = TF.compile_program(problem=f"sphere:{v}", bits_per_var=10)
        cfg = TG.GAConfig(n=n, c=10, v=v, mutation_rate=rate, mode="arith",
                          sel_lane="gather")
        assert K.hopper_reason(cfg, prog) is None
        assert K.block_reason(cfg, prog) is None
        assert K.epoch_smem_reason(cfg) is None
        wider = dataclasses.replace(cfg, v=v + 1)
        need = K.smem_bytes(n, v + 1, wider.p)
        assert need > K.SMEM_LIMIT
        wprog = TF.compile_program(problem=f"sphere:{v + 1}",
                                   bits_per_var=10)
        assert f"P={wider.p} needs {need} bytes" in K.block_reason(wider,
                                                                   wprog)
        assert K.hopper_reason(wider, wprog) is None


# (N, V, P, whether the mutation rows below P fit in shared memory)
ROW_PLACES = ((1024, 8, 21, True), (1024, 8, 1024, True),
              (1024, 20, 21, True), (1024, 21, 1, True),
              (1024, 21, 21, False), (4096, 3, 4096, False))


@pytest.mark.parametrize("n,v,p,held", ROW_PLACES)
def test_footprint_holds_the_mutation_rows_where_they_fit(n, v, p, held):
    """A block counts V * P words for the mutation rows below P where they
    fit beside the rest of its state, and none where they stay in global
    memory (N=4096, V=3 at P=N ran in the layout before this one and runs
    in this one)."""
    base = 4 * (2 * n * v + 4 * n + v * (n // 2) + 3 * v + 2 + 128)
    assert K.smem_bytes(n, v, p) == base + (4 * v * p if held else 0)
    assert K.smem_bytes(n, v, p) <= K.SMEM_LIMIT
    assert (base + 4 * v * p <= K.SMEM_LIMIT) == held


def test_full_width_island_blocks_pair_up_on_an_sm():
    """At the full-width ring (N=1024, V=8, P=21) two K2 blocks share an
    SM's 228 KiB of shared memory (1 KiB reserved a block), which is what
    lets 16 clusters of 8 islands run in one wave; so do two K3 blocks,
    which keep 32-bit words where K2 holds 16-bit ones (c = 16)."""
    cfg = TG.GAConfig(n=1024, c=16, v=8, mutation_rate=0.02, mode="arith")
    assert cfg.p == 21
    need = K.epoch_smem_bytes(1024, 8, cfg.p)
    assert need == 4 * (2 * 8192 + 4 * 1024 + 8 * 512 + 8 * 21 + 24 + 2
                        + 128 + 9)
    assert K.resident_block_bytes(cfg) == need - 2 * 2 * 8192
    for block in (need, K.resident_block_bytes(cfg)):
        assert 2 * (block + 1024) <= 228 * 1024


# A block of the island cell (N=256, V=30, P=6): at 32-bit words an SM's
# 228 KiB (1 KiB reserved a block) holds two, at 16-bit words four
ISLAND_CELL = dict(n=256, c=16, v=30, mutation_rate=0.02, mode="arith")


def test_island_cell_k2_blocks_fit_four_an_sm():
    cfg = TG.GAConfig(**ISLAND_CELL)
    assert cfg.p == 6 and K.population_bits(cfg.c) == 16
    wide = K.epoch_smem_bytes(256, 30, 6)
    assert wide == 82620 == K.resident_block_bytes(
        dataclasses.replace(cfg, c=17))
    assert K.resident_block_bytes(cfg) == 51900 == wide - 4 * 256 * 30
    per_sm = 228 * 1024
    assert 2 * (wide + 1024) <= per_sm < 3 * (wide + 1024)
    assert 4 * (51900 + 1024) == 211696 <= per_sm
    assert K.resident_smem_bytes(cfg, 8) == 8 * 51900


@pytest.mark.parametrize("n,v", [(2, 1), (64, 2), (256, 30), (1024, 8),
                                 (1024, 21), (4096, 3)])
def test_k2_footprint_follows_the_layout(n, v):
    """K2 holds 16-bit population words exactly at c <= 16: the block is
    4NV bytes smaller (two buffers of N x V words, two bytes less each)
    unless the room it frees takes in the mutation rows below P, which
    then count (V * P words).  K3's block and K1's never change with c."""
    for c in (1, 10, 16, 17, 31):
        cfg = TG.GAConfig(n=n, c=c, v=v, mutation_rate=0.02, mode="arith")
        p = min(cfg.p, n)
        bits = K.population_bits(c)
        assert bits == (16 if c <= 16 else 32)
        wide = K.epoch_smem_bytes(n, v, p)
        assert K.epoch_smem_bytes(n, v, p, 32) == wide
        if bits == 32:
            assert K.resident_block_bytes(cfg) == wide
            continue
        rows, base32 = 4 * v * p, K.epoch_smem_bytes(n, v, 0)
        assert wide == base32 + (rows if base32 + rows <= K.SMEM_LIMIT
                                 else 0)
        base16 = base32 - 4 * n * v
        assert K.resident_block_bytes(cfg) == base16 + (
            rows if base16 + rows <= K.SMEM_LIMIT else 0)
        assert K.resident_block_bytes(cfg) <= wide


def test_rows_move_into_the_16_bit_block_where_it_frees_room():
    """N=1024, V=21, P=21: at 32-bit words the mutation rows below P stay
    in global memory; the 16-bit layout frees 86,016 B and takes them in."""
    n, v, p = 1024, 21, 21
    base32 = K.epoch_smem_bytes(n, v, 0)
    assert K.epoch_smem_bytes(n, v, p) == base32
    assert base32 + 4 * v * p > K.SMEM_LIMIT
    assert K.epoch_smem_bytes(n, v, p, 16) == \
        base32 - 4 * n * v + 4 * v * p


def test_resident_plan_admits_what_the_16_bit_layout_fits():
    """N=1024, V=22 is past a block at 32-bit words (K3, and K2 at
    c = 17) and fits at 16-bit ones: at c = 16 the card's resident test
    passes where the streamed lane (K3) cannot; at c = 17 it refuses with
    K2's 32-bit bytes.  Given the program, the planner and the wrapper
    still gate K2 on K1's block (`block_reason`, 32-bit words), so such a
    spec plans gridded and the wrapper refuses it with K1's bytes."""
    prog = TF.compile_program(problem="sphere:22", bits_per_var=16)
    ring = dict(executor="fused", migration="ring", gens_per_epoch=4,
                migrate_every=2)
    cfg = TG.GAConfig(n=1024, c=16, v=22, mutation_rate=0.02, seed=2,
                      mode="arith", sel_lane="gather")
    wide = dataclasses.replace(cfg, c=17)
    need32 = K.epoch_smem_bytes(1024, 22, cfg.p)
    assert K.resident_block_bytes(cfg) <= K.SMEM_LIMIT < need32
    assert K.resident_block_bytes(wide) == need32
    assert K.resident_fit_reason(cfg, 8) is None
    assert f"{need32} bytes" in K.resident_fit_reason(wide, 8)
    assert K.streamed_tile_islands(cfg) is None
    assert [c["mode"] for c in K.epoch_mode_candidates(cfg, 8, **ring)] \
        == ["resident", "gridded"]
    assert [c["mode"] for c in K.epoch_mode_candidates(wide, 8, **ring)] \
        == ["gridded"]
    (gated,) = K.epoch_mode_candidates(cfg, 8, program=prog, **ring)
    assert gated["mode"] == "gridded"
    assert gated["fallback"] == K.block_reason(cfg, prog)
    # a budget weighs K2's own block
    budget = K.resident_smem_bytes(cfg, 8)
    assert K.resident_fit_reason(cfg, 8, budget=budget) is None
    assert K.resident_fit_reason(cfg, 8, budget=budget - 1) is not None
    from repro_torch.core import islands as TISL
    st = TISL.init_islands_fast(TISL.IslandConfig(ga=cfg, n_islands=2),
                                device="cpu")
    args = [t.reshape((1, 2) + t.shape[1:]) for t in st[:4]]
    for c in (cfg, wide):
        with pytest.raises(ValueError,
                           match=f"{K.smem_bytes(1024, 22, cfg.p)} bytes"):
            K.ga_epoch_kernel(*args, cfg=c, program=prog, migrate_every=1)


def test_wrapper_rejects_fitness_without_hopper_stage():
    tcfg = TG.GAConfig(n=16, c=8, v=2, seed=1, mode="arith")
    st = TG.stack_states([TG.init_state(tcfg, device="cpu")])
    blackbox = TF.compile_program(fitness=lambda p: p.sum(-1),
                                  bounds=((-1.0, 1.0),) * 2, bits_per_var=8)
    custom = dataclasses.replace(
        TF.compile_program(problem="sphere:2", bits_per_var=8),
        fn=lambda v: (v * v).sum(-1))
    args = (st.x, st.sel_lfsr, st.cross_lfsr, st.mut_lfsr)
    for prog in (blackbox, custom):
        # the one-block form has no FFM stage for them; K1's global form
        # runs their PyTorch stage (on the CPU, the plain version)
        assert K.problem_id(prog) is None
        assert "no Hopper FFM stage" in K.block_reason(tcfg, prog)
        assert K.hopper_reason(tcfg, prog) is None
        before = dict(K.LAUNCHES)
        got = K.ga_generation_kernel(*args, cfg=tcfg, program=prog, gens=3,
                                     track_best=True)
        want = K.ga_generation_plain(*args, cfg=tcfg, program=prog, gens=3,
                                     track_best=True)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert K.LAUNCHES == before
        with pytest.raises(ValueError, match="no Hopper FFM stage"):
            K.ga_ffm_kernel(st.x, cfg=tcfg, program=prog)


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
