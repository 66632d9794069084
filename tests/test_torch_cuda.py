"""The port on the card: the CUDA kernels K1-K4 against their plain PyTorch
versions on the same card tensors, and the fused backends against the plain
ones (`fused` against `reference`, `fused-islands` under every epoch plan
against `islands`).

Every test here needs an NVIDIA GPU and nvcc; elsewhere they skip.  Only
torch and the port are imported, so the file also runs on a machine
without JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerance: F1-F3 use only +, -, *, / and sqrt, which the kernel rounds
exactly as PyTorch's elementwise kernels do (it is built with -fmad=false),
so state, y and best are bit-exact.  Problems that call cos or exp may
differ from PyTorch's library by an ulp: y within ``1e-6 * max|y|``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert, ga  # noqa: E402
from repro_torch.core import fitness as TF  # noqa: E402
from repro_torch.core import ga as TG  # noqa: E402
from repro_torch.core import islands as TISL  # noqa: E402
from repro_torch.kernels import ga_step as K  # noqa: E402
from repro_torch.kernels import lfsr_kernel as K4  # noqa: E402
from test_torch_island_fold import (CASES, assert_same_bits,  # noqa: E402
                                    assert_segment, device_fold,
                                    keep_single_blocks, planted_bests,
                                    twin_fold, twin_single)
from test_torch_seed_state import ZERO_WORDS  # noqa: E402


@pytest.fixture(autouse=True)
def _no_ambient_cost_table(monkeypatch):
    """The plans here are the heuristic's: no cost table found on the host
    may move them."""
    monkeypatch.setenv("REPRO_GA_COST_TABLE", "off")


Y_TOL = 1e-6
EXACT = ("F1", "F2", "F3")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _stack(cfg, replicas, device):
    return TG.stack_states([TG.init_state(dataclasses.replace(cfg, seed=s),
                                          device=device)
                            for s in range(cfg.seed, cfg.seed + replicas)])


# Past N=1024 a block still has 1024 threads, so each thread takes several
# individuals in every phase: N=2048 and 4096 (V=2) cover that strided path.
SHAPES = ([(p, n) for p in EXACT for n in (64, 1024, 2048, 4096)]
          + [(p, n) for p in ("rastrigin:8", "ackley:8") for n in (64, 1024)])


@pytest.mark.cuda
@pytest.mark.parametrize("gens", [1, 16])
@pytest.mark.parametrize("problem,n", SHAPES)
@pytest.mark.parametrize("minimize", [True, False])
def test_kernel_matches_plain(cuda_device, problem, n, gens, minimize):
    prog = TF.compile_program(problem=problem, bits_per_var=10)
    cfg = TG.GAConfig(n=n, c=10, v=prog.n_vars, mutation_rate=0.02, seed=4,
                      minimize=minimize, mode="arith", sel_lane="gather")
    st = _stack(cfg, 6, cuda_device)
    args = (st.x, st.sel_lfsr, st.cross_lfsr, st.mut_lfsr)
    before = K.LAUNCHES["ga_generation"]
    got = K.ga_generation_kernel(*args, cfg=cfg, program=prog, gens=gens,
                                 track_best=True)
    torch.cuda.synchronize()
    assert K.LAUNCHES["ga_generation"] == before + 1
    want = K.ga_generation_plain(*args, cfg=cfg, program=prog, gens=gens,
                                 track_best=True)
    y, wy = got[4].cpu().numpy(), want[4].cpu().numpy()
    assert np.max(np.abs(y - wy)) <= Y_TOL * np.max(np.abs(wy))
    if prog.name in EXACT:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.cuda
def test_shared_memory_formula_matches_kernel(cuda_device):
    lib = K.kernel_library()
    assert lib.ga_step_smem_limit() == K.SMEM_LIMIT
    for n, v in ((2, 1), (64, 2), (1024, 8), (1024, 21), (4096, 2),
                 (4096, 3), (8192, 2)):
        for p in (0, 1, n // 2, n):
            assert lib.ga_step_smem_bytes(n, v, p) == K.smem_bytes(n, v, p)


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda_device):
    """A non-power-of-two N is refused in every form; a replica past a
    block's shared memory (N=8192, V=2) takes K1's global form, never the
    one-block launch."""
    prog = TF.compile_program(problem="F3", bits_per_var=10)
    odd = TG.GAConfig(n=48, c=10, v=2, seed=1, mode="arith")
    st = _stack(odd, 1, cuda_device)
    before = dict(K.LAUNCHES)
    with pytest.raises(ValueError, match="power-of-two"):
        K.ga_generation_kernel(st.x, st.sel_lfsr, st.cross_lfsr,
                               st.mut_lfsr, cfg=odd, program=prog)
    assert K.LAUNCHES == before
    cfg = TG.GAConfig(n=8192, c=10, v=2, seed=1, mode="arith",
                      sel_lane="gather")
    assert "shared memory" in K.block_reason(cfg, prog)
    st = _stack(cfg, 1, cuda_device)
    K.ga_generation_kernel(st.x, st.sel_lfsr, st.cross_lfsr, st.mut_lfsr,
                           cfg=cfg, program=prog, gens=2)
    torch.cuda.synchronize()
    assert K.LAUNCHES["ga_generation"] == before["ga_generation"]
    assert K.LAUNCHES["ga_generation:global"] == \
        before["ga_generation:global"] + 2


# the smallest of chip_smoke.py phase 17 (c)'s shapes past one block
GLOBAL_SHAPE = ("rastrigin:2", 8192, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("minimize", [True, False])
def test_global_form_kernels_match_plain(cuda_device, minimize):
    """ga_ffm, ga_best and ga_operators each equal their plain twin on the
    same card tensors, bit for bit, and so does K1's global form over a few
    generations."""
    problem, n, replicas = GLOBAL_SHAPE
    prog = TF.compile_program(problem=problem, bits_per_var=16)
    cfg = TG.GAConfig(n=n, c=16, v=prog.n_vars, seed=3, minimize=minimize,
                      mode="arith", sel_lane="gather")
    assert K.block_reason(cfg, prog) is not None
    st = _stack(cfg, replicas, cuda_device)
    before = dict(K.LAUNCHES)
    y = K.ga_ffm_kernel(st.x, cfg=cfg, program=prog)
    assert torch.equal(y, K.ga_ffm_plain(st.x, cfg=cfg, program=prog))
    y[0, 7] = y[0, 3] = y[0].min() - 1.0 if minimize else y[0].max() + 1.0
    by = torch.full((replicas,), np.inf if minimize else -np.inf,
                    device=cuda_device)
    by[1] = y[1].median()
    bx = torch.arange(replicas * 2, dtype=torch.int32,
                      device=cuda_device).reshape(replicas, 2)
    got = K.ga_best_kernel(st.x, y, by, bx, minimize=minimize)
    want = K.ga_best_plain(st.x, y, by, bx, minimize=minimize)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(got[1][0], st.x[0, 3])
    banks = (st.sel_lfsr, st.cross_lfsr, st.mut_lfsr)
    got = K.ga_operators_kernel(st.x, y, *banks, cfg=cfg)
    want = K.ga_operators_plain(st.x, y, *banks, cfg=cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES} == {
        "ga_generation": 0, "ga_epoch": 0, "ga_streamed_epoch": 0,
        "ga_generation:global": 1, "ga_ffm": 1, "ga_best": 1}
    args = (st.x,) + banks
    for track in (True, False):
        kw = dict(cfg=cfg, program=prog, gens=3, track_best=track)
        got = K.ga_generation_kernel(*args, **kw)
        want = K.ga_generation_plain(*args, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


class _WithP:
    """A GAConfig seen with another P (a GAConfig's P is at least 1)."""

    def __init__(self, cfg, p):
        self._cfg, self.p = cfg, p

    def __getattr__(self, name):
        return getattr(self._cfg, name)


# edge shapes of chip_smoke.py phase 17 (d): (N, V, R, P) -- one and two
# pairs, odd V, V past one chunk (100), P = 0 and P = N, N/2 + 1
EDGE_SHAPES = [(2, 1, 1, 0), (4, 3, 3, 3), (8192, 100, 3, 4097),
               (65536, 3, 1, 65536), (66, 64, 3, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,v,replicas,p", EDGE_SHAPES)
def test_global_form_kernels_match_plain_at_edges(cuda_device, n, v,
                                                  replicas, p):
    """ga_operators (at a power-of-two N) and ga_best equal their plain
    twins at the edge shapes: y of small integers (ties everywhere), a
    NaN in the last block's slice, the best tied across a cluster's
    blocks, minimize and maximize."""
    g = torch.Generator(device=cuda_device).manual_seed(n + v)

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=g,
                             device=cuda_device,
                             dtype=torch.int64).to(torch.int32)

    x = torch.randint(0, 1 << 16, (replicas, n, v), generator=g,
                      device=cuda_device, dtype=torch.int32)
    y = torch.randint(-50, 50, (replicas, n), generator=g,
                      device=cuda_device).to(torch.float32)
    banks = (words(replicas, 2, n), words(replicas, v, n // 2),
             words(replicas, v, n))
    blocks, slice_ = K.best_split(n)
    for minimize in (True, False):
        if n & (n - 1) == 0:
            cfg = _WithP(TG.GAConfig(n=n, c=16, v=v, seed=1,
                                     minimize=minimize, mode="arith",
                                     sel_lane="gather"), p)
            got = K.ga_operators_kernel(x, y, *banks, cfg=cfg)
            want = K.ga_operators_plain(x, y, *banks, cfg=cfg)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        by = torch.full((replicas,), np.inf if minimize else -np.inf,
                        device=cuda_device)
        bx = torch.zeros((replicas, v), dtype=torch.int32,
                         device=cuda_device)
        tie = y.clone()
        top = tie.min() - 1 if minimize else tie.max() + 1
        tie[:, n - 1] = tie[:, (blocks - 1) * slice_ // 2] = top
        nan = y.clone()
        nan[:, n - 1] = np.nan
        for yy in (y, tie, nan):
            got = K.ga_best_kernel(x, yy, by, bx, minimize=minimize)
            want = K.ga_best_plain(x, yy, by, bx, minimize=minimize)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert torch.equal(K.ga_best_kernel(x, nan, by, bx,
                                            minimize=minimize)[1], bx)


def _ffm_programs(v):
    """The built-in problems at V: the summed four (rosenbrock from its
    min_vars, 2) and F1-F3 at their V = 2."""
    names = [f"{p}:{v}" for p in ("sphere", "rastrigin", "rosenbrock",
                                  "ackley") if p != "rosenbrock" or v > 1]
    names += list(EXACT) if v == 2 else []
    return [TF.compile_program(problem=p, bits_per_var=16) for p in names]


def _same_or_both_nan(a, b):
    both = torch.isnan(a) & torch.isnan(b)
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a[~both], b[~both]))


@pytest.mark.cuda
@pytest.mark.parametrize("n,v,replicas", [(n, v, r)
                                          for n, v, r, _ in EDGE_SHAPES]
                         + [(66, 2, 3), (8192, 2, 16), (8192, 1000, 3)])
def test_ga_ffm_matches_plain_at_edges(cuda_device, n, v, replicas):
    """ga_ffm equals its plain twin bit for bit for every built-in problem
    at the edge shapes (both forms, ragged last tiles, V past one chunk),
    and where a decode hand-set to (0, inf) puts NaN (word 0: 0 * inf)
    and inf in x's decoded values, NaN where the twin has NaN.  (A spec
    cannot give such a decode: the built-in problems fix their domains;
    `dataclasses.replace` sets it on the program.)"""
    g = torch.Generator(device=cuda_device).manual_seed(n + v)
    x = torch.randint(0, 1 << 16, (replicas, n, v), generator=g,
                      device=cuda_device, dtype=torch.int32)
    cfg = TG.GAConfig(n=n, c=16, v=v, seed=1, mode="arith",
                      sel_lane="gather")
    before = K.LAUNCHES["ga_ffm"]
    progs = _ffm_programs(v)
    for prog in progs:
        got = K.ga_ffm_kernel(x, cfg=cfg, program=prog)
        assert torch.equal(got, K.ga_ffm_plain(x, cfg=cfg, program=prog)), \
            prog.name
        inf = dataclasses.replace(prog, domains=((0.0, np.inf),) * v)
        xz = x.clone()
        xz[:, ::3] = 0
        want = K.ga_ffm_plain(xz, cfg=cfg, program=inf)
        assert bool(torch.isnan(want).any() | torch.isinf(want).any())
        assert _same_or_both_nan(K.ga_ffm_kernel(xz, cfg=cfg, program=inf),
                                 want), prog.name
    assert K.LAUNCHES["ga_ffm"] == before + 2 * len(progs)


@pytest.mark.cuda
def test_ffm_launch_refuses_what_it_cannot_run(cuda_device, monkeypatch):
    """ga_ffm_launch refuses a tiling its kernel cannot run (a tile not a
    power of two, a spread tile past 256 rows or for F1-F3, a rows tile
    other than 256, 512 or 1024 or short of V, a tile past the
    shared-memory budget), and the wrapper raises on the refusal: nothing
    falls back to the plain twin."""
    n, v, r = 1024, 16, 2
    prog = TF.compile_program(problem=f"rastrigin:{v}", bits_per_var=16)
    f3 = TF.compile_program(problem="F3", bits_per_var=16)
    x = torch.randint(0, 1 << 16, (r, n, v), device=cuda_device,
                      dtype=torch.int32)
    y = torch.empty((r, n), device=cuda_device)
    lo, span = prog.device_consts(cuda_device)
    lib = K.kernel_library()
    stream = torch.cuda.current_stream().cuda_stream

    def launch(tile, chunk, spread, problem=K.PROBLEM_IDS["rastrigin"]):
        return lib.ga_ffm_launch(x.data_ptr(), y.data_ptr(), lo.data_ptr(),
                                 span.data_ptr(), r, n, v, 16, problem, tile,
                                 chunk, spread, stream)

    assert launch(*K.ffm_tiling(n, v, r, True), 1) == 0
    assert launch(K.FFM_THREADS, v, 0) == 0
    # the rows form's 1024-row tile at V = 16 is past the budget
    assert K.ffm_tile_bytes(1024, v, False) > K.FFM_SMEM_LIMIT
    for tile, chunk, spread, problem in [
            (24, v, 1, 4), (512, v, 1, 4), (16, v, 1, K.PROBLEM_IDS["F3"]),
            (128, v, 0, 4), (2048, v, 0, 4), (256, 4, 0, 4), (256, 0, 1, 4),
            (256, v + 1, 1, 4), (1024, v, 0, 4)]:
        assert launch(tile, chunk, spread, problem) != 0, (tile, chunk)
    torch.cuda.synchronize()
    cfg = TG.GAConfig(n=n, c=16, v=v, seed=1, mode="arith",
                      sel_lane="gather")
    monkeypatch.setattr(K, "ffm_tiling", lambda *a, **k: (24, v))
    before = K.LAUNCHES["ga_ffm"]
    with pytest.raises(RuntimeError, match="ga_ffm kernel launch failed"):
        K.ga_ffm_kernel(x, cfg=cfg, program=prog)
    assert K.LAUNCHES["ga_ffm"] == before
    cfg2 = TG.GAConfig(n=n, c=16, v=2, seed=1, mode="arith",
                       sel_lane="gather")
    monkeypatch.setattr(K, "ffm_spreads", lambda *a: True)
    monkeypatch.setattr(K, "ffm_tiling", lambda *a, **k: (16, 2))
    with pytest.raises(RuntimeError, match="ga_ffm kernel launch failed"):
        K.ga_ffm_kernel(x[..., :2].contiguous(), cfg=cfg2, program=f3)


@pytest.mark.cuda
def test_ga_operators_takes_banks_off_8_byte_alignment(cuda_device):
    """ga_operators reads the selection and mutation banks as 8-byte words:
    contiguous banks whose data starts 4 bytes off (views one word into a
    buffer) are copied, not refused, and the result equals the plain
    twin's."""
    n, v, replicas = 64, 3, 2
    cfg = TG.GAConfig(n=n, c=16, v=v, seed=1, mode="arith",
                      sel_lane="gather", mutation_rate=0.1)
    st = _stack(cfg, replicas, cuda_device)

    def off_by_a_word(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 8 == 4
        return view

    y = torch.randn((replicas, n), device=cuda_device)
    banks = (off_by_a_word(st.sel_lfsr), st.cross_lfsr,
             off_by_a_word(st.mut_lfsr))
    got = K.ga_operators_kernel(st.x, y, *banks, cfg=cfg)
    want = K.ga_operators_plain(st.x, y, *banks, cfg=cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_fused_blackbox_matches_reference_on_card(cuda_device):
    """A blackbox that closes over card tensors runs `fused` through K1's
    global form, its PyTorch stage in the FFM's place: equal to
    `reference` in state, best and trajectory."""
    target = torch.tensor([0.5, -1.0, 2.0], device=cuda_device)
    weights = torch.tensor([1.0, 2.0, 4.0], device=cuda_device)
    spec = ga.GASpec(
        fitness=lambda p: torch.sum(weights * (p - target) ** 2, dim=-1),
        bounds=((-4.0, 4.0),) * 3, n=1024, bits_per_var=16,
        mutation_rate=0.05, seed=0, generations=24, n_repeats=8,
        gens_per_epoch=8)
    before = dict(K.LAUNCHES)
    f = ga.solve(spec, backend="fused")
    assert f.backend == "fused"
    ran = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
    assert ran["ga_generation"] == 0 and ran["ga_ffm"] == 0
    assert ran["ga_generation:global"] == ran["ga_best"] == 24
    r = ga.solve(dataclasses.replace(spec, gens_per_epoch=1),
                 backend="reference")
    for a, b in zip(convert.state_to_numpy(f.state)[:4],
                    convert.state_to_numpy(r.state)[:4]):
        np.testing.assert_array_equal(a, b)
    assert f.best_fitness == r.best_fitness
    np.testing.assert_array_equal(f.best_x, r.best_x)
    np.testing.assert_array_equal(f.traj_best, r.traj_best[7::8])
    fr, rr = f.telemetry.per_repeat, r.telemetry.per_repeat
    np.testing.assert_array_equal(fr.traj_best, rr.traj_best[:, 7::8])
    np.testing.assert_array_equal(fr.traj_mean, rr.traj_mean[:, 7::8])


@pytest.mark.cuda
@pytest.mark.parametrize("problem", ["F3", "rosenbrock:5", "sphere:8"])
def test_fused_solve_matches_reference_on_card(cuda_device, problem):
    spec = ga.GASpec(problem=problem, n=64, bits_per_var=10, mode="arith",
                     generations=40, n_repeats=4, gens_per_epoch=8, seed=3)
    before = K.LAUNCHES["ga_generation"]
    f = ga.solve(spec, backend="fused")
    assert f.backend == "fused"
    assert K.LAUNCHES["ga_generation"] == before + 5
    r = ga.solve(dataclasses.replace(spec, gens_per_epoch=1),
                 backend="reference")
    for a, b in zip(convert.state_to_numpy(f.state)[:4],
                    convert.state_to_numpy(r.state)[:4]):
        np.testing.assert_array_equal(a, b)
    assert f.best_fitness == r.best_fitness
    np.testing.assert_array_equal(f.best_x, r.best_x)


# ---------------------------------------------------------------------------
# K2 and K3, the island ring's epoch kernels
# ---------------------------------------------------------------------------

EPOCH_SHAPES = ([(p, n) for p in EXACT for n in (64, 1024, 4096)]
                + [(p, 1024) for p in ("rastrigin:8", "ackley:8")])


def _island_groups(cfg, groups, islands, device):
    st = TISL.init_islands_fast(TISL.IslandConfig(
        ga=cfg, n_islands=groups * islands), device=device)
    return [t.reshape((groups, islands) + t.shape[1:]) for t in st[:4]]


def _epoch_case(problem, n, minimize):
    prog = TF.compile_program(problem=problem, bits_per_var=10)
    cfg = TG.GAConfig(n=n, c=10, v=prog.n_vars, mutation_rate=0.02, seed=4,
                      minimize=minimize, mode="arith", sel_lane="gather")
    return prog, cfg


def _assert_kernel_equals_plain(got, want, exact):
    """Words bit-exact; y (index 4) within 1e-6 * max|y| and, off F1-F3,
    best_y (index 5) too."""
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        if a.dtype == np.float32:
            assert np.all(np.isfinite(a))
            assert np.max(np.abs(a - b)) <= Y_TOL * np.max(np.abs(b))
            if not exact:
                continue
        np.testing.assert_array_equal(a, b, err_msg=f"output {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("minimize", [True, False])
@pytest.mark.parametrize("islands", [1, 4, 8])
@pytest.mark.parametrize("mode", ["ring", "free", "boundary"])
@pytest.mark.parametrize("problem,n", EPOCH_SHAPES)
def test_epoch_kernel_matches_plain(cuda_device, problem, n, mode, islands,
                                    minimize):
    prog, cfg = _epoch_case(problem, n, minimize)
    args = _island_groups(cfg, 2, islands, cuda_device)
    kw = dict(migrate_every=3, intervals=1 if mode == "boundary" else 2,
              boundary=mode == "boundary", migrate=mode != "free")
    before = K.LAUNCHES["ga_epoch"]
    got = K.ga_epoch_kernel(*args, cfg=cfg, program=prog, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["ga_epoch"] == before + 1
    want = K.ga_epoch_plain(*args, cfg=cfg, program=prog, **kw)
    _assert_kernel_equals_plain(got, want, prog.name in EXACT)


@pytest.mark.cuda
def test_epoch_kernel_matches_plain_at_the_island_cell(cuda_device):
    """K2 at the benchmark's island cell: 51 groups of 8 islands (51
    clusters, past the card's clusters at once), N=256, rastrigin:30, 16
    bits, two intervals of 16 generations; every output bit for bit."""
    prog = TF.compile_program(problem="rastrigin:30", bits_per_var=16)
    cfg = TG.GAConfig(n=256, c=16, v=30, mutation_rate=0.02, seed=3,
                      minimize=True, mode="arith", sel_lane="gather")
    args = _island_groups(cfg, 51, 8, cuda_device)
    kw = dict(cfg=cfg, program=prog, migrate_every=16, intervals=2)
    got = K.ga_epoch_kernel(*args, **kw)
    want = K.ga_epoch_plain(*args, **kw)
    assert got[5].shape == (2, 51, 8)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        assert torch.equal(a, b), f"output {i}"


# K2's two population layouts: 16-bit words at c <= 16, 32-bit at c = 17;
# N from a block of one warp to 512 threads, V up to the island cell's 30
# (at N=1024 the largest V K1's 32-bit block admits, 21, as K2 takes only
# what K1's one-block form does)
LAYOUT_SHAPES = [(n, v) for n in (4, 256) for v in (1, 3, 30)] + [
    (1024, v) for v in (1, 3, 21)]
LAYOUT_RUNS = [("ring", 1), ("ring", 2), ("free", 1), ("free", 2),
               ("boundary", 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,intervals", LAYOUT_RUNS)
@pytest.mark.parametrize("n,v", LAYOUT_SHAPES)
@pytest.mark.parametrize("c", [10, 16, 17])
def test_epoch_kernel_layouts_match_plain(cuda_device, c, n, v, mode,
                                          intervals):
    """K2 in its 16-bit layout (c <= 16) and its 32-bit one (c = 17)
    against its plain version, every output bit for bit (sphere: exact
    float32), from words drawn over every bit a layout holds: [0, 2^16) at
    c <= 16, so the bits above c that crossover carries survive the 16-bit
    words, and all 32 bits at c = 17."""
    prog = TF.compile_program(problem=f"sphere:{v}", bits_per_var=c)
    cfg = TG.GAConfig(n=n, c=c, v=v, mutation_rate=0.02, seed=6,
                      minimize=True, mode="arith", sel_lane="gather")
    bits = K.population_bits(c)
    assert bits == (16 if c <= 16 else 32)
    assert K.kernel_attrs("ga_epoch", cfg)["population_bits"] == bits
    args = _island_groups(cfg, 3, 4, cuda_device)
    g = torch.Generator(device="cpu").manual_seed(c * n + v)
    words = torch.randint(0, 1 << 16, args[0].shape, generator=g,
                          dtype=torch.int64) if bits == 16 else \
        torch.randint(-2 ** 31, 2 ** 31, args[0].shape, generator=g,
                      dtype=torch.int64)
    args[0] = words.to(torch.int32).to(cuda_device)
    kw = dict(cfg=cfg, program=prog, migrate_every=3, intervals=intervals,
              boundary=mode == "boundary", migrate=mode != "free")
    got = K.ga_epoch_kernel(*args, **kw)
    want = K.ga_epoch_plain(*args, **kw)
    assert len(got) == len(want) == (9 if mode == "boundary" else 7)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        assert torch.equal(a, b), f"output {i}"


@pytest.mark.cuda
def test_island_cell_clusters_run_in_one_wave(cuda_device):
    """At the island cell (N=256, V=30, P=6, c=16, clusters of 8) K2's
    16-bit block of 51,900 B lets four share an SM, and the card holds the
    cell's 51 clusters at once; its 32-bit block (c=17) held two an SM."""
    cfg = TG.GAConfig(n=256, c=16, v=30, mutation_rate=0.02, mode="arith",
                      sel_lane="gather")
    attrs = K.kernel_attrs("ga_epoch", cfg)
    assert attrs["population_bits"] == 16 and attrs["smem_bytes"] == 51900
    assert attrs["blocks_per_sm"] >= 4, attrs
    assert K.max_active_clusters(cfg, 8) >= 51
    wide = dataclasses.replace(cfg, c=17)
    assert K.kernel_attrs("ga_epoch", wide)["blocks_per_sm"] == 2
    assert K.max_active_clusters(wide, 8) < 51


# K2's two-lane form (one thread an individual; 16-bit words, no data, 32
# <= N <= 512): (problem, N, mutation rate, clocks a draw, islands, groups,
# generations an interval): the island cell (N=256, V=30, P=6, 51 x 8
# islands, intervals of 16), a block of two warps and one of 512 threads,
# V odd (the last variable's cut clocked by the even lane alone), the
# mutation rows past 32 (P=52: rows in two warps; P=N: every lane's), and
# two clocks a draw (the run-time build)
TWO_LANE_CASES = [("rastrigin:30", 256, 0.02, 3, 8, 51, 16),
                  ("rastrigin:30", 64, 0.02, 3, 4, 3, 3),
                  ("rastrigin:30", 512, 0.02, 3, 8, 2, 3),
                  ("rastrigin:7", 128, 0.02, 3, 4, 3, 3),
                  ("sphere:1", 64, 0.02, 3, 4, 3, 3),
                  ("rastrigin:30", 256, 0.2, 3, 8, 2, 3),
                  ("ackley:5", 64, 1.0, 3, 4, 3, 3),
                  ("rastrigin:30", 256, 0.02, 2, 8, 2, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ring", "free", "boundary"])
@pytest.mark.parametrize("minimize", [True, False])
@pytest.mark.parametrize("problem,n,rate,steps,islands,groups,every",
                         TWO_LANE_CASES)
def test_two_lane_epoch_matches_plain(cuda_device, problem, n, rate, steps,
                                      islands, groups, every, minimize,
                                      mode):
    """K2's two-lane form against `ga_epoch_plain` and against its pair
    form, all outputs bit for bit, where the rule picks it.  (K2 always
    folds its best, so `track_best` has no off state here; K1, which has
    one, keeps one lane a pair.)"""
    prog = TF.compile_program(problem=problem, bits_per_var=16)
    cfg = TG.GAConfig(n=n, c=16, v=prog.n_vars, mutation_rate=rate, seed=8,
                      minimize=minimize, steps_per_draw=steps, mode="arith",
                      sel_lane="gather")
    assert rate < 0.1 or min(cfg.p, n) > 32
    assert K.pair_threads(cfg, islands, cuda_device, prog) == 2
    args = _island_groups(cfg, groups, islands, cuda_device)
    kw = dict(cfg=cfg, program=prog, migrate_every=every,
              intervals=1 if mode == "boundary" else 2,
              boundary=mode == "boundary", migrate=mode != "free")
    before = K.LAUNCHES["ga_epoch"]
    two = K.ga_epoch_kernel(*args, lanes=2, **kw)
    one = K.ga_epoch_kernel(*args, lanes=1, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["ga_epoch"] == before + 2
    want = K.ga_epoch_plain(*args, **kw)
    assert len(two) == len(want) == (9 if mode == "boundary" else 7)
    for i, (a, b, c) in enumerate(zip(two, one, want)):
        assert a.shape == c.shape, i
        assert torch.equal(a, c), f"output {i}"
        assert torch.equal(a, b), f"output {i} against the pair form"


@pytest.mark.cuda
def test_two_lane_kernel_attributes_at_the_island_cell(cuda_device):
    """At the island cell (N=256, V=30, P=6, c=16) K2 takes its two-lane
    form: 256 threads, at most 64 registers, no spills (its local bytes
    are the pair form's, the 32-B stack of cosf's slow path), four blocks
    an SM (32 warps) and the 51 clusters of 8 at once.  K1, K3, K2's pair
    form and its rastrigin_sr build keep one thread a pair with their
    threads, registers and blocks an SM."""
    cfg = TG.GAConfig(n=256, c=16, v=30, mutation_rate=0.02, mode="arith",
                      sel_lane="gather")
    attrs = K.kernel_attrs("ga_epoch", cfg)
    assert attrs["threads"] == 256 and attrs["pair_threads"] == 2, attrs
    assert attrs["registers"] <= 64, attrs
    assert attrs["local_bytes"] == K.kernel_attrs(
        "ga_epoch", cfg, lanes=1)["local_bytes"] == 32, attrs
    assert attrs["blocks_per_sm"] == 4 and attrs["smem_bytes"] == 51900
    assert K.clusters_at_once(cfg, 8, cuda_device, None, 2) >= 51
    assert K.clusters_at_once(cfg, 8, cuda_device, None, 2) >= \
        K.clusters_at_once(cfg, 8, cuda_device, None, 1)
    prog = TF.compile_program(problem="rastrigin_sr:30", bits_per_var=16)
    # (kernel, program, lanes): threads, registers, blocks an SM (the
    # rule's pick where lanes is None)
    kept = [("ga_generation", None, None, 128, 64, 2),
            ("ga_streamed_epoch", None, None, 128, 64, 2),
            ("ga_epoch", None, 1, 128, 64, 4),
            ("ga_epoch", prog, None, 128, 128, 4)]
    for name, pr, lanes, threads, regs, blocks in kept:
        a = K.kernel_attrs(name, cfg, pr, lanes)
        assert a["pair_threads"] == 1 and a["threads"] == threads, (name, a)
        assert a["registers"] == regs and a["blocks_per_sm"] == blocks, \
            (name, a)


def _sr_case(v, n, c, minimize=True):
    prog = TF.compile_program(problem=f"rastrigin_sr:{v}", bits_per_var=c)
    cfg = TG.GAConfig(n=n, c=c, v=v, mutation_rate=0.02, seed=5,
                      minimize=minimize, mode="arith", sel_lane="gather")
    return prog, cfg


def _assert_same(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        assert torch.equal(a, b), f"output {i}"


# rastrigin_sr: from the least V to the most its builds hold in registers
SR_SHAPES = [(2, 64), (5, 64), (30, 256), (32, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("minimize", [True, False])
@pytest.mark.parametrize("v,n", SR_SHAPES)
def test_rastrigin_sr_one_block_and_ga_ffm_match_plain(cuda_device, v, n,
                                                       minimize):
    """K1's one-block form in rastrigin_sr's build, and ga_ffm's rows form
    for it, against their plain versions bit for bit."""
    prog, cfg = _sr_case(v, n, 16, minimize)
    assert K.block_reason(cfg, prog) is None
    st = _stack(cfg, 5, cuda_device)
    args = (st.x, st.sel_lfsr, st.cross_lfsr, st.mut_lfsr)
    before = K.LAUNCHES["ga_generation"]
    got = K.ga_generation_kernel(*args, cfg=cfg, program=prog, gens=16,
                                 track_best=True)
    torch.cuda.synchronize()
    assert K.LAUNCHES["ga_generation"] == before + 1
    _assert_same(got, K.ga_generation_plain(*args, cfg=cfg, program=prog,
                                            gens=16, track_best=True))
    x = torch.randint(0, 1 << 16, (3, n, v), dtype=torch.int32,
                      device=cuda_device)
    assert torch.equal(K.ga_ffm_kernel(x, cfg=cfg, program=prog),
                       prog.stage(x))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,intervals", [("ring", 2), ("free", 2),
                                            ("boundary", 1)])
@pytest.mark.parametrize("c", [16, 17])
@pytest.mark.parametrize("v,n", SR_SHAPES)
def test_rastrigin_sr_epoch_matches_plain(cuda_device, v, n, c, mode,
                                          intervals):
    """K2's rastrigin_sr build at 16-bit (c = 16) and 32-bit (c = 17)
    words against its plain version, every output bit for bit."""
    prog, cfg = _sr_case(v, n, c)
    assert K.kernel_attrs("ga_epoch", cfg, prog)["population_bits"] == (
        16 if c == 16 else 32)
    args = _island_groups(cfg, 3, 4, cuda_device)
    kw = dict(cfg=cfg, program=prog, migrate_every=3, intervals=intervals,
              boundary=mode == "boundary", migrate=mode != "free")
    _assert_same(K.ga_epoch_kernel(*args, **kw),
                 K.ga_epoch_plain(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("tile,splice", [(1, False), (1, True), (2, True)])
@pytest.mark.parametrize("v,n", [(5, 64), (30, 256)])
def test_rastrigin_sr_streamed_matches_plain(cuda_device, v, n, tile,
                                             splice):
    """K3's rastrigin_sr build, one interval and the ring inside at tiles
    1 and 2, against its plain version bit for bit."""
    prog, cfg = _sr_case(v, n, 16)
    args = _island_groups(cfg, 2, 4, cuda_device)
    kw = dict(cfg=cfg, program=prog, migrate_every=3, tile_islands=tile,
              migrate=True, intervals=2 if splice else 1, splice=splice)
    _assert_same(K.ga_streamed_epoch_kernel(*args, **kw),
                 K.ga_streamed_epoch_plain(*args, **kw))


@pytest.mark.cuda
def test_rastrigin_sr_epoch_at_the_rotated_cell(cuda_device):
    """K2's rastrigin_sr build at the rotated cell (51 groups of 8 islands,
    N=256, V=30, 16 bits, two intervals of 16 generations) bit for bit; its
    block of 55,868 B still lets four share an SM and the card hold the
    51 clusters at once, and the island cell's build reads as it did."""
    prog, cfg = _sr_case(30, 256, 16)
    args = _island_groups(cfg, 51, 8, cuda_device)
    kw = dict(cfg=cfg, program=prog, migrate_every=16, intervals=2)
    _assert_same(K.ga_epoch_kernel(*args, **kw),
                 K.ga_epoch_plain(*args, **kw))
    attrs = K.kernel_attrs("ga_epoch", cfg, prog)
    assert attrs["smem_bytes"] == 55868 and attrs["blocks_per_sm"] >= 4
    assert attrs["registers"] <= 128
    assert K.max_active_clusters(cfg, 8, prog) >= 51
    plain = K.kernel_attrs("ga_epoch", cfg)
    assert plain["smem_bytes"] == 51900 and plain["registers"] == 64
    assert K.max_active_clusters(cfg, 8) >= 51


@pytest.mark.cuda
@pytest.mark.parametrize("v,n", SR_SHAPES + [(30, 1024)])
def test_rastrigin_sr_block_bytes_match_the_kernels(cuda_device, v, n):
    """The Python block sizes with rastrigin_sr's data (`data_words`) are
    the CUDA launchers' own, for K1, K2 at both layouts and K3."""
    prog, cfg = _sr_case(v, n, 16)
    lib, pid, data = K.kernel_library(), K.PROBLEM_IDS["rastrigin_sr"], \
        K.data_words(prog)
    p = min(cfg.p, n)
    assert lib.ga_block_smem_bytes(0, n, v, p, 32, pid) == \
        K.smem_bytes(n, v, p, data)
    for bits in (16, 32):
        assert lib.ga_block_smem_bytes(1, n, v, p, bits, pid) == \
            K.epoch_smem_bytes(n, v, p, bits, data)
    assert lib.ga_block_smem_bytes(2, n, v, p, 32, pid) == \
        K.epoch_smem_bytes(n, v, p, 32, data)
    assert lib.ga_block_smem_bytes(1, n, v, p, 16, K.PROBLEM_IDS[
        "rastrigin"]) == K.epoch_smem_bytes(n, v, p, 16)


@pytest.mark.cuda
def test_rastrigin_sr_past_the_registers_runs_the_pytorch_stage(
        cuda_device):
    """V = 33: K1 takes its global form with the program's PyTorch stage
    (no ga_ffm launch), equal to the plain version; the island ring plans
    gridded with the reason."""
    prog, cfg = _sr_case(33, 64, 16)
    assert K.block_reason(cfg, prog) is not None
    st = _stack(cfg, 3, cuda_device)
    args = (st.x, st.sel_lfsr, st.cross_lfsr, st.mut_lfsr)
    before = dict(K.LAUNCHES)
    got = K.ga_generation_kernel(*args, cfg=cfg, program=prog, gens=4,
                                 track_best=True)
    torch.cuda.synchronize()
    assert K.LAUNCHES["ga_ffm"] == before["ga_ffm"]
    assert K.LAUNCHES["ga_best"] == before["ga_best"] + 4
    _assert_same(got, K.ga_generation_plain(*args, cfg=cfg, program=prog,
                                            gens=4, track_best=True))
    spec = ga.GASpec(problem="rastrigin_sr:33", n=64, bits_per_var=16,
                     mode="arith", generations=8, n_repeats=2, n_islands=4,
                     migrate_every=2, gens_per_epoch=4, seed=3)
    opts = ga.EngineOptions(device="cuda", cost_table=False, faults=False)
    res = ga.solve(spec, "fused-islands", options=opts)
    assert res.telemetry.plan.mode == "gridded"
    ref = ga.solve(spec, "islands", options=opts)
    _assert_same(res.state, ref.state)


@pytest.mark.cuda
@pytest.mark.parametrize("minimize", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_island_fold_on_card_matches_the_host_loop(cuda_device, case,
                                                   minimize):
    """The island ring's segment fold on the card at the island cell's
    shape (51 replicas x 8 islands, V=30, a chunk of 1024 generations: 64
    intervals in 32 launches), planted ties, NaN and +-inf, against the
    host loop it replaced, bit for bit: torch.argmin's and amin's tie and
    NaN rules on CUDA are NumPy's."""
    sizes = (2,) * 32
    bys, bxs, tms = planted_bests(case, 51, 8, 30, sizes, minimize, seed=9,
                                  device=cuda_device)
    got, nbytes = device_fold(bys, bxs, tms, 51, 30, minimize)
    assert_same_bits(got, twin_fold(bys, bxs, tms, 32, 51, 30, minimize))
    assert nbytes == 65076


@pytest.mark.cuda
def test_island_cell_segment_folds_on_the_card(cuda_device, monkeypatch):
    """A chunk of the island cell's spec on the card: the segment's
    fields equal the host loop's fold of the bests the segment folded,
    one `segment.fold` span before the wait, and the boundary reads back
    at most 70,000 bytes (`segment.result`'s `readback_bytes`)."""
    from repro_torch import trace as TR
    from repro_torch.ga import backends as B

    spec = ga.GASpec(problem="rastrigin:30", n=256, bits_per_var=16,
                     mode="arith", mutation_rate=0.02, generations=1024,
                     n_repeats=51, n_islands=8, migrate_every=16,
                     gens_per_epoch=32, seed=17)
    opts = ga.EngineOptions(device="cuda", cost_table=False, faults=False)
    seen = []
    real = B.fold_island_bests

    def keep(bys, bxs, tms, r_, mini):
        seen.append((list(bys), list(bxs), list(tms)))
        return real(bys, bxs, tms, r_, mini)

    monkeypatch.setattr(B, "fold_island_bests", keep)
    eng = ga.Engine(spec, "fused-islands", options=opts)
    TR.disable()
    TR.clear()
    TR.enable()
    try:
        (tele,) = list(eng.run_chunked(chunk_generations=1024))
        recs = TR.records()
    finally:
        TR.disable()
        TR.clear()
    per = tele["telemetry"].per_repeat
    (bys, bxs, tms), = seen
    assert len(bys) == 32 and tele["telemetry"].plan.mode == "resident"
    assert_same_bits((per.best, per.best_x, per.traj_best, per.traj_mean),
                     twin_fold(bys, bxs, tms, 32, 51, 30, True))
    by_name = {}
    for r in recs:
        by_name.setdefault(r["name"], []).append(r)
    (fold,), (wait,), (res,) = (by_name[n] for n in (
        "segment.fold", "segment.wait", "segment.result"))
    assert fold["attrs"] == {"intervals_folded": 64}
    assert fold["t1"] <= wait["t0"] and wait["t1"] <= res["t0"]
    assert res["attrs"]["readback_bytes"] <= 70000


@pytest.mark.cuda
def test_single_segment_folds_on_the_card(cuda_device, monkeypatch):
    """A fused chunk of the d10 cells' shape on the card (51 x 1024, V=10,
    1024 generations in launches of 32): every field of the segment and of
    its `per_repeat` equals `twin_single`'s host reduction of the block it
    packed, the pack's `segment.fold` ends before `segment.wait`, and the
    boundary reads back the one packed tensor (`readback_bytes`)."""
    from repro_torch import trace as TR

    spec = ga.GASpec(problem="rastrigin:10", n=1024, bits_per_var=16,
                     mode="arith", mutation_rate=0.02, generations=1024,
                     n_repeats=51, gens_per_epoch=32, seed=17)
    opts = ga.EngineOptions(device="cuda", cost_table=False, faults=False)
    seen = keep_single_blocks(monkeypatch)
    eng = ga.Engine(spec, "fused", options=opts)
    state = eng.init_state()
    TR.disable()
    TR.clear()
    TR.enable()
    try:
        seg = eng.backend.segment(state, 1024)
        recs = TR.records()
    finally:
        TR.disable()
        TR.clear()
    (out,) = seen
    assert seg.telemetry.topology.launches == 32
    assert_segment(seg, twin_single(out, False, True))
    by_name = {}
    for r in recs:
        by_name.setdefault(r["name"], []).append(r)
    (fold,), (wait,), (res,) = (by_name[n] for n in (
        "segment.fold", "segment.wait", "segment.result"))
    assert by_name["executor.launch"][-1]["t1"] <= fold["t0"]
    assert fold["t1"] <= wait["t0"] and wait["t1"] <= res["t0"]
    assert res["attrs"]["readback_bytes"] == 4 * (
        32 * 51 + 51 + 51 * 10 + 32 * 51)


@pytest.mark.cuda
@pytest.mark.parametrize("minimize", [True, False])
@pytest.mark.parametrize("tile", [1, 2])
@pytest.mark.parametrize("problem,n", EPOCH_SHAPES)
def test_streamed_kernel_matches_plain(cuda_device, problem, n, tile,
                                       minimize):
    prog, cfg = _epoch_case(problem, n, minimize)
    args = _island_groups(cfg, 2, 4, cuda_device)
    before = K.LAUNCHES["ga_streamed_epoch"]
    got = K.ga_streamed_epoch_kernel(*args, cfg=cfg, program=prog,
                                     migrate_every=3, tile_islands=tile)
    torch.cuda.synchronize()
    assert K.LAUNCHES["ga_streamed_epoch"] == before + 1
    want = K.ga_streamed_epoch_plain(*args, cfg=cfg, program=prog,
                                     migrate_every=3)
    _assert_kernel_equals_plain(got, want, prog.name in EXACT)


# (islands, tile) of the ring-inside form: every tile of 1, 2 and 4 that
# divides 9, 12 and 16 islands
RING_TILES = [(9, 1), (12, 1), (12, 2), (12, 4), (16, 1), (16, 2), (16, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("migrate", [True, False])
@pytest.mark.parametrize("intervals", [1, 4])
@pytest.mark.parametrize("islands,tile", RING_TILES)
@pytest.mark.parametrize("problem,n", [("F3", 64), ("rastrigin:8", 1024)])
def test_streamed_ring_kernel_matches_plain(cuda_device, problem, n, islands,
                                            tile, intervals, migrate):
    """K3's splice form (k intervals, the ring inside one cooperative
    launch) against its plain version: k passes with the splice between."""
    prog, cfg = _epoch_case(problem, n, True)
    args = _island_groups(cfg, 2, islands, cuda_device)
    kw = dict(cfg=cfg, program=prog, migrate_every=3, migrate=migrate,
              intervals=intervals, splice=True)
    before = K.LAUNCHES["ga_streamed_epoch"]
    got = K.ga_streamed_epoch_kernel(*args, tile_islands=tile, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["ga_streamed_epoch"] == before + 1
    assert got[5].shape == (intervals, 2, islands)
    want = K.ga_streamed_epoch_plain(*args, **kw)
    _assert_kernel_equals_plain(got, want, prog.name in EXACT)


def _past_coresidency(device):
    """20 replica groups of 16 islands at the full width: 320 K3 blocks."""
    prog = TF.compile_program(problem="rastrigin:8", bits_per_var=16)
    cfg = TG.GAConfig(n=1024, c=16, v=8, mutation_rate=0.02, seed=4,
                      mode="arith", sel_lane="gather")
    return prog, cfg, _island_groups(cfg, 20, 16, device)


@pytest.mark.cuda
def test_streamed_stack_past_coresidency_takes_tile_two(cuda_device):
    """The card holds two K3 blocks an SM, fewer than 320: the planner
    walks two islands a block; a tile of 1 runs in two waves of whole
    groups, and both equal the plain version."""
    prog, cfg, args = _past_coresidency(cuda_device)
    cap = K.streamed_capacity(cfg, cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert cap == K.kernel_attrs("ga_streamed_epoch", cfg)["blocks_per_sm"] \
        * sms
    assert 160 <= cap < 320
    assert K.streamed_tile_islands(cfg, 20, 16, cuda_device) == 2
    kw = dict(cfg=cfg, program=prog, migrate_every=4, intervals=2,
              splice=True)
    want = K.ga_streamed_epoch_plain(*args, **kw)
    for tile, waves in ((2, 1), (1, 2)):
        before = K.LAUNCHES["ga_streamed_epoch"]
        got = K.ga_streamed_epoch_kernel(*args, tile_islands=tile, **kw)
        torch.cuda.synchronize()
        assert K.LAUNCHES["ga_streamed_epoch"] == before + waves
        _assert_kernel_equals_plain(got, want, False)


@pytest.mark.cuda
def test_pinned_tile_that_cannot_coreside_raises(cuda_device):
    spec = ga.GASpec(problem="rastrigin:8", n=1024, bits_per_var=16,
                     mode="arith", n_repeats=20, n_islands=16,
                     migrate_every=16, gens_per_epoch=64, generations=64)
    eng = ga.Engine(spec, "fused-islands")
    assert (eng.backend.topology.plan["mode"],
            eng.backend.topology.plan["tile_islands"]) == ("streamed", 2)
    with pytest.raises(ValueError, match="cannot co-reside"):
        ga.Engine(spec, "fused-islands",
                  options=ga.EngineOptions(stream_tile_islands=1))
    assert ga.Engine(spec, "fused-islands", options=ga.EngineOptions(
        stream_tile_islands=4)).backend.topology.plan["tile_islands"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("generations,launches", [(30, 3), (25, 3), (10, 1)])
def test_streamed_solve_makes_one_launch_per_k_intervals(
        cuda_device, generations, launches):
    """A fused-islands streamed solve launches K3 once per
    gens_per_epoch // migrate_every intervals (the last launch takes the
    rest) and equals `islands`."""
    kw = dict(problem="F3", n_islands=12, n_repeats=2, gens_per_epoch=10,
              generations=generations)
    ref = _island_solve("islands", **kw)
    before = dict(K.LAUNCHES)
    got = _island_solve("fused-islands", **kw)
    assert got.telemetry.plan.mode == "streamed"
    assert got.telemetry.topology.launches == launches
    assert {k: K.LAUNCHES[k] - before[k] for k in before} == {
        "ga_generation": 0, "ga_epoch": 0, "ga_streamed_epoch": launches,
        "ga_generation:global": 0, "ga_ffm": 0, "ga_best": 0}
    _assert_same_solve(got, ref, traj=False)


@pytest.mark.cuda
def test_epoch_shared_memory_and_clusters(cuda_device):
    lib = K.kernel_library()
    assert lib.ga_step_max_cluster() == K.MAX_CLUSTER
    for n, v in ((2, 1), (64, 2), (256, 30), (1024, 8), (1024, 21),
                 (4096, 2), (4096, 3)):
        for p in (1, 6, 21, n):
            for bits in (16, 32):
                assert lib.ga_epoch_smem_bytes(n, v, p, bits) == \
                    K.epoch_smem_bytes(n, v, p, bits)
    cfg = TG.GAConfig(n=1024, c=16, v=8, mutation_rate=0.02, mode="arith",
                      sel_lane="gather")
    for islands in (1, 4, 8):
        assert K.max_active_clusters(cfg, islands) >= 1
    # the full-width ring, 16 replicas of 8 islands, fits the card at once
    assert K.max_active_clusters(cfg, 8) >= 16


@pytest.mark.cuda
def test_epoch_kernels_refuse_what_they_cannot_take(cuda_device):
    prog, cfg = _epoch_case("F3", 64, True)
    args = _island_groups(cfg, 1, 9, cuda_device)
    before = dict(K.LAUNCHES)
    with pytest.raises(ValueError, match="thread-block cluster"):
        K.ga_epoch_kernel(*args, cfg=cfg, program=prog, migrate_every=2)
    four = [t[:, :4] for t in args]
    with pytest.raises(TypeError, match="int32 words"):
        K.ga_epoch_kernel(four[0].to(torch.int64), *four[1:], cfg=cfg,
                          program=prog, migrate_every=2)
    with pytest.raises(ValueError, match="must be"):
        K.ga_streamed_epoch_kernel(four[0][0], *four[1:], cfg=cfg,
                                   program=prog, migrate_every=2)
    blackbox = TF.compile_program(fitness=lambda p: p.sum(-1),
                                  bounds=((-1.0, 1.0),) * 2, bits_per_var=10)
    for fn in (K.ga_epoch_kernel, K.ga_streamed_epoch_kernel):
        with pytest.raises(ValueError, match="no Hopper FFM stage"):
            fn(*four, cfg=cfg, program=blackbox, migrate_every=2)
    assert K.LAUNCHES == before


@pytest.mark.cuda
def test_kernel_attributes_let_two_island_blocks_share_an_sm(cuda_device):
    """At the full-width shape each kernel takes 512 threads of at most 64
    registers and two blocks an SM, so the resident ring runs in one wave."""
    cfg = TG.GAConfig(n=1024, c=16, v=8, mutation_rate=0.02, mode="arith",
                      sel_lane="gather")
    for name in K.KERNEL_IDS:
        attrs = K.kernel_attrs(name, cfg)
        assert attrs["threads"] == 512
        assert attrs["registers"] <= 64
        assert attrs["blocks_per_sm"] >= 2, (name, attrs)


# ---------------------------------------------------------------------------
# The generation body K1-K3 share, across its parameters
# ---------------------------------------------------------------------------

# (problem, N, steps_per_draw, mutation_rate): the LFSR advance at every
# chunking of its 22-clock pass; odd and large V; P = 1 (the least
# GAConfig gives: P = max(1, ceil(N * rate))), N/2 and N; N below a warp
# and past the 512 threads of a block; the largest V at N = 4096, 2048 and
# 1024 that the footprint admits (tests/test_torch_kernels.py), with the
# mutation rows below P in shared memory and, where they do not fit, in
# global memory (V=21 at N=1024 already at P=21; the largest shapes at
# P=N, among them N=4096, V=3 and N=8192, V=1, which the layout before
# this one also ran).
BODY_CASES = ([("F3", 64, s, 0.02) for s in (1, 2, 3, 7, 31, 32, 40)]
              + [(p, 64, 3, 0.02) for p in ("sphere:1", "rosenbrock:3",
                                            "ackley:5", "rastrigin:16")]
              + [("F2", 64, 3, r) for r in (0.0, 0.5, 1.0)]
              + [("rastrigin:8", 1024, 3, 1.0), ("F1", 4, 3, 0.02),
                 ("F1", 16, 5, 0.3), ("F3", 2048, 3, 0.02),
                 ("F3", 4096, 3, 0.02), ("sphere:4", 4096, 3, 0.02),
                 ("sphere:9", 2048, 3, 0.02), ("sphere:20", 1024, 3, 0.02),
                 ("sphere:21", 1024, 3, 0.02), ("sphere:21", 1024, 7, 1.0),
                 ("sphere:9", 2048, 3, 1.0), ("sphere:4", 4096, 3, 1.0),
                 ("F3", 4096, 3, 0.9), ("sphere:3", 4096, 3, 1.0),
                 ("sphere:1", 8192, 3, 1.0)])


@pytest.mark.cuda
@pytest.mark.parametrize("problem,n,steps,rate", BODY_CASES)
def test_generation_body_matches_plain(cuda_device, problem, n, steps,
                                       rate):
    """K1, K2 (ring, free, boundary) and K3 (tiles 1 and 2, one pass and
    the ring-inside form) each equal their plain version on the same card
    tensors, in the 3-clock build and the run-time one."""
    prog = TF.compile_program(problem=problem, bits_per_var=10)
    cfg = TG.GAConfig(n=n, c=10, v=prog.n_vars, mutation_rate=rate, seed=5,
                      minimize=n != 16, steps_per_draw=steps, mode="arith",
                      sel_lane="gather")
    assert K.hopper_reason(cfg, prog) is None
    exact = prog.name in EXACT
    before = dict(K.LAUNCHES)
    st = _stack(cfg, 3, cuda_device)
    args = (st.x, st.sel_lfsr, st.cross_lfsr, st.mut_lfsr)
    for gens, track in ((3, True), (2, False)):
        kw = dict(cfg=cfg, program=prog, gens=gens, track_best=track)
        _assert_kernel_equals_plain(K.ga_generation_kernel(*args, **kw),
                                    K.ga_generation_plain(*args, **kw),
                                    exact)
    eargs = _island_groups(cfg, 2, 4, cuda_device)
    run = dict(cfg=cfg, program=prog, migrate_every=3)
    for kw in (dict(intervals=2), dict(intervals=2, migrate=False),
               dict(boundary=True)):
        _assert_kernel_equals_plain(K.ga_epoch_kernel(*eargs, **run, **kw),
                                    K.ga_epoch_plain(*eargs, **run, **kw),
                                    exact)
    for tile in (1, 2):
        _assert_kernel_equals_plain(
            K.ga_streamed_epoch_kernel(*eargs, tile_islands=tile, **run),
            K.ga_streamed_epoch_plain(*eargs, **run), exact)
        ring = dict(run, intervals=2, splice=True)
        _assert_kernel_equals_plain(
            K.ga_streamed_epoch_kernel(*eargs, tile_islands=tile, **ring),
            K.ga_streamed_epoch_plain(*eargs, **ring), exact)
    torch.cuda.synchronize()
    assert {k: K.LAUNCHES[k] - before[k] for k in before} == {
        "ga_generation": 2, "ga_epoch": 3, "ga_streamed_epoch": 4,
        "ga_generation:global": 0, "ga_ffm": 0, "ga_best": 0}


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(7,), (3, 5), (2, 130), (1 << 20,)])
@pytest.mark.parametrize("steps", [1, 3, 13, 40])
def test_lfsr_kernel_matches_plain(cuda_device, shape, steps):
    from repro_torch.core import lfsr
    s = lfsr.seeds(99, int(np.prod(shape)), device=cuda_device).reshape(shape)
    before = K4.LAUNCHES["lfsr_advance"]
    got = K4.lfsr_advance_kernel(s, steps)
    torch.cuda.synchronize()
    assert K4.LAUNCHES["lfsr_advance"] == before + 1
    assert torch.equal(got, K4.lfsr_advance_plain(s, steps))


# ---------------------------------------------------------------------------
# The initial state's seed words
# ---------------------------------------------------------------------------

# (n, v, c, seeds): both cells' shapes at full size, N not a power of two,
# V=1 and R=1, c of 1, 16 and 32, seeds at the edges of 32 bits and past
# them, a packed job's seed list, `init_islands`' seeds
SEED_STATE_CASES = {
    "d10": (1024, 10, 16, list(range(3_000_000_017, 3_000_000_068))),
    "d100": (4096, 100, 16, list(range(7, 58))),
    "n66": (66, 3, 10, [1, 2, 3]),
    "n100": (100, 2, 12, [5, 6]),
    "v1-r1": (16, 1, 10, [123]),
    "c1": (64, 4, 1, [0, 1]),
    "c16": (64, 4, 16, [0, 1]),
    "c32": (64, 4, 32, [0, 1]),
    "seed-edges": (32, 2, 10, [0, 2**32 - 1, -5, 2**32 + 7]),
    "packed": (64, 2, 10, [9, 2, 1_000_003, 2, 77]),
    "islands": (32, 2, 10, [11 + 7919 * (i + 1) for i in range(8)]),
    "zero-words": (16, 2, 10, [1] + [sd for sd, _ in ZERO_WORDS]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SEED_STATE_CASES))
def test_seed_state_kernel_matches_plain(cuda_device, case):
    """One launch gives the plain twin's five leaves bit for bit."""
    n, v, c, seeds = SEED_STATE_CASES[case]
    before = K4.LAUNCHES["seed_state"]
    got = K4.seed_state_kernel(n, v, c, seeds, device=cuda_device)
    torch.cuda.synchronize()
    assert K4.LAUNCHES["seed_state"] == before + 1
    want = K4.seed_state_plain(n, v, c, seeds, cuda_device)
    for name, g, w in zip(("x", "sel", "cross", "mut", "k"), got, want):
        assert g.is_cuda and g.is_contiguous(), name
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name
    if case == "zero-words":
        for i, (_, word) in enumerate(ZERO_WORDS, start=1):
            raw = torch.cat([t[i].flatten() for t in got[1:4]])
            if word < raw.numel():
                assert int(raw[word]) & 0xFFFFFFFF == 0xDEADBEEF


# ---------------------------------------------------------------------------
# fused-islands under every plan against islands
# ---------------------------------------------------------------------------


def _island_solve(backend, **kw):
    opts = {k: kw.pop(k) for k in ("plan_override", "stream_tile_islands")
            if k in kw}
    spec = ga.GASpec(**dict(dict(n=64, bits_per_var=10, mode="arith",
                                 mutation_rate=0.05, seed=3, generations=20,
                                 n_islands=4, migrate_every=5,
                                 gens_per_epoch=5), **kw))
    return ga.solve(spec, backend=backend, options=ga.EngineOptions(**opts))


def _assert_same_solve(a, b, traj=True):
    for x, y in zip(convert.state_to_numpy(a.state),
                    convert.state_to_numpy(b.state)):
        np.testing.assert_array_equal(x, y)
    assert a.best_fitness == b.best_fitness
    np.testing.assert_array_equal(a.best_x, b.best_x)
    if traj:
        np.testing.assert_array_equal(a.traj_best, b.traj_best)


@pytest.mark.cuda
@pytest.mark.parametrize("problem", ["F3", "rosenbrock:5", "sphere:8"])
def test_fused_islands_plans_match_islands_on_card(cuda_device, problem):
    """Each plan launches its kernel and equals `islands`; resident-free
    folds two epochs a launch, so its trajectory has half the samples."""
    cases = [(dict(), "resident", "ga_epoch"),
             (dict(n_islands=12, n_repeats=2), "streamed",
              "ga_streamed_epoch"),
             (dict(n_islands=12, n_repeats=2, stream_tile_islands=3),
              "streamed", "ga_streamed_epoch"),
             (dict(migration="none", gens_per_epoch=10), "resident-free",
              "ga_epoch")]
    for kw, mode, kernel in cases:
        ref = _island_solve("islands", problem=problem,
                            **{k: v for k, v in kw.items()
                               if k != "stream_tile_islands"})
        for plan, launched in ((mode, kernel), ("gridded", "ga_generation")):
            before = K.LAUNCHES[launched]
            got = _island_solve("fused-islands", problem=problem,
                                plan_override=plan, **kw)
            assert got.backend == "fused-islands"
            assert got.telemetry.plan.mode == plan
            assert K.LAUNCHES[launched] > before
            _assert_same_solve(got, ref, traj=plan != "resident-free")


@pytest.mark.cuda
@pytest.mark.parametrize("islands", [2, 4, 8])
@pytest.mark.parametrize("problem", ["F3", "rosenbrock:5", "sphere:8"])
def test_budgeted_streamed_plan_matches_islands_on_card(cuda_device,
                                                        problem, islands):
    """Under a planning budget one byte short of a group's K2 blocks, K3
    runs at 8 islands or fewer (two intervals a launch, the ring inside)
    and equals `islands`, its trajectory folded a launch.  (K3 keeps
    32-bit words, so at two islands one 16-bit K2 block is below a K3
    block: the budget is set just under the resident epoch.)"""
    kw = dict(problem=problem, n_islands=islands, n_repeats=2,
              gens_per_epoch=10)
    cfg = ga.GASpec(**dict(dict(n=64, bits_per_var=10, mode="arith",
                                mutation_rate=0.05), **kw)).ga_config()
    budget = K.resident_smem_bytes(cfg, islands) - 1
    assert K.epoch_smem_bytes(cfg.n, cfg.v, cfg.p) <= budget
    ref = _island_solve("islands", **kw)
    before = K.LAUNCHES["ga_streamed_epoch"]
    got = ga.solve(ref.spec, backend="fused-islands",
                   options=ga.EngineOptions(smem_budget=budget))
    assert got.telemetry.plan.mode == "streamed"
    assert got.telemetry.plan.tile_islands == K.streamed_tile_islands(
        cfg, 2, islands, cuda_device, budget)
    assert K.LAUNCHES["ga_streamed_epoch"] == before + 2
    _assert_same_solve(got, ref, traj=False)
    fold = np.minimum(ref.traj_best[0::2], ref.traj_best[1::2])
    np.testing.assert_array_equal(got.traj_best, fold)


def _paper_stack(cfg, replicas, device):
    return _stack(cfg, replicas, torch.device("cpu")), \
        _stack(cfg, replicas, device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
def test_ops_on_card_match_cpu(cuda_device, n):
    """Each `kernels.ops` wrapper on a card tensor launches its kernel and
    equals the same wrapper on a CPU tensor (its plain twin): the paper's
    F1-F3 at every N of its grid, words bit-exact, y and best within
    ``1e-6 * max|y|`` (the CPU's float32 sqrt may round F3 an ulp
    apart)."""
    from repro_torch.configs import ga_paper as TP
    from repro_torch.kernels import ops
    for problem, m in zip(("F1", "F2", "F3"), TP.BIT_WIDTHS[::2]):
        cfg = TP.paper_config(n=n, m=m, mode="arith")
        prog = TF.compile_program(problem=problem, bits_per_var=cfg.c)
        cpu, card = _paper_stack(cfg, 10, cuda_device)
        run = dict(cfg=cfg, program=prog, gens=TP.K_GENERATIONS,
                   track_best=True)
        before = K.LAUNCHES["ga_generation"]
        got = ops.ga_generation(card.x, card.sel_lfsr, card.cross_lfsr,
                                card.mut_lfsr, **run)
        torch.cuda.synchronize()
        assert K.LAUNCHES["ga_generation"] == before + 1
        want = ops.ga_generation(cpu.x, cpu.sel_lfsr, cpu.cross_lfsr,
                                 cpu.mut_lfsr, **run)
        for i, (a, b) in enumerate(zip(got, want)):
            a, b = a.cpu().numpy(), b.numpy()
            if i in (4, 5):
                assert np.max(np.abs(a - b)) <= Y_TOL * np.max(np.abs(b))
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"output {i}")
        before = K4.LAUNCHES["lfsr_advance"]
        for bank in ("sel_lfsr", "cross_lfsr", "mut_lfsr"):
            a = ops.lfsr_advance(getattr(card, bank), 3 * TP.K_GENERATIONS)
            b = ops.lfsr_advance(getattr(cpu, bank), 3 * TP.K_GENERATIONS)
            assert torch.equal(a.cpu(), b)
        assert K4.LAUNCHES["lfsr_advance"] == before + 3
    cfg = TP.paper_config(n=64, m=20, mode="arith")
    prog = TF.compile_program(problem="F3", bits_per_var=cfg.c)
    cpu, card = (tuple(t.reshape((2, 4) + t.shape[1:]) for t in
                       (s.x, s.sel_lfsr, s.cross_lfsr, s.mut_lfsr))
                 for s in _paper_stack(cfg, 8, cuda_device))
    for kw in (dict(intervals=2), dict(boundary=True)):
        before = K.LAUNCHES["ga_epoch"]
        got = ops.ga_epoch(*card, cfg=cfg, program=prog, migrate_every=5,
                           **kw)
        torch.cuda.synchronize()
        assert K.LAUNCHES["ga_epoch"] == before + 1
        want = ops.ga_epoch(*cpu, cfg=cfg, program=prog, migrate_every=5,
                            **kw)
        for i, (a, b) in enumerate(zip(got, want)):
            a, b = a.cpu().numpy(), b.numpy()
            if i in (4, 5):
                assert np.max(np.abs(a - b)) <= Y_TOL * np.max(np.abs(b))
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"output {i}")
    with pytest.raises(ValueError, match="requires mode='arith'"):
        ops.ga_generation(card[0][0], card[1][0], card[2][0], card[3][0],
                          cfg=TP.paper_config(n=64, m=20), program=prog)


# ---------------------------------------------------------------------------
# Packs, chunks and checkpoints on the card
# ---------------------------------------------------------------------------

PACK_CASES = [("fused", dict(gens_per_epoch=8)),
              ("fused-islands", dict(n_islands=4, migrate_every=4,
                                     gens_per_epoch=8)),
              ("fused-islands", dict(n_islands=12, migrate_every=4,
                                     gens_per_epoch=8))]


def _pack_specs(kw):
    base = dict(problem="F3", n=64, bits_per_var=10, mode="arith",
                mutation_rate=0.05, generations=32, **kw)
    return [ga.GASpec(seed=11, **base), ga.GASpec(seed=40, **base),
            ga.GASpec(seed=7, n_repeats=2, **base)]


@pytest.mark.cuda
@pytest.mark.parametrize("backend,kw", PACK_CASES)
def test_pack_crash_and_resume_match_solo_on_card(cuda_device, tmp_path,
                                                  backend, kw):
    """A pack crashed at chunk 3 by `chunk_crash` resumes in a fresh engine
    from step 16 and ends with every job bit-identical to its solo run on
    the card: best, best_params and the final state slice."""
    from repro_torch import faults as FLT
    from repro_torch.ckpt import checkpoint as CKPT
    specs = _pack_specs(kw)
    ck = str(tmp_path / "pack")
    crash = ga.EngineOptions(faults="chunk_crash:at=3")
    seen = []
    with pytest.raises(FLT.ChunkCrash):
        for tele in ga.PackedEngine(specs, backend, options=crash) \
                .run_chunked(chunk_generations=8, ckpt_dir=ck):
            seen.append(tele["gens_done"])
    assert seen == [8, 16]
    pe = ga.PackedEngine(specs, backend)
    teles = list(pe.run_chunked(chunk_generations=8, ckpt_dir=ck))
    assert teles[0]["resumed_from"] == 16
    assert [t["gens_done"] for t in teles] == [24, 32]
    final, _ = CKPT.restore(ck, 32, pe.init_state())
    for spec, jt in zip(specs, teles[-1]["jobs"]):
        solo = ga.solve(spec, backend=backend)
        assert solo.backend == backend
        assert jt["best_fitness"] == solo.best_fitness
        np.testing.assert_array_equal(jt["best_params"], solo.best_params)
        off, cnt = jt["slots"]
        for a, b in zip(final, solo.state):
            assert a.device.type == "cuda" and b.device.type == "cuda"
            assert torch.equal(a[off:off + cnt].reshape(b.shape), b)


@pytest.mark.cuda
def test_restore_places_every_leaf_on_the_card(cuda_device, tmp_path):
    from repro_torch.ckpt import checkpoint as CKPT
    eng = ga.Engine(_pack_specs({})[2], "fused")
    st = eng.init_state()
    CKPT.save(str(tmp_path), 3, st, extra={"backend": "fused"})
    got, _ = CKPT.restore(str(tmp_path), 3, st)
    for a, b in zip(got, st):
        assert a.device == b.device and a.device.type == "cuda"
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_repack_on_card_matches_solo(cuda_device, tmp_path):
    specs = _pack_specs(dict(gens_per_epoch=8))
    pack = str(tmp_path / "pack")
    for tele in ga.PackedEngine(specs, "fused").run_chunked(
            chunk_generations=8, ckpt_dir=pack):
        if tele["gens_done"] >= 16:
            break
    pair = str(tmp_path / "pair")
    assert ga.repack_checkpoint(pack, specs, [0, 2], pair, "fused") == 16
    last = list(ga.PackedEngine([specs[0], specs[2]], "fused").run_chunked(
        chunk_generations=8, ckpt_dir=pair))[-1]
    for spec, jt in zip((specs[0], specs[2]), last["jobs"]):
        solo = ga.solve(spec, backend="fused")
        assert jt["best_fitness"] == solo.best_fitness
        np.testing.assert_array_equal(jt["best_params"], solo.best_params)


@pytest.mark.cuda
@pytest.mark.parametrize("backend,kw", PACK_CASES)
def test_scheduler_on_card_matches_solo(cuda_device, tmp_path, backend, kw):
    """The scheduler packs the jobs into one launch on the card, a crash
    of one chunk retries the pack from its checkpoint, and every job ends
    equal to its solo run."""
    from repro_torch import faults as FLT
    from repro_torch.serve.engine import GAMetricsRegistry
    from repro_torch.serve.scheduler import GAScheduler
    inj = FLT.FaultInjector()
    sched = GAScheduler(registry=GAMetricsRegistry(), backend=backend,
                        chunk_generations=8, ckpt_root=str(tmp_path),
                        paused=True, options=ga.EngineOptions(faults=inj))
    try:
        specs = _pack_specs(kw)
        ids = [sched.submit(s) for s in specs]
        inj.add_rule(f"chunk_crash@{ids[0]}:at=2")
        sched.resume_dispatch()
        for jid, spec in zip(ids, specs):
            res = sched.result(jid, timeout=300)
            solo = ga.solve(spec, backend=backend)
            assert res["pack_size"] == len(specs)
            assert res["best_fitness"] == solo.best_fitness
            np.testing.assert_array_equal(res["best_params"],
                                          solo.best_params)
        stats = sched.stats()
        assert stats["retries"] == len(specs)
        assert stats["packs_launched"] == 2
    finally:
        sched.shutdown()


@pytest.mark.cuda
def test_scheduler_for_the_card_runs_on_it(cuda_device, tmp_path):
    from repro_torch.serve.scheduler import GAScheduler
    sched = GAScheduler(ckpt_root=str(tmp_path), paused=True)
    try:
        assert sched.device.type == "cuda"
    finally:
        sched.shutdown()


# ---------------------------------------------------------------------------
# The autotune sweep and the eager backend on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kw,modes", [
    (dict(n_islands=4), {"resident", "gridded"}),
    (dict(n_islands=4, migration="none"), {"gridded", "resident-free"}),
    (dict(n_islands=12, n_repeats=2), {"streamed", "gridded"})])
def test_sweep_on_card_and_its_measured_plan(cuda_device, kw, modes):
    """The sweep times every candidate on the card (both lanes), and an
    engine planned from that table equals the heuristic one bit for bit."""
    from repro_torch.autotune import sweep
    spec = ga.GASpec(**dict(dict(problem="F3", n=64, bits_per_var=10,
                                 mode="arith", mutation_rate=0.05, seed=3,
                                 generations=16, migrate_every=4,
                                 gens_per_epoch=8), **kw))
    before = dict(K.LAUNCHES)
    table = sweep([spec], backend="fused-islands", min_reps=2, max_reps=3)
    assert {e["mode"] for e in table.entries()} == modes
    assert {e["lane"] for e in table.entries()} == {"onehot", "gather"}
    assert all(e["gens_per_s"] > 0 for e in table.entries())
    assert table.host["platform"] == "cuda"
    assert K.LAUNCHES["ga_generation"] > before["ga_generation"]
    meas = ga.solve(spec, backend="fused-islands",
                    options=ga.EngineOptions(cost_table=table))
    heur = ga.solve(spec, backend="fused-islands",
                    options=ga.EngineOptions(cost_table=False))
    assert meas.telemetry.plan.source == "measured"
    assert meas.telemetry.plan.gens_per_s > 0
    _assert_same_solve(meas, heur, traj=(meas.telemetry.plan.gens_per_launch
                                         == heur.telemetry.plan
                                         .gens_per_launch))


@pytest.mark.cuda
@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("n_repeats", [1, 3])
def test_eager_on_card_equals_reference_on_card(cuda_device, n_repeats,
                                                workers):
    """Eager keeps the state on the card and crosses only y to the host:
    state, best and the trajectory of bests equal `reference` on the card;
    the means within 1e-6 * max(|mean|, |best|) (numpy's sum against
    PyTorch's)."""
    spec = ga.GASpec(problem="rastrigin:8", n=256, bits_per_var=16,
                     mode="arith", mutation_rate=0.02, seed=9,
                     generations=24, n_repeats=n_repeats)
    eager = ga.solve(spec, backend="eager",
                     options=ga.EngineOptions(fitness_workers=workers))
    ref = ga.solve(spec, backend="reference")
    assert eager.state.x.device.type == "cuda"
    _assert_same_solve(eager, ref)
    scale = np.maximum(np.abs(ref.traj_mean), np.abs(ref.traj_best))
    assert np.all(np.abs(eager.traj_mean - ref.traj_mean) <= 1e-6 * scale)


# ---------------------------------------------------------------------------
# The island ring on a mesh of logical shards of the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kw,mode,form", [
    (dict(), "resident-sharded", "ga_epoch:boundary"),
    (dict(n_islands=18, n_repeats=2), "streamed",
     "ga_streamed_epoch:one-interval"),
    (dict(plan_override="gridded"), "gridded", None)])
def test_sharded_plans_on_card_match_plain(cuda_device, kw, mode, form):
    """A 2-shard mesh of the card: each sharded plan launches its kernel
    form a shard and interval, and equals the same run on a 2-shard mesh of
    the CPU (the kernels' plain versions) and `islands` on the card."""
    from repro_torch.launch.mesh import Mesh
    kw = dict(kw)
    override = kw.pop("plan_override", None)
    spec = ga.GASpec(**dict(dict(problem="F3", n=64, bits_per_var=10,
                                 mode="arith", mutation_rate=0.05, seed=11,
                                 generations=30, n_islands=8,
                                 migrate_every=5, gens_per_epoch=10), **kw))
    card = Mesh([torch.device("cuda", 0)] * 2, ("islands",))
    cpu = Mesh([torch.device("cpu")] * 2, ("islands",))
    forms = dict(K.FORM_LAUNCHES)
    got = ga.solve(spec, backend="fused-islands", options=ga.EngineOptions(
        mesh=card, plan_override=override))
    torch.cuda.synchronize()
    plain = ga.solve(spec, backend="fused-islands", options=ga.EngineOptions(
        mesh=cpu, plan_override=override))
    ref = ga.solve(spec, backend="islands")
    assert got.telemetry.plan.mode == plain.telemetry.plan.mode == mode
    assert got.state.x.device.type == "cuda"
    assert got.telemetry.topology.n_shards == 2
    if form is not None:
        assert K.FORM_LAUNCHES[form] > forms[form]
    _assert_same_solve(got, plain)
    _assert_same_solve(got, ref, traj=mode != "streamed")


@pytest.mark.cuda
@pytest.mark.parametrize("kw,mode", [
    (dict(), "resident-sharded"), (dict(n_islands=36), "streamed"),
    (dict(plan_override="gridded"), "gridded")])
def test_sharded_plans_across_cards_match_one_card(cuda_device, kw, mode):
    """A mesh of distinct cards (every card the host has, at most 4): the
    shards' launches run on their own cards and the elites, the split and
    the gather cross between cards; each plan equals the same run on one
    card."""
    from repro_torch.launch.mesh import parse_mesh
    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        pytest.skip("needs two NVIDIA GPUs")
    kw = dict(kw)
    override = kw.pop("plan_override", None)
    spec = ga.GASpec(**dict(dict(problem="F3", n=64, bits_per_var=10,
                                 mode="arith", mutation_rate=0.05, seed=11,
                                 generations=30, n_islands=4 * n,
                                 migrate_every=5, gens_per_epoch=10,
                                 n_repeats=2), **kw))
    mesh = parse_mesh(str(n))
    assert len({d.index for d in mesh.devices.flat}) == n
    got = ga.solve(spec, backend="fused-islands", options=ga.EngineOptions(
        mesh=mesh, plan_override=override))
    one = ga.solve(spec, backend="fused-islands",
                   options=ga.EngineOptions(plan_override=override))
    assert got.telemetry.plan.mode == mode
    assert got.telemetry.topology.n_shards == n
    assert got.state.x.device == mesh.first_device
    _assert_same_solve(got, one, traj=mode != "resident-sharded")


# ---------------------------------------------------------------------------
# The LM serving path on the card: every architecture at reduced size, in
# float32 with TF32 off, against the same weights on the CPU.  Bound:
# |Δ| <= 5e-4 * max(1, max|CPU|), the float32 bound the CPU tests hold the
# port to against JAX (tests/test_torch_lm_common.py): the card sums in
# other orders than the CPU does.
# ---------------------------------------------------------------------------

LM_F32_REL = 5e-4
LM_ARCHS = ("deepseek-v3-671b", "gemma3-27b", "mamba2-1.3b", "minitron-8b",
            "moonshot-v1-16b-a3b", "pixtral-12b", "qwen1.5-32b",
            "whisper-large-v3", "yi-34b", "zamba2-2.7b")


def _lm_run(model, cfg, data, device, s):
    from repro_torch.models import lm as TLM
    p = cfg.n_patches if cfg.family == "vlm" else 0
    toks = torch.as_tensor(data["tokens"], dtype=torch.long, device=device)
    kw = {k: torch.as_tensor(v, device=device) for k, v in data.items()
          if k != "tokens"}
    with torch.inference_mode():
        full, _ = model({"tokens": toks, **kw})
        cache = TLM.new_cache(cfg, toks.shape[0], s + 8 + p, device=device)
        lp, cache = model.prefill(toks[:, :s], cache, **kw)
        d1, cache = model.decode_step(toks[:, s:s + 1], cache)
        d2, cache = model.decode_step(toks[:, s + 1:s + 2], cache)
    return [t.float().cpu().numpy() for t in (full, lp, d1, d2)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_reduced_on_card_matches_cpu(cuda_device, arch, monkeypatch):
    import copy

    from repro_torch import configs as TCONF
    from repro_torch.models import lm as TLM
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = dataclasses.replace(TCONF.reduced(TCONF.get_config(arch)),
                              dtype="float32")
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    s, b = 32, 2
    p = cfg.n_patches if cfg.family == "vlm" else 0
    rng = np.random.default_rng(1)
    data = {"tokens": rng.integers(0, cfg.vocab, (b, s + 2))}
    if cfg.family == "audio":
        data["frames"] = (rng.normal(size=(b, cfg.enc_seq, cfg.d_model))
                          * 0.1).astype(np.float32)
    if cfg.family == "vlm":
        data["patches"] = (rng.normal(size=(b, cfg.n_patches, cfg.d_model))
                           * 0.1).astype(np.float32)
    cpu = TLM.init_params(cfg, max_seq=s + 8 + p, device="cpu", seed=0)
    card = copy.deepcopy(cpu).to(cuda_device)
    want = _lm_run(cpu, cfg, data, "cpu", s)
    got = _lm_run(card, cfg, data, cuda_device, s)
    for g, w in zip(got, want):
        err = np.abs(g - w).max() / max(1.0, np.abs(w).max())
        assert err <= LM_F32_REL, err
    # and on the card, prefill and decode reproduce its own forward
    full, lp, d1, d2 = got
    assert np.abs(lp - full[:, p + s - 1]).max() <= LM_F32_REL * max(
        1.0, np.abs(full).max())
    for i, d in enumerate((d1, d2)):
        assert np.abs(d - full[:, p + s + i]).max() <= 5 * LM_F32_REL * max(
            1.0, np.abs(full).max())


# ---------------------------------------------------------------------------
# LM training: one train step on the card against the CPU, and AdamW's
# 8-bit update of one leaf (chip_smoke.py phase 14 runs all ten families)
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ("minitron-8b", "moonshot-v1-16b-a3b", "mamba2-1.3b")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_on_card_matches_cpu(cuda_device, arch, monkeypatch):
    """A reduced float32 train step with remat (TF32 off): the loss within
    1e-5 relative, every gradient leaf within 1e-4 x its max|g|, the
    updated parameters within 2 ulps plus lr x the gap of the two
    gradients' first Adam step directions (`repro_torch.train.parity`,
    which chip_smoke.py phase 14 (a) runs for all ten); and remat
    bit-equal to no remat on the card."""
    from repro_torch.train import parity
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    r = parity.hold_step(arch, cuda_device)
    assert r["loss_rel"] <= 1e-5, r["loss"]
    assert r["aux_gap"] <= 1e-5 * r["aux_scale"], r["aux"]
    assert r["remat_equal"]
    assert max(r["grad_rel"].values()) <= 1e-4, r["grad_rel"]
    assert max(r["update_excess"].values()) <= 0, r["update_excess"]


@pytest.mark.cuda
def test_train_8bit_update_on_card_matches_cpu(cuda_device):
    """Three 8-bit AdamW steps of one bf16 leaf (512 x 1024) and one that
    cannot be quantized, from the same gradients, the clip out of reach
    (the norm is a reduction whose order differs): parameters, q and
    scale equal on the card and the CPU in all but 0.1% of the elements,
    there within one unit."""
    from repro_torch.optim import adamw as OPT
    rng = np.random.default_rng(0)
    cfg = OPT.AdamWConfig(lr=1e-2, state_bits=8, grad_clip=1e30)
    p0 = {"w": torch.tensor(rng.normal(size=(512, 1024)).astype(np.float32)
                            ).to(torch.bfloat16),
          "b": torch.tensor(rng.normal(size=(5, 7)).astype(np.float32))}
    runs = {}
    for dev in ("cpu", cuda_device):
        params = {k: v.to(dev).clone() for k, v in p0.items()}
        st = OPT.init(params, cfg)
        g_rng = np.random.default_rng(1)
        for _ in range(3):
            grads = {k: torch.tensor(g_rng.normal(size=v.shape).astype(
                np.float32)).to(device=dev, dtype=v.dtype)
                for k, v in params.items()}
            st, _ = OPT.update(params, grads, st, cfg)
        runs[torch.device(dev).type] = (params, st)
    (pc, sc), (pk, sk) = runs["cpu"], runs["cuda"]
    for k in p0:
        d = (pk[k].cpu().float() - pc[k].float()).abs()
        assert (d > 0).float().mean() <= 1e-3, k
    assert isinstance(sk.m["w"], OPT.QTensor)
    for a, b in ((sk.m["w"], sc.m["w"]), (sk.v["w"], sc.v["w"])):
        dq = (a.q.cpu().int() - b.q.int()).abs()
        assert dq.max() <= 1 and (dq > 0).float().mean() <= 1e-3
        ds = (a.scale.cpu().view(torch.int32).long()
              - b.scale.view(torch.int32).long()).abs()
        assert ds.max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4), (1, 8)])
@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_moe_a2a_on_card_matches_cpu(cuda_device, shape, cf):
    """The expert-parallel MoE on a logical mesh of the card against the
    same on a logical CPU mesh, float32 at reduced width (d 128, 8
    experts, top-2, expert_ff 64): the output within 1e-5 * max|y|, the
    weight gradients of sum(y ** 2) within 1e-4 * max|g| (cuBLAS and the
    CPU sum the products in other orders), the dropped rows the same."""
    from repro_torch.launch.mesh import logical_mesh
    from repro_torch.models import common as C
    from repro_torch.models import moe as MOE
    from repro_torch.models.moe_a2a import moe_a2a_forward

    cfg = MOE.MoEConfig(d_model=128, n_experts=8, top_k=2, expert_ff=64,
                        capacity_factor=cf)
    leaves = ("router", "w_gate", "w_up", "w_down")
    cpu = MOE.MoE(cfg, C.seeded_init(torch.float32, "cpu", 22))
    x = torch.randn(4, 32, 128, generator=torch.Generator().manual_seed(1))
    card = MOE.MoE(cfg, C.Init(torch.float32, cuda_device))
    with torch.no_grad():
        for k in leaves:
            getattr(card, k).copy_(getattr(cpu, k))
    n = shape[0] * shape[1]
    out = {}
    for name, moe, dev in (("cpu", cpu, "cpu"), ("card", card, cuda_device)):
        for k in leaves:
            getattr(moe, k).requires_grad_(True)
        y, dropped = moe_a2a_forward(moe, x.to(dev), cfg,
                                     logical_mesh(dev, shape),
                                     with_dropped=True)
        torch.sum(y ** 2).backward()
        out[name] = (y.detach().cpu(), dropped.cpu(),
                     {k: getattr(moe, k).grad.cpu() for k in leaves})
    (yc, dc, gc), (yg, dg, gg) = out["cpu"], out["card"]
    assert torch.equal(dc, dg)
    assert float((yc - yg).abs().max()) <= 1e-5 * float(yc.abs().max())
    for k in leaves:
        err = float((gc[k] - gg[k]).abs().max())
        assert err <= 1e-4 * float(gc[k].abs().max()), (k, err)
