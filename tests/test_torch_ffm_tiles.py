"""How ga_ffm cuts its work, and why its chunked fold is the plain order (CPU).

`ffm_tiling` picks ga_ffm's tile of rows of x seen as [R * N, V] and its
chunk of variables, in one of two forms (`ffm_spreads`): the rows form (a
thread evaluates whole rows, F1-F3 always) or the spread form (a thread a
(row, variable) term, then a thread a row folding the chunk's terms into
sums it carries to the next chunk).  These tests hold the choice to what
the CUDA launcher checks (the tiles and chunks cover every (row, variable)
once, within the shared-memory budget), walk the kernel's item and fold
loops over small shapes, and emulate the spread form's chunked order in
PyTorch: the terms of each chunk, rosenbrock's halo word, ackley's two
sums, folded left to right with the first term not added to 0.  The
emulation equals `program.stage` bit for bit, which is what the kernel is
held to on the card.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import fitness as TF  # noqa: E402
from repro_torch.kernels import ga_step as K  # noqa: E402

# the grid of tests/test_torch_global_tiles.py
VS = (1, 2, 3, 64, 100, 1000, 4096)
NS = (2, 4, 64, 8192, 65536, 1 << 20)
RS = (1, 16, 128)


def _forms(v):
    """The forms ga_ffm can take at V: the spread form always, the rows
    form where a 256-row tile of whole rows fits the budget."""
    return [True] + ([False] if K.ffm_tile_bytes(K.FFM_THREADS, v, False)
                     <= K.FFM_SMEM_LIMIT else [])


@pytest.mark.parametrize("r", RS)
@pytest.mark.parametrize("v", VS)
@pytest.mark.parametrize("n", NS)
def test_ffm_tile_fits_and_covers(n, v, r):
    rows = r * n
    for spread in _forms(v):
        tile, chunk = K.ffm_tiling(n, v, r, spread)
        assert K.ffm_tile_bytes(tile, chunk, spread) <= K.FFM_SMEM_LIMIT
        assert tile >= 1 and tile & (tile - 1) == 0
        if spread:
            assert tile <= K.FFM_THREADS
            assert 1 <= chunk <= min(v, K.FFM_CHUNK)
        else:
            assert tile in (K.FFM_THREADS, 2 * K.FFM_THREADS,
                            4 * K.FFM_THREADS)
            assert chunk == v
        # the blocks' tiles [b * tile, min(rows, (b + 1) * tile)) cover the
        # rows once, every block some (the last may be ragged)
        blocks = -(-rows // tile)
        assert (blocks - 1) * tile < rows <= blocks * tile
        # the chunks [j0, j0 + chunk), in order, cover V once
        starts = list(range(0, v, chunk))
        widths = [min(chunk, v - j0) for j0 in starts]
        assert starts == sorted(starts) and sum(widths) == v
        assert min(widths) >= 1 and len(widths) == -(-v // chunk)
    assert K.ffm_tiling(n, v, r) == K.ffm_tiling(n, v, r,
                                                 K.ffm_spreads(n, v, r))


@pytest.mark.parametrize("r", RS)
@pytest.mark.parametrize("v", VS)
def test_ffm_tile_is_cut_only_to_fill_the_grid(v, r):
    """A tile is the largest that fits the budget, halved only while the
    grid is short of OPS_GRID blocks (and, spread, the tile holds more
    than FFM_ITEMS items)."""
    n = 8192
    rows = r * n
    for spread in _forms(v):
        tile, chunk = K.ffm_tiling(n, v, r, spread)
        largest = K.FFM_THREADS if spread else K.FFM_ROWS_TILE
        while (largest > (1 if spread else K.FFM_THREADS)
               and K.ffm_tile_bytes(largest, chunk, spread)
               > K.FFM_SMEM_LIMIT):
            largest //= 2
        assert tile <= largest
        if tile < largest:
            twice = 2 * tile
            assert -(-rows // twice) < K.OPS_GRID
            assert not spread or twice * chunk > K.FFM_ITEMS


@pytest.mark.parametrize("n,v,r,spread,tile,chunk", [
    (8192, 2, 16, False, 256, 2), (65536, 2, 16, False, 1024, 2),
    (1024, 32, 16, True, 32, 32), (4096, 64, 16, True, 64, 64),
    (8192, 100, 3, True, 32, 64), (1024, 3, 128, False, 256, 3),
    (1024, 8, 16, True, 64, 8), (8192, 8, 16, False, 256, 8)])
def test_ffm_tiling_at_the_measured_shapes(n, v, r, spread, tile, chunk):
    """The forms and tiles at the shapes chip_smoke.py phase 17 times
    (rosenbrock:64 and ackley:64 share sphere:64's), its edge shape past
    one chunk, and two of the sweep's form comparisons."""
    assert K.ffm_spreads(n, v, r) == spread
    assert K.ffm_tiling(n, v, r) == (tile, chunk)


@pytest.mark.parametrize("r", RS)
@pytest.mark.parametrize("v", VS + (4, 8, 16, 46, 47))
@pytest.mark.parametrize("n", NS)
def test_ffm_form_rule(n, v, r):
    """The rows form below FFM_SPREAD_V (F1-F3 are V = 2), else only where
    its 256-row tiles alone fill OPS_GRID blocks within the budget."""
    fills = r * n >= K.FFM_THREADS * K.OPS_GRID
    fits = K.ffm_tile_bytes(K.FFM_THREADS, v, False) <= K.FFM_SMEM_LIMIT
    assert K.ffm_spreads(n, v, r) == (v >= K.FFM_SPREAD_V
                                      and not (fills and fits))
    if v < K.FFM_SPREAD_V:
        assert fits


def _spread_items(rows, v, tile, chunk, rosenbrock):
    """The kernel's spread-form loops over a grid, in Python: per block and
    chunk the words it loads (with rosenbrock's halo), the (row, variable)
    terms of `ffm_terms`' item loop (rastrigin's and ackley's; sphere's and
    rosenbrock's folding thread computes the same terms of its row) and
    the rows `tid < here` fold."""
    lg = tile.bit_length() - 1
    loaded, terms, folded = [], [], []
    for row0 in range(0, rows, tile):
        here = min(tile, rows - row0)
        for j0 in range(0, v, chunk):
            vc = min(chunk, v - j0)
            width = min(vc + 1, v - j0) if rosenbrock else vc
            nterm = min(vc, v - 1 - j0) if rosenbrock else vc
            loaded.extend((row0 + k, j0 + j) for k in range(here)
                          for j in range(width))
            for q in range(nterm << lg):
                k, jj = q & (tile - 1), q >> lg
                if k < here:
                    terms.append((row0 + k, j0 + jj))
                    if rosenbrock:
                        assert (row0 + k, j0 + jj + 1) in set(loaded[-here
                                                                     * width:])
            folded.extend((row0 + tid, j0) for tid in range(K.FFM_THREADS)
                          if tid < here)
    return loaded, terms, folded


@pytest.mark.parametrize("rosenbrock", [False, True])
@pytest.mark.parametrize("n,v,r", [(2, 1, 1), (4, 3, 3), (66, 64, 3),
                                   (66, 65, 1), (6, 100, 2), (1024, 4, 1)])
def test_spread_items_cover_each_term_once(n, v, r, rosenbrock):
    rows = r * n
    tile, chunk = K.ffm_tiling(n, v, r, spread=True)
    loaded, terms, folded = _spread_items(rows, v, tile, chunk, rosenbrock)
    nterm = v - 1 if rosenbrock else v
    assert sorted(terms) == [(i, j) for i in range(rows)
                             for j in range(nterm)]
    assert all(0 <= j < v for _, j in loaded)
    chunks = -(-v // chunk)
    assert sorted(folded) == sorted((i, j0) for i in range(rows)
                                    for j0 in range(0, v, chunk))
    assert len(folded) == rows * chunks


@pytest.mark.parametrize("n,v,r", [(2, 1, 1), (66, 2, 3), (8192, 2, 1),
                                   (1000, 3, 3)])
def test_rows_form_takes_each_row_once(n, v, r):
    """The rows form: thread t of a block takes rows t + 256 m, m < K =
    tile / 256, those below the ragged tile's end."""
    rows = r * n
    tile, chunk = K.ffm_tiling(n, v, r, spread=False)
    assert chunk == v
    per = tile // K.FFM_THREADS
    seen = []
    for row0 in range(0, rows, tile):
        here = min(tile, rows - row0)
        seen.extend(row0 + t + m * K.FFM_THREADS
                    for t in range(K.FFM_THREADS) for m in range(per)
                    if t + m * K.FFM_THREADS < here)
    assert sorted(seen) == list(range(rows))


# ---------------------------------------------------------------------------
# The chunked fold of the spread form against the plain stage
# ---------------------------------------------------------------------------

SUMMED = ("sphere", "rastrigin", "rosenbrock", "ackley")
FOLD_VS = (1, 2, 3, 31, 64, 65, 100)
TWO_PI = 2.0 * np.pi


def _decode(prog, w, j0, j1):
    """Variables [j0, j1) of x's words, as the kernel decodes a chunk."""
    lo, span = prog.device_consts(w.device)
    u = (w[..., j0:j1] & ((1 << prog.bits_per_var) - 1)).to(torch.float32)
    return lo[j0:j1] + u * span[j0:j1]


def _spread_emulation(prog, x, chunk):
    """ga_ffm's spread form in PyTorch: each chunk's terms from its words
    (rosenbrock's with one halo word past the chunk), folded left to right
    into sums carried across chunks, `j ? s + t : t`; ackley's two sums
    finished with `ackley_of`'s expression."""
    name, v = prog.name, x.shape[-1]
    s1 = torch.zeros(x.shape[:-1], dtype=torch.float32)
    s2 = torch.zeros_like(s1)
    for j0 in range(0, v, chunk):
        vc = min(chunk, v - j0)
        if name == "rosenbrock":
            vals = _decode(prog, x, j0, j0 + min(vc + 1, v - j0))
            a, b = vals[..., :-1], vals[..., 1:]
            d, e = b - a * a, 1.0 - a
            t1 = 100.0 * (d * d) + e * e          # terms j0 .. j0 + n - 1
        else:
            a = _decode(prog, x, j0, j0 + vc)
            if name == "sphere":
                t1 = a * a
            elif name == "rastrigin":
                t1 = a * a - 10.0 * torch.cos(TWO_PI * a) + 10.0
            else:
                t1, t2 = a * a, torch.cos(TWO_PI * a)
        for jj in range(t1.shape[-1]):
            j = j0 + jj
            s1 = s1 + t1[..., jj] if j else t1[..., jj]
            if name == "ackley":
                s2 = s2 + t2[..., jj] if j else t2[..., jj]
    if name != "ackley":
        return s1
    fv = torch.full_like(s1, float(v))
    return (-20.0 * torch.exp(-0.2 * torch.sqrt(s1 / fv))
            - torch.exp(s2 / fv) + 20.0 + np.e)


def _rows_emulation(prog, x, tile):
    """ga_ffm's rows form in PyTorch: x's rows cut into tiles, each row's
    whole expression in `ffm`'s order, y scattered back."""
    name = prog.name
    flat = x.reshape(-1, x.shape[-1])
    y = torch.empty(flat.shape[0], dtype=torch.float32)
    for row0 in range(0, flat.shape[0], tile):
        a = _decode(prog, flat[row0:row0 + tile], 0, x.shape[-1])
        if name == "F1":
            t = a[:, 1]
            out = t * (t * t) - 15.0 * (t * t) + 500.0
        elif name == "F2":
            out = 8.0 * a[:, 0] + (-4.0 * a[:, 1] + 1020.0)
        elif name == "F3":
            out = torch.sqrt(torch.clamp_min(
                a[:, 0] * a[:, 0] + a[:, 1] * a[:, 1], 0.0))
        else:
            out = _spread_emulation(prog, flat[row0:row0 + tile],
                                    x.shape[-1])
        y[row0:row0 + tile] = out
    return y.reshape(x.shape[:-1])


def _words(r, n, v, c, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 1 << c, size=(r, n, v),
                                         dtype=np.int64).astype(np.int32))


def _cases():
    for name in SUMMED:
        for v in FOLD_VS:
            if name == "rosenbrock" and v == 1:
                continue    # min_vars = 2: no spec has it, the plain stage
            yield name, v   # has no first term to start its sum
    for name in ("F1", "F2", "F3"):
        yield name, 2


@pytest.mark.parametrize("name,v", list(_cases()))
def test_chunked_fold_is_the_plain_order(name, v):
    """The kernel's order, emulated, equals `program.stage` bit for bit:
    the spread form at the tiling's chunk and at chunks of 1 and 7 (a
    boundary after every variable, and ragged ones), the rows form at its
    tile."""
    problem = name if name.startswith("F") else f"{name}:{v}"
    prog = TF.compile_program(problem=problem, bits_per_var=16)
    r, n = 3, 66
    x = _words(r, n, v, 16, seed=v)
    want = prog.stage(x)
    if not name.startswith("F"):
        for chunk in sorted({K.ffm_tiling(n, v, r, True)[1], 1, min(7, v)}):
            got = _spread_emulation(prog, x, chunk)
            assert torch.equal(got, want), (name, v, chunk)
    if K.ffm_tile_bytes(K.FFM_THREADS, v, False) <= K.FFM_SMEM_LIMIT:
        tile = K.ffm_tiling(n, v, r, False)[0]
        assert torch.equal(_rows_emulation(prog, x, tile), want)


@pytest.mark.parametrize("name", SUMMED)
def test_chunked_fold_passes_nan_and_inf(name):
    """A decode of (0, inf) gives NaN (0 * inf) at word 0 and inf past it:
    the emulated order passes them as the stage does."""
    v = 65
    prog = TF.compile_program(problem=f"{name}:{v}", bits_per_var=16)
    prog = dataclasses.replace(prog, domains=((0.0, math.inf),) * v)
    x = _words(2, 8, v, 16, seed=1)
    x[0, 0, 3] = 0                      # NaN in the first chunk
    x[1, 2, 64] = 0                     # NaN past it
    x[1, 5] = 0                         # a row of NaN
    want = prog.stage(x)
    assert torch.isnan(want).any() or torch.isinf(want).any()
    for chunk in (K.ffm_tiling(8, v, 2, True)[1], 1, 7):
        got = _spread_emulation(prog, x, chunk)
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
