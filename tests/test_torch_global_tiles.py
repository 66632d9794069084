"""How K1's global form cuts its work into blocks (CPU).

`operators_tiling` picks ga_operators' tile of pairs and chunk of
variables, and `best_split` ga_best's cluster of slices; the CUDA launchers
take both and refuse what their kernels cannot run.  These tests hold the
choices to what the launchers check: a tile fits its shared-memory budget,
the tiles and chunks cover every (pair, variable) of a replica once, and
the slices cover a row of y once, with every block of a cluster given some.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ga_step as K  # noqa: E402

VS = (1, 2, 3, 64, 100, 1000, 4096)
NS = (2, 4, 64, 8192, 65536, 1 << 20)
RS = (1, 16, 128)


@pytest.mark.parametrize("r", RS)
@pytest.mark.parametrize("v", VS)
@pytest.mark.parametrize("n", NS)
def test_operators_tile_fits_and_covers(n, v, r):
    tile, chunk = K.operators_tiling(n, v, r)
    half = n // 2
    assert tile >= 1 and tile & (tile - 1) == 0 and half % tile == 0
    assert tile <= K.OPS_TILE_PAIRS
    assert K.operators_tile_bytes(tile, chunk) <= K.OPS_SMEM_LIMIT
    assert 1 <= chunk <= min(v, K.OPS_CHUNK)
    # the chunks [j0, j0 + chunk) of the grid's second axis cover V once
    widths = [min(chunk, v - j0) for j0 in range(0, v, chunk)]
    assert sum(widths) == v and min(widths) >= 1
    assert len(widths) == -(-v // chunk)
    # the tiles of the grid's first axis cover the pairs of a replica once
    assert list(range(0, half, tile)) == [b * tile
                                         for b in range(half // tile)]


@pytest.mark.parametrize("r", RS)
@pytest.mark.parametrize("v", VS)
def test_operators_tile_is_cut_only_to_fill_the_grid(v, r):
    """The tile is the largest power of two up to OPS_TILE_PAIRS that fits
    the budget, halved only while the grid is short of OPS_GRID blocks and
    the tile holds more than OPS_ITEMS items."""
    n = 8192
    tile, chunk = K.operators_tiling(n, v, r)
    chunks = -(-v // chunk)
    largest = K.OPS_TILE_PAIRS
    while K.operators_tile_bytes(largest, chunk) > K.OPS_SMEM_LIMIT:
        largest //= 2
    assert tile <= largest
    if tile < largest:      # it was halved: the tile twice as large was
        twice = 2 * tile    # too few blocks for the card, and large
        assert r * (n // 2 // twice) * chunks < K.OPS_GRID
        assert twice * chunk > K.OPS_ITEMS
    assert (tile * chunk <= K.OPS_ITEMS
            or r * (n // 2 // tile) * chunks >= K.OPS_GRID
            or tile == largest)


@pytest.mark.parametrize("n,v,r,tile", [(65536, 2, 16, 256),
                                        (8192, 2, 16, 256),
                                        (1024, 32, 16, 16),
                                        (4096, 64, 16, 32),
                                        (1024, 3, 128, 128),
                                        (1024, 6, 128, 128)])
def test_operators_tiling_at_the_measured_shapes(n, v, r, tile):
    """The tiles chosen at the shapes whose launch shapes were timed on
    the card (chip_smoke.py phase 17 and its blackbox and ring runs)."""
    assert K.operators_tiling(n, v, r) == (tile, min(v, K.OPS_CHUNK))


@pytest.mark.parametrize("n", [2, 4, 66, 1000, 4096, 4098, 8192, 12290,
                               65536, 65538, 1 << 20, (1 << 20) + 2])
def test_best_split_covers_a_row_once(n):
    blocks, slice_ = K.best_split(n)
    assert 1 <= blocks <= K.MAX_CLUSTER
    assert slice_ % 4 == 0
    covered = []
    for rank in range(blocks):
        lo, hi = rank * slice_, min(n, (rank + 1) * slice_)
        assert hi > lo, f"block {rank} of {blocks} has no values"
        covered.extend(range(lo, hi))
    assert covered == list(range(n))


@pytest.mark.parametrize("n,blocks", [(2, 1), (4096, 1), (4098, 2),
                                      (8192, 2), (20000, 5), (65536, 8),
                                      (1 << 20, 8)])
def test_best_split_grows_the_cluster_with_n(n, blocks):
    assert K.best_split(n)[0] == blocks


@pytest.mark.parametrize("n,v", [(2, 1), (4, 3), (16, 5), (64, 64),
                                 (1024, 2)])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_child_store_covers_the_tile_once(n, v, offset):
    """ga_operators' store when a chunk is the whole row: a scalar head up
    to 16-byte alignment, 4-word stores, a scalar tail; at any word offset
    of x' they write each of the tile's 2 x tile x V words once."""
    tile, chunk = K.operators_tiling(n, v, 4)
    assert chunk == v
    words = 2 * tile * v
    for pr0 in range(0, n // 2, tile):
        start = offset + 2 * pr0 * v
        head = min(words, ((16 - (4 * start) % 16) % 16) // 4)
        body = (words - head) // 4
        seen = list(range(head))
        for q in range(body):
            assert (start + head + 4 * q) % 4 == 0
            seen.extend(range(head + 4 * q, head + 4 * q + 4))
        seen.extend(range(head + 4 * body, words))
        assert seen == list(range(words))
        assert words - head - 4 * body < 4
