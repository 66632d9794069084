"""A segment's way to the host (`ga.backends.pack_segment`,
`read_segment`, `build_segment`) against the host code it replaced, copied
here as twins.  The island ring's fold on the tensors' own device
(`fold_island_bests`) against `twin_fold`, bit for bit on planted ties
between islands and between intervals, NaN, +-inf, nothing better than
+-inf, maximisation, an uneven last launch, one replica and 2 to 8
islands; and whole segments of every island plan the CPU reaches and of
the single topology (reference unstacked and stacked, fused with a short
last launch, a fitness giving NaN and +-inf), each field of `Segment` and
`ReplicaStats` with its dtype against the twins' reduction of the arrays
that segment reduced (`twin_single` is the single topology's old host
copies and NumPy reduction).  Only torch and the port are imported, so
`tests/test_torch_cuda.py` reuses the twins on the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_island_fold.py
"""

import numpy as np
import pytest
import torch

from repro_torch import convert, ga
from repro_torch.ga import backends as B
from repro_torch.launch.mesh import Mesh


@pytest.fixture(autouse=True)
def _no_ambient_cost_table(monkeypatch):
    """The plans here are the heuristic's or forced: no cost table found on
    the host may move them."""
    monkeypatch.setenv("REPRO_GA_COST_TABLE", "off")


def twin_fold(bys, bxs, tms, launches, r_, v, mini):
    """The segment's host fold as it was, interval by interval in NumPy:
    (best [R], best_x [R, V], traj_best [R, launches], traj_mean [R,
    launches])."""
    reduce = np.min if mini else np.max
    ends = np.cumsum([t.shape[0] for t in bys])
    by = torch.cat(bys).cpu().numpy().reshape(ends[-1], r_, -1)
    bx = convert.words_to_numpy(torch.cat(bxs)).reshape(
        ends[-1], r_, -1, v)
    tm = torch.stack(tms).cpu().numpy().reshape(launches, r_, -1)
    rep_y = np.full((r_,), np.inf if mini else -np.inf, np.float32)
    rep_x = np.zeros((r_, v), np.uint32)
    rows = np.arange(r_)
    for t in range(ends[-1]):
        i = np.argmin(by[t], axis=1) if mini else np.argmax(by[t], axis=1)
        ep_y, ep_x = by[t][rows, i], bx[t][rows, i]
        better = ep_y < rep_y if mini else ep_y > rep_y
        rep_y = np.where(better, ep_y, rep_y)
        rep_x = np.where(better[:, None], ep_x, rep_x)
    tb_rep = np.stack([reduce(by[a:b], axis=(0, 2)) for a, b in
                       zip(np.concatenate([[0], ends[:-1]]), ends)],
                      axis=1)                             # [R, launches]
    tm_rep = np.ascontiguousarray(tm.mean(axis=2).T)
    return rep_y, rep_x, tb_rep, tm_rep


def twin_single(out, unstacked, mini):
    """`SingleTopology.segment`'s host reduction as it was, of an executor
    block's `out` (state, best_y, best_x, traj_best, traj_mean): (best_y,
    best_x, traj_best, traj_mean, per_repeat as (best, best_x, traj_best,
    traj_mean) or None)."""
    _state, by, bx, tb, tm = out
    if unstacked:
        return (float(by), convert.words_to_numpy(bx), tb.cpu().numpy(),
                tm.cpu().numpy(), None)
    per_rep = by.cpu().numpy()                     # [R]
    bx = convert.words_to_numpy(bx)                # [R, V]
    tb, tm = tb.cpu().numpy(), tm.cpu().numpy()    # [R, T]
    r = int(np.argmin(per_rep) if mini else np.argmax(per_rep))
    reduce = np.min if mini else np.max
    best_tb, mean_tm = reduce(tb, axis=0), tm.mean(axis=0)
    return (float(per_rep[r]), bx[r], best_tb, mean_tm,
            (per_rep, bx, tb, tm))


def twin_island_segment(rep_y, rep_x, tb, tm, mini):
    """The island segment's fields as the host built them from
    `twin_fold`'s arrays, in `twin_single`'s order."""
    r = int(np.argmin(rep_y) if mini else np.argmax(rep_y))
    reduce = np.min if mini else np.max
    return (float(rep_y[r]), rep_x[r], reduce(tb, axis=0), tm.mean(axis=0),
            (rep_y, rep_x, tb, tm))


def assert_segment(seg, want):
    """Every field of `seg` and of its `per_repeat` equals the twin's
    `want` in type, dtype, shape and bits."""
    best_y, best_x, tb, tm, per = want
    assert type(seg.best_y) is float
    assert_same_bits((np.float64(seg.best_y).reshape(1).view(np.uint64),
                      seg.best_x, seg.traj_best, seg.traj_mean),
                     (np.float64(best_y).reshape(1).view(np.uint64),
                      best_x, tb, tm))
    rep = seg.telemetry.per_repeat
    if per is None:
        assert rep is None
    else:
        assert_same_bits((rep.best, rep.best_x, rep.traj_best,
                          rep.traj_mean), per)


def device_fold(bys, bxs, tms, r_, v, mini):
    """The port's fold, packed, and its one read-back, with the bytes it
    read."""
    words = B.fold_island_bests(bys, bxs, tms, r_, mini)
    return B.read_segment(words, r_, v, len(bys)), 4 * words.numel()


def assert_same_bits(got, want):
    """Arrays equal in dtype, shape and every bit (NaN payloads too)."""
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.ascontiguousarray(a).view(np.uint8),
                                      np.ascontiguousarray(b).view(np.uint8))


CASES = ("ties", "interval_ties", "nan", "inf", "all_worst", "all_nan")


def planted_bests(case, r_, i_, v, sizes, mini, seed, device="cpu"):
    """A segment's launch outputs as the runners hand them over (no
    replica axis when `r_` is None), with `case` planted: values drawn
    from {0, 1, 2} so islands and intervals tie; the extreme planted in
    two intervals of each replica; NaN in a fifth of the slots and at
    the extreme's interval; +-inf at random; every slot the worst value
    (+inf minimising, -inf maximising); every slot NaN."""
    g = torch.Generator().manual_seed(seed)
    r = r_ or 1
    t_ = sum(sizes)
    by = torch.randint(0, 3, (t_, r, i_), generator=g).float()
    worst = float("inf") if mini else float("-inf")
    nan = float("nan")
    if case == "interval_ties":
        best = -1.0 if mini else 3.0
        for j in range(r):
            a, b = torch.randperm(t_, generator=g)[:2].tolist()
            by[a, j, j % i_] = best
            by[b, j, (j + 1) % i_] = best
    elif case == "nan":
        by[torch.rand(by.shape, generator=g) < 0.2] = nan
        best = -1.0 if mini else 3.0
        by[t_ // 2, :, 0] = best
        by[t_ // 2, :, i_ - 1] = nan
        by[t_ - 1, :, i_ - 1] = best
    elif case == "inf":
        u = torch.rand(by.shape, generator=g)
        by[u < 0.1] = float("inf")
        by[u > 0.9] = float("-inf")
    elif case == "all_worst":
        by.fill_(worst)
    elif case == "all_nan":
        by.fill_(nan)
    bx = torch.randint(-2 ** 31, 2 ** 31, (t_, r, i_, v), generator=g,
                       dtype=torch.int64).to(torch.int32)
    tm = torch.rand((len(sizes), r, i_), generator=g) * 7
    if case == "nan":
        tm[0, 0, 0] = nan
    if r_ is None:
        by, bx, tm = by[:, 0], bx[:, 0], tm[:, 0]
    ends = np.cumsum([0] + list(sizes))
    return ([by[a:b].to(device) for a, b in zip(ends[:-1], ends[1:])],
            [bx[a:b].to(device) for a, b in zip(ends[:-1], ends[1:])],
            [t.to(device) for t in tm])


# (replicas, islands, V, intervals a launch); None: no replica axis
SHAPES = {
    "uneven": (2, 4, 3, (2, 2, 2, 2, 1)),      # 9 intervals at 2 a launch
    "longer_tail": (2, 2, 3, (1, 1, 2)),
    "islands8": (3, 8, 5, (2, 2, 2)),
    "one_launch": (1, 4, 3, (3,)),
    "one_replica": (None, 4, 3, (2, 2, 1)),
    "cell": (51, 8, 30, (2,) * 32),
}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("minimize", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_fold_matches_the_host_loop(case, minimize, shape):
    r_, i_, v, sizes = SHAPES[shape]
    bys, bxs, tms = planted_bests(case, r_, i_, v, sizes, minimize, seed=5)
    r = r_ or 1
    want = twin_fold(bys, bxs, tms, len(sizes), r, v, minimize)
    got, nbytes = device_fold(bys, bxs, tms, r, v, minimize)
    assert_same_bits(got, want)
    assert nbytes == 4 * (len(sizes) * r * i_ + r + r * v + len(sizes) * r)
    if case in ("all_worst", "all_nan"):
        assert np.all(got[0] == (np.inf if minimize else -np.inf))
        assert not got[1].any()


# whole segments: (backend, plan, spec fields, mesh shards, generations)
BASE = dict(problem="rastrigin:3", n=16, bits_per_var=10, mode="arith",
            mutation_rate=0.05, seed=3, n_repeats=2, n_islands=4,
            migrate_every=2, gens_per_epoch=4)
PLANS = {
    "islands": ("islands", "gridded", {}, 0, 18),
    "gridded": ("fused-islands", "gridded", {}, 0, 18),
    "resident": ("fused-islands", "resident", {}, 0, 18),
    "resident_one_replica": ("fused-islands", "resident",
                             {"n_repeats": 1}, 0, 18),
    "resident_maximise": ("fused-islands", "resident",
                          {"minimize": False}, 0, 18),
    # launches of 5, 5 and 4 generations: 1, 1 and 2 intervals
    "resident_free": ("fused-islands", "resident-free",
                      {"migration": "none", "gens_per_epoch": 5}, 0, 14),
    "streamed": ("fused-islands", "streamed", {"n_islands": 12}, 0, 18),
    "resident_sharded": ("fused-islands", "resident-sharded", {}, 2, 10),
    "gridded_sharded": ("fused-islands", "gridded", {}, 2, 10),
    "streamed_sharded": ("fused-islands", "streamed",
                         {"n_islands": 18}, 2, 10),
}


def spiky(v):
    """A sum of squares with NaN, +inf and -inf planted by region, so the
    trajectories and the bests carry all three."""
    y = (v * v).sum(-1)
    y = torch.where(v[..., 0] > 4.0, float("nan"), y)
    y = torch.where(v[..., 1] > 4.0, float("inf"), y)
    return torch.where(v[..., 1] < -4.5, float("-inf"), y)


SPIKY = {"problem": None, "fitness": spiky, "bounds": ((-5.12, 5.12),) * 3}
# the single topology: (backend, spec fields, generations); the fused
# launches run 4, 4 and 2 generations
SINGLE_BASE = dict(BASE, n_repeats=3, n_islands=1)
SINGLE = {
    "reference_unstacked": ("reference", {"n_repeats": 1}, 9),
    "reference_stacked": ("reference", {}, 9),
    "reference_maximise": ("reference", {"minimize": False}, 9),
    "fused_one_replica": ("fused", {"n_repeats": 1}, 10),
    "fused_stacked": ("fused", {}, 10),
    "fused_maximise": ("fused", {"minimize": False}, 10),
    "reference_unstacked_nan_inf": ("reference",
                                    dict(SPIKY, n_repeats=1), 9),
    "reference_nan_inf": ("reference", SPIKY, 9),
    "fused_nan_inf": ("fused", SPIKY, 10),
    "fused_nan_inf_maximise": ("fused", dict(SPIKY, minimize=False), 10),
}
CPU = ga.EngineOptions(device="cpu", cost_table=False, faults=False)


def _leaves_equal(a, b):
    for x, y in zip(a, b, strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


def keep_single_blocks(monkeypatch) -> list:
    """The list each single-topology executor block's output is appended
    to, from here on (`SingleTopology._runner` wrapped)."""
    seen = []
    real = B.SingleTopology._runner

    def keep(self, g):
        run = real(self, g)

        def runner(state):
            seen.append(run(state))
            return seen[-1]
        return runner

    monkeypatch.setattr(B.SingleTopology, "_runner", keep)
    return seen


def single_segment(name, monkeypatch):
    """A single-topology segment and `twin_single` of the executor block
    it reduced; the segment's state, gens and launches are the block's."""
    backend, extra, gens = SINGLE[name]
    spec = ga.GASpec(**dict(SINGLE_BASE, **extra))
    seen = keep_single_blocks(monkeypatch)
    eng = ga.Engine(spec, backend, options=CPU)
    state = eng.init_state()
    unstacked = state.x.dim() == 2
    assert unstacked == (backend == "reference" and spec.n_repeats == 1)
    seg = eng.backend.segment(state, gens)
    (out,) = seen
    _leaves_equal(seg.state, out[0])
    assert seg.gens == gens
    assert (seg.telemetry.topology.launches
            == eng.backend.executor.launches(gens)
            == (3 if backend == "fused" else 0))
    if "nan_inf" in name:
        tb = out[3].cpu().numpy()
        assert np.isnan(tb).any() and np.isinf(out[1].cpu().numpy()).any()
    return seg, twin_single(out, unstacked, spec.minimize)


def island_segment(name, monkeypatch):
    """An island segment under its plan and the twins' fold of the bests
    it folded; its state is the `islands` backend's."""
    backend, plan, extra, shards, gens = PLANS[name]
    spec = ga.GASpec(**dict(BASE, **extra))
    mesh = (Mesh([torch.device("cpu")] * shards, ("islands",)) if shards
            else None)
    opts = ga.EngineOptions(device=None if mesh else "cpu", mesh=mesh,
                            cost_table=False, faults=False,
                            plan_override=plan)
    seen = []
    real = B.fold_island_bests

    def keep(bys, bxs, tms, r_, mini):
        seen.append((list(bys), list(bxs), list(tms)))
        return real(bys, bxs, tms, r_, mini)

    monkeypatch.setattr(B, "fold_island_bests", keep)
    eng = ga.Engine(spec, backend, options=opts)
    seg = eng.backend.segment(eng.init_state(), gens)
    assert seg.telemetry.plan.mode == plan
    (bys, bxs, tms), = seen
    launches = seg.telemetry.topology.launches
    assert len(bys) == launches
    ref = ga.Engine(spec, "islands", options=CPU)
    _leaves_equal(seg.state, ref.backend.segment(ref.init_state(),
                                                 gens).state)
    mini, v = spec.minimize, spec.ga_config().v
    return seg, twin_island_segment(
        *twin_fold(bys, bxs, tms, launches, spec.n_repeats, v, mini), mini)


@pytest.mark.parametrize("name", list(PLANS) + list(SINGLE))
def test_segment_fields_match_the_host_loop(name, monkeypatch):
    """Every field of the segment and of its `per_repeat`, with its dtype,
    against the twins: the island plans' fold and the single topology's
    old host reduction (`per_repeat` None on the unstacked reference)."""
    make = single_segment if name in SINGLE else island_segment
    assert_segment(*make(name, monkeypatch))


def test_the_fold_stays_on_the_bests_device():
    """The fold's result is one int32 tensor on the bests' device; its
    read-back is the caller's."""
    bys, bxs, tms = planted_bests("ties", 2, 4, 3, (2, 1), True, seed=1)
    words = B.fold_island_bests(bys, bxs, tms, 2, True)
    assert words.dtype == torch.int32 and words.device == bys[0].device
    assert words.shape == (2 * 2 * 4 + 2 + 2 * 3 + 2 * 2,)
