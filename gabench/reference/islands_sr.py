"""The island GA on CEC 2017 F5's form, written out plainly: what a cell of
`n_islands` populations a replica with ring migration, each scored by the
shifted and rotated Rastrigin, must produce.

This is `islands.py` with its fitness replaced, restated here whole since a
reference imports nothing but torch and NumPy.  The fitness is F5 as the
suite's `cec17_func.cpp` computes it (`sr_func`, then `rastrigin_func`,
plus F5's bias 500), in float32 with every operation rounded on its own and
every sum left to right:

  * x_j = lo + u_j * span, the decode on [-100, 100];
  * y_j = (x_j - o_j) * 0.0512 (the shrink rate 5.12 / 100);
  * z_i = (...(y_0 M_i0 + y_1 M_i1) + ...) + y_{V-1} M_i,V-1;
  * f = (...(t_0 + t_1) + ...) + t_{V-1} + 500, t_i = z_i^2 - 10
    cos(2 pi z_i) + 10.

The shift o and rotation M are not the suite's files but a synthetic pair
made from a seed, in float64 and then cast to float32 (`sr_data`):
``default_rng([2017, 5, V])``, o ~ U(-80, 80)^V, A ~ U(-1, 1)^(V x V), M
the modified Gram-Schmidt orthonormalisation of A's rows with every dot
product summed left to right.

The island GA itself is `islands.py`'s.  Each island is one population of `plain.py`'s GA (its clocking, decode,
fitness and operators, restated here, since a reference imports nothing
but torch and NumPy), and the islands of a replica exchange individuals
in a ring, the rule set of the JAX package's `core/islands.py`:

  * a replica seeded s draws one splitmix stream of I x (2N + V N/2 +
    2 V N) words from s, cut island by island into the selection [2, N],
    crossover [V, N/2] and mutation [V, N] banks and the initial
    population [N, V] (clocked 8 times and truncated to c bits), as
    `init_islands_fast` cuts it;
  * the run goes in intervals of `migrate_every` generations.  At an
    interval's end each island's population is scored (the migration
    fitness), island i's first-occurrence best row replaces island
    (i + 1) mod I's first-occurrence worst row, and the next generation
    scores the spliced population whole, so the spliced rows are
    re-evaluated;
  * each island's best is folded over the interval's generations (the
    first index holding the population's least fitness, kept on strict
    improvement), and a replica's best is folded once an interval: the
    first island holding the interval's least, kept on strict
    improvement.

Departures from the JAX package's `core/islands.py`, each the port's
behaviour: the best is folded at every interval (the JAX package folds a
resident launch's intervals first, which under ties between islands moves
best_x with the plan); `run` rounds `gens` up to whole intervals, as the
port's island segment does; the islands advance together as one stacked
tensor, which changes no word, since no operation mixes islands outside
the ring.

`run` samples the trajectory once a launch unit of `unit` generations
(whole intervals): the least of the unit's interval bests over the
islands, and the mean over the islands (NumPy's float32 mean, as the port
takes it) of each island's mean migration fitness at the unit's last
interval, as the `fused-islands` backend reports it on its resident plan.
`means="generations"` takes the mean over the unit's generations and
islands of the populations' means instead, as the `islands` backend (one
interval a sample) reports it.  `fitness_dtype=torch.bfloat16` computes
every fitness, the migration fitness too, in the next precision down: the
control that the comparison must reject.

The harness's hooks: `shape_of`, `leaf_shapes` (replicas first, then
islands), `evals_per_generation` (I N), `State`, `init`, `run`,
`traj_unit` (`gens_per_epoch`) and `cpu_cut`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

# the reference multiplies no matrices, and a float32 product on the card
# would otherwise be allowed to round to TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class Shape:
    """What the GA's arithmetic depends on, with the ring."""

    problem: str                 # "rastrigin_sr"
    n: int                       # population an island
    v: int                       # variables
    c: int                       # bits a variable
    mutation_rate: float
    steps_per_draw: int
    minimize: bool = True
    n_islands: int = 2           # islands a replica
    migrate_every: int = 16      # generations between migrations

    @property
    def p(self) -> int:
        return max(1, math.ceil(self.n * self.mutation_rate))

    @property
    def idx_bits(self) -> int:
        return max(1, math.ceil(math.log2(self.n)))

    @property
    def cut_bits(self) -> int:
        return max(1, math.ceil(math.log2(self.c + 1)))

    @property
    def var_mask(self) -> int:
        return (1 << self.c) - 1

    @property
    def state_words(self) -> int:
        """LFSR and population words of one island."""
        n, v = self.n, self.v
        return n * v + 2 * n + v * (n // 2) + v * n


class State(NamedTuple):
    x: torch.Tensor       # int32 [R, I, N, V]
    sel: torch.Tensor     # int32 [R, I, 2, N]
    cross: torch.Tensor   # int32 [R, I, V, N/2]
    mut: torch.Tensor     # int32 [R, I, V, N]
    k: torch.Tensor       # int32 [R, I] generations run


class Run(NamedTuple):
    state: State
    best: torch.Tensor        # float32 [R]
    best_x: torch.Tensor      # int32 [R, V]
    traj_best: torch.Tensor   # float32 [R, T]
    traj_mean: torch.Tensor   # float32 [R, T]


# the domain of the problems a configuration may name
DOMAINS = {"rastrigin_sr": (-100.0, 100.0)}
SHRINK = 0.0512
_DATA = {}      # (V, device) -> (o, M) float32 tensors


def _dot(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The dot product over the last axis, summed left to right."""
    acc = a[..., 0] * b[..., 0]
    for k in range(1, a.shape[-1]):
        acc = acc + a[..., k] * b[..., k]
    return acc


def sr_data(v: int):
    """(o [V], M [V, V]) in float64: the seeded shift and the modified
    Gram-Schmidt rotation of the module's docstring."""
    rng = np.random.default_rng([2017, 5, v])
    o = rng.uniform(-80.0, 80.0, v)
    a = rng.uniform(-1.0, 1.0, (v, v))
    q = np.zeros_like(a)
    for i in range(v):
        w = a[i].copy()
        for j in range(i):
            w = w - _dot(q[j], w) * q[j]
        q[i] = w / np.sqrt(_dot(w, w))
    return o, q


def _device_data(v: int, device):
    key = (v, str(device))
    if key not in _DATA:
        o, m = sr_data(v)
        _DATA[key] = tuple(torch.from_numpy(t.astype(np.float32)).to(device)
                           for t in (o, m))
    return _DATA[key]


def shape_of(config: dict) -> Shape:
    """The shape of a configuration file's spec."""
    spec = config["spec"]
    name, _, v = spec["problem"].partition(":")
    return Shape(problem=name, n=spec["n"], v=int(v), c=spec["bits_per_var"],
                 mutation_rate=spec["mutation_rate"],
                 steps_per_draw=spec["steps_per_draw"],
                 minimize=spec["minimize"], n_islands=spec["n_islands"],
                 migrate_every=spec["migrate_every"])


def leaf_shapes(shape: Shape, replicas: int) -> tuple:
    """The int32 state leaves' shapes, in `State`'s order (the port's)."""
    n, v, ri = shape.n, shape.v, (replicas, shape.n_islands)
    return ri + (n, v), ri + (2, n), ri + (v, n // 2), ri + (v, n), ri


def evals_per_generation(shape: Shape) -> int:
    """Fitness evaluations one replica makes a generation: a population's
    an island."""
    return shape.n_islands * shape.n


def traj_unit(config: dict) -> int:
    """Generations one trajectory sample covers: a resident launch's."""
    return config["spec"]["gens_per_epoch"]


def cpu_cut(config: dict) -> dict:
    """The configuration cut to a CPU test's size, on the resident plan
    still: V <= 4, N = 16, 3 replicas of at most 4 islands, a migration
    every 2 generations, 2 intervals a launch, and jobs and chunks of 8
    generations (4 intervals, 2 launches)."""
    spec = dict(config["spec"])
    name, _, v = spec["problem"].partition(":")
    spec.update(problem=f"{name}:{min(int(v), 4)}", n=16, n_repeats=3,
                n_islands=max(2, min(spec["n_islands"], 4)), migrate_every=2,
                generations=8, gens_per_epoch=4)
    return dict(config, spec=spec, chunk_generations=8)


def seed_words(seed: int, count: int) -> np.ndarray:
    """`count` non-zero uint32 words of a splitmix hash of `seed`."""
    base = int(seed) & 0xFFFFFFFF
    idx = (np.arange(1, count + 1, dtype=np.uint64)
           + np.uint64(base) * np.uint64(0x9E3779B9))
    z = idx * np.uint64(0xBF58476D1CE4E5B9)
    z ^= z >> np.uint64(31)
    z = z * np.uint64(0x94D049BB133111EB)
    z ^= z >> np.uint64(27)
    out = (z & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return np.where(out == 0, np.uint32(0xDEADBEEF), out)


def clock(s: torch.Tensor, t: int) -> torch.Tensor:
    """Each register clocked t times: feedback s31 ^ s21 ^ s1 ^ s0 shifted
    in at bit 0 (int32 words; bit 0 of an arithmetic shift is a logical
    one's)."""
    for _ in range(t):
        fb = ((s >> 31) ^ (s >> 21) ^ (s >> 1) ^ s) & 1
        s = (s << 1) | fb
    return s


def top_bits(r: torch.Tensor, bits: int) -> torch.Tensor:
    """The `bits` most significant bits of each word, 1 <= bits <= 31."""
    return (r >> (32 - bits)) & ((1 << bits) - 1)


def fitness(shape: Shape, x: torch.Tensor,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """F5's form of the module's docstring, as float32 [..., N] (computed
    in `dtype`: the decode in float32, then everything in `dtype`)."""
    if shape.problem not in DOMAINS:
        raise ValueError(f"the reference has no problem {shape.problem!r}")
    lo, hi = DOMAINS[shape.problem]
    lo_t = torch.full((shape.v,), lo, dtype=torch.float32, device=x.device)
    span = torch.full((shape.v,), np.float32((hi - lo) / shape.var_mask),
                      dtype=torch.float32, device=x.device)
    u = (x & shape.var_mask).to(torch.float32)
    val = (lo_t + u * span).to(dtype)
    o, m = (t.to(dtype) for t in _device_data(shape.v, x.device))
    y = (val - o) * SHRINK
    z = y[..., 0:1] * m[:, 0]
    for j in range(1, shape.v):
        z = z + y[..., j:j + 1] * m[:, j]
    terms = z * z - 10.0 * torch.cos(2.0 * math.pi * z) + 10.0
    acc = terms[..., 0]
    for i in range(1, shape.v):
        acc = acc + terms[..., i]
    return (acc + 500.0).to(torch.float32)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -2, idx.unsqueeze(-1).expand(*idx.shape,
                                                        x.shape[-1]))


def generation(shape: Shape, pop: State, y: torch.Tensor) -> State:
    """Tournament selection, single-point crossover and XOR mutation of
    one generation of each population of a flat stack [L, ...] scored by
    y [L, N]."""
    spd = shape.steps_per_draw
    sel = clock(pop.sel, spd)
    i1 = top_bits(sel[:, 0, :], shape.idx_bits).to(torch.int64)
    i2 = top_bits(sel[:, 1, :], shape.idx_bits).to(torch.int64)
    if shape.n & (shape.n - 1):
        i1, i2 = i1 % shape.n, i2 % shape.n
    y1, y2 = torch.gather(y, -1, i1), torch.gather(y, -1, i2)
    first = (y1 <= y2) if shape.minimize else (y1 >= y2)
    w = torch.where(first.unsqueeze(-1), _rows(pop.x, i1), _rows(pop.x, i2))

    cross = clock(pop.cross, spd)
    cut = torch.clamp_max(top_bits(cross, shape.cut_bits), shape.c)
    tail = (torch.full_like(cut, shape.var_mask) >> cut).transpose(-1, -2)
    w1, w2 = w[:, 0::2, :], w[:, 1::2, :]
    z = torch.stack([(w1 & ~tail) | (w2 & tail),
                     (w2 & ~tail) | (w1 & tail)], dim=-2).reshape(w.shape)

    mut = clock(pop.mut, spd)
    p = min(shape.p, shape.n)
    flips = top_bits(mut, shape.c).transpose(-1, -2)
    z[:, :p, :] ^= flips[:, :p, :]
    return State(z, sel, cross, mut, pop.k + 1)


def init(shape: Shape, seeds, device) -> State:
    """One replica a seed, its islands cut from the seed's one stream."""
    n, v, i = shape.n, shape.v, shape.n_islands
    half = n // 2
    per = 2 * n + v * half + 2 * v * n
    words = np.stack([seed_words(s, i * per).reshape(i, per)
                      for s in seeds])
    w = torch.from_numpy(words.view(np.int32)).to(device)
    ri = (len(seeds), i)
    a, b, c = 2 * n, 2 * n + v * half, 2 * n + v * half + v * n
    x = top_bits(clock(w[..., c:].reshape(ri + (n, v)), 8), shape.c)
    return State(x=x.contiguous(),
                 sel=w[..., :a].reshape(ri + (2, n)).contiguous(),
                 cross=w[..., a:b].reshape(ri + (v, half)).contiguous(),
                 mut=w[..., b:c].reshape(ri + (v, n)).contiguous(),
                 k=torch.zeros(ri, dtype=torch.int32, device=device))


def _first(y: torch.Tensor, best: bool, minimize: bool) -> torch.Tensor:
    """Each population's first index holding its least (most) fitness, or
    with `best` False its worst's; [..., N] -> int64 [..., 1]."""
    low = minimize == best
    return (torch.argmin(y, dim=-1) if low
            else torch.argmax(y, dim=-1)).unsqueeze(-1)


def ring(shape: Shape, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One ring migration of x [R, I, N, V] scored by y [R, I, N]: island
    i's best row in island (i + 1) mod I's worst slot."""
    mini = shape.minimize
    elite = _rows(x, _first(y, True, mini)).squeeze(-2)       # [R, I, V]
    worst = _first(y, False, mini)                              # [R, I, 1]
    x = x.clone()
    x.scatter_(-2, worst.unsqueeze(-1).expand(*worst.shape, shape.v),
               torch.roll(elite, 1, dims=1).unsqueeze(-2))
    return x


def run(shape: Shape, st: State, gens: int, unit: int = None,
        fitness_dtype: torch.dtype = torch.float32,
        means: str = "migration") -> Run:
    """`gens` generations from `st`, rounded up to whole intervals; the
    trajectory sampled once a launch unit of `unit` generations (a
    multiple of `migrate_every`, one interval where not given; the last
    unit may be shorter)."""
    e, mini = shape.migrate_every, shape.minimize
    unit = unit or e
    if unit % e:
        raise ValueError(f"a launch unit of {unit} generations is not whole "
                         f"intervals of {e}")
    per = unit // e
    if means not in ("migration", "generations"):
        raise ValueError(f"means must be 'migration' or 'generations', "
                         f"got {means!r}")
    intervals = max(1, math.ceil(gens / e))
    r, i = st.x.shape[:2]
    dev = st.x.device
    inf = math.inf if mini else -math.inf
    flat = State(*(t.reshape((r * i,) + t.shape[2:]) for t in st))
    best = torch.full((r,), inf, dtype=torch.float32, device=dev)
    best_x = torch.zeros((r, shape.v), dtype=torch.int32, device=dev)
    rows = torch.arange(r, device=dev)
    tb, tm, unit_b, unit_m = [], [], [], []
    for t in range(intervals):
        ib = torch.full((r * i,), inf, dtype=torch.float32, device=dev)
        ix = torch.zeros((r * i, shape.v), dtype=torch.int32, device=dev)
        for _ in range(e):
            y = fitness(shape, flat.x, fitness_dtype)
            idx = _first(y, True, mini)
            gb = torch.gather(y, -1, idx).squeeze(-1)
            better = (gb < ib) if mini else (gb > ib)
            ib = torch.where(better, gb, ib)
            ix = torch.where(better.unsqueeze(-1),
                             _rows(flat.x, idx).squeeze(-2), ix)
            if means == "generations":
                unit_m.append(torch.mean(y, dim=-1).reshape(r, i))
            flat = generation(shape, flat, y)
        ymig = fitness(shape, flat.x, fitness_dtype).reshape(r, i, -1)
        x = ring(shape, flat.x.reshape(r, i, shape.n, shape.v), ymig)
        flat = flat._replace(x=x.reshape(r * i, shape.n, shape.v))
        # the replica's best: the first island holding the interval's least
        ib, ix = ib.reshape(r, i), ix.reshape(r, i, shape.v)
        isl = (torch.argmin(ib, dim=1) if mini else torch.argmax(ib, dim=1))
        ep_y, ep_x = ib[rows, isl], ix[rows, isl]
        better = (ep_y < best) if mini else (ep_y > best)
        best = torch.where(better, ep_y, best)
        best_x = torch.where(better.unsqueeze(-1), ep_x, best_x)
        unit_b.append(torch.amin(ib, dim=1) if mini
                      else torch.amax(ib, dim=1))
        if (t + 1) % per == 0 or t + 1 == intervals:
            tb.append(torch.stack(unit_b).amin(dim=0) if mini
                      else torch.stack(unit_b).amax(dim=0))
            if means == "migration":
                m = torch.mean(ymig, dim=-1).cpu().numpy()       # [R, I]
            else:
                m = torch.stack(unit_m, dim=-1).cpu().numpy().reshape(r, -1)
            tm.append(torch.from_numpy(np.ascontiguousarray(
                m.mean(axis=-1))).to(dev))
            unit_b, unit_m = [], []
    out = State(*(t.reshape((r, i) + t.shape[1:]) for t in flat))
    return Run(out, best, best_x, torch.stack(tb, dim=-1),
               torch.stack(tm, dim=-1))
