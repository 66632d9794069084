"""The paper's GA, written out plainly: what a cell's run must produce.

Seeds, state layout, LFSR clocking, decode, fitness, tournament
selection, single-point crossover, XOR mutation and the best fold, each
in the order of operations that makes the result bit for bit the one the
GA defines (the port's `reference` backend computes the same words):

  * every LFSR word is an int32 holding the uint32 bit pattern of a
    32-bit Fibonacci register with taps r^32 + r^22 + r^2 + 1, clocked
    `steps_per_draw` times a draw, its draw truncated to its top bits;
  * a replica seeded s draws its words from a splitmix hash of s, in the
    order selection [2, N], crossover [V, N/2], mutation [V, N] and the
    initial population [N, V], which is clocked 8 times and truncated to
    c bits;
  * float32 fitness: the decode lo + u * span, then each term and the sum
    over V left to right, every operation rounded on its own;
  * a replica's best is the first index holding its population's least
    fitness, folded into the running best on strict improvement.

`run` samples the trajectory once a launch unit of `unit` generations
(the population best and mean of the unit's last generation), as the
fused executor reports it.  `fitness_dtype=torch.bfloat16` computes the
fitness in the next precision down: the control that the comparison must
reject.

A configuration file names its reference (`"reference"`, this file where
absent), and the harness takes from it everything that depends on the
configuration's shape: `shape_of`, `leaf_shapes`, `evals_per_generation`,
`State`, `init`, `run`, `traj_unit` and `cpu_cut`.  This one is one
population a replica, state [R, N, V] and its three banks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Shape:
    """What the GA's arithmetic depends on."""

    problem: str                 # "rastrigin"
    n: int                       # population
    v: int                       # variables
    c: int                       # bits a variable
    mutation_rate: float
    steps_per_draw: int
    minimize: bool = True

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
        """LFSR and population words of one replica."""
        n, v = self.n, self.v
        return n * v + 2 * n + v * (n // 2) + v * n


class State(NamedTuple):
    x: torch.Tensor       # int32 [R, N, V]
    sel: torch.Tensor     # int32 [R, 2, N]
    cross: torch.Tensor   # int32 [R, V, N/2]
    mut: torch.Tensor     # int32 [R, V, N]
    k: torch.Tensor       # int32 [R] generations run


class Run(NamedTuple):
    state: State
    best: torch.Tensor        # float32 [R]
    best_x: torch.Tensor      # int32 [R, V]
    traj_best: torch.Tensor   # float32 [R, T]
    traj_mean: torch.Tensor   # float32 [R, T]


# (domain, terms) of the problems a configuration may name
DOMAINS = {"rastrigin": (-5.12, 5.12)}


def shape_of(config: dict) -> Shape:
    """The shape of a configuration file's spec."""
    spec = config["spec"]
    name, _, v = spec["problem"].partition(":")
    return Shape(problem=name, n=spec["n"], v=int(v), c=spec["bits_per_var"],
                 mutation_rate=spec["mutation_rate"],
                 steps_per_draw=spec["steps_per_draw"],
                 minimize=spec["minimize"])


def leaf_shapes(shape: Shape, replicas: int) -> tuple:
    """The int32 state leaves' shapes, in `State`'s order (the port's)."""
    n, v, r = shape.n, shape.v, replicas
    return (r, n, v), (r, 2, n), (r, v, n // 2), (r, v, n), (r,)


def evals_per_generation(shape: Shape) -> int:
    """Fitness evaluations one replica makes a generation."""
    return shape.n


def traj_unit(config: dict) -> int:
    """Generations one trajectory sample covers: the fused executor
    samples once a launch, every other backend once a generation."""
    return (config["spec"]["gens_per_epoch"] if config["backend"] == "fused"
            else 1)


def cpu_cut(config: dict) -> dict:
    """The configuration cut to a CPU test's size: the same problem,
    operators and launch folding; V <= 4, N = 16, 3 replicas,
    8-generation jobs and chunks."""
    spec = dict(config["spec"])
    name, _, v = spec["problem"].partition(":")
    spec.update(problem=f"{name}:{min(int(v), 4)}", n=16, n_repeats=3,
                generations=8, gens_per_epoch=min(spec["gens_per_epoch"], 4))
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
    in at bit 0.  Bit 0 of an arithmetic right shift is the bit a logical
    one gives, so int32 words need no widening."""
    for _ in range(t):
        fb = ((s >> 31) ^ (s >> 21) ^ (s >> 1) ^ s) & 1
        s = (s << 1) | fb
    return s


def top_bits(r: torch.Tensor, bits: int) -> torch.Tensor:
    """The `bits` most significant bits of each word, 1 <= bits <= 31."""
    return (r >> (32 - bits)) & ((1 << bits) - 1)


def init(shape: Shape, seeds, device) -> State:
    """One replica a seed, stacked."""
    n, v = shape.n, shape.v
    half = n // 2
    total = 2 * n + v * half + 2 * v * n
    words = np.stack([seed_words(s, total) for s in seeds])
    w = torch.from_numpy(words.view(np.int32)).to(device)
    r = len(seeds)
    a, b, c = 2 * n, 2 * n + v * half, 2 * n + v * half + v * n
    x = top_bits(clock(w[:, c:].reshape(r, n, v), 8), shape.c)
    return State(x=x.contiguous(),
                 sel=w[:, :a].reshape(r, 2, n).contiguous(),
                 cross=w[:, a:b].reshape(r, v, half).contiguous(),
                 mut=w[:, b:c].reshape(r, v, n).contiguous(),
                 k=torch.zeros((r,), dtype=torch.int32, device=device))


def fitness(shape: Shape, x: torch.Tensor,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Rastrigin, sum over V of x^2 - 10 cos(2 pi x) + 10, as float32 [R, N]
    (computed in `dtype`)."""
    if shape.problem not in DOMAINS:
        raise ValueError(f"the reference has no problem {shape.problem!r}")
    lo, hi = DOMAINS[shape.problem]
    lo_t = torch.full((shape.v,), lo, dtype=torch.float32, device=x.device)
    span = torch.full((shape.v,), np.float32((hi - lo) / shape.var_mask),
                      dtype=torch.float32, device=x.device)
    u = (x & shape.var_mask).to(torch.float32)
    val = (lo_t + u * span).to(dtype)
    terms = val * val - 10.0 * torch.cos(2.0 * math.pi * val) + 10.0
    acc = terms[..., 0]
    for i in range(1, shape.v):
        acc = acc + terms[..., i]
    return acc.to(torch.float32)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -2, idx.unsqueeze(-1).expand(*idx.shape,
                                                        x.shape[-1]))


def generation(shape: Shape, st: State, y: torch.Tensor) -> State:
    """Selection, crossover and mutation of one generation scored by y."""
    spd = shape.steps_per_draw
    sel = clock(st.sel, spd)
    i1 = top_bits(sel[:, 0, :], shape.idx_bits).to(torch.int64)
    i2 = top_bits(sel[:, 1, :], shape.idx_bits).to(torch.int64)
    if shape.n & (shape.n - 1):
        i1, i2 = i1 % shape.n, i2 % shape.n
    y1, y2 = torch.gather(y, -1, i1), torch.gather(y, -1, i2)
    first = (y1 <= y2) if shape.minimize else (y1 >= y2)
    w = torch.where(first.unsqueeze(-1), _rows(st.x, i1), _rows(st.x, i2))

    cross = clock(st.cross, spd)
    cut = torch.clamp_max(top_bits(cross, shape.cut_bits), shape.c)
    tail = (torch.full_like(cut, shape.var_mask) >> cut).transpose(-1, -2)
    w1, w2 = w[:, 0::2, :], w[:, 1::2, :]
    z = torch.stack([(w1 & ~tail) | (w2 & tail),
                     (w2 & ~tail) | (w1 & tail)], dim=-2).reshape(w.shape)

    mut = clock(st.mut, spd)
    p = min(shape.p, shape.n)
    flips = top_bits(mut, shape.c).transpose(-1, -2)
    z[:, :p, :] ^= flips[:, :p, :]
    return State(z, sel, cross, mut, st.k + 1)


def run(shape: Shape, st: State, gens: int, unit: int = 1,
        fitness_dtype: torch.dtype = torch.float32) -> Run:
    """`gens` generations from `st`; the trajectory sampled at the last
    generation of each launch unit of `unit` (the last unit may be
    shorter)."""
    r = st.x.shape[0]
    dev = st.x.device
    best = torch.full((r,), math.inf if shape.minimize else -math.inf,
                      dtype=torch.float32, device=dev)
    best_x = torch.zeros((r, shape.v), dtype=torch.int32, device=dev)
    tb, tm = [], []
    for g in range(gens):
        y = fitness(shape, st.x, fitness_dtype)
        idx = (torch.argmin(y, dim=-1) if shape.minimize
               else torch.argmax(y, dim=-1)).unsqueeze(-1)
        gb = torch.gather(y, -1, idx).squeeze(-1)
        gx = _rows(st.x, idx).squeeze(-2)
        better = (gb < best) if shape.minimize else (gb > best)
        best = torch.where(better, gb, best)
        best_x = torch.where(better.unsqueeze(-1), gx, best_x)
        if (g + 1) % unit == 0 or g + 1 == gens:
            tb.append(gb)
            tm.append(torch.mean(y, dim=-1))
        st = generation(shape, st, y)
    return Run(st, best, best_x, torch.stack(tb, dim=-1),
               torch.stack(tm, dim=-1))
