"""Full-parallel Genetic Algorithm — the paper's datapath in PyTorch.

One `generation()` call is the paper's 3-clock pipeline beat: it evaluates all
N fitness values, runs N tournaments, N/2 single-point crossovers and P
mutations, producing the next population.

Chromosome layout: V variables of c bits each, stored as int32[N, V] (the
uint32 bit patterns; see `repro_torch.core.lfsr`).  V=2, c=m/2 reproduces
the paper exactly.

Every operator takes any number of leading batch axes: a stack of replicas
is int32[R, N, V] with banks [R, 2, N] / [R, V, N/2] / [R, V, N], and each
replica evolves exactly as it would alone.

Module → code map (paper Sec. 3):
  FFM   -> fitness_fn (see core/fitness.py; LUT = faithful, arith = float32)
  SM    -> tournament selection with per-slot LFSR pairs, MSB-truncated draws
  CM    -> mask-shift bitwise crossover, per-variable cut points (CMPQ1/CMPQ2)
  MM    -> XOR of the first P individuals with LFSR words
  SyncM -> the generation loop in `run_scan`
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import fitness as F
from repro_torch.core import lfsr


# Past this population size the onehot selection lane's (N, N) one-hot
# tournament matrices exceed the TPU kernel's VMEM share.  The CUDA kernel
# reads contestants from shared memory on either lane; the cap is kept so a
# spec validates the same way in both packages.
ONEHOT_MAX_N = 1024


@dataclasses.dataclass(frozen=True)
class GAConfig:
    n: int                       # population size N (even, paper uses 4..64)
    c: int                       # bits per variable (= m/2 for the paper)
    v: int = 2                   # number of variables packed per chromosome
    mutation_rate: float = 0.01  # MR; P = ceil(N * MR) individuals mutate
    minimize: bool = True        # SMMAXMIN
    steps_per_draw: int = 3      # LFSR clocks per generation (SyncM cadence)
    seed: int = 1234
    mode: str = "lut"            # "lut" (faithful ROMs) | "arith" (float32)
    sel_lane: str = "onehot"     # resolved lane ("onehot" | "gather");
                                 # "auto" lives on GASpec, never here

    def __post_init__(self):
        if self.n % 2:
            raise ValueError(f"N must be even (paper Sec. 2), got {self.n}")
        if not 1 <= self.c <= 31:
            raise ValueError(f"bits per variable must be in [1, 31], "
                             f"got {self.c}")
        if self.sel_lane not in ("onehot", "gather"):
            raise ValueError(
                f"sel_lane={self.sel_lane!r}: GAConfig carries a RESOLVED "
                "lane ('onehot' | 'gather'); 'auto' is resolved by GASpec")

    @property
    def m(self) -> int:
        return self.c * self.v

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


class GAState(NamedTuple):
    x: torch.Tensor           # int32[..., N, V] population
    sel_lfsr: torch.Tensor    # int32[..., 2, N]   SMLFSR1/2 per selection slot
    cross_lfsr: torch.Tensor  # int32[..., V, N/2] CMPQLFSR per crossover pair
    mut_lfsr: torch.Tensor    # int32[..., V, N]   MMLFSR per mutation slot
    k: torch.Tensor           # int32[...] generation counter


FitnessFn = Callable[[torch.Tensor], torch.Tensor]  # int32[..., N, V] -> [..., N]


# ---------------------------------------------------------------------------
# State init
# ---------------------------------------------------------------------------


def init_states(cfg: GAConfig, seeds, *, device) -> GAState:
    """One population per seed, stacked on a leading axis: entry i is
    bit-identical to `init_state` of `cfg` seeded `seeds[i]`.  The seed
    hashes run on the host in one batch; the warm-up clocks run on
    `device` over the whole stack."""
    n, v = cfg.n, cfg.v
    total = 2 * n + v * (n // 2) + v * n + v * n  # sel + cross + mut + init
    words = np.stack([lfsr.np_seeds(sd, total) for sd in seeds])
    s = torch.from_numpy(words.view(np.int32)).to(device)
    r = len(seeds)
    sel = s[:, : 2 * n].reshape(r, 2, n)
    cross = s[:, 2 * n: 2 * n + v * (n // 2)].reshape(r, v, n // 2)
    mut = s[:, 2 * n + v * (n // 2): 2 * n + v * (n // 2) + v * n]
    init_bank = s[:, -v * n:].reshape(r, n, v)
    # a few warmup clocks, then MSB-truncate to c bits per gene
    x = lfsr.truncate(lfsr.steps(init_bank, 8), cfg.c)
    return GAState(x=x, sel_lfsr=sel.contiguous(), cross_lfsr=cross.contiguous(),
                   mut_lfsr=mut.reshape(r, v, n).contiguous(),
                   k=torch.zeros((r,), dtype=torch.int32, device=device))


def init_state(cfg: GAConfig, *, device) -> GAState:
    """Seed every LFSR distinctly (the paper's CCseed) and draw the initial
    random population from a dedicated LFSR bank."""
    return GAState(*(leaf[0] for leaf in init_states(cfg, [cfg.seed],
                                                     device=device)))


def stack_states(states) -> GAState:
    """Stack single-population states on a new leading replica axis."""
    return GAState(*(torch.stack(leaves) for leaves in zip(*states)))


# ---------------------------------------------------------------------------
# The generation step (Algorithm 1, lines 3–14, fully parallel)
# ---------------------------------------------------------------------------


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx, :] per batch entry: x [..., N, V], idx int64 [..., N]."""
    return torch.gather(x, -2, idx.unsqueeze(-1).expand(*idx.shape,
                                                        x.shape[-1]))


def _select(x, y, sel_lfsr, cfg: GAConfig):
    """SM: N parallel 2-way tournaments."""
    sel_lfsr, r = lfsr.draw(sel_lfsr, cfg.steps_per_draw)
    i1 = lfsr.truncate(r[..., 0, :], cfg.idx_bits).to(torch.int64)
    i2 = lfsr.truncate(r[..., 1, :], cfg.idx_bits).to(torch.int64)
    if cfg.n & (cfg.n - 1):  # non power-of-two N: fold into range
        i1 = i1 % cfg.n
        i2 = i2 % cfg.n
    y1 = torch.gather(y, -1, i1)
    y2 = torch.gather(y, -1, i2)
    first_wins = (y1 <= y2) if cfg.minimize else (y1 >= y2)
    w = torch.where(first_wins.unsqueeze(-1), _rows(x, i1), _rows(x, i2))
    return w, sel_lfsr


def _crossover(w, cross_lfsr, cfg: GAConfig):
    """CM: N/2 parallel single-point crossovers, independent cut per variable.

    mask s = (2^c - 1) >> cut; offspring are (h1|t2, h2|t1) with
    h = w & ~s (head), t = w & s (tail) — paper Eqs. 12–20.
    """
    cross_lfsr, r = lfsr.draw(cross_lfsr, cfg.steps_per_draw)  # [..., V, N/2]
    cut = torch.clamp_max(lfsr.truncate(r, cfg.cut_bits), cfg.c)
    s = (torch.full_like(cut, cfg.var_mask) >> cut).transpose(-1, -2)  # [..., N/2, V]
    w1, w2 = w[..., 0::2, :], w[..., 1::2, :]                  # [..., N/2, V]
    h1, t1 = w1 & ~s, w1 & s
    h2, t2 = w2 & ~s, w2 & s
    z1 = h1 | t2
    z2 = h2 | t1
    z = torch.stack([z1, z2], dim=-2).reshape(w.shape)
    return z, cross_lfsr


def _mutate(z, mut_lfsr, cfg: GAConfig):
    """MM: XOR the first P offspring with LFSR words (paper Eq. 21 == XOR)."""
    mut_lfsr, r = lfsr.draw(mut_lfsr, cfg.steps_per_draw)      # [..., V, N]
    rbits = lfsr.truncate(r, cfg.c).transpose(-1, -2)          # [..., N, V]
    mut_row = (torch.arange(cfg.n, device=z.device) < cfg.p).unsqueeze(-1)
    return torch.where(mut_row, z ^ rbits, z), mut_lfsr


def generation(state: GAState, cfg: GAConfig, fit: FitnessFn
               ) -> Tuple[GAState, torch.Tensor]:
    """One full GA generation. Returns (next_state, fitness_of_current_pop)."""
    y = fit(state.x)
    return generation_with_y(state, y, cfg), y


# ---------------------------------------------------------------------------
# K-generation driver (SyncM analogue)
# ---------------------------------------------------------------------------


class GARun(NamedTuple):
    state: GAState
    best_y: torch.Tensor     # [...] best fitness ever seen
    best_x: torch.Tensor     # [..., V] its chromosome
    traj_best: torch.Tensor  # [..., K] per-generation population best
    traj_mean: torch.Tensor  # [..., K] per-generation population mean


GenerationFn = Callable[[GAState, GAConfig, FitnessFn],
                        Tuple[GAState, torch.Tensor]]


def gen_best(x: torch.Tensor, y: torch.Tensor, minimize: bool
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Population best of x [..., N, V] scored by y [..., N] (float32):
    (y[idx], x[idx]) at the FIRST index holding the min (max)."""
    idx = (torch.argmin(y, dim=-1) if minimize
           else torch.argmax(y, dim=-1)).unsqueeze(-1)
    return (torch.gather(y, -1, idx).squeeze(-1),
            _rows(x, idx).squeeze(-2))


def fold_best(by, bx, gb, gx, minimize: bool):
    """Strict-improvement fold of a generation best into the running best."""
    better = (gb < by) if minimize else (gb > by)
    return (torch.where(better, gb, by),
            torch.where(better.unsqueeze(-1), gx, bx))


def run_scan(cfg: GAConfig, fit: FitnessFn, k_generations: int,
             state: GAState, generation_fn: GenerationFn = None) -> GARun:
    """K-generation loop.  `generation_fn` swaps the operator pipeline
    (defaults to the paper's tournament/single-point/XOR `generation`).

    This is the reference *executor* of the engine (`repro_torch.ga`); the
    state may carry leading replica axes.  Nothing here reads back to the
    host, so on the card the whole loop is queued without a sync."""
    if generation_fn is None:
        generation_fn = generation
    lead = state.x.shape[:-2]
    dev = state.x.device
    by = torch.full(lead, math.inf if cfg.minimize else -math.inf,
                    dtype=torch.float32, device=dev)
    bx = torch.zeros(lead + (cfg.v,), dtype=torch.int32, device=dev)
    tb, tm = [], []
    for _ in range(k_generations):
        st2, y = generation_fn(state, cfg, fit)
        yf = y.to(torch.float32)
        gb, gx = gen_best(state.x, yf, cfg.minimize)
        by, bx = fold_best(by, bx, gb, gx, cfg.minimize)
        tb.append(gb)
        tm.append(torch.mean(yf, dim=-1))
        state = st2
    return GARun(state, by, bx, torch.stack(tb, dim=-1),
                 torch.stack(tm, dim=-1))


def generation_with_y(state: GAState, y: torch.Tensor,
                      cfg: GAConfig) -> GAState:
    """SM+CM+MM given externally-computed fitness — lets fitness computed
    elsewhere (another framework, a simulator) drive the GA."""
    w, sel_lfsr = _select(state.x, y, state.sel_lfsr, cfg)
    z, cross_lfsr = _crossover(w, state.cross_lfsr, cfg)
    x_new, mut_lfsr = _mutate(z, state.mut_lfsr, cfg)
    return GAState(x_new, sel_lfsr, cross_lfsr, mut_lfsr, state.k + 1)


def decode_best(run_out: GARun, cfg: GAConfig, domain) -> np.ndarray:
    """Decode the best chromosome's genes to real values."""
    u = run_out.best_x.cpu() & cfg.var_mask
    return F.decode(u, cfg.c, domain).numpy()
