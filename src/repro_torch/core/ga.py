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
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import trace as TR
from repro_torch.core import fitness as F
from repro_torch.core import lfsr
from repro_torch.kernels import lfsr_kernel as K4


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
# Fitness builders — thin wrappers over core.fitness.FitnessProgram
# ---------------------------------------------------------------------------


def make_lut_fitness(tables: F.LutTables) -> FitnessFn:
    """Faithful ROM-pipeline fitness over the whole chromosome matrix."""
    return lambda x: F.lut_fitness(x, tables)


def make_blackbox_fitness(fn: Callable[[torch.Tensor], torch.Tensor], c: int,
                          bounds) -> FitnessFn:
    """General V-variable fitness: decode each c-bit gene to its bound range
    and hand the (N, V) float32 tensor to `fn`."""
    prog = F.compile_program(fitness=fn, bounds=bounds, bits_per_var=c)
    return prog.stage


def fitness_for_problem(problem, cfg: GAConfig) -> FitnessFn:
    """Fitness for a registry problem (name or ProblemDef) at cfg's V, c and
    mode."""
    name = problem.name if isinstance(problem, F.ProblemDef) else problem
    prog = F.compile_program(problem=name, n_vars=cfg.v, bits_per_var=cfg.c,
                             mode=cfg.mode, minimize=cfg.minimize)
    return prog.fitness(cfg.mode)


# ---------------------------------------------------------------------------
# State init
# ---------------------------------------------------------------------------


def init_states(cfg: GAConfig, seeds, *, device) -> GAState:
    """One population per seed, stacked on a leading axis: entry i is
    bit-identical to `init_state` of `cfg` seeded `seeds[i]`.  On a CUDA
    device one kernel derives every word on the card; on the CPU its plain
    twin hashes the seeds on the host (`kernels.lfsr_kernel`).  This is the
    one kernel the module launches, so on a card every backend's initial
    state, the reference backend's too, comes from it; the kernel is held
    to its plain twin on the card apart from any backend."""
    seeds = list(seeds)
    device = torch.device(device)
    with TR.span("init.seed_hash"):
        leaves = K4.seed_state_kernel(cfg.n, cfg.v, cfg.c, seeds,
                                      device=device)
        TR.count("device_words" if device.type == "cuda" else "host_words",
                 len(seeds) * K4.state_words(cfg.n, cfg.v))
    return GAState(*leaves)


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


def host_fitness(y) -> np.ndarray:
    """Fitness values as a float32 numpy array on the host: the one crossing
    a generation of the eager loop makes (a tensor on any device, or what a
    host-side fitness returned)."""
    if isinstance(y, torch.Tensor):
        y = y.detach().cpu().numpy()
    return np.asarray(y, np.float32)


def run_eager(cfg: GAConfig, fit: FitnessFn, k_generations: int,
              state: Optional[GAState] = None, apply_ops_fn=None, *,
              device) -> GARun:
    """Host-loop driver for fitness evaluated outside the operator step
    (a simulator, a training trial): each generation `fit(state.x)` crosses
    to the host as float32, the best and mean are taken there with numpy,
    and the operators run as the plain tensor step on the state's device.
    `apply_ops_fn(state, y, cfg) -> state` swaps the SM/CM/MM pipeline
    (defaults to `generation_with_y`); `device` places a fresh state when
    none is given, and a given state must lie on it."""
    dev = torch.device(device)
    if state is None:
        state = init_state(cfg, device=dev)
    elif state.x.device.type != dev.type:
        raise ValueError(f"the state lies on {state.x.device}, not {dev}")
    step = apply_ops_fn or generation_with_y
    sign = 1.0 if cfg.minimize else -1.0
    best_y = np.inf
    best_x = torch.zeros((cfg.v,), dtype=torch.int32, device=dev)
    tb, tm = [], []
    for _ in range(k_generations):
        y = host_fitness(fit(state.x))
        idx = int(np.argmin(sign * y))
        if sign * y[idx] < sign * best_y or not np.isfinite(best_y):
            best_y = float(y[idx])
            best_x = state.x[idx]
        tb.append(float(y[idx]))
        tm.append(float(y.mean()))
        state = step(state, torch.from_numpy(y).to(dev), cfg)
    return GARun(state, torch.tensor(best_y, dtype=torch.float32), best_x,
                 torch.tensor(tb, dtype=torch.float32),
                 torch.tensor(tm, dtype=torch.float32))


def decode_best(run_out: GARun, cfg: GAConfig, domain) -> np.ndarray:
    """Decode the best chromosome's genes to real values."""
    u = run_out.best_x.cpu() & cfg.var_mask
    return F.decode(u, cfg.c, domain).numpy()
