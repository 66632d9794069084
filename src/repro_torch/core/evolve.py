"""`evolve` — the GA engine exposed as a blackbox-tuning service.

Anything expressible as "minimize f(θ) over a box" — learning-rate
schedule coefficients, serving batch knobs, quantization clip scales — can
be handed to the full-parallel GA.  The evaluation function receives a
whole population at once, an (N, V) float32 tensor, and returns (N,)
scores as a tensor: the port's blackbox contract (`ga.GASpec.fitness`).

A thin shim over the engine, as in the JAX package's `repro.core.evolve`:
the run is a `GASpec` handed to `ga.solve`, which routes to the eager
backend when `jit_fitness=False` (the fitness runs outside the operator
step, its values crossing to the host each generation), the island
backend when `n_islands > 1`, and the reference loop otherwise.  The run
goes to the card unless `options=ga.EngineOptions(device="cpu")` asks for
the CPU.  Prefer building a `GASpec` directly in new code.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class EvolveResult:
    best_params: np.ndarray     # [V] decoded
    best_fitness: float
    traj_best: np.ndarray       # [K] (island runs: one entry per epoch)
    traj_mean: np.ndarray       # [K]


def evolve(fn: Callable[[torch.Tensor], torch.Tensor],
           bounds: Sequence[Tuple[float, float]],
           *,
           population: int = 64,
           generations: int = 100,
           bits_per_var: int = 16,
           mutation_rate: float = 0.02,
           minimize: bool = True,
           seed: int = 0,
           n_islands: int = 1,
           migrate_every: int = 16,
           jit_fitness: bool = True,
           selection: str = "tournament",
           options=None) -> EvolveResult:
    """Minimize (or maximize) `fn` over box `bounds` with the parallel GA.

    fn: (N, V) float32 tensor -> (N,) tensor.  Set jit_fitness=False when
    fn must run outside the operator step (e.g. it runs training trials) —
    the operators stay the plain tensor step, fitness runs in a host loop.
    With n_islands > 1 the island model is used.  `selection` picks any
    registered selection scheme (see repro_torch.ga.SELECTION); `options`
    is a `ga.EngineOptions` (the device above all).
    """
    from repro_torch import ga

    # the island model always runs the fitness inside its step:
    # jit_fitness=False only selects the eager driver for single-population
    # runs, where a host loop is possible at all
    spec = ga.GASpec(fitness=fn, bounds=tuple(tuple(b) for b in bounds),
                     n=population, bits_per_var=bits_per_var,
                     mutation_rate=mutation_rate, minimize=minimize,
                     seed=seed, generations=generations,
                     n_islands=n_islands, migrate_every=migrate_every,
                     jit_fitness=jit_fitness or n_islands > 1,
                     selection=selection)
    res = ga.solve(spec, options=options)
    return EvolveResult(best_params=res.best_params,
                        best_fitness=res.best_fitness,
                        traj_best=res.traj_best,
                        traj_mean=res.traj_mean)
