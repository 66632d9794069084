"""The public wrappers of the port's kernels: the JAX package's
`repro.kernels.ops` with the same names and keywords, less `interpret`.

Where the JAX wrappers choose interpret mode off the TPU, these choose by
the tensors' device: a CUDA tensor launches the kernel
(`ga_step.ga_generation_kernel`, `ga_step.ga_epoch_kernel`,
`lfsr_kernel.lfsr_advance_kernel`) and a CPU tensor runs its plain twin.
There is no third way: on a CUDA tensor a kernel that fails to build or
launch raises, and nothing falls back to the plain twin.

`program` (a `core.fitness.FitnessProgram`) takes the place of the JAX
wrappers' traced `ffm` stage: the kernels hold the built-in problems' FFM
stages in CUDA and name them by the program.  They compute the arith FFM
only, so `ga_generation` and `ga_epoch` refuse a LUT config instead of
running arith on it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.fitness import FitnessProgram
from repro_torch.core.ga import GAConfig
from repro_torch.kernels import ga_step as _ga_step
from repro_torch.kernels import lfsr_kernel as _lfsr


def _check_arith(cfg: GAConfig) -> None:
    if cfg.mode != "arith":
        raise ValueError(_ga_step.ARITH_REASON)


def lfsr_advance(state: torch.Tensor, steps: int) -> torch.Tensor:
    """Advance every lane of `state` (int32 words, any shape) `steps`
    clocks of the paper's LFSR."""
    return _lfsr.lfsr_advance_kernel(state, steps)


def ga_generation(x, sel, cross, mut, *, cfg: GAConfig,
                  program: FitnessProgram, gens: int = 1,
                  track_best: bool = False) -> Tuple[torch.Tensor, ...]:
    """`gens` fused GA generations over a stack of replicas [R, ...]
    (`ga_step.ga_generation_kernel`); track_best=True appends the best
    over the generations (best_y [R], best_x [R, V])."""
    _check_arith(cfg)
    return _ga_step.ga_generation_kernel(x, sel, cross, mut, cfg=cfg,
                                         program=program, gens=gens,
                                         track_best=track_best)


def ga_epoch(x, sel, cross, mut, *, cfg: GAConfig, program: FitnessProgram,
             migrate_every: int, intervals: int = 1,
             boundary: bool = False) -> Tuple[torch.Tensor, ...]:
    """Resident epochs over replica-stacked island groups [G, I, ...]:
    `intervals x migrate_every` generations with the ring migration inside
    the launch (`ga_step.ga_epoch_kernel`).  The best comes a migration
    interval at a time ([K, G, I]), where the TPU kernel returns its fold
    over the launch."""
    _check_arith(cfg)
    return _ga_step.ga_epoch_kernel(x, sel, cross, mut, cfg=cfg,
                                    program=program,
                                    migrate_every=migrate_every,
                                    intervals=intervals, boundary=boundary)
