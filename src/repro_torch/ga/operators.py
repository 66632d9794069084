"""Pluggable GA operator stages (SM / CM / MM) with registries.

The paper's datapath hardwires one operator per stage (2-way tournament,
single-point crossover, XOR mutation).  Each stage is a protocol + registry:

  * ``SelectionOp(x, y, sel_lfsr, cfg) -> (w, sel_lfsr')``
  * ``CrossoverOp(w, cross_lfsr, cfg) -> (z, cross_lfsr')``
  * ``MutationOp(z, mut_lfsr, cfg)   -> (x', mut_lfsr')``

All operators consume the same LFSR banks as the paper's modules, so the
GAState layout is identical whichever combination is selected.  The
registries hold the JAX package's operators under its names; `register_*`
adds more.  Everything but the paper pipeline runs on the reference
executor and the `islands` topology (the fused kernels hardwire the
paper pipeline).
"""

from __future__ import annotations

from typing import Callable, Dict, Protocol, Tuple

import torch

from repro_torch.core import ga as G
from repro_torch.core import lfsr
from repro_torch.core import selection as SEL
from repro_torch.core.ga import GAConfig, GAState


class SelectionOp(Protocol):
    def __call__(self, x: torch.Tensor, y: torch.Tensor,
                 sel_lfsr: torch.Tensor, cfg: GAConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]: ...


class CrossoverOp(Protocol):
    def __call__(self, w: torch.Tensor, cross_lfsr: torch.Tensor,
                 cfg: GAConfig) -> Tuple[torch.Tensor, torch.Tensor]: ...


class MutationOp(Protocol):
    def __call__(self, z: torch.Tensor, mut_lfsr: torch.Tensor,
                 cfg: GAConfig) -> Tuple[torch.Tensor, torch.Tensor]: ...


SELECTION: Dict[str, SelectionOp] = {}
CROSSOVER: Dict[str, CrossoverOp] = {}
MUTATION: Dict[str, MutationOp] = {}


def register_selection(name: str):
    def deco(fn):
        SELECTION[name] = fn
        return fn
    return deco


def register_crossover(name: str):
    def deco(fn):
        CROSSOVER[name] = fn
        return fn
    return deco


def register_mutation(name: str):
    def deco(fn):
        MUTATION[name] = fn
        return fn
    return deco


# ---------------------------------------------------------------------------
# Built-in selection schemes (paper SM + the Sec. 2 survey variants)
# ---------------------------------------------------------------------------

SELECTION["tournament"] = SEL.tournament        # the paper's hardware SM
SELECTION["tournament4"] = SEL.tournament_k     # k=4, stronger pressure
SELECTION["roulette"] = SEL.roulette            # fitness-proportional
SELECTION["rank"] = SEL.rank                    # linear-rank
SELECTION["tournament_elite"] = SEL.with_elitism(SEL.tournament, n_elite=1)


# ---------------------------------------------------------------------------
# Built-in crossover operators
# ---------------------------------------------------------------------------

CROSSOVER["single_point"] = G._crossover  # the paper's CM (Eqs. 12-20)


@register_crossover("uniform")
def uniform(w, cross_lfsr, cfg: GAConfig):
    """Uniform crossover: each bit of each offspring pair is swapped
    independently with p=1/2, using the pair's CM LFSR word as the mask.
    Bit-conserving like the paper's CM (same XOR-sum invariant)."""
    cross_lfsr, r = lfsr.draw(cross_lfsr, cfg.steps_per_draw)  # [..., V, N/2]
    m = (r & cfg.var_mask).transpose(-1, -2)                    # [..., N/2, V]
    w1, w2 = w[..., 0::2, :], w[..., 1::2, :]
    z1 = (w1 & m) | (w2 & ~m)
    z2 = (w2 & m) | (w1 & ~m)
    return torch.stack([z1, z2], dim=-2).reshape(w.shape), cross_lfsr


@register_crossover("none")
def no_crossover(w, cross_lfsr, cfg: GAConfig):
    """Pass-through CM (selection + mutation only)."""
    return w, cross_lfsr


# ---------------------------------------------------------------------------
# Built-in mutation operators
# ---------------------------------------------------------------------------

MUTATION["xor"] = G._mutate               # the paper's MM: XOR the first P


@register_mutation("none")
def no_mutation(z, mut_lfsr, cfg: GAConfig):
    """Pass-through MM."""
    return z, mut_lfsr


PAPER_PIPELINE = ("tournament", "single_point", "xor")


def resolve(selection: str, crossover: str, mutation: str
            ) -> Tuple[SelectionOp, CrossoverOp, MutationOp]:
    names = {"selection": (selection, SELECTION),
             "crossover": (crossover, CROSSOVER),
             "mutation": (mutation, MUTATION)}
    for kind, (name, reg) in names.items():
        if name not in reg:
            raise ValueError(f"unknown {kind} operator {name!r}; "
                             f"registered: {sorted(reg)}")
    return SELECTION[selection], CROSSOVER[crossover], MUTATION[mutation]


def make_apply_ops(selection: str = "tournament",
                   crossover: str = "single_point",
                   mutation: str = "xor") -> Callable:
    """Build ``apply_ops(state, y, cfg) -> state'`` (fitness supplied by the
    caller) — the analogue of `G.generation_with_y`."""
    sel, cx, mu = resolve(selection, crossover, mutation)

    def apply_ops(state: GAState, y: torch.Tensor, cfg: GAConfig) -> GAState:
        w, sel_lfsr = sel(state.x, y, state.sel_lfsr, cfg)
        z, cross_lfsr = cx(w, state.cross_lfsr, cfg)
        x_new, mut_lfsr = mu(z, state.mut_lfsr, cfg)
        return GAState(x_new, sel_lfsr, cross_lfsr, mut_lfsr, state.k + 1)

    return apply_ops


def make_generation(selection: str = "tournament",
                    crossover: str = "single_point",
                    mutation: str = "xor") -> Callable:
    """Build a ``generation_fn(state, cfg, fit) -> (state', y)`` from named
    operators — drop-in for `repro_torch.core.ga.generation`."""
    if (selection, crossover, mutation) == PAPER_PIPELINE:
        return G.generation   # identical pipeline; keep the core path
    apply_ops = make_apply_ops(selection, crossover, mutation)

    def generation_fn(state: GAState, cfg: GAConfig, fit: G.FitnessFn):
        y = fit(state.x)
        return apply_ops(state, y, cfg), y

    return generation_fn
