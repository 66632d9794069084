"""`GASpec` — one frozen description of a GA run.

A spec bundles the problem (a registered benchmark or a blackbox fitness
over a box), the chromosome encoding, the operator pipeline, the run policy
(generations, repeats, islands) and the population topology.  Every
backend consumes the same spec, so swapping ``"reference"`` ↔ ``"fused"`` is
a string, not a rewrite.  The fields and their validation are those of the
JAX package's `GASpec`, so one spec description runs on either package.

The fitness side of a spec compiles to a
`repro_torch.core.fitness.FitnessProgram` (`spec.program()`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np

from repro_torch.core import fitness as F
from repro_torch.core import ga as G
from repro_torch.ga import operators as OPS


@dataclasses.dataclass(frozen=True)
class GASpec:
    """Problem + encoding + operator choices + run policy (all frozen).

    Exactly one of ``problem`` (a registered benchmark name — ``"F1"``..,
    ``"sphere"``, ``"rastrigin"``, .. — optionally with a ``:V`` suffix,
    e.g. ``"rastrigin:8"``) or ``fitness`` (a batch blackbox
    ``(N, V) float32 -> (N,)`` on torch tensors, with ``bounds``) must be set.
    """

    # ---- problem --------------------------------------------------------
    problem: Optional[str] = None
    fitness: Optional[Callable] = None
    bounds: Optional[Tuple[Tuple[float, float], ...]] = None

    # ---- encoding -------------------------------------------------------
    n: int = 32                    # population size N (even)
    bits_per_var: int = 10         # c (paper: m/2)
    n_vars: Optional[int] = None   # V; default from the problem registry
    mode: str = "arith"            # FFM mode: "lut" (ROMs) | "arith" (f32)
    # tournament gather lane: "onehot", "gather" or "auto".  Both lanes are
    # bit-identical; on the card both are one indexed read from shared
    # memory.  Validated exactly as in the JAX package (the onehot N cap).
    sel_lane: str = "auto"

    # ---- operators ------------------------------------------------------
    selection: str = "tournament"
    crossover: str = "single_point"
    mutation: str = "xor"
    mutation_rate: float = 0.02
    minimize: bool = True
    steps_per_draw: int = 3

    # ---- run policy -----------------------------------------------------
    generations: int = 100
    seed: int = 1
    n_repeats: int = 1             # independent stacked replicas (Table 3)
    n_islands: int = 1             # >1 -> island model with migration
    migrate_every: int = 16
    jit_fitness: bool = True       # False -> fitness needs a host loop
    # generations folded INSIDE one kernel launch (fused executor).
    # Population/LFSR state and the running best individual stay
    # bit-identical to gens_per_epoch=1; only the best/mean trajectory
    # coarsens to one sample per launch.  Ignored by the reference executor.
    gens_per_epoch: int = 1

    # ---- topology (how populations are arranged + exchanged) ------------
    topology: Optional[str] = None
    migration: str = "ring"
    mesh_axes: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        if (self.problem is None) == (self.fitness is None):
            raise ValueError("set exactly one of problem= or fitness=")
        if self.mode not in ("lut", "arith"):
            raise ValueError(f"mode must be 'lut' or 'arith', got {self.mode!r}")
        if self.sel_lane not in ("auto", "onehot", "gather"):
            raise ValueError(f"sel_lane must be 'onehot', 'gather' or "
                             f"'auto', got {self.sel_lane!r}")
        if self.sel_lane == "onehot" and self.n > G.ONEHOT_MAX_N:
            raise ValueError(
                f"sel_lane='onehot' pinned with N={self.n} > "
                f"{G.ONEHOT_MAX_N}: the (N, N) one-hot tournament matrices "
                "would exceed VMEM in every fused kernel.  Fix: split the "
                "population across more islands (smaller per-island N), or "
                "switch to the O(N*V) dynamic-indexing lane with "
                "sel_lane='gather'")
        if self.problem is not None:
            pdef, v_suffix = F.resolve_problem(self.problem)
            if v_suffix is not None:
                if self.n_vars is not None and self.n_vars != v_suffix:
                    raise ValueError(
                        f"problem {self.problem!r} pins V={v_suffix} but "
                        f"n_vars={self.n_vars} was also given")
                object.__setattr__(self, "problem", pdef.name)
                object.__setattr__(self, "n_vars", v_suffix)
            F.resolve_vars(pdef, self.n_vars)
            F.check_mode(pdef, self.mode)
        if self.fitness is not None and self.bounds is None:
            raise ValueError("blackbox fitness requires bounds=")
        if self.fitness is not None and self.mode == "lut":
            raise ValueError("blackbox fitness has no LUT lowering; "
                             "run mode='arith'")
        if self.bounds is not None:
            object.__setattr__(self, "bounds",
                               tuple((float(lo), float(hi))
                                     for lo, hi in self.bounds))
        # operator names must exist — fail at spec build, not mid-run
        OPS.resolve(self.selection, self.crossover, self.mutation)
        for field, lo in (("n", 2), ("bits_per_var", 1), ("generations", 1),
                          ("n_repeats", 1), ("n_islands", 1),
                          ("migrate_every", 1), ("gens_per_epoch", 1)):
            if getattr(self, field) < lo:
                raise ValueError(f"{field} must be >= {lo}")
        if self.topology == "auto":
            object.__setattr__(self, "topology", None)
        if self.topology not in (None, "single", "island_ring"):
            raise ValueError(
                f"topology must be 'single', 'island_ring' or None/'auto', "
                f"got {self.topology!r}")
        if self.topology == "single" and self.n_islands > 1:
            raise ValueError("topology='single' is inconsistent with "
                             f"n_islands={self.n_islands}; drop one of them")
        if self.topology == "island_ring" and self.n_islands == 1:
            raise ValueError("topology='island_ring' needs n_islands > 1")
        if self.migration not in ("ring", "none"):
            raise ValueError(f"migration must be 'ring' or 'none', "
                             f"got {self.migration!r}")
        if (self.effective_topology == "island_ring"
                and self.migration == "ring"
                and self.gens_per_epoch > self.migrate_every
                and self.gens_per_epoch % self.migrate_every):
            raise ValueError(
                f"gens_per_epoch={self.gens_per_epoch} is not a multiple of "
                f"migrate_every={self.migrate_every}: on an island_ring "
                "topology a resident launch folds WHOLE migration intervals, "
                "so gens_per_epoch beyond migrate_every must be a multiple of "
                "it — round to a multiple or lower it to migrate_every")
        if self.mesh_axes is not None:
            if (not self.mesh_axes
                    or not all(isinstance(a, str) and a
                               for a in self.mesh_axes)):
                raise ValueError("mesh_axes must be a non-empty tuple of "
                                 f"axis names, got {self.mesh_axes!r}")
            object.__setattr__(self, "mesh_axes", tuple(self.mesh_axes))

    # ---- derived --------------------------------------------------------

    @property
    def v(self) -> int:
        if self.bounds is not None:
            return len(self.bounds)
        return F.resolve_vars(self.problem_def(), self.n_vars)

    @property
    def resolved_sel_lane(self) -> str:
        """The concrete selection lane: an explicit pin wins; "auto" keeps
        the one-hot lane while it is legal (N <= ONEHOT_MAX_N) and switches
        to the gather lane past the cap."""
        if self.sel_lane != "auto":
            return self.sel_lane
        return "onehot" if self.n <= G.ONEHOT_MAX_N else "gather"

    @property
    def effective_topology(self) -> str:
        """The topology this spec runs on: the explicit `topology` field, or
        derived from `n_islands` when left as None/'auto'."""
        if self.topology is not None:
            return self.topology
        return "island_ring" if self.n_islands > 1 else "single"

    @property
    def uses_paper_pipeline(self) -> bool:
        return (self.selection, self.crossover,
                self.mutation) == OPS.PAPER_PIPELINE

    def ga_config(self) -> G.GAConfig:
        return G.GAConfig(n=self.n, c=self.bits_per_var, v=self.v,
                          mutation_rate=self.mutation_rate,
                          minimize=self.minimize,
                          steps_per_draw=self.steps_per_draw,
                          seed=self.seed, mode=self.mode,
                          sel_lane=self.resolved_sel_lane)

    def problem_def(self) -> Optional[F.ProblemDef]:
        return F.PROBLEMS[self.problem] if self.problem is not None else None

    def program(self) -> F.FitnessProgram:
        """The spec's fitness compiled for every executor (LUT ROMs when
        mode='lut', the arith stage always).  Cached per spec instance."""
        cached = self.__dict__.get("_program")
        if cached is None:
            cached = F.compile_program(problem=self.problem,
                                       fitness=self.fitness,
                                       bounds=self.bounds, n_vars=self.v,
                                       bits_per_var=self.bits_per_var,
                                       mode=self.mode, minimize=self.minimize)
            object.__setattr__(self, "_program", cached)
        return cached

    def compile_key(self) -> tuple:
        """Hashable shape identity: two specs with equal keys run identical
        computations — only `seed`, `generations` and `n_repeats` may
        differ.  Blackbox fitnesses are keyed by callable identity."""
        fit_id = (self.problem if self.problem is not None
                  else ("blackbox", id(self.fitness), self.bounds))
        return (fit_id, self.v, self.n, self.bits_per_var, self.mode,
                self.resolved_sel_lane,
                self.selection, self.crossover, self.mutation,
                self.mutation_rate, self.minimize, self.steps_per_draw,
                self.n_islands, self.migrate_every, self.gens_per_epoch,
                self.effective_topology, self.migration, self.mesh_axes,
                self.jit_fitness)

    def fitness_fn(self) -> G.FitnessFn:
        return self.program().fitness(self.mode)

    def fitness_scale(self) -> float:
        """Raw-fitness units per real unit (lut mode is fixed-point)."""
        return self.program().scale(self.mode)

    def var_domains(self) -> Tuple[Tuple[float, float], ...]:
        """Per-variable decode range."""
        if self.bounds is not None:
            return self.bounds
        return (self.problem_def().domain,) * self.v

    def decode(self, x: np.ndarray) -> np.ndarray:
        """Decode a uint32[V] chromosome to real variable values."""
        u = np.asarray(x, np.uint64) & np.uint64((1 << self.bits_per_var) - 1)
        doms = self.var_domains()
        lo = np.array([d[0] for d in doms])
        hi = np.array([d[1] for d in doms])
        return lo + u.astype(np.float64) * (hi - lo) / \
            ((1 << self.bits_per_var) - 1)


def paper_spec(problem: str = "F3", n: int = 32, m: int = 20,
               mode: str = "lut", **kw) -> GASpec:
    """The paper's experiment grid as a spec: chromosome m = 2c bits."""
    return GASpec(problem=problem, n=n, bits_per_var=m // 2, n_vars=2,
                  mode=mode, **kw)
