"""`repro_torch.ga` — the public GA engine API (one spec, topology × executor).

    from repro_torch import ga

    result = ga.solve(ga.GASpec(problem="F3", n=64, bits_per_var=10,
                                generations=100), backend="fused")

    =============  ================  ========  ===========================
    backend        executor          topology  notes
    =============  ================  ========  ===========================
    reference      plain PyTorch     single    any registered operators,
                                               lut or arith FFM, stacked
                                               `n_repeats`
    fused          CUDA kernel K1    single    state in shared memory,
                                               `gens_per_epoch` generations
                                               a launch; bit-identical to
                                               reference
    islands        plain PyTorch     island    ring migration between
                                     ring      `migrate_every`-generation
                                               blocks; lut or arith
    fused-islands  CUDA kernels      island    epoch plan: K1 with the ring
                   K1, K2, K3        ring      between launches (gridded),
                                               K2 with the ring inside
                                               (resident), K3 passes with
                                               the splice between
                                               (streamed); bit-identical to
                                               islands
    eager          host loop         single    fitness evaluated outside
                                               the step (`jit_fitness=
                                               False`); the operators are
                                               the plain tensor step
    =============  ================  ========  ===========================

Non-paper operators (selection ``tournament4``, ``roulette``, ``rank``,
``tournament_elite``; crossover ``uniform``/``none``; mutation ``none``)
run on ``reference`` and ``islands``, as in the JAX package.

Every backend also runs chunked (`Engine.run_chunked`, with checkpoints in
the JAX package's format), packed (`PackedEngine`: many jobs as the
replica slots of one run, each bit-identical to its solo run) and repacked
(`repack_checkpoint`); what an engine builds for a spec shape is shared
through `RUNNER_CACHE`.

The island planner's measured tier reads a cost table
(`EngineOptions(cost_table=...)`, `repro_torch.autotune`), and
`repro_torch.core.evolve` is the blackbox-tuning entry on top of `solve`.

Runs go to the card unless `EngineOptions(device="cpu")` asks for the CPU.
"""

from repro_torch.core.fitness import (PROBLEMS, FitnessProgram, ProblemDef,
                                      compile_program, register_problem,
                                      resolve_problem)
from repro_torch.ga.spec import GASpec, paper_spec
from repro_torch.ga.operators import (CROSSOVER, MUTATION, PAPER_PIPELINE,
                                      SELECTION, CrossoverOp, MutationOp,
                                      SelectionOp, make_apply_ops,
                                      make_generation, no_crossover,
                                      no_mutation, register_crossover,
                                      register_mutation, register_selection,
                                      uniform)
from repro_torch.ga.compile_cache import RUNNER_CACHE, CompileCache
from repro_torch.ga.options import EngineOptions, resolve_options
from repro_torch.ga.telemetry import (TELEMETRY_VERSION, PlanInfo,
                                      ReplicaStats, RunTelemetry,
                                      TopologyInfo)
from repro_torch.ga.backends import (BACKENDS, EXECUTORS, TOPOLOGIES, Backend,
                                     Executor, Segment, Topology)
from repro_torch.ga.engine import (BackendUnsupported, Engine, EngineResult,
                                   PackedEngine, capability_matrix,
                                   repack_checkpoint, resolve_backend, solve)

__all__ = [
    "GASpec", "paper_spec",
    "PROBLEMS", "ProblemDef", "FitnessProgram", "compile_program",
    "register_problem", "resolve_problem",
    "Engine", "EngineResult", "solve", "resolve_backend",
    "PackedEngine", "repack_checkpoint", "RUNNER_CACHE", "CompileCache",
    "capability_matrix", "BackendUnsupported",
    "EngineOptions", "resolve_options",
    "RunTelemetry", "PlanInfo", "TopologyInfo", "ReplicaStats",
    "TELEMETRY_VERSION",
    "BACKENDS", "Backend", "Segment",
    "EXECUTORS", "TOPOLOGIES", "Executor", "Topology",
    "SELECTION", "CROSSOVER", "MUTATION", "PAPER_PIPELINE",
    "SelectionOp", "CrossoverOp", "MutationOp",
    "register_selection", "register_crossover", "register_mutation",
    "make_generation", "make_apply_ops",
    "uniform", "no_crossover", "no_mutation",
]
