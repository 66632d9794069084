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
    =============  ================  ========  ===========================

Runs go to the card unless `EngineOptions(device="cpu")` asks for the CPU.
"""

from repro_torch.core.fitness import (PROBLEMS, FitnessProgram, ProblemDef,
                                      compile_program, register_problem,
                                      resolve_problem)
from repro_torch.ga.spec import GASpec, paper_spec
from repro_torch.ga.operators import (CROSSOVER, MUTATION, PAPER_PIPELINE,
                                      SELECTION, CrossoverOp, MutationOp,
                                      SelectionOp, make_apply_ops,
                                      make_generation, register_crossover,
                                      register_mutation, register_selection)
from repro_torch.ga.options import EngineOptions, resolve_options
from repro_torch.ga.telemetry import (TELEMETRY_VERSION, ReplicaStats,
                                      RunTelemetry, TopologyInfo)
from repro_torch.ga.backends import (BACKENDS, EXECUTORS, TOPOLOGIES, Backend,
                                     Executor, Segment, Topology)
from repro_torch.ga.engine import (BackendUnsupported, Engine, EngineResult,
                                   capability_matrix, resolve_backend, solve)

__all__ = [
    "GASpec", "paper_spec",
    "PROBLEMS", "ProblemDef", "FitnessProgram", "compile_program",
    "register_problem", "resolve_problem",
    "Engine", "EngineResult", "solve", "resolve_backend",
    "capability_matrix", "BackendUnsupported",
    "EngineOptions", "resolve_options",
    "RunTelemetry", "TopologyInfo", "ReplicaStats",
    "TELEMETRY_VERSION",
    "BACKENDS", "Backend", "Segment",
    "EXECUTORS", "TOPOLOGIES", "Executor", "Topology",
    "SELECTION", "CROSSOVER", "MUTATION", "PAPER_PIPELINE",
    "SelectionOp", "CrossoverOp", "MutationOp",
    "register_selection", "register_crossover", "register_mutation",
    "make_generation", "make_apply_ops",
]
