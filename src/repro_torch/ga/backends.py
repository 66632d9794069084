"""Engine backends — **topology × executor** compositions.

An **executor** advances a stack of populations a block of generations:

  reference  the operator pipeline in plain PyTorch
             (`repro_torch.core.ga.run_scan`); any registered operators.
  fused      the hand-written CUDA kernel K1
             (`repro_torch.kernels.ga_step`) — one launch per
             `spec.gens_per_epoch` generations, the replica stack one thread
             block each; paper pipeline, arith FFM of a built-in problem,
             power-of-two N whose state fits a block's shared memory.
             Bit-identical to `reference` (state and best; the trajectory
             coarsens to one sample per launch when gens_per_epoch > 1).

A **topology** owns population layout and the epoch loop:

  single     one population (or `n_repeats` stacked replicas, replica r
             seeded `seed + r`), no migration; a segment is one executor
             block.

The registry exposes the compositions under the JAX package's names:

  reference  = reference × single
  fused      = fused     × single

Each backend implements `supports(spec)` (capability check → reason string
or None), `init()` (backend-native state) and `segment(state, gens)`
(advance `gens` generations, returning the new state + telemetry).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import ga as G
from repro_torch.ga import operators as OPS
from repro_torch.ga import telemetry as RT
from repro_torch.ga.options import resolve_options
from repro_torch.ga.spec import GASpec
from repro_torch.kernels import ga_step as K


@dataclasses.dataclass
class Segment:
    """One contiguous block of generations (raw fitness units); traj arrays
    have one entry per trajectory sample (see `Executor`)."""

    state: Any
    best_y: float
    best_x: np.ndarray          # uint32[V]
    traj_best: np.ndarray
    traj_mean: np.ndarray
    gens: int
    telemetry: RT.RunTelemetry = dataclasses.field(
        default_factory=RT.RunTelemetry)


def _arg_best(y: np.ndarray, minimize: bool) -> int:
    return int(np.argmin(y) if minimize else np.argmax(y))


def _stack_states(cfg: G.GAConfig, n_replicas: int, device) -> G.GAState:
    """Replica r is seeded `seed + r` — replica 0 reproduces the solo run
    bit-exactly, and the splitmix seed hash decorrelates consecutive
    integers."""
    return G.init_states(cfg, [cfg.seed + r for r in range(n_replicas)],
                         device=device)


class Backend:
    """One execution strategy for a GASpec, on the device of its
    `ga.EngineOptions` (which raises when that is CUDA and no card is
    there)."""

    name = "?"

    def __init__(self, spec: GASpec, *, options=None):
        self.options = resolve_options(options)
        self.spec = spec
        self.cfg = spec.ga_config()
        self.device = self.options.torch_device()

    @staticmethod
    def supports(spec: GASpec) -> Optional[str]:
        """None if the spec can run on this backend, else the reason why not."""
        raise NotImplementedError

    def init(self):
        raise NotImplementedError

    def segment(self, state, gens: int) -> Segment:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Executors — advance a stack of populations one block of generations
# ---------------------------------------------------------------------------


class Executor:
    """Steps a leading-axis stack of populations `gens` generations.

    `block(gens)` returns a function
        states[L, ...] -> (states', best_y[L], best_x[L, V],
                           traj_best[L, T], traj_mean[L, T])
    where best_* track the best individual seen across the block and traj_*
    are population best/mean per trajectory sample (fitness of the
    pre-update population).  T is one entry per generation, except the
    fused executor with `gens_per_epoch > 1` where it is one per launch.
    """

    name = "?"
    stacked_only = True    # False -> also offers an unstacked solo path

    def __init__(self, spec: GASpec):
        self.spec = spec
        self.cfg = spec.ga_config()
        self.fit = spec.fitness_fn()

    @staticmethod
    def supports(spec: GASpec) -> Optional[str]:
        raise NotImplementedError

    def launches(self, gens: int) -> int:
        """Kernel launches one block of `gens` generations makes."""
        return 0

    def block(self, gens: int):
        raise NotImplementedError


class ReferenceExecutor(Executor):
    name = "reference"
    stacked_only = False

    def __init__(self, spec: GASpec):
        super().__init__(spec)
        self.gen_fn = OPS.make_generation(spec.selection, spec.crossover,
                                          spec.mutation)

    @staticmethod
    def supports(spec: GASpec) -> Optional[str]:
        if not spec.jit_fitness:
            return ("fitness needs the host-loop 'eager' backend "
                    "(jit_fitness=False), which the port does not have yet")
        return None

    def solo(self, gens: int):
        """Single-population runner (GARun); also takes a replica stack."""
        return lambda st: G.run_scan(self.cfg, self.fit, gens, st,
                                     self.gen_fn)

    def block(self, gens: int):
        one = self.solo(gens)

        def run_block(states: G.GAState):
            out = one(states)
            return (out.state, out.best_y, out.best_x,
                    out.traj_best, out.traj_mean)

        return run_block


class FusedExecutor(Executor):
    name = "fused"
    stacked_only = True

    def __init__(self, spec: GASpec):
        super().__init__(spec)
        self.gens_per_epoch = spec.gens_per_epoch
        self.program = spec.program()

    @staticmethod
    def supports(spec: GASpec) -> Optional[str]:
        if not spec.jit_fitness:
            return ("fitness needs the host-loop 'eager' backend "
                    "(jit_fitness=False), which the port does not have yet")
        if spec.mode != "arith":
            return ("the CUDA kernel requires mode='arith' — LUT gathers "
                    "stay on the plain path ('reference')")
        if not spec.uses_paper_pipeline:
            return ("fused kernel hardwires the paper pipeline "
                    "(tournament/single_point/xor); other operators run on "
                    "'reference'")
        return K.hopper_reason(spec.ga_config(), spec.program())

    def _launch_gens(self, gens: int):
        gpe = max(1, min(self.gens_per_epoch, gens))
        n_full, rem = divmod(gens, gpe)
        return [gpe] * n_full + ([rem] if rem else [])

    def launches(self, gens: int) -> int:
        return len(self._launch_gens(gens))

    def block(self, gens: int):
        cfg, prog, mini = self.cfg, self.program, self.spec.minimize
        # generations folded inside one launch: the in-kernel best fold
        # (track_best) keeps best_y/best_x bit-identical to gens_per_epoch=1;
        # trajectories coarsen to one sample per launch, both taken from y —
        # the launch's LAST pre-update population.
        plan = self._launch_gens(gens)

        def run_block(states: G.GAState):
            x, sel, cross, mut = states.x, states.sel_lfsr, \
                states.cross_lfsr, states.mut_lfsr
            L, dev = x.shape[0], x.device
            by = torch.full((L,), math.inf if mini else -math.inf,
                            dtype=torch.float32, device=dev)
            bx = torch.zeros((L, cfg.v), dtype=torch.int32, device=dev)
            tbs, tms = [], []
            for g in plan:
                x, sel, cross, mut, y, lby, lbx = K.ga_generation_kernel(
                    x, sel, cross, mut, cfg=cfg, program=prog, gens=g,
                    track_best=True)
                by, bx = G.fold_best(by, bx, lby, lbx, mini)
                tbs.append(torch.amin(y, dim=-1) if mini
                           else torch.amax(y, dim=-1))
                tms.append(torch.mean(y, dim=-1))
            state = G.GAState(x, sel, cross, mut, states.k + gens)
            return (state, by, bx, torch.stack(tbs, dim=-1),
                    torch.stack(tms, dim=-1))

        return run_block


EXECUTORS: Dict[str, type] = {
    ReferenceExecutor.name: ReferenceExecutor,
    FusedExecutor.name: FusedExecutor,
}


# ---------------------------------------------------------------------------
# Topologies — population layout and the epoch loop
# ---------------------------------------------------------------------------


class Topology:
    name = "?"

    def __init__(self, spec: GASpec, executor: Executor, *, device):
        self.spec = spec
        self.cfg = spec.ga_config()
        self.executor = executor
        self.device = device

    @staticmethod
    def supports(spec: GASpec) -> Optional[str]:
        raise NotImplementedError

    def init(self):
        raise NotImplementedError

    def segment(self, state, gens: int) -> Segment:
        raise NotImplementedError


class SingleTopology(Topology):
    """One population; `n_repeats` independent replicas ride the executor's
    stack axis.  A segment is exactly one executor block."""

    name = "single"

    @staticmethod
    def supports(spec: GASpec) -> Optional[str]:
        if spec.effective_topology != "single":
            return ("n_islands > 1: the island ring is not ported yet; "
                    "run one population (n_islands=1)")
        return None

    def _solo(self) -> bool:
        return self.spec.n_repeats == 1 and not self.executor.stacked_only

    def init(self):
        if self._solo():
            return G.init_state(self.cfg, device=self.device)
        return _stack_states(self.cfg, self.spec.n_repeats, self.device)

    def segment(self, state, gens: int) -> Segment:
        mini = self.spec.minimize
        tele = RT.RunTelemetry()
        tele.topology.launches = self.executor.launches(gens)
        if self._solo():
            out: G.GARun = self.executor.solo(gens)(state)
            return Segment(state=out.state, best_y=float(out.best_y),
                           best_x=convert.words_to_numpy(out.best_x),
                           traj_best=out.traj_best.cpu().numpy(),
                           traj_mean=out.traj_mean.cpu().numpy(), gens=gens,
                           telemetry=tele)
        state, by, bx, tb, tm = self.executor.block(gens)(state)
        per_rep = by.cpu().numpy()                             # [R]
        bx = convert.words_to_numpy(bx)                        # [R, V]
        tb, tm = tb.cpu().numpy(), tm.cpu().numpy()            # [R, T]
        r = _arg_best(per_rep, mini)
        reduce = np.min if mini else np.max
        tele.per_repeat = RT.ReplicaStats(best=per_rep, best_x=bx,
                                          traj_best=tb, traj_mean=tm)
        return Segment(state=state, best_y=float(per_rep[r]),
                       best_x=bx[r], traj_best=reduce(tb, axis=0),
                       traj_mean=tm.mean(axis=0), gens=gens, telemetry=tele)


TOPOLOGIES: Dict[str, type] = {SingleTopology.name: SingleTopology}


class ComposedBackend(Backend):
    """A (topology × executor) pair behind the uniform Backend interface."""

    executor_cls: type = None
    topology_cls: type = None

    def __init__(self, spec: GASpec, *, options=None):
        super().__init__(spec, options=options)
        self.executor: Executor = self.executor_cls(self.spec)
        self.topology: Topology = self.topology_cls(
            self.spec, self.executor, device=self.device)

    @classmethod
    def supports(cls, spec: GASpec) -> Optional[str]:
        reason = cls.executor_cls.supports(spec)
        if reason is not None:
            return reason
        return cls.topology_cls.supports(spec)

    def init(self):
        return self.topology.init()

    def segment(self, state, gens: int) -> Segment:
        seg = self.topology.segment(state, gens)
        info = seg.telemetry.topology
        info.executor = self.executor_cls.name
        info.topology = self.topology_cls.name
        return seg


def _compose(backend_name: str, executor: type, topology: type) -> type:
    return type(f"{backend_name.title().replace('-', '')}Backend",
                (ComposedBackend,),
                {"name": backend_name, "executor_cls": executor,
                 "topology_cls": topology})


ReferenceBackend = _compose("reference", ReferenceExecutor, SingleTopology)
FusedBackend = _compose("fused", FusedExecutor, SingleTopology)

BACKENDS: Dict[str, type] = {
    ReferenceBackend.name: ReferenceBackend,
    FusedBackend.name: FusedBackend,
}
