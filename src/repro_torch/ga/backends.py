"""Engine backends — **topology × executor** compositions.

An **executor** advances a stack of populations a block of generations:

  reference  the operator pipeline in plain PyTorch
             (`repro_torch.core.ga.run_scan`); any registered operators.
  fused      the hand-written CUDA kernel K1
             (`repro_torch.kernels.ga_step`) — one K1 call per
             `spec.gens_per_epoch` generations: the replica stack one thread
             block each where a replica fits a block's shared memory and the
             fitness is a built-in problem, else K1's global form (three
             launches a generation, the state in global memory, any fitness
             through its PyTorch stage); paper pipeline, arith FFM,
             power-of-two N, the JAX package's gates.  Bit-identical to
             `reference` (state and best; the trajectory coarsens to one
             sample per launch when gens_per_epoch > 1).

A **topology** owns population layout, the epoch loop and migration:

  single       one population (or `n_repeats` stacked replicas, replica r
               seeded `seed + r`), no migration; a segment is one executor
               block.
  island_ring  `n_islands` populations; every `migrate_every` generations
               the best individual of each island replaces the worst of
               the next (`repro_torch.core.islands.migrate_ring`).
               `n_repeats` replicas stack OUTSIDE the island axis ([R, I,
               ...]).  With the fused executor an epoch planner picks the
               launch shape (see `IslandRingTopology`): the ring between
               K1 launches (gridded), inside the K2 kernel (resident), or
               inside a cooperative K3 launch (streamed) — all
               bit-identical.  Given a mesh (`EngineOptions.mesh`), the
               island axis splits over its shards (`spec.mesh_axes`,
               default all axes), each shard's launches run on its device,
               and the ring crosses shards through the boundary elites
               (`islands.migrate_ring_sharded`), bit-identical to the run
               on one device.

The registry exposes the compositions under the JAX package's names:

  reference      = reference × single
  fused          = fused     × single
  islands        = reference × island_ring
  fused-islands  = fused     × island_ring

and, outside the composition, `eager`: a host loop for fitness evaluated
outside the operator step (`jit_fitness=False`), the operators the plain
tensor step on the engine's device.

Each backend implements `supports(spec, mesh)` (capability check → reason
string or None), `init()` (backend-native state), `init_packed(seeds)` (one
replica slot per seed, for job packing) and `segment(state, gens)`
(advance `gens` generations, returning the new state + telemetry).

Both topologies hand a segment's result to the host one way: packed on
its device into one int32 tensor before the wait (`pack_segment`), read
back once (`read_segment`), made a `Segment` on the host (`build_segment`).

What a backend builds for a spec shape — the executor with its compiled
FitnessProgram and the runner closures of each launch shape — comes from
the process-wide `ga.RUNNER_CACHE`, so a second engine of the same shape
builds none of it again.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import weakref
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import autotune as _cost
from repro_torch import convert
from repro_torch import trace as TR
from repro_torch.core import ga as G
from repro_torch.core import islands as ISL
from repro_torch.ga import compile_cache as CC
from repro_torch.ga import operators as OPS
from repro_torch.ga import telemetry as RT
from repro_torch.ga.options import plan_mode, resolve_options
from repro_torch.ga.spec import GASpec
from repro_torch.kernels import ga_step as K


@dataclasses.dataclass
class Segment:
    """One contiguous block of generations (raw fitness units): the best
    replica's best_y and best_x, and a sample's extreme (traj_best) and mean
    (traj_mean) over the replicas, whose own arrays are
    `telemetry.per_repeat` (None for one unstacked population)."""

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


def _islands_seeded(icfg: ISL.IslandConfig, seed: int, device) -> G.GAState:
    return ISL.init_islands_fast(dataclasses.replace(
        icfg, ga=dataclasses.replace(icfg.ga, seed=seed)), device=device)


def _stack_island_replicas_seeded(icfg: ISL.IslandConfig, seeds,
                                  device) -> G.GAState:
    """[R, I, ...] stack with one island set per seed: replica i is
    bit-identical to a solo run seeded `seeds[i]`, the contract job
    packing relies on."""
    return G.stack_states([_islands_seeded(icfg, s, device) for s in seeds])


def _stack_island_replicas(icfg: ISL.IslandConfig, n_replicas: int,
                           device) -> G.GAState:
    """[R, I, ...] stack: replica r re-seeds the island seed stream with
    `seed + r`, so replica 0 reproduces the n_repeats=1 island run."""
    return _stack_island_replicas_seeded(
        icfg, [icfg.ga.seed + r for r in range(n_replicas)], device)


def _check_seeds(seeds, n_repeats: int) -> None:
    if len(seeds) != n_repeats:
        raise ValueError(f"{len(seeds)} seeds packed into a spec with "
                         f"n_repeats={n_repeats}")


class Backend:
    """One execution strategy for a GASpec, on the device of its
    `ga.EngineOptions` (which raises when that is CUDA and no card is
    there) and, for the island ring, over its mesh.  The options' cost table is resolved once here
    (`repro_torch.autotune.resolve_table`: None discovers the ambient
    per-host table, False pins the pure heuristic) and feeds the measured
    tier of the island-ring epoch planner."""

    name = "?"

    def __init__(self, spec: GASpec, *, options=None):
        self.options = resolve_options(options)
        if (self.options.sel_lane is not None
                and self.options.sel_lane != spec.sel_lane):
            # rebuild the spec so the override flows through validation,
            # ga_config() and compile_key() like a spec-level pin would
            spec = dataclasses.replace(spec, sel_lane=self.options.sel_lane)
        self.spec = spec
        self.cfg = spec.ga_config()
        self.device = self.options.torch_device()
        self.mesh = self.options.mesh
        self.cost_table = _cost.resolve_table(self.options.cost_table)

    @staticmethod
    def supports(spec: GASpec, mesh=None) -> Optional[str]:
        """None if the spec can run on this backend (over `mesh`, when
        given), else the reason why not."""
        raise NotImplementedError

    def init(self):
        raise NotImplementedError

    def init_packed(self, seeds):
        """Stacked state with one replica SLOT per seed — the layout job
        packing (`repro_torch.ga.engine.PackedEngine`) runs many tenants
        through: slot i is bit-identical to a solo run seeded
        `seeds[i]`.  Backends whose replica axis is a host loop (eager)
        cannot pack."""
        raise NotImplementedError(
            f"backend {self.name!r} does not support packed (multi-job) "
            "state initialization")

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
    fused executor with `gens_per_epoch > 1` where it is one per launch
    (`launch_sample`).  The reference block also takes no leading axis.
    """

    name = "?"
    stacked_only = True    # False -> init keeps a lone population unstacked

    def __init__(self, spec: GASpec):
        self.spec = spec
        self.cfg = spec.ga_config()
        self.program = spec.program()
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
            return ("fitness is evaluated outside the operator step "
                    "(jit_fitness=False); use 'eager'")
        return None

    def block(self, gens: int):
        # a GARun is the block's tuple, in its order
        return lambda states: G.run_scan(self.cfg, self.fit, gens, states,
                                         self.gen_fn)


class FusedExecutor(Executor):
    name = "fused"

    def __init__(self, spec: GASpec):
        super().__init__(spec)
        self.gens_per_epoch = spec.gens_per_epoch

    @staticmethod
    def supports(spec: GASpec) -> Optional[str]:
        if not spec.jit_fitness:
            return ("fitness is evaluated outside the operator step "
                    "(jit_fitness=False); use 'eager'")
        if spec.mode != "arith":
            return K.ARITH_REASON
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
            samples = []
            for g in plan:
                with TR.span("executor.launch"):
                    x, sel, cross, mut, y, lby, lbx = K.ga_generation_kernel(
                        x, sel, cross, mut, cfg=cfg, program=prog, gens=g,
                        track_best=True)
                    by, bx = G.fold_best(by, bx, lby, lbx, mini)
                    samples.append(launch_sample(y, mini))
            state = G.GAState(x, sel, cross, mut, states.k + gens)
            tbs, tms = zip(*samples)
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


def _mesh_axes(spec: GASpec, mesh) -> Optional[tuple]:
    """Mesh axes the island axis shards over: `spec.mesh_axes` or all axes
    of the mesh (None without a mesh)."""
    if spec.mesh_axes is not None:
        return tuple(spec.mesh_axes)
    if mesh is not None:
        return tuple(mesh.axis_names)
    return None


class Topology:
    name = "?"

    def __init__(self, spec: GASpec, executor: Executor, *, device,
                 mesh=None, cost_table=None, plan_override=None,
                 smem_budget=None, stream_tile_islands=None):
        self.spec = spec
        self.cfg = spec.ga_config()
        self.executor = executor
        self.device = device
        self.mesh = mesh
        # a measured cost table, a forced epoch mode, a planning
        # shared-memory budget and a pinned streamed tile; only the
        # island_ring planner reads them — single has one launch shape
        self.cost_table = cost_table
        self.plan_override = plan_override
        self.smem_budget = smem_budget
        self.stream_tile_islands = stream_tile_islands
        self._cache: Dict[Any, Any] = {}   # instance memo over RUNNER_CACHE
        self.clock = SegmentClock(device)

    def _cached_runner(self, builder, *parts):
        """Instance memo in front of the process-global RUNNER_CACHE, so the
        global hit/miss counters record one resolution per topology
        instance (one per Engine build) instead of one per launch.  The
        key holds the spec's shape, this composition, the device and the
        mesh."""
        fn = self._cache.get(parts)
        if fn is None:
            key = CC.runner_key(self.spec, self.name, self.executor.name,
                                self.device, *parts, mesh=self.mesh)
            fn = CC.RUNNER_CACHE.get_or_build(key, builder)
            self._cache[parts] = fn
        return fn

    @staticmethod
    def supports(spec: GASpec, mesh=None) -> Optional[str]:
        raise NotImplementedError

    def init(self):
        raise NotImplementedError

    def init_packed(self, seeds):
        raise NotImplementedError

    def segment(self, state, gens: int) -> Segment:
        raise NotImplementedError


class SegmentClock:
    """Device time of one engine's segments, without a profiler.

    `start(sp, counts)` before a segment's first device operation and
    `stop(sp, mark, counts)` after its last give the segment's span, on a
    CUDA device while tracing is on: `device_ms`, the stream's time from
    one timing event to the other; `gap_before_ms`, from the engine's
    previous segment's end event to this start event (the device idle
    between them, unless other work was queued there); and the counters
    `kernel_launches.<kernel>`, what `counts` (a kernel -> launches dict)
    gained.  `stop` records its end event inside a `segment.wait` span and
    waits on it.  Off, or off CUDA, both do nothing."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.last_end = None

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def start(self, sp, counts: dict) -> Optional[tuple]:
        if not (sp and self.cuda):
            return None
        return self._event(), dict(counts)

    def stop(self, sp, mark: Optional[tuple], counts: dict) -> None:
        if mark is None:
            self.last_end = None
            return
        start, before = mark
        with TR.span("segment.wait"):
            end = self._event()
            end.synchronize()
        for name, n in counts.items():
            if n != before.get(name, 0):
                sp.count("kernel_launches." + name, n - before.get(name, 0))
        sp.set("device_ms", start.elapsed_time(end))
        if self.last_end is not None:
            sp.set("gap_before_ms", self.last_end.elapsed_time(start))
        self.last_end = end


def count_data_bytes(sp, program) -> None:
    """A traced segment's counter `ffm_data_bytes`: the bytes of problem
    data its fitness stage reads (`FitnessProgram.data_bytes`), for a
    problem with data only."""
    if program is not None and program.data is not None:
        sp.count("ffm_data_bytes", program.data_bytes)


class SingleTopology(Topology):
    """One population; `n_repeats` independent replicas ride the executor's
    stack axis.  A segment is exactly one executor block; its result is
    packed as one interval of one island.  Traced: `topology.segment` (on a
    card `SegmentClock`'s events and counts; `ffm_data_bytes` for a problem
    with data) around `executor.launch`, `segment.fold` (the pack's
    enqueue), `segment.wait`, `segment.result`."""

    name = "single"

    @staticmethod
    def supports(spec: GASpec, mesh=None) -> Optional[str]:
        if spec.effective_topology != "single":
            return ("n_islands > 1; use an island_ring backend "
                    "('islands' / 'fused-islands')")
        if mesh is not None:
            return ("single topology would silently ignore the mesh; "
                    "shard over devices with an island_ring backend "
                    "(n_islands > 1)")
        return None

    def init(self):
        if self.spec.n_repeats == 1 and not self.executor.stacked_only:
            return G.init_state(self.cfg, device=self.device)
        return _stack_states(self.cfg, self.spec.n_repeats, self.device)

    def init_packed(self, seeds):
        _check_seeds(seeds, self.spec.n_repeats)
        return G.init_states(self.cfg, list(seeds), device=self.device)

    def _runner(self, gens: int):
        return self._cached_runner(lambda: self.executor.block(gens),
                                   "block", gens)

    def segment(self, state, gens: int) -> Segment:
        with TR.span("topology.segment") as sp:
            count_data_bytes(sp, self.executor.program)
            mark = self.clock.start(sp, K.LAUNCHES)
            state, by, bx, tb, tm = self._runner(gens)(state)
            with TR.span("segment.fold"):
                words = pack_segment(by, bx, tb, tm)
            self.clock.stop(sp, mark, K.LAUNCHES)
            rep = read_segment(words, self.spec.n_repeats, self.cfg.v,
                               tb.shape[-1])
        tele = RT.RunTelemetry()
        tele.topology.launches = self.executor.launches(gens)
        return build_segment(state, gens, *rep, minimize=self.spec.minimize,
                             telemetry=tele, stacked=state.x.dim() > 2)


class IslandRingTopology(Topology):
    """`n_islands` populations with ring migration every `migrate_every`
    generations.  Replicas stack OUTSIDE the island axis ([R, I, ...]; [I,
    ...] when n_repeats == 1).

    The epoch plan (`_epoch_plan`) picks the launch shape from
    `kernels.ga_step.epoch_mode_candidates`, whose feasibility test is the
    card's (one island a thread block, a ring of at most MAX_CLUSTER
    islands a cluster):

      gridded        always feasible: an executor block of `migrate_every`
                     generations over the flattened [R * I] stack (K1
                     launches on fused), then the migration fitness and
                     `islands.migrate_ring` in PyTorch;
      resident       (fused, ring, gens_per_epoch >= migrate_every, I <= 8)
                     one K2 launch folds gens_per_epoch // migrate_every
                     whole intervals, the ring inside the kernel;
      resident-free  (fused, migration="none") one K2 launch without a ring
                     folds the whole gens_per_epoch;
      streamed       (fused, resident refused: past the cluster, or past
                     a planning `smem_budget`) one K3 launch folds k
                     whole intervals, the ring inside the kernel through
                     global memory; its island tile comes from how many
                     blocks the card holds at once.

    Given a mesh, the island axis splits into `n_shards` contiguous blocks
    of `i_local` islands, in the logical order of
    `mesh.shard_devices(spec.mesh_axes or all axes)`.  Between segments the
    state stays one stack of global tensors on the mesh's first device
    (what checkpoints, packs and results read); `segment` splits it onto
    the shards' devices before its first launch and gathers it after its
    last.  In between, every launch runs a shard at a time and the ring
    crosses shards through `islands.ring_shift_sharded`:

      gridded           the executor block a shard (K1 launches on fused),
                        then `islands.migrate_ring_sharded` on the
                        migration fitness;
      resident-sharded  (fused, ring, the local islands fit a cluster) one
                        K2 launch a shard and interval in the boundary
                        form: the intra-shard ring inside the kernel, the
                        shard's last elite and island 0's worst slot out;
                        the elites shift to the next shard and splice in
                        PyTorch;
      streamed          (fused, the local islands past a cluster) per
                        interval one K3 launch a shard in the one-interval
                        form (no `splice`), the pre-splice elites shifted
                        across shards and spliced in PyTorch.  The
                        ring-inside form (`splice=True`) runs one shard's
                        islands only, so its ring cannot cross a shard
                        boundary.

    No resident or resident-free plan runs on a mesh, as in the JAX
    package.

    Selection is two-tier, as in the JAX package.  candidates[0] is the
    heuristic (`plan_source: "heuristic"`).  When a measured cost table
    covers the heuristic's own point, the planner instead takes the
    candidate with the best measured gens/s (`"measured"`, the expected
    rate in plan["plan_gens_per_s"]); for `sel_lane="auto"` the other
    lane's candidates join that argmax as measured-only ones, and a pick
    on the other lane rebuilds the spec, configs and executor the runners
    close over.  No table, or one that misses the heuristic's point, keeps
    the heuristic.  A `plan_override` skips the table: it picks another
    feasible mode (`"forced"`) or raises.  Every plan is bit-identical in
    state and best tracking; plans that fold several intervals a launch
    coarsen the trajectory to one sample a launch."""

    name = "island_ring"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        spec, mesh = self.spec, self.mesh
        self.icfg = ISL.IslandConfig(ga=self.cfg, n_islands=spec.n_islands,
                                     migrate_every=spec.migrate_every)
        self._mesh_axes = _mesh_axes(spec, mesh)
        self.n_shards = mesh.shards(self._mesh_axes) if mesh else 1
        self.i_local = max(1, spec.n_islands // self.n_shards)
        self._shard_devices = (mesh.shard_devices(self._mesh_axes)
                               if mesh else None)
        # planned per engine, not cached: cheap (the card's occupancy it
        # reads is cached in kernels.ga_step) and it follows the planner's
        # inputs wherever they change
        self.plan = self._epoch_plan()
        lane = self.plan.get("lane", self.cfg.sel_lane)
        if lane != self.cfg.sel_lane:
            # a measured cross-lane pick: pin the lane in the spec (so the
            # runner-cache keys name it) and give this topology its own
            # executor copy, never the shared cached one
            self.spec = dataclasses.replace(self.spec, sel_lane=lane)
            self.cfg = self.spec.ga_config()
            self.icfg = dataclasses.replace(self.icfg, ga=self.cfg)
            self.executor = copy.copy(self.executor)
            self.executor.spec, self.executor.cfg = self.spec, self.cfg

    def epoch_candidates(self) -> list:
        """Tier-1 feasible plan candidates, heuristic first (the autotune
        runner measures exactly this list, so table points and planner
        queries cannot drift apart).  All carry the spec's own resolved
        selection lane; the other lane's are a measured-only grid
        (`_lane_candidates`)."""
        return self._lane_candidates(self.cfg.sel_lane)

    def _lane_candidates(self, lane: str) -> list:
        """Feasible candidates with the selection lane forced to `lane`."""
        spec = self.spec
        cfg = (self.cfg if lane == self.cfg.sel_lane
               else dataclasses.replace(self.cfg, sel_lane=lane))
        return K.epoch_mode_candidates(
            cfg, self.i_local, executor=self.executor.name,
            migration=spec.migration, gens_per_epoch=spec.gens_per_epoch,
            migrate_every=spec.migrate_every, groups=spec.n_repeats,
            device=self.device, sharded=self.mesh is not None,
            budget=self.smem_budget, program=self.executor.program)

    def _plan_point(self, cand: Dict[str, Any]) -> Dict[str, Any]:
        return CC.plan_point(self.spec, executor=self.executor.name,
                             mode=cand["mode"], n_shards=self.n_shards,
                             lane=cand.get("lane"))

    def _measured(self, cands: list) -> Optional[Dict[str, Any]]:
        """Tier 2: the candidate with the best measured gens/s, or None
        when no table covers the heuristic's own point (an uncovered spec
        keeps the heuristic, and a covered one's pick is provably no
        slower than it measured)."""
        table = self.cost_table
        if table is None:
            return None
        rated = [(c, table.lookup(self._plan_point(c), c["gens_per_launch"]))
                 for c in cands]
        # sel_lane="auto": the heuristic never switches lane on its own,
        # measurement does
        if self.spec.sel_lane == "auto":
            twin = "gather" if self.cfg.sel_lane == "onehot" else "onehot"
            if twin != "onehot" or self.spec.n <= G.ONEHOT_MAX_N:
                rated += [(c, table.lookup(self._plan_point(c),
                                           c["gens_per_launch"]))
                          for c in self._lane_candidates(twin)]
        if len(rated) < 2 or rated[0][1] is None:
            return None
        best_c, best_v = rated[0]
        for c, v in rated[1:]:
            if v is not None and v > best_v:
                best_c, best_v = c, v
        return dict(best_c, plan_source="measured",
                    plan_gens_per_s=round(best_v, 3))

    def _epoch_plan(self) -> Dict[str, Any]:
        spec = self.spec
        cands = self.epoch_candidates()
        want = plan_mode(self.plan_override)
        if want is None:
            plan = (self._measured(cands)
                    or dict(cands[0], plan_source="heuristic"))
        else:
            plan = next((dict(c, plan_source="forced") for c in cands
                         if c["mode"] == want), None)
            if plan is None:
                hint = ""
                if want == "streamed":
                    hint = (" — streamed is only offered when the resident "
                            "epoch does not fit the card or the planning "
                            "budget (this spec fits resident; lower "
                            "smem_budget to force streaming)")
                elif want == "resident-sharded" and self.mesh is None:
                    hint = (" — resident-sharded needs a mesh "
                            "(EngineOptions(mesh=...))")
                raise ValueError(
                    f"plan_override mode {want!r} is not feasible for this "
                    f"spec (candidates: {[c['mode'] for c in cands]})"
                    + hint)
        n, v, p = self.cfg.n, self.cfg.v, self.cfg.p
        prog = self.executor.program
        data = K.data_words(prog)
        if plan["mode"] == "streamed":
            if self.stream_tile_islands is not None:
                t = int(self.stream_tile_islands)
                reason = K.streamed_tile_reason(
                    self.cfg, spec.n_repeats, self.i_local, t, self.device,
                    prog)
                if reason is not None:
                    raise ValueError(reason)
                plan["tile_islands"] = t
            plan["smem_estimate_bytes"] = K.epoch_smem_bytes(n, v, p, 32,
                                                             data)
            plan["population_bits"], plan["pair_threads"] = 32, 1
        elif plan["mode"].startswith("resident"):
            plan["smem_estimate_bytes"] = K.resident_block_bytes(self.cfg,
                                                                 prog)
            plan["population_bits"] = K.population_bits(self.cfg.c)
            plan["pair_threads"] = K.pair_threads(self.cfg, self.i_local,
                                                  self.device, prog)
            if plan["mode"] != "resident-free":
                plan["clusters_at_once"] = K.clusters_at_once(
                    self.cfg, self.i_local, self.device, prog,
                    plan["pair_threads"])
        elif (self.executor.name == "fused"
              and K.block_reason(self.cfg, prog) is None):
            # (K1's global form keeps no replica in shared memory)
            plan["smem_estimate_bytes"] = K.smem_bytes(n, v, p, data)
            plan["population_bits"], plan["pair_threads"] = 32, 1
        return plan

    @staticmethod
    def supports(spec: GASpec, mesh=None) -> Optional[str]:
        if spec.topology == "single":
            return "spec pins topology='single'; use a single backend"
        if mesh is not None:
            axes = _mesh_axes(spec, mesh)
            missing = [a for a in axes if a not in mesh.shape]
            if missing:
                return (f"mesh_axes {missing} not in the mesh "
                        f"(axes: {tuple(mesh.axis_names)})")
            n_shards = mesh.shards(axes)
            if spec.n_islands % n_shards:
                return (f"n_islands={spec.n_islands} must divide evenly over "
                        f"the {n_shards} mesh shard(s)")
        return None

    def init(self):
        if self.spec.n_repeats > 1:
            return _stack_island_replicas(self.icfg, self.spec.n_repeats,
                                          self.device)
        return ISL.init_islands_fast(self.icfg, device=self.device)

    def init_packed(self, seeds):
        _check_seeds(seeds, self.spec.n_repeats)
        if self.spec.n_repeats == 1:
            return _islands_seeded(self.icfg, seeds[0], self.device)
        return _stack_island_replicas_seeded(self.icfg, seeds, self.device)

    # ---- runners: shards -> (shards', best_y, best_x, traj_mean) --------
    # Each takes and returns a list of one state a shard ([R?, I_local, ...]
    # on the shard's device; without a mesh, the one whole state), with a
    # list a shard of: each island's best of every migration interval the
    # launch ran ([K, R?, I_local]) and the final fitness means
    # ([R?, I_local]).  The fused runners see a stack as [G, I, ...] replica
    # groups.

    def _grouped(self, states: G.GAState) -> G.GAState:
        if self.spec.n_repeats > 1:
            return states
        return G.GAState(*(t.unsqueeze(0) for t in states))

    def _ungrouped(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return t if self.spec.n_repeats > 1 else t.select(dim, 0)

    @staticmethod
    def _gridded_block(blk, states: G.GAState):
        """The executor block over the flattened [R * I] stack."""
        lead = states.x.shape[:-2]
        flat = G.GAState(*(t.reshape((-1,) + t.shape[len(lead):])
                           for t in states))
        flat, by, bx, _tb, tm = blk(flat)
        states = G.GAState(*(t.reshape(lead + t.shape[1:]) for t in flat))
        return (states, by.reshape((1,) + lead),
                bx.reshape((1,) + lead + (-1,)), tm.reshape(lead + (-1,)))

    def _resident_runner(self, k: int, *, migrate: bool = True):
        """ONE K2 launch: k whole intervals with the ring inside the kernel,
        or (migrate=False, the resident-free mode) k generations — as whole
        intervals when they divide k, so the best folds as `islands`
        samples it."""
        e = self.icfg.migrate_every
        if migrate:
            intervals = k
        elif k % e == 0:
            intervals = k // e
        else:
            e, intervals = k, 1
        prog, sq = self.executor.program, self._ungrouped
        lanes = self.plan["pair_threads"]

        def launch(shards):
            (states,) = shards
            g = self._grouped(states)
            x, sel, cross, mut, y, by, bx = K.ga_epoch_kernel(
                g.x, g.sel_lfsr, g.cross_lfsr, g.mut_lfsr, cfg=self.cfg,
                program=prog, migrate_every=e, intervals=intervals,
                migrate=migrate, lanes=lanes)
            state = G.GAState(sq(x), sq(sel), sq(cross), sq(mut),
                              states.k + e * intervals)
            return ([state], [sq(by, 1)], [sq(bx, 1)],
                    [sq(launch_sample(y)[1])])

        return launch

    def _streamed_runner(self, k: int):
        """ONE K3 launch: k whole intervals with the ring (or, without
        migration, none) inside the kernel."""
        e, tile = self.icfg.migrate_every, self.plan["tile_islands"]
        migrate = self.spec.migration == "ring"
        prog, sq = self.executor.program, self._ungrouped

        def launch(shards):
            (states,) = shards
            g = self._grouped(states)
            x, sel, cross, mut, y, by, bx = K.ga_streamed_epoch_kernel(
                g.x, g.sel_lfsr, g.cross_lfsr, g.mut_lfsr, cfg=self.cfg,
                program=prog, migrate_every=e, tile_islands=tile,
                migrate=migrate, intervals=k, splice=True)
            state = G.GAState(sq(x), sq(sel), sq(cross), sq(mut),
                              states.k + k * e)
            return ([state], [sq(by, 1)], [sq(bx, 1)],
                    [sq(launch_sample(y)[1])])

        return launch

    # ---- on a mesh: the split and the gather around a segment --------------

    def _island_dim(self) -> int:
        return 0 if self.spec.n_repeats == 1 else 1

    def _split(self, state: G.GAState) -> list:
        """The global state's island blocks, copied onto their shards'
        devices."""
        a, il = self._island_dim(), self.i_local
        return [G.GAState(*(t.narrow(a, j * il, il).to(dev, copy=True)
                            for t in state))
                for j, dev in enumerate(self._shard_devices)]

    def _gather(self, parts: list, dim: int) -> torch.Tensor:
        """One tensor on the run's device from a tensor a shard."""
        if len(parts) == 1:
            return parts[0].to(self.device)
        return torch.cat([t.to(self.device) for t in parts], dim=dim)

    def _gather_state(self, shards: list) -> G.GAState:
        """The shards' states as one global state on the run's device."""
        a = self._island_dim()
        return G.GAState(*(self._gather(list(leaf), a)
                           for leaf in zip(*shards)))

    def _gridded_runner(self):
        """One epoch: an executor block of `migrate_every` generations a
        shard over its flattened [R * I_local] stack, then
        `islands.migrate_ring_sharded` on the migration fitness (without a
        mesh, `migrate_ring` bit for bit)."""
        blk = self.executor.block(self.icfg.migrate_every)
        fit, mini = self.executor.fit, self.spec.minimize
        migrate = self.spec.migration == "ring"

        def epoch(shards):
            outs = [self._gridded_block(blk, s) for s in shards]
            shards = [o[0] for o in outs]
            if migrate:
                shards, _ex, _ey = ISL.migrate_ring_sharded(
                    shards, [fit(s.x) for s in shards], minimize=mini,
                    mesh=self.mesh, axis_names=self._mesh_axes)
            return (shards, [o[1] for o in outs], [o[2] for o in outs],
                    [o[3] for o in outs])

        return epoch

    def _resident_sharded_runner(self):
        """One interval: a K2 launch a shard in the boundary form (the
        ring among the shard's islands inside the kernel), then each
        shard's last elite crosses to the next shard and splices into its
        island 0 at the worst slot the kernel found there."""
        e, prog, sq = (self.icfg.migrate_every, self.executor.program,
                       self._ungrouped)
        lanes = self.plan["pair_threads"]

        def launch(shards):
            outs = []
            for s in shards:
                g = self._grouped(s)
                outs.append(K.ga_epoch_kernel(
                    g.x, g.sel_lfsr, g.cross_lfsr, g.mut_lfsr, cfg=self.cfg,
                    program=prog, migrate_every=e, intervals=1,
                    boundary=True, lanes=lanes))
            recv = ISL.ring_shift_sharded([o[7] for o in outs], self.mesh,
                                          self._mesh_axes)
            new, bys, bxs, tms = [], [], [], []
            for s, o, r in zip(shards, outs, recv):
                x, sel, cross, mut, y, by, bx, _send, w0 = o
                # x is the launch's fresh output: the splice writes in place
                x[:, 0] = ISL.splice_at(x[:, 0], w0, r)
                new.append(G.GAState(sq(x), sq(sel), sq(cross), sq(mut),
                                     s.k + e))
                bys.append(sq(by, 1))
                bxs.append(sq(bx, 1))
                tms.append(sq(launch_sample(y)[1]))
            return new, bys, bxs, tms

        return launch

    def _streamed_sharded_runner(self, k: int):
        """k intervals, each a K3 launch a shard in the one-interval form
        (no `splice`), then the pre-splice elites shifted by one island
        across the whole ring and spliced into the worst slots."""
        e, tile = self.icfg.migrate_every, self.plan["tile_islands"]
        migrate = self.spec.migration == "ring"
        prog, sq = self.executor.program, self._ungrouped

        def launch(shards):
            gs = [self._grouped(s) for s in shards]
            bys, bxs = [[] for _ in gs], [[] for _ in gs]
            for _ in range(k):
                outs = [K.ga_streamed_epoch_kernel(
                    g.x, g.sel_lfsr, g.cross_lfsr, g.mut_lfsr, cfg=self.cfg,
                    program=prog, migrate_every=e, tile_islands=tile,
                    migrate=migrate) for g in gs]
                xs = [o[0] for o in outs]
                if migrate:
                    recv = ISL.ring_shift_sharded(
                        [o[7][:, -1] for o in outs], self.mesh,
                        self._mesh_axes)
                    xs = [ISL.splice_at(o[0], o[8], torch.cat(
                        [r.unsqueeze(1), o[7][:, :-1]], dim=1))
                        for o, r in zip(outs, recv)]
                gs = [G.GAState(x, o[1], o[2], o[3], g.k)
                      for x, o, g in zip(xs, outs, gs)]
                for j, o in enumerate(outs):
                    bys[j].append(o[5])
                    bxs[j].append(o[6])
            new = [G.GAState(sq(g.x), sq(g.sel_lfsr), sq(g.cross_lfsr),
                             sq(g.mut_lfsr), s.k + k * e)
                   for g, s in zip(gs, shards)]
            return (new, [sq(torch.stack(b), 1) for b in bys],
                    [sq(torch.stack(b), 1) for b in bxs],
                    [sq(launch_sample(o[4])[1]) for o in outs])

        return launch

    def _schedule(self, epochs: int):
        """The runners of one segment and the generations a trajectory
        sample stands for.  Every plan covers the same epochs *
        migrate_every generations; resident-free paces in raw generations
        (no ring, no interval boundary), the others in whole intervals."""
        e, mode = self.icfg.migrate_every, self.plan["mode"]
        if mode == "resident-free":
            g_max = self.plan["gens_per_launch"]
            sched, left = [], epochs * e
            while left:
                g = min(g_max, left)
                sched.append(self._cached_runner(
                    lambda g=g: self._resident_runner(g, migrate=False),
                    "resident-free", g))
                left -= g
            return sched, g_max
        per_launch = self.plan["epochs_per_launch"]
        sharded = self.mesh is not None
        sched, left = [], epochs
        while left:
            k = min(per_launch, left)
            if mode == "resident":
                sched.append(self._cached_runner(
                    lambda k=k: self._resident_runner(k), "resident", k))
            elif mode == "resident-sharded":
                sched.append(self._cached_runner(
                    self._resident_sharded_runner, "resident-sharded"))
            elif mode == "streamed":
                build = (self._streamed_sharded_runner if sharded
                         else self._streamed_runner)
                sched.append(self._cached_runner(
                    lambda k=k: build(k), "streamed", k,
                    self.plan["tile_islands"]))
            else:
                sched.append(self._cached_runner(self._gridded_runner,
                                                 "gridded"))
            left -= k
        return sched, e * per_launch

    def segment(self, state, gens: int) -> Segment:
        """Run the schedule, then fold the per-replica best as `islands`
        samples it: per migration interval, the first island holding the
        interval's best, kept on strict improvement.  (The JAX package folds
        a resident launch's intervals first, so under a tie between islands
        at different intervals its best_x depends on the plan; folding at
        the interval makes every plan give `islands`' best_x.)  One
        trajectory sample a launch: the best over its intervals and
        islands, and the mean of its final fitness.  On a mesh the state is
        split onto the shards once, before the first launch, and gathered
        once, after the last.

        The fold runs on the bests' device (`fold_island_bests`) before
        the segment's wait; the host reads its packed result back once.

        Traced, the segment is a `topology.segment` span (attribute `plan`,
        and `population_bits` and `pair_threads` where the plan's kernel
        holds its population in shared memory; counters `intervals` and
        `migrations`, and on a card for a K2 ring `cluster_waves`, its
        launches times the waves of clusters each takes; `ffm_data_bytes` for a problem with data; off
        a mesh on a card also `SegmentClock`'s timing events and launch
        counts), a
        `topology.launch` span a runner call, a `segment.fold` span around
        the fold's enqueue (counter `intervals_folded`), `segment.wait`
        and `segment.result` (`read_segment`)."""
        e = self.icfg.migrate_every
        epochs = max(1, math.ceil(gens / e))
        mini = self.spec.minimize
        migrations = epochs if self.spec.migration == "ring" else 0
        sched, unit = self._schedule(epochs)
        bys, bxs, tms = [], [], []
        a = self._island_dim()
        attrs = {"plan": self.plan["mode"]}
        for key in ("population_bits", "pair_threads"):
            if key in self.plan:
                attrs[key] = self.plan[key]
        with TR.span("topology.segment", **attrs) as sp:
            sp.count("intervals", epochs)
            sp.count("migrations", migrations)
            count_data_bytes(sp, self.executor.program)
            at_once = self.plan.get("clusters_at_once")
            if at_once:
                sp.count("cluster_waves", len(sched) * self.n_shards
                         * -(-self.spec.n_repeats // at_once))
            # on a mesh the launches run on several devices: no clock
            mark = self.clock.start(sp and self.mesh is None, K.LAUNCHES)
            shards = [state] if self.mesh is None else self._split(state)
            for runner in sched:
                with TR.span("topology.launch"):
                    shards, by, bx, tm = runner(shards)
                bys.append(self._gather(by, a + 1))
                bxs.append(self._gather(bx, a + 1))
                tms.append(self._gather(tm, a))
            state = (shards[0] if self.mesh is None
                     else self._gather_state(shards))
            with TR.span("segment.fold") as fp:
                fp.count("intervals_folded", sum(t.shape[0] for t in bys))
                words = fold_island_bests(bys, bxs, tms, self.spec.n_repeats,
                                          mini)
            self.clock.stop(sp, mark, K.LAUNCHES)
            rep = read_segment(words, self.spec.n_repeats, self.cfg.v,
                               len(sched))
        tele = RT.RunTelemetry(
            plan=RT.PlanInfo.from_plan(self.plan),
            topology=RT.TopologyInfo(
                n_islands=self.icfg.n_islands, n_shards=self.n_shards,
                sharded=self.mesh is not None, launches=len(sched),
                migrations=migrations, telemetry_unit_gens=unit))
        return build_segment(state, epochs * e, *rep, minimize=mini,
                             telemetry=tele)


def fold_island_bests(bys, bxs, tms, n_repeats: int,
                      minimize: bool) -> torch.Tensor:
    """A segment's per-interval island bests folded on their device, as
    `islands` samples them, into `pack_segment`'s one int32 tensor.

    `bys` [K, R?, I] f32, `bxs` [K, R?, I, V] int32 and `tms` [R?, I, ...]
    f32 (a gridded launch's means a generation) hold a launch each.  Per
    interval the first island at the extreme (NaN counts as one, as NumPy's
    argmin counts it); across intervals the earliest strict improvement on
    +-inf, so an interval whose pick is NaN gives nothing and a replica
    nothing improves keeps +-inf and zeros.  One trajectory sample a
    launch: the extreme over its intervals and islands, NaN propagating;
    its mean the launch means [R, L, -1]."""
    sizes = [t.shape[0] for t in bys]
    by = torch.cat(bys).reshape(sum(sizes), n_repeats, -1)      # [T, R, I]
    bx = torch.cat(bxs).reshape(by.shape + (-1,))                # [.., V]
    tm = torch.stack([t.reshape(n_repeats, -1) for t in tms], 1)  # [R, L, I]
    arg, red = ((torch.argmin, torch.amin) if minimize
                else (torch.argmax, torch.amax))
    worst = math.inf if minimize else -math.inf
    isl = arg(by, dim=2)                                         # [T, R]
    ep = by.gather(2, isl.unsqueeze(2)).squeeze(2)
    t = arg(ep.masked_fill(ep.isnan(), worst), dim=0)            # [R]
    rows = torch.arange(n_repeats, device=by.device)
    y = ep[t, rows]
    found = y < worst if minimize else y > worst
    best = torch.where(found, y, worst)
    best_x = torch.where(found.unsqueeze(1), bx[t, rows, isl[t, rows]], 0)
    # all launches but the last hold sizes[0] intervals
    head = sizes[0] * (len(sizes) - 1)
    tb = torch.cat([
        red(by[:head].reshape(-1, sizes[0], *by.shape[1:]), dim=(1, 3)).T,
        red(by[head:], dim=(0, 2)).unsqueeze(1)], dim=1)         # [R, L]
    return pack_segment(best, best_x, tb, tm)


def launch_sample(y: torch.Tensor, minimize: Optional[bool] = None):
    """A launch's trajectory sample of its fitness y [..., N]: (the extreme,
    None without `minimize`, and the mean over the population)."""
    ext = None
    if minimize is not None:
        ext = torch.amin(y, dim=-1) if minimize else torch.amax(y, dim=-1)
    return ext, torch.mean(y, dim=-1)


def pack_segment(best: torch.Tensor, best_x: torch.Tensor,
                 traj_best: torch.Tensor,
                 traj_mean: torch.Tensor) -> torch.Tensor:
    """A segment's result as one int32 tensor on its device: the sample
    means [R, S, X] f32 (X averaged on the host; [R, S] is X = 1), best [R]
    f32, best_x [R, V] int32 and traj_best [R, S] f32."""
    return torch.cat([traj_mean.reshape(-1).view(torch.int32),
                      best.reshape(-1).view(torch.int32), best_x.reshape(-1),
                      traj_best.reshape(-1).view(torch.int32)])


def read_segment(words: torch.Tensor, n_repeats: int, v: int,
                 samples: int):
    """`pack_segment`'s words read back once, in a `segment.result` span
    (counter `readback_bytes`), and unpacked: (best [R], best_x [R, V]
    uint32, traj_best [R, S], traj_mean [R, S], float32 means over X)."""
    r_ = n_repeats
    with TR.span("segment.result") as rp:
        host = convert.words_to_numpy(words)
        rp.count("readback_bytes", host.nbytes)
        f = host.view(np.float32)
        n_tm = host.size - r_ - r_ * v - samples * r_
        rep_y = f[n_tm:n_tm + r_]
        rep_x = host[n_tm + r_:n_tm + r_ + r_ * v].reshape(r_, v)
        tb = f[n_tm + r_ + r_ * v:].reshape(r_, samples)
        return rep_y, rep_x, tb, f[:n_tm].reshape(r_, samples, -1).mean(2)


def build_segment(state, gens: int, rep_y, rep_x, tb_rep, tm_rep, *,
                  minimize: bool, telemetry: RT.RunTelemetry,
                  stacked: bool = True) -> Segment:
    """The `Segment` of `read_segment`'s arrays, and with `stacked` the
    arrays as the telemetry's `ReplicaStats`."""
    r = _arg_best(rep_y, minimize)
    if stacked:
        telemetry.per_repeat = RT.ReplicaStats(
            best=rep_y, best_x=rep_x, traj_best=tb_rep, traj_mean=tm_rep)
    reduce = np.min if minimize else np.max
    return Segment(state=state, best_y=float(rep_y[r]), best_x=rep_x[r],
                   traj_best=reduce(tb_rep, axis=0),
                   traj_mean=tm_rep.mean(axis=0), gens=gens,
                   telemetry=telemetry)


TOPOLOGIES: Dict[str, type] = {
    SingleTopology.name: SingleTopology,
    IslandRingTopology.name: IslandRingTopology,
}

class ComposedBackend(Backend):
    """A (topology × executor) pair behind the uniform Backend interface."""

    executor_cls: type = None
    topology_cls: type = None

    def __init__(self, spec: GASpec, *, options=None):
        super().__init__(spec, options=options)
        # executors are seed-free (cfg.seed only seeds init): one per shape
        self.executor: Executor = CC.RUNNER_CACHE.get_or_build(
            CC.runner_key(self.spec, self.topology_cls.name,
                          self.executor_cls.name, self.device, "executor"),
            lambda: self.executor_cls(self.spec))
        self.topology: Topology = self.topology_cls(
            self.spec, self.executor, device=self.device, mesh=self.mesh,
            cost_table=self.cost_table,
            plan_override=self.options.plan_override,
            smem_budget=self.options.smem_budget,
            stream_tile_islands=self.options.stream_tile_islands)
        # a measured cross-lane plan runs the topology's own executor copy
        self.executor = self.topology.executor

    @classmethod
    def supports(cls, spec: GASpec, mesh=None) -> Optional[str]:
        reason = cls.executor_cls.supports(spec)
        if reason is not None:
            return reason
        return cls.topology_cls.supports(spec, mesh)

    def init(self):
        return self.topology.init()

    def init_packed(self, seeds):
        return self.topology.init_packed(seeds)

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
IslandsBackend = _compose("islands", ReferenceExecutor, IslandRingTopology)
FusedIslandsBackend = _compose("fused-islands", FusedExecutor,
                               IslandRingTopology)



# ---------------------------------------------------------------------------
# eager — a host generation loop for fitness evaluated outside the step
# ---------------------------------------------------------------------------


def _pooled_fitness(fit, pool, workers: int):
    """Population-parallel host fitness: split the (N, V) batch into
    `workers` contiguous row chunks and evaluate them on `pool`, a bounded
    thread pool that outlives the call.  Chunks come back in submission
    order and are concatenated, so the result is bitwise identical to the
    serial batch call — the pool only overlaps the (GIL-releasing or
    I/O-bound) fitness work."""

    def pooled(x):
        n = x.shape[0]
        chunk = max(1, -(-n // workers))
        parts = [x[i:i + chunk] for i in range(0, n, chunk)]
        outs = list(pool.map(lambda p: G.host_fitness(fit(p)), parts))
        return np.concatenate(outs, axis=0)

    return pooled


class EagerBackend(Backend):
    """`core.ga.run_eager` a replica: each generation the fitness crosses
    to the host, and the operators run as the plain tensor step on the
    engine's device.  `n_repeats` replicas run one after another."""

    name = "eager"

    def __init__(self, spec: GASpec, *, options=None):
        super().__init__(spec, options=options)
        spec = self.spec
        self.fit = spec.fitness_fn()
        workers = self.options.fitness_workers
        if workers > 1:
            # one pool a backend, as the JAX package keeps it; its idle
            # workers end when the backend is collected
            from concurrent.futures import ThreadPoolExecutor
            pool = ThreadPoolExecutor(max_workers=workers,
                                      thread_name_prefix="ga-fitness")
            weakref.finalize(self, pool.shutdown, wait=False)
            self.fit = _pooled_fitness(self.fit, pool, workers)
        self.apply_ops = OPS.make_apply_ops(spec.selection, spec.crossover,
                                            spec.mutation)

    @staticmethod
    def supports(spec: GASpec, mesh=None) -> Optional[str]:
        if spec.effective_topology != "single":
            return "eager driver has no migration; use an island_ring backend"
        if mesh is not None:
            return ("eager driver is host-local and would silently ignore "
                    "the mesh; use an island_ring backend (n_islands > 1)")
        return None

    def init(self):
        if self.spec.n_repeats == 1:
            return G.init_state(self.cfg, device=self.device)
        return _stack_states(self.cfg, self.spec.n_repeats, self.device)

    def _run(self, state, gens: int) -> G.GARun:
        return G.run_eager(self.cfg, self.fit, gens, state,
                           apply_ops_fn=self.apply_ops, device=self.device)

    def segment(self, state, gens: int) -> Segment:
        R = self.spec.n_repeats
        mini = self.spec.minimize
        if R == 1:
            out = self._run(state, gens)
            return Segment(state=out.state, best_y=float(out.best_y),
                           best_x=convert.words_to_numpy(out.best_x),
                           traj_best=out.traj_best.numpy(),
                           traj_mean=out.traj_mean.numpy(), gens=gens)
        outs = [self._run(G.GAState(*(t[r] for t in state)), gens)
                for r in range(R)]
        per_rep = np.array([float(o.best_y) for o in outs])
        i = _arg_best(per_rep, mini)
        tb = np.stack([o.traj_best.numpy() for o in outs])
        reduce = np.min if mini else np.max
        return Segment(state=G.stack_states([o.state for o in outs]),
                       best_y=float(per_rep[i]),
                       best_x=convert.words_to_numpy(outs[i].best_x),
                       traj_best=reduce(tb, axis=0),
                       traj_mean=np.stack([o.traj_mean.numpy()
                                           for o in outs]).mean(axis=0),
                       gens=gens,
                       telemetry=RT.RunTelemetry(
                           per_repeat=RT.ReplicaStats(best=per_rep)))


BACKENDS: Dict[str, type] = {
    ReferenceBackend.name: ReferenceBackend,
    FusedBackend.name: FusedBackend,
    IslandsBackend.name: IslandsBackend,
    FusedIslandsBackend.name: FusedIslandsBackend,
    EagerBackend.name: EagerBackend,
}
