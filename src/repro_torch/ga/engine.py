"""The Engine: one entry point for every GA execution strategy.

    from repro_torch import ga

    spec = ga.GASpec(problem="F3", n=64, bits_per_var=10, generations=100)
    result = ga.solve(spec)                      # auto-picks a backend
    result = ga.solve(spec, backend="fused")     # or pin one explicitly
    result = ga.solve(spec, options=ga.EngineOptions(device="cpu"))

Runs live on the card (``EngineOptions(device="cuda")``, the default)
unless the options ask for the CPU; without a card an engine refuses to
build instead of carrying on on the CPU.  `EngineOptions(mesh=...)` shards
the island axis over a `repro_torch.launch.mesh.Mesh`.  Backend selection
(`backend="auto"`) walks the capability matrix: eager when the fitness is
evaluated outside the operator step (`jit_fitness=False`); for an island
spec fused-islands on CUDA, then islands; for one population fused on
CUDA, then reference — the kernels first where they run.  On a mesh only
the island-ring backends take a spec (the others refuse a mesh).  Pinning
a backend that cannot run the spec warns and falls back to the next
capable one — a decision about what the spec needs, never about the
device or a kernel.

Streaming + checkpointing:

    eng = ga.Engine(spec)
    for tele in eng.run_chunked(chunk_generations=25, ckpt_dir="/tmp/ga"):
        print(tele["gens_done"], tele["best_fitness"])

Each chunk persists the full backend-native GAState through
`repro_torch.ckpt.checkpoint` in the JAX package's format, so a killed run
resumes from the last chunk (`resume=True`, the default) in either
package, and on any mesh the spec divides over (a step holds the state
whole, as the engine keeps it between segments).
`PackedEngine` runs many shape-compatible jobs as the replica slots of
one backend run, each bit-identical to its solo run, and
`repack_checkpoint` slices a pack checkpoint down to some of its jobs.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import faults as FLT
from repro_torch import trace as TR
from repro_torch.ckpt import checkpoint as CKPT
from repro_torch.ga import telemetry as RT
from repro_torch.ga.backends import BACKENDS, Backend, Segment
from repro_torch.ga.options import EngineOptions, resolve_options
from repro_torch.ga.spec import GASpec


class BackendUnsupported(ValueError):
    """Raised when no backend can run a spec."""


def capability_matrix(spec: GASpec, mesh=None) -> Dict[str, Optional[str]]:
    """Backend name -> None (supported) or the reason it cannot run."""
    return {name: cls.supports(spec, mesh) for name, cls in BACKENDS.items()}


def _auto_order(spec: GASpec, device: torch.device):
    if not spec.jit_fitness:
        return ["eager"]
    cuda = device.type == "cuda"
    order = []
    if spec.effective_topology == "island_ring":
        if cuda:
            order.append("fused-islands")   # the hand-written kernels
        order.append("islands")
    if cuda:
        order.append("fused")
    order += ["reference", "islands", "eager"]
    return order


def resolve_backend(spec: GASpec, backend: str = "auto",
                    device="cuda", mesh=None) -> str:
    """Pick the backend name for a spec (over `mesh`, when given), with
    graceful fallback."""
    device = torch.device(device)
    caps = capability_matrix(spec, mesh)
    if backend != "auto":
        if backend not in BACKENDS:
            raise BackendUnsupported(
                f"unknown backend {backend!r}; registered: {sorted(BACKENDS)}")
        reason = caps[backend]
        if reason is None:
            return backend
        fallback = next((n for n in _auto_order(spec, device)
                         if caps[n] is None), None)
        if fallback is None:
            raise BackendUnsupported(
                f"backend {backend!r} cannot run this spec ({reason}) and "
                f"no fallback applies: {caps}")
        warnings.warn(f"backend {backend!r} cannot run this spec ({reason}); "
                      f"falling back to {fallback!r}", stacklevel=3)
        return fallback
    for name in _auto_order(spec, device):
        if caps[name] is None:
            return name
    raise BackendUnsupported(f"no backend supports this spec: {caps}")


@dataclasses.dataclass
class EngineResult:
    """Uniform result across backends (fitness in real units — lut-mode
    fixed-point scaling is already divided out).  How the run executed is
    in `telemetry` (ga.RunTelemetry: .topology / .per_repeat)."""

    spec: GASpec
    backend: str
    best_fitness: float
    best_x: np.ndarray            # uint32[V] chromosome
    best_params: np.ndarray       # float64[V] decoded variables
    traj_best: np.ndarray
    traj_mean: np.ndarray
    generations: int
    wall_s: float
    telemetry: RT.RunTelemetry = dataclasses.field(
        default_factory=RT.RunTelemetry)
    state: object = None          # final backend-native state (GAState)


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (the port's block_until_ready)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _refuse_backend(extra: Dict, ckpt_dir: str, backend: str,
                    hint: str) -> None:
    ck_backend = extra.get("backend")
    if ck_backend is not None and ck_backend != backend:
        raise ValueError(
            f"checkpoint in {ckpt_dir} was written by the {ck_backend!r} "
            f"backend; resuming it with {backend!r} would load a mismatched "
            f"state layout{hint}")


class Engine:
    """A spec bound to a backend on the options' device.  What it builds
    for the spec's shape comes from `ga.RUNNER_CACHE` (see
    `repro_torch.ga.compile_cache`)."""

    def __init__(self, spec: GASpec, backend: str = "auto", *,
                 options: Optional[EngineOptions] = None):
        self.spec = spec
        self.options = resolve_options(options)
        self.device = self.options.torch_device()
        self.backend_name = resolve_backend(spec, backend, self.device,
                                            self.options.mesh)
        # resolved ONCE and shared with every checkpoint write: fault-rule
        # occurrence counters live on the injector instance
        self.faults = FLT.resolve_faults(self.options.faults)
        self.backend: Backend = BACKENDS[self.backend_name](
            spec, options=self.options)
        # the run id of this engine's spans (`repro_torch.trace`)
        self.trace_run = TR.new_run()

    def init_state(self):
        with TR.span("engine.init_state", (self.trace_run, None)):
            return self.backend.init()

    def _result(self, seg: Segment, wall_s: float) -> EngineResult:
        scale = self.spec.fitness_scale()
        tele = seg.telemetry
        if tele.problem is None:
            tele.problem = self.spec.problem or "blackbox"
            tele.n_vars = self.spec.v
        return EngineResult(
            spec=self.spec, backend=self.backend_name,
            best_fitness=seg.best_y / scale,
            best_x=np.asarray(seg.best_x, np.uint32),
            best_params=self.spec.decode(seg.best_x),
            traj_best=np.asarray(seg.traj_best) / scale,
            traj_mean=np.asarray(seg.traj_mean) / scale,
            generations=seg.gens, wall_s=wall_s, telemetry=tele,
            state=seg.state)

    def run(self, generations: Optional[int] = None,
            state=None) -> EngineResult:
        gens = generations or self.spec.generations
        with TR.span("engine.run", (self.trace_run, None)):
            t0 = time.perf_counter()
            if state is None:
                state = self.init_state()
            seg = self.backend.segment(state, gens)
            _sync(self.device)
            return self._result(seg, time.perf_counter() - t0)

    def run_chunked(self, *, chunk_generations: Optional[int] = None,
                    generations: Optional[int] = None,
                    ckpt_dir: Optional[str] = None,
                    resume: bool = True,
                    fault_tag: str = "") -> Iterator[Dict[str, Any]]:
        """Stream the run chunk by chunk, yielding per-chunk telemetry.

        With `ckpt_dir`, each chunk checkpoints the backend-native state; a
        restarted run with the same spec/ckpt_dir resumes at the last chunk
        (the newest VALID one — a corrupt step falls back to its
        predecessor; the first chunk after a resume carries
        ``"resumed_from"``).  `fault_tag` rides into every
        `repro_torch.faults` injection-site tag so armed fault rules can
        target one run.

        Telemetry granularity follows the backend's LAUNCH unit: island
        topologies sample trajectories once per launch, and a resident or
        streamed launch covers several migration intervals — UP TO
        `telemetry_unit_gens` generations per `traj_best` entry;
        `migrations` counts every ring migration including the ones folded
        inside a launch.
        """
        total = generations or self.spec.generations
        # the default chunk never undercuts gens_per_epoch: a chunk smaller
        # than one launch would cap the interval folding the spec asked for
        # (an explicit chunk_generations is honored as given)
        chunk = chunk_generations or max(1, total // 10,
                                         self.spec.gens_per_epoch)
        scale = self.spec.fitness_scale()
        mini = self.spec.minimize

        state = self.init_state()
        done, chunk_idx, migrations = 0, 0, 0
        resumed_from: Optional[int] = None
        best_y: Optional[float] = None
        best_x = None
        if ckpt_dir and resume:
            step = CKPT.latest_step(ckpt_dir)
            if step is not None:
                resumed_from = int(step)
                state, extra = CKPT.restore(ckpt_dir, step, state)
                _refuse_backend(extra, ckpt_dir, self.backend_name,
                                " — rerun with the original backend or a "
                                "fresh ckpt_dir")
                done = int(extra["gens_done"])
                chunk_idx = int(extra.get("chunk_idx", 0))
                migrations = int(extra.get("migrations", 0))
                best_y = float(extra["best_y"])
                best_x = np.asarray(extra["best_x"], np.uint32)

        if done >= total and best_y is not None:
            # resumed a finished run: surface the stored result instead of
            # yielding nothing
            yield {
                "chunk": chunk_idx, "gens_done": done, "gens_total": total,
                "chunk_gens": 0, "chunk_best": best_y / scale,
                "best_fitness": best_y / scale,
                "best_params": self.spec.decode(best_x),
                "traj_best": np.empty((0,)), "wall_s": 0.0,
                "gens_per_s": 0.0, "backend": self.backend_name,
                "problem": self.spec.problem or "blackbox",
                "n_vars": self.spec.v,
                "migrations": migrations,
                "already_complete": True,
            }
            return

        while done < total:
            tag = f"{fault_tag}|{self.backend_name}|chunk={chunk_idx + 1}"
            if self.faults is not None:
                self.faults.inject("slow_chunk", tag)
            with TR.span("engine.chunk", (self.trace_run, chunk_idx + 1)):
                t0 = time.perf_counter()
                seg = self.backend.segment(state, min(chunk, total - done))
                _sync(self.device)
                dt = time.perf_counter() - t0
                if self.faults is not None:
                    # crash AFTER the compute, BEFORE the checkpoint: the
                    # chunk's work is lost, earlier checkpoints are not, and
                    # a retry recomputes it deterministically
                    self.faults.inject("chunk_crash", tag)
                state = seg.state
                done += seg.gens
                chunk_idx += 1
                migrations += seg.telemetry.topology.migrations
                if resumed_from is not None:
                    seg.telemetry.resumed_from = resumed_from
                if best_y is None or (seg.best_y < best_y if mini
                                      else seg.best_y > best_y):
                    best_y, best_x = seg.best_y, np.asarray(seg.best_x)
                if ckpt_dir:
                    CKPT.save(ckpt_dir, step=done, tree=state,
                              extra={"gens_done": done,
                                     "chunk_idx": chunk_idx,
                                     "migrations": migrations,
                                     "best_y": float(best_y),
                                     "best_x": [int(v) for v in best_x],
                                     "backend": self.backend_name},
                              faults=self.faults, fault_tag=fault_tag)
                out = {
                    "chunk": chunk_idx,
                    "resumed_from": resumed_from,
                    "gens_done": done,
                    "gens_total": total,
                    "chunk_gens": seg.gens,
                    "chunk_best": seg.best_y / scale,
                    "best_fitness": best_y / scale,
                    "best_params": self.spec.decode(best_x),
                    "traj_best": np.asarray(seg.traj_best) / scale,
                    "wall_s": dt,
                    "gens_per_s": seg.gens / dt if dt > 0 else float("inf"),
                    "backend": self.backend_name,
                    "problem": self.spec.problem or "blackbox",
                    "n_vars": self.spec.v,
                    "migrations": migrations,
                    "telemetry_unit_gens": seg.telemetry.topology
                                              .telemetry_unit_gens,
                    "telemetry": seg.telemetry,
                }
            yield out
            resumed_from = None    # only the first post-resume chunk carries it


def solve(spec: GASpec, backend: str = "auto", *,
          generations: Optional[int] = None,
          options: Optional[EngineOptions] = None) -> EngineResult:
    """Run a GASpec end to end and return the uniform result."""
    return Engine(spec, backend, options=options).run(generations)


class PackedEngine:
    """K shape-compatible GASpecs multiplexed through ONE backend run.

    The engine already stacks `n_repeats` independent replicas down a
    leading axis; packing reuses that axis as a *tenant* axis: job j
    contributes `n_repeats` slots seeded `seed+0..seed+r-1` — exactly the
    seeds the job would use alone — so every slot, and therefore every
    job's result, is bit-identical to running that job solo.  Specs must
    share `compile_key()` and `generations`; only seeds and repeat counts
    may differ.  The pack is never shrunk to fit the card: a launch the
    card cannot hold raises.

        pe = PackedEngine([spec_a, spec_b, spec_c])
        for tele in pe.run_chunked(ckpt_dir="/tmp/pack"):
            for jt in tele["jobs"]:
                print(jt["job_index"], jt["best_fitness"])

    `run_chunked` mirrors `Engine.run_chunked` (chunked telemetry +
    checkpoint/resume — the scheduler's preemption primitive) but yields a
    pack-level dict whose `"jobs"` list carries one Engine-style telemetry
    dict per job, unpacked from the segment's per-replica telemetry."""

    def __init__(self, specs, backend: str = "auto", *,
                 options: Optional[EngineOptions] = None):
        self.options = resolve_options(options)
        self.device = self.options.torch_device()
        specs = list(specs)
        if not specs:
            raise ValueError("PackedEngine needs at least one spec")
        key0, gens0 = specs[0].compile_key(), specs[0].generations
        for s in specs[1:]:
            if s.compile_key() != key0:
                raise BackendUnsupported(
                    "specs are not shape-compatible for packing (their "
                    "compile_key()s differ); submit them separately")
            if s.generations != gens0:
                raise BackendUnsupported(
                    "packed jobs must share generations= (the pack runs the "
                    "stack lock-step); submit unequal-length jobs separately")
        self.specs = specs
        self.slots, self.seeds = [], []
        off = 0
        for s in specs:
            self.slots.append((off, s.n_repeats))
            self.seeds.extend(s.seed + r for r in range(s.n_repeats))
            off += s.n_repeats
        self.n_slots = off
        self.batch_spec = dataclasses.replace(specs[0], n_repeats=self.n_slots)
        self.backend_name = resolve_backend(self.batch_spec, backend,
                                            self.device, self.options.mesh)
        self.faults = FLT.resolve_faults(self.options.faults)
        # a single 1-repeat job has no stack axis to pack: delegate to the
        # plain Engine (same result layout, zero packing overhead)
        self._solo: Optional[Engine] = None
        if self.n_slots == 1:
            self._solo = Engine(specs[0], self.backend_name,
                                options=self.options)
            self.backend = self._solo.backend
        else:
            self.backend = BACKENDS[self.backend_name](
                self.batch_spec, options=self.options)

    def init_state(self):
        if self._solo is not None:
            return self._solo.init_state()
        return self.backend.init_packed(list(self.seeds))

    def _job_tele(self, j: int, *, chunk_idx, done, total, dt, seg_gens,
                  slot_y, slot_x, chunk_y, traj, migrations, telemetry):
        off, cnt = self.slots[j]
        spec = self.specs[j]
        scale = spec.fitness_scale()
        mini = spec.minimize
        yj = slot_y[off:off + cnt]
        r = off + (int(np.argmin(yj)) if mini else int(np.argmax(yj)))
        cyj = chunk_y[off:off + cnt]
        tj = traj[off:off + cnt]                     # [r_j, T]
        return {
            "chunk": chunk_idx, "gens_done": done, "gens_total": total,
            "chunk_gens": seg_gens,
            "chunk_best": float(np.min(cyj) if mini else np.max(cyj)) / scale,
            "best_fitness": float(slot_y[r]) / scale,
            "best_params": spec.decode(slot_x[r]),
            "traj_best": (np.min(tj, axis=0) if mini
                          else np.max(tj, axis=0)) / scale,
            "wall_s": dt,
            "gens_per_s": seg_gens / dt if dt > 0 else float("inf"),
            "backend": self.backend_name,
            "problem": spec.problem or "blackbox",
            "n_vars": spec.v,
            "migrations": migrations,
            "telemetry_unit_gens": (telemetry.topology.telemetry_unit_gens
                                    if telemetry is not None else 1),
            "job_index": j, "pack_size": len(self.specs),
            "slots": (off, cnt),
            "telemetry": (telemetry.job_view()
                          if telemetry is not None else None),
        }

    def run_chunked(self, *, chunk_generations: Optional[int] = None,
                    ckpt_dir: Optional[str] = None,
                    resume: bool = True,
                    fault_tag: str = "") -> Iterator[Dict[str, Any]]:
        """Chunked pack run: yields {"chunk", "gens_done", ..., "jobs": [...]}
        with one Engine-style telemetry dict per job.  With `ckpt_dir`, every
        chunk checkpoints the whole packed state + per-slot bests, so an
        abandoned run (preemption) resumes bit-identically — the checkpoint
        records the slot seeds and refuses a mismatched pack composition."""
        if self._solo is not None:
            for tele in self._solo.run_chunked(
                    chunk_generations=chunk_generations,
                    ckpt_dir=ckpt_dir, resume=resume, fault_tag=fault_tag):
                jt = dict(tele)
                jt.update(job_index=0, pack_size=1, slots=(0, 1))
                yield {"chunk": tele["chunk"], "gens_done": tele["gens_done"],
                       "gens_total": tele["gens_total"],
                       "chunk_gens": tele["chunk_gens"],
                       "wall_s": tele["wall_s"],
                       "gens_per_s": tele["gens_per_s"],
                       "backend": self.backend_name, "pack_size": 1,
                       "jobs": [jt]}
            return

        spec = self.batch_spec
        total = spec.generations
        chunk = chunk_generations or max(1, total // 10, spec.gens_per_epoch)
        mini = spec.minimize
        L = self.n_slots

        state = self.init_state()
        done, chunk_idx, migrations = 0, 0, 0
        resumed_from: Optional[int] = None
        slot_y = np.full((L,), np.inf if mini else -np.inf, np.float32)
        slot_x = np.zeros((L, spec.v), np.uint32)
        if ckpt_dir and resume:
            step = CKPT.latest_step(ckpt_dir)
            if step is not None:
                resumed_from = int(step)
                state, extra = CKPT.restore(ckpt_dir, step, state)
                _refuse_backend(extra, ckpt_dir, self.backend_name, "")
                ck_seeds = [int(s) for s in extra.get("seeds", [])]
                if ck_seeds and ck_seeds != [int(s) for s in self.seeds]:
                    raise ValueError(
                        f"checkpoint in {ckpt_dir} holds a pack with slot "
                        f"seeds {ck_seeds}, not {list(self.seeds)} — a pack "
                        "must resume with the same jobs in the same order")
                done = int(extra["gens_done"])
                chunk_idx = int(extra.get("chunk_idx", 0))
                migrations = int(extra.get("migrations", 0))
                slot_y = np.asarray(extra["slot_y"], np.float32)
                slot_x = np.asarray(extra["slot_x"],
                                    np.uint32).reshape(L, spec.v)

        if done >= total:
            # resumed a finished pack: surface the stored per-job results
            yield {
                "chunk": chunk_idx, "gens_done": done, "gens_total": total,
                "chunk_gens": 0, "wall_s": 0.0, "gens_per_s": 0.0,
                "backend": self.backend_name, "pack_size": len(self.specs),
                "already_complete": True,
                "jobs": [self._job_tele(
                    j, chunk_idx=chunk_idx, done=done, total=total, dt=0.0,
                    seg_gens=0, slot_y=slot_y, slot_x=slot_x, chunk_y=slot_y,
                    traj=slot_y[:, None], migrations=migrations,
                    telemetry=None)
                    for j in range(len(self.specs))],
            }
            return

        while done < total:
            tag = f"{fault_tag}|{self.backend_name}|chunk={chunk_idx + 1}"
            if self.faults is not None:
                self.faults.inject("slow_chunk", tag)
            t0 = time.perf_counter()
            seg = self.backend.segment(state, min(chunk, total - done))
            _sync(self.device)
            dt = time.perf_counter() - t0
            if self.faults is not None:
                # crash AFTER the compute, BEFORE the checkpoint (see Engine)
                self.faults.inject("chunk_crash", tag)
            state = seg.state
            done += seg.gens
            chunk_idx += 1
            migrations += seg.telemetry.topology.migrations
            if resumed_from is not None:
                seg.telemetry.resumed_from = resumed_from
            rep = seg.telemetry.per_repeat
            by = np.asarray(rep.best, np.float32).reshape(L)
            bx = np.asarray(rep.best_x, np.uint32).reshape(L, spec.v)
            traj = np.asarray(rep.traj_best, np.float32).reshape(L, -1)
            better = by < slot_y if mini else by > slot_y
            slot_y = np.where(better, by, slot_y)
            slot_x = np.where(better[:, None], bx, slot_x)
            if ckpt_dir:
                CKPT.save(ckpt_dir, step=done, tree=state,
                          extra={"gens_done": done, "chunk_idx": chunk_idx,
                                 "migrations": migrations,
                                 "slot_y": [float(v) for v in slot_y],
                                 "slot_x": [[int(v) for v in row]
                                            for row in slot_x],
                                 "seeds": [int(s) for s in self.seeds],
                                 "backend": self.backend_name},
                          faults=self.faults, fault_tag=fault_tag)
            yield {
                "chunk": chunk_idx, "resumed_from": resumed_from,
                "gens_done": done, "gens_total": total,
                "chunk_gens": seg.gens, "wall_s": dt,
                "gens_per_s": seg.gens / dt if dt > 0 else float("inf"),
                "backend": self.backend_name, "pack_size": len(self.specs),
                "jobs": [self._job_tele(
                    j, chunk_idx=chunk_idx, done=done, total=total, dt=dt,
                    seg_gens=seg.gens, slot_y=slot_y, slot_x=slot_x,
                    chunk_y=by, traj=traj, migrations=migrations,
                    telemetry=seg.telemetry)
                    for j in range(len(self.specs))],
            }
            resumed_from = None

    def run(self, *, chunk_generations: Optional[int] = None):
        """Run the pack to completion; returns the final per-job telemetry
        list (one Engine-style dict per job)."""
        last = None
        for last in self.run_chunked(chunk_generations=chunk_generations):
            pass
        return last["jobs"]


def repack_checkpoint(old_dir: str, specs, keep, new_dir: str,
                      backend: str = "auto", *,
                      options: Optional[EngineOptions] = None
                      ) -> Optional[int]:
    """Slice a pack checkpoint down to the jobs in `keep` (indices into
    `specs`) and write it to `new_dir`, so survivors of a quarantined pack
    resume bit-identically from where the pack left off.

    Packed state leaves carry the slot stack down their leading axis (the
    replica axis `init_packed` builds); slicing that axis at the kept jobs'
    slot offsets yields exactly the state those slots would hold had they
    run alone from the same seeds — the packing bit-identity invariant run
    in reverse.  Leaves whose shape does not change between pack sizes
    pass through; anything that matches neither pattern is a layout change
    and raises.  The sliced state lands on the device of the new pack's
    state.  Returns the checkpointed step (generations done), or None when
    `old_dir` holds no valid step."""
    specs = list(specs)
    keep = list(keep)
    pe_old = PackedEngine(specs, backend, options=options)
    step = CKPT.latest_step(old_dir)
    if step is None:
        return None
    state, extra = CKPT.restore(old_dir, step, pe_old.init_state())
    ck_backend = extra.get("backend")
    if ck_backend is not None and ck_backend != pe_old.backend_name:
        raise ValueError(
            f"checkpoint in {old_dir} was written by the {ck_backend!r} "
            f"backend, not {pe_old.backend_name!r}; repack with the "
            "original backend")
    ck_seeds = [int(s) for s in extra.get("seeds", [])]
    if ck_seeds and ck_seeds != [int(s) for s in pe_old.seeds]:
        raise ValueError(
            f"checkpoint in {old_dir} holds slot seeds {ck_seeds}, but the "
            f"given specs produce {list(pe_old.seeds)} — pass the pack's "
            "original specs in their original order")

    pe_new = PackedEngine([specs[j] for j in keep], backend, options=options)
    idx = []
    for j in keep:
        off, cnt = pe_old.slots[j]
        idx.extend(range(off, off + cnt))

    def _slice(new_like: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
        want = tuple(new_like.shape)
        if tuple(old.shape) == want:
            return old.to(new_like.device)
        if old.dim() and old.shape[0] == pe_old.n_slots:
            sl = old[torch.tensor(idx, device=old.device)]
            if tuple(sl.shape) == want:
                return sl.to(new_like.device)
            if len(idx) == 1 and tuple(sl.shape[1:]) == want:
                # a 1-slot target runs the solo (lead=0) layout
                return sl[0].to(new_like.device)
        raise ValueError(
            f"cannot repack state leaf of shape {tuple(old.shape)} into "
            f"{want}: neither shape-stable nor sliceable down the "
            f"{pe_old.n_slots}-slot axis")

    new_like = pe_new.init_state()
    new_state = type(new_like)(*(_slice(a, b)
                                 for a, b in zip(new_like, state)))

    done = int(extra["gens_done"])
    idx_arr = np.asarray(idx)
    slot_y = np.asarray(extra["slot_y"], np.float32)
    slot_x = np.asarray(extra["slot_x"], np.uint32).reshape(
        pe_old.n_slots, specs[0].v)
    if pe_new.n_slots > 1:
        new_extra = {"gens_done": done,
                     "chunk_idx": int(extra.get("chunk_idx", 0)),
                     "migrations": int(extra.get("migrations", 0)),
                     "slot_y": [float(v) for v in slot_y[idx_arr]],
                     "slot_x": [[int(v) for v in row]
                                for row in slot_x[idx_arr]],
                     "seeds": [int(s) for s in pe_new.seeds],
                     "backend": pe_new.backend_name}
    else:
        # a 1-slot pack delegates to the plain Engine, whose resume reads
        # the solo extra format
        r = idx[0]
        new_extra = {"gens_done": done,
                     "chunk_idx": int(extra.get("chunk_idx", 0)),
                     "migrations": int(extra.get("migrations", 0)),
                     "best_y": float(slot_y[r]),
                     "best_x": [int(v) for v in slot_x[r]],
                     "backend": pe_new.backend_name}
    # recovery machinery is not an injection site: faults=False keeps an
    # ambient ckpt_corrupt rule from eating the repacked checkpoint
    CKPT.save(new_dir, step=done, tree=new_state, extra=new_extra,
              faults=False)
    return done
