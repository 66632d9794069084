"""Batched LM serving, and GA serving telemetry; the JAX package's
`repro.serve.engine`, both halves under the same names.

The LM half: `Engine` runs a fixed batch of `slots` in lock-step over one
model's `prefill` and `decode_step` on one device (the card unless the
caller asks for the CPU), and `serve_queue` refills the batch from a queue
of requests.  The decode position is a Python int, so the decode loop never
waits on the device; only the timers synchronize.  Greedy sampling takes
the first maximum, as `jnp.argmax` does; otherwise tokens are drawn from
softmax(logits / temperature) with a `torch.Generator` seeded from `seed`
(its draws are not `jax.random`'s).

The GA half: `run_ga_job` drives `repro_torch.ga.Engine.run_chunked` under a
job id and aggregates its per-chunk telemetry (generations/s, best-fitness
trajectory, migration count) into `GA_METRICS`, whose `metrics()` snapshot
is the /metrics-style dict `repro_torch.serve.metrics_http` serves;
`repro_torch.serve.scheduler.GAScheduler` feeds the same registry from its
worker thread.  A job's `shards` is the count of mesh shards its island
axis spans (`RunTelemetry.topology.n_shards`; 1 without a mesh).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm as LM


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 32
    out_tokens: Optional[List[int]] = None


@dataclasses.dataclass
class EngineConfig:
    batch: int = 8
    max_len: int = 512
    greedy: bool = True
    temperature: float = 1.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Engine:
    """Slot-based batched generation over (prefill, decode_step).

    `params` is the `LM` (`repro_torch.models.lm.init_params`, or
    `repro_torch.models.convert.lm_params_from_numpy`), already on
    `device`: the card by default, which raises where there is none;
    `device="cpu"` runs on the CPU."""

    def __init__(self, cfg: ModelConfig, params: LM.LM, ecfg: EngineConfig,
                 device=None):
        dev = torch.device(device or "cuda")
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Engine(device={str(dev)!r}) needs a CUDA device and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "serve on the CPU")
        held = next(params.parameters()).device
        if held.type != dev.type or (dev.index is not None
                                     and held.index != dev.index):
            raise ValueError(f"the model's parameters are on {held}, the "
                             f"engine's device is {dev}: build the model "
                             "there")
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.device = dev

    def _sample(self, logits: torch.Tensor,
                gen: Optional[torch.Generator]) -> torch.Tensor:
        if self.ecfg.greedy:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.ecfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    def _on_device(self, a) -> Optional[torch.Tensor]:
        return None if a is None else torch.as_tensor(a, device=self.device)

    def generate(self, prompts, max_new_tokens: int = 32, frames=None,
                 patches=None, seed: int = 0
                 ) -> Tuple[np.ndarray, Dict[str, float]]:
        """Lock-step generation. prompts: (B, S) ints.  Returns the
        (B, max_new_tokens) int32 tokens and the timings (host clock up to
        a device synchronize)."""
        prompts = np.asarray(prompts)
        b, s = prompts.shape
        if b != self.ecfg.batch:
            raise ValueError(f"{b} prompts for an engine of batch "
                             f"{self.ecfg.batch}")
        frames, patches = self._on_device(frames), self._on_device(patches)
        kw = {}
        if frames is not None:
            kw["frames"] = frames
        if patches is not None:
            kw["patches"] = patches
        with torch.inference_mode():
            cache = LM.new_cache(self.cfg, b, self.ecfg.max_len,
                                 device=self.device)
            prefix = s + (patches.shape[1] if patches is not None
                          and self.cfg.family == "vlm" else 0)
            slots = self.params.position_slots(cache)
            if slots is not None and prefix + max_new_tokens - 1 > slots:
                raise ValueError(
                    f"{prefix} prompt positions and {max_new_tokens} new "
                    f"tokens reach position {prefix + max_new_tokens - 2}, "
                    f"past the cache's {slots} slots")
            tokens = torch.as_tensor(prompts, dtype=torch.long,
                                     device=self.device)
            _sync(self.device)
            t0 = time.perf_counter()
            logits, cache = self.params.prefill(tokens, cache, **kw)
            _sync(self.device)
            t_prefill = time.perf_counter() - t0

            gen = None
            if not self.ecfg.greedy:
                gen = torch.Generator(device=self.device).manual_seed(seed)
            tok = self._sample(logits, gen)[:, None]
            out = [tok]
            t1 = time.perf_counter()
            for _ in range(max_new_tokens - 1):
                logits, cache = self.params.decode_step(tok, cache)
                tok = self._sample(logits, gen)[:, None]
                out.append(tok)
            _sync(self.device)
            t_decode = time.perf_counter() - t1
            toks = torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
        return toks, {
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "decode_tok_per_s": b * (max_new_tokens - 1) / max(t_decode, 1e-9),
        }


def serve_queue(engine: Engine, requests: List[Request],
                max_new_tokens: int = 16) -> Dict[int, np.ndarray]:
    """Minimal continuous batching: group requests into engine-sized
    batches, refilling from the queue as batches finish.  Prompts are
    left-padded with zeros and attend the padding, as in the JAX package."""
    q: "queue.Queue[Request]" = queue.Queue()
    for r in requests:
        q.put(r)
    results: Dict[int, np.ndarray] = {}
    bsz = engine.ecfg.batch
    while not q.empty():
        batch: List[Request] = []
        while len(batch) < bsz and not q.empty():
            batch.append(q.get())
        while len(batch) < bsz:           # pad with a copy of the last req
            batch.append(batch[-1])
        slen = max(len(r.prompt) for r in batch)
        prompts = np.zeros((bsz, slen), np.int32)
        for i, r in enumerate(batch):
            prompts[i, -len(r.prompt):] = r.prompt
        toks, _ = engine.generate(prompts, max_new_tokens)
        for i, r in enumerate(batch):
            if r.uid not in results:
                results[r.uid] = toks[i]
    return results


# ---------------------------------------------------------------------------
# GA job telemetry (Engine.run_chunked -> /metrics-style dicts)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GAJobStats:
    """Aggregated `repro_torch.ga.Engine.run_chunked` telemetry for one
    job."""

    job_id: str
    backend: str = "?"
    problem: str = "?"               # registry name or "blackbox"
    n_vars: int = 0                  # decoded variable count V
    # pending | queued | running | preempted | done | failed
    status: str = "pending"
    gens_done: int = 0
    gens_total: int = 0
    chunks: int = 0
    best_fitness: Optional[float] = None
    best_trajectory: List[float] = dataclasses.field(default_factory=list)
    migrations: int = 0
    islands: int = 1                 # populations evolving concurrently
    shards: int = 1                  # mesh shards the island axis spans
    wall_s: float = 0.0
    error: Optional[str] = None
    priority: int = 0                # scheduler priority (higher preempts)
    preemptions: int = 0             # times the scheduler parked this job
    retries: int = 0                 # scheduler retry dispatches of this job
    deadline_s: Optional[float] = None   # wall budget (None = unbounded)
    quarantined: bool = False        # failed as the isolated poison job
    pack_size: int = 1               # jobs sharing the launch it ran in
    epoch_mode: str = "-"            # resident | streamed | gridded | ...
    plan_source: str = "-"           # heuristic | measured | forced
    plan_fallback: Optional[str] = None   # why resident modes were infeasible
    tile_islands: Optional[int] = None    # streamed mode's island tile size
    sel_lane: str = "-"              # fused tournament lane: onehot | gather

    @property
    def gens_per_s(self) -> float:
        return self.gens_done / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def gens_per_s_per_shard(self) -> float:
        """Island-generations/s each mesh shard contributes (the scaling
        headline: flat per-shard throughput == linear total speedup)."""
        return self.gens_per_s * self.islands / max(self.shards, 1)

    def as_metrics(self) -> Dict[str, Any]:
        """Flat dict the /metrics endpoint of a GA job would serialize."""
        return {
            "job_id": self.job_id,
            "backend": self.backend,
            "problem": self.problem,
            "n_vars": self.n_vars,
            "status": self.status,
            "generations_done": self.gens_done,
            "generations_total": self.gens_total,
            "chunks": self.chunks,
            "generations_per_s": round(self.gens_per_s, 2),
            "islands": self.islands,
            "shards": self.shards,
            "generations_per_s_per_shard": round(self.gens_per_s_per_shard, 2),
            "best_fitness": self.best_fitness,
            "best_fitness_trajectory": list(self.best_trajectory),
            "migration_count": self.migrations,
            "wall_s": round(self.wall_s, 4),
            "error": self.error,
            "priority": self.priority,
            "preemptions": self.preemptions,
            "retries": self.retries,
            "deadline_s": self.deadline_s,
            "quarantined": self.quarantined,
            "pack_size": self.pack_size,
            "epoch_mode": self.epoch_mode,
            "plan_source": self.plan_source,
            "plan_fallback": self.plan_fallback,
            "tile_islands": self.tile_islands,
            "sel_lane": self.sel_lane,
        }


class GAMetricsRegistry:
    """Thread-safe per-job telemetry aggregation for GA runs.

    Feed it `run_chunked` telemetry dicts via `record_chunk`; scrape the
    whole registry with `metrics()` (every job keyed by id, plus fleet
    totals), the shape a /metrics handler returns as JSON.  Every mutation
    and snapshot holds the registry lock — the scheduler records chunks
    from its worker thread while HTTP handler threads scrape and stream.

    Streaming: `subscribe(job_id)` returns a Queue that receives every
    subsequent `record_chunk` telemetry dict for that job plus a final
    `{"event": "end", ...}` marker from `finish_job` — the feed the
    metrics_http SSE/long-poll endpoints drain.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._jobs: Dict[str, GAJobStats] = {}
        self._next_id = 0
        self._subs: Dict[str, List["queue.Queue"]] = {}
        self._scheduler_stats: Optional[Any] = None   # callable -> dict

    def allocate_job_id(self, suffix: str = "job") -> str:
        """A unique job id, safe under concurrent `run_ga_job` calls."""
        with self._lock:
            jid = f"ga-{self._next_id}-{suffix}"
            self._next_id += 1
            return jid

    def ensure_next_id(self, n: int) -> None:
        """Bump the id counter to at least `n` — a recovering scheduler
        calls this so fresh ids never collide with journaled ones."""
        with self._lock:
            self._next_id = max(self._next_id, int(n))

    def start_job(self, job_id: str, backend: str = "?",
                  gens_total: int = 0, problem: str = "?",
                  n_vars: int = 0) -> GAJobStats:
        """Mark a job running.  Upserts: a job the scheduler queued (or
        preempted and re-dispatched) keeps its accumulated stats."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                job = GAJobStats(job_id=job_id)
                self._jobs[job_id] = job
            job.backend = backend if backend != "?" else job.backend
            job.problem = problem if problem != "?" else job.problem
            job.n_vars = n_vars or job.n_vars
            job.gens_total = gens_total or job.gens_total
            job.status = "running"
            return job

    def queue_job(self, job_id: str, problem: str = "?", gens_total: int = 0,
                  n_vars: int = 0, priority: int = 0,
                  deadline_s: Optional[float] = None) -> GAJobStats:
        """Register a scheduler-owned job in the QUEUED state."""
        with self._lock:
            job = GAJobStats(job_id=job_id, problem=problem, n_vars=n_vars,
                             gens_total=gens_total, status="queued",
                             priority=priority, deadline_s=deadline_s)
            self._jobs[job_id] = job
            return job

    def set_status(self, job_id: str, status: str) -> None:
        """Move a job between scheduler states (queued/running/preempted)."""
        with self._lock:
            job = self._jobs[job_id]
            if status == "preempted" and job.status != "preempted":
                job.preemptions += 1
            job.status = status

    def note_retry(self, job_id: str) -> None:
        """Count one scheduler retry dispatch against the job."""
        with self._lock:
            self._jobs[job_id].retries += 1

    def record_chunk(self, job_id: str, tele: Dict[str, Any]) -> None:
        """Fold one `Engine.run_chunked` telemetry dict into the job."""
        with self._lock:
            job = self._jobs[job_id]
            job.backend = tele.get("backend", job.backend)
            job.problem = tele.get("problem", job.problem)
            job.n_vars = int(tele.get("n_vars", job.n_vars))
            job.gens_done = int(tele.get("gens_done", job.gens_done))
            job.gens_total = int(tele.get("gens_total", job.gens_total))
            job.chunks += 1
            job.wall_s += float(tele.get("wall_s", 0.0))
            job.migrations = int(tele.get("migrations", job.migrations))
            job.pack_size = int(tele.get("pack_size", job.pack_size))
            rt = tele.get("telemetry")
            if rt is not None:
                job.islands = rt.topology.n_islands
                job.shards = rt.topology.n_shards
                if rt.plan.mode != "-":
                    job.epoch_mode = rt.plan.mode
                    job.plan_source = rt.plan.source
                    job.tile_islands = rt.plan.tile_islands
                    job.sel_lane = rt.plan.lane
                    job.plan_fallback = rt.plan.fallback or job.plan_fallback
            bf = tele.get("best_fitness")
            if bf is not None:
                job.best_fitness = float(bf)
                job.best_trajectory.append(float(bf))
            subs = list(self._subs.get(job_id, ()))
        event = {"event": "chunk", "job_id": job_id}
        event.update({k: v for k, v in tele.items()
                      if k not in ("telemetry", "extras", "best_params",
                                   "traj_best")})
        for q in subs:
            q.put(event)

    def finish_job(self, job_id: str, error: Optional[str] = None,
                   status: Optional[str] = None,
                   quarantined: bool = False) -> None:
        """Terminal transition.  `status` overrides the default
        failed/done mapping (the scheduler passes "deadline_exceeded");
        `quarantined` marks a poison job isolated by pack splitting."""
        with self._lock:
            job = self._jobs[job_id]
            job.status = status or ("failed" if error else "done")
            job.error = error
            job.quarantined = job.quarantined or quarantined
            subs = list(self._subs.get(job_id, ()))
            end = {"event": "end", "job_id": job_id, "status": job.status,
                   "best_fitness": job.best_fitness, "error": error}
        for q in subs:
            q.put(end)

    def abort_streams(self, reason: str) -> None:
        """Push an aborted end-sentinel to every subscriber of a
        non-terminal job — the worker thread died or the scheduler shut
        down, so those chunk feeds will never produce an organic end event
        and blocked `stream()` / SSE clients must be released."""
        with self._lock:
            targets = []
            for jid, subs in self._subs.items():
                job = self._jobs.get(jid)
                if job is not None and job.status in (
                        "done", "failed", "deadline_exceeded"):
                    continue
                targets.extend((q, jid) for q in subs)
        for q, jid in targets:
            q.put({"event": "end", "job_id": jid, "status": "aborted",
                   "error": reason})

    def evict_job(self, job_id: str) -> bool:
        """Drop a finished job's stats and any stale subscriber queues (the
        scheduler's TTL GC calls this).  Returns False if already gone."""
        with self._lock:
            gone = self._jobs.pop(job_id, None)
            self._subs.pop(job_id, None)
            return gone is not None

    # ---- streaming ------------------------------------------------------

    def subscribe(self, job_id: str) -> "queue.Queue":
        """A Queue fed every future chunk event (and the end marker) for
        `job_id`.  Pair with `unsubscribe` when the client disconnects."""
        q: "queue.Queue" = queue.Queue()
        with self._lock:
            self._subs.setdefault(job_id, []).append(q)
        return q

    def unsubscribe(self, job_id: str, q: "queue.Queue") -> None:
        with self._lock:
            subs = self._subs.get(job_id)
            if subs and q in subs:
                subs.remove(q)
                if not subs:
                    del self._subs[job_id]

    # ---- scheduler gauges ----------------------------------------------

    def attach_scheduler_stats(self, stats_fn) -> None:
        """Register a zero-arg callable returning scheduler gauges
        (queue depth, jobs running, compile-cache counters); its dict rides
        into every `metrics()` snapshot under "scheduler"."""
        with self._lock:
            self._scheduler_stats = stats_fn

    def metrics(self) -> Dict[str, Any]:
        """The /metrics snapshot: every job + fleet aggregates."""
        with self._lock:
            jobs = {jid: j.as_metrics() for jid, j in self._jobs.items()}
            stats_fn = self._scheduler_stats
        by_status = {}
        for j in jobs.values():
            by_status[j["status"]] = by_status.get(j["status"], 0) + 1
        snap = {
            "jobs": jobs,
            "job_count": len(jobs),
            "jobs_done": by_status.get("done", 0),
            "jobs_running": by_status.get("running", 0),
            "jobs_queued": by_status.get("queued", 0),
            "jobs_preempted": by_status.get("preempted", 0),
            "jobs_failed": by_status.get("failed", 0),
            "jobs_deadline_exceeded": by_status.get("deadline_exceeded", 0),
            "generations_total": sum(j["generations_done"]
                                     for j in jobs.values()),
            "migrations_total": sum(j["migration_count"]
                                    for j in jobs.values()),
        }
        if stats_fn is not None:
            try:
                snap["scheduler"] = dict(stats_fn())
            except Exception:      # a dying scheduler must not kill scrapes
                pass
        return snap

    def reset(self) -> None:
        with self._lock:
            self._jobs.clear()
            self._subs.clear()
            self._scheduler_stats = None


GA_METRICS = GAMetricsRegistry()


def run_ga_job(spec, backend: str = "auto", *, job_id: Optional[str] = None,
               chunk_generations: Optional[int] = None,
               ckpt_dir: Optional[str] = None,
               registry: Optional[GAMetricsRegistry] = None,
               options=None) -> Dict[str, Any]:
    """Run a GASpec as a telemetered serving job.

    Streams `Engine.run_chunked` into the registry so a concurrent /metrics
    scrape sees live generations/s, the best-fitness trajectory and the
    migration count.  Returns the job's final metrics dict.
    """
    from repro_torch import ga

    registry = registry if registry is not None else GA_METRICS
    if job_id is None:
        job_id = registry.allocate_job_id(spec.problem or "blackbox")
    eng = ga.Engine(spec, backend, options=options)
    registry.start_job(job_id, backend=eng.backend_name,
                       gens_total=spec.generations,
                       problem=spec.problem or "blackbox", n_vars=spec.v)
    try:
        for tele in eng.run_chunked(chunk_generations=chunk_generations,
                                    ckpt_dir=ckpt_dir):
            registry.record_chunk(job_id, tele)
    except Exception as e:   # surface the failure in /metrics, then re-raise
        registry.finish_job(job_id, error=repr(e))
        raise
    registry.finish_job(job_id)
    return registry.metrics()["jobs"][job_id]
