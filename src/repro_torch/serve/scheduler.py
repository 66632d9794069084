"""GA-as-a-service: async multi-tenant job scheduler over one device mesh.

`run_ga_job` made the engine a telemetered *single-job* service; this module
makes it multi-tenant.  A `GAScheduler` owns the device (or the mesh) and a
worker thread; clients `submit(spec)` and get a job id back immediately:

    sched = GAScheduler()                     # the card; or options=
                                              # EngineOptions(device="cpu"),
                                              # or mesh=parse_mesh("auto")
    a = sched.submit(spec_a)                  # QUEUED
    b = sched.submit(spec_b)                  # shape-compatible with a
    hot = sched.submit(urgent, priority=10)   # preempts the running pack
    for event in sched.stream(a):             # live per-chunk telemetry
        print(event["gens_done"], event["best_fitness"])
    print(sched.result(a)["best_fitness"])    # blocks until DONE

Three mechanisms carry the multiplexing:

* **Packing** — queued jobs whose specs share `GASpec.compile_key()` (and
  `generations`) are packed down the engine's `n_repeats` replica axis into
  ONE `PackedEngine` launch, up to `max_pack` slots.  Slot seeding follows
  the solo convention exactly, so per-job results are bit-identical to
  running each job alone (asserted in tests).
* **Engine cache** — executors and runners live in the process-global
  `repro_torch.ga.compile_cache.RUNNER_CACHE`, keyed by spec shape: the
  second submission of an identical spec shape reuses what the first built
  (the hit/miss counters are exported through `stats()` → /metrics).
* **Preemption** — the worker drives `PackedEngine.run_chunked` with a
  checkpoint directory; between chunks it checks for strictly
  higher-priority queued work, and if present parks the pack (jobs →
  PREEMPTED, state already on disk) and requeues it.  Resume restores the
  packed state bit-identically — `run_chunked`'s checkpoint/resume path IS
  the preemption primitive, no new state format.

Job states: QUEUED → RUNNING → DONE, with RUNNING → PREEMPTED → QUEUED
loops and any state → FAILED on error.  Telemetry flows through a
`GAMetricsRegistry` (per-chunk pub/sub feeds the metrics_http SSE and
long-poll endpoints; `attach_scheduler_stats` adds queue-depth /
jobs-running / cache-hit gauges to every /metrics scrape).

Two trace-driven extensions ride on top:

* **Cost-table ordering** — when a `cost_table` (see
  `repro_torch.autotune`) is attached, every submission gets a measured
  gens/s estimate for its planned launch shape; within a priority level
  the dispatcher runs shortest-estimated-wall first.  The table also
  flows into every `PackedEngine` so each launch uses the measured epoch
  plan.  With no table the ordering is bit-identical to plain
  priority/FIFO.
* **TTL GC** — `job_ttl_s` bounds how long DONE/FAILED jobs linger in the
  scheduler and registry; the worker sweeps them out between dispatches
  (`repro_ga_sched_evicted_total` counts evictions).

Fault tolerance (exercised through the `repro_torch.faults` injection
registry by `tests/test_torch_scheduler.py` and `chip_smoke.py`):

* **Retry with backoff** — a unit failing with a *transient* error
  (`repro_torch.faults.classify_error`: injected faults, I/O, runtime and
  CUDA errors) requeues frozen with exponential backoff + deterministic jitter
  (`retry_backoff`), resuming from its last pack checkpoint; each job
  spends one retry of its budget (`max_retries`, per-job override at
  submit).  *Permanent* errors (ValueError and friends — the work is
  wrong, not the world) skip straight to failure handling.
* **Pack isolation / quarantine** — when a multi-job pack exhausts its
  budget (or hits a permanent error), the pack SPLITS: each job re-enters
  the queue as a solo frozen unit resuming from a checkpoint sliced out
  of the pack's (`ga.repack_checkpoint` — the packing bit-identity
  invariant run in reverse).  The poison job re-fails alone and is
  quarantined as FAILED; the survivors complete bit-identically to an
  undisturbed run.
* **Deadlines** — `submit(..., deadline_s=)` bounds a job's wall clock
  from submission; enforcement is at chunk granularity (queued jobs past
  deadline never dispatch; running jobs are marked between chunks) with
  the terminal DEADLINE_EXCEEDED state.
* **Durability** — every submit / dispatch / park / requeue / terminal
  transition appends to `journal.jsonl` under `ckpt_root`
  (`repro_torch.serve.journal`); `GAScheduler(recover=True)` replays it so
  a restarted server re-enqueues pending jobs (frozen packs resume from
  their checkpoints) and restores finished results.  The journal and the
  checkpoints are the JAX package's formats, so a JAX scheduler's root
  recovers here too.

The port of the JAX package's `repro.serve.scheduler`, every mechanism and
counter kept, `mesh=` included: every engine the worker builds shards its
island axis over that mesh (`ga.EngineOptions.mesh`).  The device comes
from `options.device`, or is the mesh's first device: a scheduler for the
card raises at construction on a host without one, rather than hand its
worker an error it would retry.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import tempfile
import threading
import time as _time
import warnings
import zlib
from typing import Any, Dict, Iterator, List, Optional

from repro_torch import faults as FLT
from repro_torch.serve import journal as JRN
from repro_torch.serve.engine import GA_METRICS, GAMetricsRegistry

QUEUED = "queued"
RUNNING = "running"
PREEMPTED = "preempted"
DONE = "done"
FAILED = "failed"
DEADLINE_EXCEEDED = "deadline_exceeded"

TERMINAL_STATES = (DONE, FAILED, DEADLINE_EXCEEDED)


def retry_backoff(base_s: float, attempt: int, token: str = "") -> float:
    """Exponential backoff with deterministic jitter: `base * 2^(attempt-1)`
    stretched by up to +25% keyed on `token` (the unit id) — retries of
    different units decorrelate without `random`, and the same unit backs
    off identically on every replay."""
    jitter = (zlib.crc32(f"{token}:{attempt}".encode()) % 1000) / 4000.0
    return base_s * (2 ** max(attempt - 1, 0)) * (1.0 + jitter)


@dataclasses.dataclass
class Job:
    """One submitted GASpec and its scheduler-side lifecycle."""

    job_id: str
    spec: Any
    backend: str = "auto"
    priority: int = 0
    state: str = QUEUED
    result: Optional[Dict[str, Any]] = None
    error: Optional[str] = None
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    finished_at: Optional[float] = None      # clock() terminal stamp
    deadline_s: Optional[float] = None       # wall budget from submission
    max_retries: Optional[int] = None        # per-job retry budget override
    retries: int = 0                         # retry dispatches consumed
    quarantined: bool = False                # failed as the isolated poison
    submitted_at: float = 0.0                # clock() submission stamp
    recovered: bool = False                  # re-enqueued by journal replay
    est_gens_per_s: Optional[float] = None   # cost-table throughput estimate


@dataclasses.dataclass
class _Unit:
    """One schedulable queue entry: fresh single jobs (packable at dispatch)
    or a preempted pack (membership frozen — its checkpoint holds the whole
    packed state, so it must resume with the same jobs in the same order)."""

    seq: int
    jobs: List[Job]
    packable: bool = True
    ckpt_dir: Optional[str] = None
    attempts: int = 0            # dispatches that ended in failure
    not_before: float = 0.0      # clock() gate for retry backoff
    isolated: bool = False       # solo split out of a quarantined pack

    @property
    def priority(self) -> int:
        return max(j.priority for j in self.jobs)

    def live_jobs(self) -> List[Job]:
        """Members not yet in a terminal state (a frozen pack keeps its
        full membership for checkpoint-seed identity, but deadline-expired
        jobs inside it no longer receive chunks or results)."""
        return [j for j in self.jobs if j.state not in TERMINAL_STATES]


class GAScheduler:
    """Async multi-tenant GA job scheduler (one worker thread owns the
    device, or the mesh).

    Parameters: `mesh` is handed to every engine build (it may also ride
    in `options.mesh`, but not in both); `backend` is the default backend
    request; `max_pack` caps
    slots per launch; `chunk_generations` sets the telemetry/preemption
    granularity; `ckpt_root` is where pack checkpoints and the journal
    live (a temp dir by default); `job_ttl_s` evicts DONE/FAILED jobs that
    many seconds after they finish (None keeps them forever);
    `cost_table` follows `repro_torch.autotune.resolve_table` — None
    discovers the ambient table, False disables, a path or CostTable pins
    one (it may also ride in `options.cost_table`, but not in both).
    Engine knobs arrive as one `ga.EngineOptions` via `options=` — the
    device, and the plan, planning budget, tile, lane and fault knobs of
    every packed launch.
    """

    def __init__(self, *, mesh=None,
                 registry: Optional[GAMetricsRegistry] = None,
                 backend: str = "auto", max_pack: int = 8,
                 chunk_generations: Optional[int] = None,
                 ckpt_root: Optional[str] = None,
                 job_ttl_s: Optional[float] = None,
                 cost_table=None, options=None,
                 max_retries: int = 3, retry_backoff_s: float = 0.05,
                 recover: bool = False, paused: bool = False,
                 clock=None):
        from repro_torch.autotune import resolve_table   # import-light
        from repro_torch.ga.options import resolve_options

        self.options = resolve_options(options, mesh=mesh)
        self.mesh = self.options.mesh
        if cost_table is not None:
            if self.options.cost_table is not None:
                raise ValueError(
                    "got both cost_table= and options.cost_table: pass the "
                    "table in one of them")
            self.options = dataclasses.replace(self.options,
                                               cost_table=cost_table)
        # once, here: a scheduler meant for the card fails now on a host
        # without one, not in its worker as a retried transient
        self.device = self.options.torch_device()
        self.registry = registry if registry is not None else GA_METRICS
        self.backend = backend
        self.max_pack = max(1, int(max_pack))
        self.chunk_generations = chunk_generations
        self.ckpt_root = ckpt_root or tempfile.mkdtemp(prefix="ga-sched-")
        self.job_ttl_s = None if job_ttl_s is None else float(job_ttl_s)
        self.max_retries = max(0, int(max_retries))
        self.retry_backoff_s = float(retry_backoff_s)
        # injectable clock: deadlines / backoff gates / TTL stamps all read
        # it, so fault tests drive time without sleeping
        self._clock = clock if clock is not None else _time.monotonic
        # resolved ONCE: the injector instance (occurrence counters included)
        # is shared with every engine build via EngineOptions.faults
        self.faults = FLT.resolve_faults(self.options.faults)
        # resolve once: every engine build + submit estimate reuses it
        self.cost_table = resolve_table(self.options.cost_table)
        # every engine built here plans from that table, or from the
        # heuristic alone: never from a table its own discovery would find
        self.options = dataclasses.replace(
            self.options, cost_table=(self.cost_table
                                      if self.cost_table is not None
                                      else False))
        self._cv = threading.Condition()
        self._queue: List[_Unit] = []
        self._jobs: Dict[str, Job] = {}
        self._seq = itertools.count()
        self._stop = False
        self._paused = bool(paused)
        self._running: List[Job] = []
        self.packs_launched = 0
        self.preemptions = 0
        self.jobs_packed = 0        # jobs that shared a launch with >=1 other
        self.jobs_evicted = 0       # finished jobs TTL-swept from registry
        self.plans_measured = 0     # launches planned from the cost table
        self.plans_heuristic = 0    # launches planned by the static heuristic
        self.retries_total = 0      # job retry dispatches after transients
        self.quarantined_total = 0  # poison jobs isolated + failed
        self.recovered_total = 0    # jobs re-enqueued by journal replay
        self.deadline_exceeded_total = 0
        self._journal_path = os.path.join(self.ckpt_root, JRN.JOURNAL_NAME)
        # "a" mode never truncates, so opening before replay is safe —
        # and recovery's own transitions get journaled too
        self._journal = JRN.SchedulerJournal(self._journal_path)
        if recover:
            self._recover()
        self.registry.attach_scheduler_stats(self.stats)
        self._worker = threading.Thread(target=self._run, name="ga-scheduler",
                                        daemon=True)
        self._worker.start()

    # ---- client API -----------------------------------------------------

    def submit(self, spec, *, backend: Optional[str] = None,
               priority: int = 0, deadline_s: Optional[float] = None,
               max_retries: Optional[int] = None) -> str:
        """Enqueue a GASpec; returns its job id immediately (state QUEUED).

        `deadline_s` bounds the job's wall clock from this moment —
        enforced at chunk granularity, ending in DEADLINE_EXCEEDED.
        `max_retries` overrides the scheduler's per-job retry budget."""
        with self._cv:
            if self._stop:
                raise RuntimeError("scheduler is shut down")
        job_id = self.registry.allocate_job_id(spec.problem or "blackbox")
        job = Job(job_id=job_id, spec=spec,
                  backend=backend if backend is not None else self.backend,
                  priority=int(priority),
                  deadline_s=None if deadline_s is None else float(deadline_s),
                  max_retries=max_retries,
                  submitted_at=self._clock())
        if self.cost_table is not None:
            # a scheduling hint: None (never an error) for a spec the
            # table does not cover or no engine can take
            from repro_torch.autotune import estimate_gens_per_s
            job.est_gens_per_s = estimate_gens_per_s(
                spec, self.cost_table, backend=job.backend,
                options=self.options)
        self.registry.queue_job(job_id, problem=spec.problem or "blackbox",
                                gens_total=spec.generations, n_vars=spec.v,
                                priority=job.priority, deadline_s=deadline_s)
        self._journal.append({"ev": "submit", "job_id": job_id,
                              "spec": JRN.spec_to_json(spec),
                              "backend": job.backend,
                              "priority": job.priority,
                              "deadline_s": job.deadline_s,
                              "max_retries": job.max_retries})
        with self._cv:
            self._jobs[job_id] = job
            self._queue.append(_Unit(seq=next(self._seq), jobs=[job]))
            self._cv.notify_all()
        return job_id

    def pause(self) -> None:
        """Stop dispatching new units (the unit in flight finishes its
        chunk loop normally).  Lets a chaos harness arm job-targeted fault
        rules between submit and first dispatch without racing the worker."""
        with self._cv:
            self._paused = True

    def resume_dispatch(self) -> None:
        with self._cv:
            self._paused = False
            self._cv.notify_all()

    def job(self, job_id: str) -> Job:
        with self._cv:
            return self._jobs[job_id]

    def result(self, job_id: str, timeout: Optional[float] = None
               ) -> Dict[str, Any]:
        """Block until the job finishes; returns its final telemetry dict.
        Raises RuntimeError if it FAILED, TimeoutError on timeout."""
        job = self.job(job_id)
        if not job.done.wait(timeout):
            raise TimeoutError(f"job {job_id} still {job.state} "
                               f"after {timeout}s")
        if job.state in (FAILED, DEADLINE_EXCEEDED):
            raise RuntimeError(f"job {job_id} {job.state}: {job.error}")
        return job.result

    def stream(self, job_id: str, timeout: Optional[float] = None
               ) -> Iterator[Dict[str, Any]]:
        """Yield per-chunk telemetry events live until the job ends (the
        same feed the metrics_http SSE endpoint serves)."""
        job = self.job(job_id)
        q = self.registry.subscribe(job_id)
        try:
            # subscribed after the job ended -> the end event predates the
            # subscription and will never arrive; don't block on it
            st = self.registry.metrics()["jobs"].get(job_id, {}).get("status")
            if job.done.is_set() or st in TERMINAL_STATES:
                return
            while True:
                event = q.get(timeout=timeout)
                if (event.get("event") == "end"
                        and event.get("status") == "aborted"):
                    # the worker died or the scheduler shut down under us —
                    # no organic end event is coming
                    raise RuntimeError(
                        f"job {job_id} stream aborted: {event.get('error')}")
                yield event
                if event.get("event") == "end":
                    return
        finally:
            self.registry.unsubscribe(job_id, q)

    def wait_all(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted job is DONE or FAILED."""
        import time as _t
        deadline = None if timeout is None else _t.monotonic() + timeout
        for job in list(self._jobs.values()):
            left = None if deadline is None else deadline - _t.monotonic()
            if left is not None and left <= 0:
                raise TimeoutError("jobs still pending")
            if not job.done.wait(left):
                raise TimeoutError(f"job {job.job_id} still {job.state}")

    def stats(self) -> Dict[str, Any]:
        """Scheduler gauges for /metrics (queue depth, running, packing and
        compile-cache counters)."""
        from repro_torch.ga.compile_cache import RUNNER_CACHE
        with self._cv:
            depth = sum(len(u.jobs) for u in self._queue)
            running = len(self._running)
        cache = RUNNER_CACHE.stats()
        return {"queue_depth": depth, "jobs_running": running,
                "packs_launched": self.packs_launched,
                "preemptions": self.preemptions,
                "jobs_packed": self.jobs_packed,
                "max_pack": self.max_pack,
                "cache_hits": cache["hits"],
                "cache_misses": cache["misses"],
                "cache_entries": cache["entries"],
                "jobs_evicted": self.jobs_evicted,
                "plans_measured": self.plans_measured,
                "plans_heuristic": self.plans_heuristic,
                "plan_table_entries": (len(self.cost_table)
                                       if self.cost_table is not None else 0),
                "retries": self.retries_total,
                "quarantined": self.quarantined_total,
                "recovered": self.recovered_total,
                "deadline_exceeded": self.deadline_exceeded_total,
                "worker_alive": (self._worker.is_alive()
                                 if hasattr(self, "_worker") else False)}

    def gc_now(self, now: Optional[float] = None) -> int:
        """Evict DONE/FAILED jobs older than `job_ttl_s`; returns the count.
        The worker calls this between dispatches; tests call it directly.
        Registry eviction happens outside `_cv` (its Condition lock is not
        reentrant and the registry takes its own lock)."""
        if self.job_ttl_s is None:
            return 0
        now = self._clock() if now is None else now
        with self._cv:
            stale = [j for j in self._jobs.values()
                     if j.state in TERMINAL_STATES
                     and j.finished_at is not None
                     and now - j.finished_at >= self.job_ttl_s]
            for j in stale:
                del self._jobs[j.job_id]
        for j in stale:
            self.registry.evict_job(j.job_id)
        self.jobs_evicted += len(stale)
        return len(stale)

    def shutdown(self, wait: bool = True, timeout: float = 30.0) -> None:
        """Stop the worker after the unit in flight; queued jobs stay QUEUED
        (their journal entries let a `recover=True` restart re-enqueue
        them).  With `wait`, a worker that fails to join within `timeout`
        is surfaced loudly — `stats()["worker_alive"]` stays True so
        callers can detect the stuck thread instead of silently leaking
        it."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if wait:
            self._worker.join(timeout)
            if self._worker.is_alive():
                warnings.warn(
                    f"GAScheduler worker did not stop within {timeout}s "
                    "(stuck mid-unit?); it remains joinable via "
                    "stats()['worker_alive']", stacklevel=2)
        # release any stream()/SSE clients blocked on jobs that will now
        # never produce an organic end event
        self.registry.abort_streams("scheduler shut down")
        if not self._worker.is_alive():
            self._journal.close()

    # ---- worker ---------------------------------------------------------

    def _pack_sig(self, job: Job):
        return (job.spec.compile_key(), job.spec.generations, job.backend)

    def _unit_order_key(self, u: _Unit):
        """Dispatch order: priority first, then (with a cost table) shortest
        estimated wall, then FIFO.  Estimated units outrank unestimated ones
        within a level; with no table every unit gets the same middle terms,
        so the order is bit-identical to plain priority/FIFO."""
        ests = [j.spec.generations / j.est_gens_per_s for j in u.jobs
                if j.est_gens_per_s]
        if not ests:
            return (u.priority, 0, 0.0, -u.seq)
        return (u.priority, 1, -min(ests), -u.seq)

    def _take_unit(self, ready: List[_Unit]) -> Optional[_Unit]:
        """Pop the best-priority READY unit; pack compatible fresh jobs onto
        it.  FIFO within a priority level (seq breaks ties)."""
        best = max(ready, key=self._unit_order_key)
        self._queue.remove(best)
        now = self._clock()
        if best.packable:
            sig = self._pack_sig(best.jobs[0])
            room = self.max_pack - best.jobs[0].spec.n_repeats
            for u in sorted([u for u in self._queue
                             if u.packable and u.not_before <= now],
                            key=lambda u: u.seq):
                if room <= 0:
                    break
                cand = u.jobs[0]
                if (self._pack_sig(cand) == sig
                        and cand.spec.n_repeats <= room):
                    self._queue.remove(u)
                    best.jobs.append(cand)
                    room -= cand.spec.n_repeats
        return best

    def _higher_priority_waiting(self, priority: int) -> bool:
        with self._cv:
            now = self._clock()
            return any(u.priority > priority and u.not_before <= now
                       for u in self._queue)

    def _run(self) -> None:
        try:
            self._run_loop()
        except BaseException as e:
            # the worker is the only dispatcher: its death strands every
            # stream()/SSE client — release them with a typed sentinel
            self.registry.abort_streams(f"scheduler worker died: {e!r}")
            raise

    def _run_loop(self) -> None:
        # with a TTL, wake periodically so finished jobs age out even while
        # the queue is idle; gc runs OUTSIDE _cv (it takes _cv itself plus
        # the registry lock)
        wait_s = None if self.job_ttl_s is None else min(1.0, self.job_ttl_s)
        while True:
            with self._cv:
                unit = None
                while not self._stop:
                    now = self._clock()
                    ready = ([] if self._paused else
                             [u for u in self._queue if u.not_before <= now])
                    if ready:
                        unit = self._take_unit(ready)
                        break
                    if self._queue or self._paused:
                        # backoff-delayed units (or a paused dispatcher):
                        # poll — an injected fake clock advances without a
                        # notify, so a real-time cap keeps the worker live
                        self._cv.wait(timeout=0.05)
                    else:
                        self._cv.wait(timeout=wait_s)
                        break   # idle wake: run the TTL sweep
                if self._stop:
                    return
                if unit is not None:
                    for j in unit.live_jobs():
                        j.state = RUNNING
                    self._running = unit.live_jobs()
            if unit is None:
                self.gc_now()
                continue
            try:
                self._run_unit(unit)
            except Exception as e:     # noqa: BLE001 — job-level failure wall
                self._handle_unit_failure(unit, e)
            finally:
                with self._cv:
                    self._running = []
                self.gc_now()

    # ---- failure handling ----------------------------------------------

    def _retry_budget(self, job: Job) -> int:
        return self.max_retries if job.max_retries is None \
            else max(0, int(job.max_retries))

    def _fail_job(self, job: Job, err: str, *, quarantined: bool = False,
                  state: str = FAILED) -> None:
        job.state = state
        job.error = err
        job.quarantined = quarantined
        job.finished_at = self._clock()
        if quarantined:
            self.quarantined_total += 1
        self.registry.finish_job(job.job_id, error=err, status=state,
                                 quarantined=quarantined)
        self._journal.append({"ev": "state", "job_id": job.job_id,
                              "state": state, "error": err})
        job.done.set()

    def _handle_unit_failure(self, unit: _Unit, exc: Exception) -> None:
        """Classify, then retry / split / quarantine.

        Transient + budget left: the whole unit requeues frozen with
        backoff, resuming from its last checkpoint.  Budget exhausted (or
        a permanent error) on a multi-job pack: split into solo frozen
        units, each resuming from a checkpoint sliced out of the pack's —
        the poison job re-fails alone and lands here again as a singleton,
        where it is quarantined; the survivors complete untouched."""
        unit.attempts += 1
        live = unit.live_jobs()
        err = repr(exc)
        kind = FLT.classify_error(exc)
        if not live:
            return
        if kind == "transient" and all(j.retries < self._retry_budget(j)
                                       for j in live):
            delay = retry_backoff(self.retry_backoff_s, unit.attempts,
                                  token=f"unit-{unit.seq}")
            for j in live:
                j.retries += 1
                j.state = QUEUED
                self.registry.note_retry(j.job_id)
                self.registry.set_status(j.job_id, QUEUED)
            self.retries_total += len(live)
            unit.packable = False      # membership freezes with its ckpt
            unit.not_before = self._clock() + delay
            self._journal.append({"ev": "requeue", "seq": unit.seq,
                                  "job_ids": [j.job_id for j in unit.jobs],
                                  "ckpt_dir": unit.ckpt_dir,
                                  "error": err, "backoff_s": delay})
            with self._cv:
                self._queue.append(unit)
                self._cv.notify_all()
            return
        if len(live) > 1:
            self._split_unit(unit, live, err)
            return
        self._fail_job(live[0], err, quarantined=unit.isolated
                       or live[0].retries >= self._retry_budget(live[0]))

    def _split_unit(self, unit: _Unit, live: List[Job], err: str) -> None:
        """Pack isolation: one solo frozen unit per live job, each resuming
        from a slice of the pack checkpoint (`ga.repack_checkpoint`)."""
        from repro_torch import ga
        specs = [j.spec for j in unit.jobs]
        opts = dataclasses.replace(self.options,
                                   faults=False)   # recovery ≠ injection site
        new_units = []
        for j in live:
            idx = unit.jobs.index(j)
            seq = next(self._seq)
            solo_dir = os.path.join(self.ckpt_root, f"pack-{seq}")
            if unit.ckpt_dir is not None:
                try:
                    ga.repack_checkpoint(unit.ckpt_dir, specs, [idx],
                                         solo_dir, j.backend, options=opts)
                except Exception as slice_err:   # noqa: BLE001
                    # an unsliceable/corrupt pack ckpt costs progress, not
                    # correctness: the solo unit restarts from generation 0
                    warnings.warn(
                        f"could not slice pack checkpoint for {j.job_id} "
                        f"({slice_err!r}); its solo retry restarts fresh",
                        stacklevel=2)
            j.state = QUEUED
            self.registry.set_status(j.job_id, QUEUED)
            new_units.append(_Unit(seq=seq, jobs=[j], packable=False,
                                   ckpt_dir=solo_dir, isolated=True))
            self._journal.append({"ev": "requeue", "seq": seq,
                                  "job_ids": [j.job_id],
                                  "ckpt_dir": solo_dir, "error": err,
                                  "isolated": True})
        with self._cv:
            self._queue.extend(new_units)
            self._cv.notify_all()

    # ---- deadlines ------------------------------------------------------

    def _expire_deadlines(self, jobs: List[Job]) -> List[Job]:
        """Mark any over-deadline job terminal; returns the expired ones."""
        now = self._clock()
        expired = []
        for j in jobs:
            if j.state in TERMINAL_STATES or j.deadline_s is None:
                continue
            spent = now - j.submitted_at
            if spent >= j.deadline_s:
                self.deadline_exceeded_total += 1
                self._fail_job(
                    j, f"deadline {j.deadline_s}s exceeded after {spent:.3f}s "
                       f"({j.spec.generations} generations requested)",
                    state=DEADLINE_EXCEEDED)
                expired.append(j)
        return expired

    # ---- journal recovery ----------------------------------------------

    def _recover(self) -> None:
        """Replay `journal.jsonl`: restore terminal jobs (with their
        JSON-safe results), re-enqueue everything else.  Pending jobs whose
        last unit was dispatched/parked come back as frozen units pointing
        at that unit's checkpoint dir, so the pack resumes bit-identically
        from its last completed chunk.  Blackbox jobs (callable fitness —
        not journal-serializable) still pending are FAILED with a clear
        reason rather than silently dropped.  Deadlines restart from
        recovery time (the journal records the budget, not elapsed wall)."""
        events = JRN.read_journal(self._journal_path)
        if not events:
            return
        rec_jobs, rec_units, job_unit, max_seq = JRN.replay(events)
        self._seq = itertools.count(max_seq + 1)
        id_nums = []
        for jid in rec_jobs:
            try:
                id_nums.append(int(jid.split("-")[1]))
            except (IndexError, ValueError):
                pass
        if id_nums:
            self.registry.ensure_next_id(max(id_nums) + 1)
        now = self._clock()
        pending_by_unit: Dict[Optional[int], List[Job]] = {}
        for rj in rec_jobs.values():
            spec = None
            if rj.spec_json is not None:
                spec = JRN.spec_from_json(rj.spec_json)
            job = Job(job_id=rj.job_id, spec=spec, backend=rj.backend,
                      priority=rj.priority, deadline_s=rj.deadline_s,
                      max_retries=rj.max_retries, submitted_at=now,
                      recovered=True)
            self._jobs[rj.job_id] = job
            problem = (spec.problem or "blackbox") if spec is not None \
                else "blackbox"
            self.registry.queue_job(
                rj.job_id, problem=problem,
                gens_total=spec.generations if spec is not None else 0,
                n_vars=spec.v if spec is not None else 0,
                priority=rj.priority, deadline_s=rj.deadline_s)
            if rj.terminal:
                job.state = rj.state
                job.error = rj.error
                job.result = rj.result
                job.finished_at = now
                self.registry.finish_job(rj.job_id, error=rj.error,
                                         status=rj.state)
                job.done.set()
                continue
            if spec is None:
                self._fail_job(job, "not recoverable after restart: a "
                               "blackbox (callable) fitness cannot be "
                               "journal-serialized; resubmit the job")
                continue
            pending_by_unit.setdefault(job_unit.get(rj.job_id),
                                       []).append(job)
        for seq, jobs in pending_by_unit.items():
            unit_info = rec_units.get(seq) if seq is not None else None
            ids = unit_info["job_ids"] if unit_info else []
            if (unit_info is not None
                    and sorted(ids) == sorted(j.job_id for j in jobs)):
                # full membership survived: resume the frozen pack from its
                # checkpoint (journal order = slot order = seed identity)
                order = {jid: i for i, jid in enumerate(ids)}
                jobs = sorted(jobs, key=lambda j: order[j.job_id])
                self._queue.append(_Unit(seq=seq, jobs=jobs, packable=False,
                                         ckpt_dir=unit_info["ckpt_dir"]))
            else:
                # membership changed (some members finished) — the pack
                # checkpoint no longer matches; restart each job fresh
                for j in jobs:
                    self._queue.append(_Unit(seq=next(self._seq), jobs=[j]))
            self.recovered_total += len(jobs)
            for j in jobs:
                self.registry.set_status(j.job_id, QUEUED)

    # result keys that survive journaling (scalars + decoded params only —
    # numpy trajectories and RunTelemetry objects are not JSON)
    _RESULT_JSON_KEYS = ("chunk", "gens_done", "gens_total", "chunk_gens",
                         "chunk_best", "best_fitness", "wall_s", "gens_per_s",
                         "backend", "problem", "n_vars", "migrations",
                         "job_index", "pack_size")

    def _run_unit(self, unit: _Unit) -> None:
        from repro_torch.ga.engine import PackedEngine

        jobs = unit.jobs
        # a queued job can blow its deadline before ever dispatching
        self._expire_deadlines(jobs)
        live = unit.live_jobs()
        if not live:
            return
        if unit.packable:
            # fresh unit: expired members simply leave the pack
            unit.jobs = jobs = live
        if unit.ckpt_dir is None:
            unit.ckpt_dir = os.path.join(self.ckpt_root, f"pack-{unit.seq}")
        fault_tag = ",".join(j.job_id for j in jobs)
        if self.faults is not None:
            # the compile_fail site: a build blow-up before any chunk
            self.faults.inject("compile_fail", fault_tag)
        pe = PackedEngine(
            [j.spec for j in jobs], jobs[0].backend,
            options=dataclasses.replace(
                self.options,
                # share THIS injector instance (counters and all); False
                # stops a disarmed engine re-resolving the ambient env
                faults=self.faults if self.faults is not None else False))
        self.packs_launched += 1
        if len(jobs) > 1:
            self.jobs_packed += len(jobs)
        for j in live:
            self.registry.start_job(j.job_id, backend=pe.backend_name,
                                    gens_total=j.spec.generations,
                                    problem=j.spec.problem or "blackbox",
                                    n_vars=j.spec.v)
        self._journal.append({"ev": "dispatch", "seq": unit.seq,
                              "job_ids": [j.job_id for j in jobs],
                              "ckpt_dir": unit.ckpt_dir,
                              "attempt": unit.attempts})
        priority = unit.priority
        last: Optional[Dict[str, Any]] = None
        for tele in pe.run_chunked(chunk_generations=self.chunk_generations,
                                   ckpt_dir=unit.ckpt_dir, resume=True,
                                   fault_tag=fault_tag):
            if last is None:   # count the plan once per dispatch
                tj = tele["jobs"][0].get("telemetry")
                ps = tj.plan.source if tj is not None else None
                if ps == "measured":
                    self.plans_measured += 1
                elif ps is not None and ps != "-":
                    self.plans_heuristic += 1
            last = tele
            for j, jt in zip(jobs, tele["jobs"]):
                if j.state not in TERMINAL_STATES:
                    self.registry.record_chunk(j.job_id, jt)
            # deadline enforcement at chunk granularity: expired members of
            # a frozen pack stay in the launch (the checkpoint's membership
            # identity) but stop receiving chunks/results; a pack with no
            # live member left stops computing entirely
            self._expire_deadlines(jobs)
            if not unit.live_jobs():
                return
            if (tele["gens_done"] < tele["gens_total"]
                    and self._higher_priority_waiting(priority)):
                # park the pack: state is already checkpointed; membership
                # freezes so the packed checkpoint resumes with these jobs
                for j in unit.live_jobs():
                    j.state = PREEMPTED
                    self.registry.set_status(j.job_id, PREEMPTED)
                self.preemptions += 1
                self._journal.append({"ev": "park", "seq": unit.seq,
                                      "job_ids": [j.job_id for j in jobs],
                                      "ckpt_dir": unit.ckpt_dir})
                with self._cv:
                    # jobs stay PREEMPTED while waiting (the informative
                    # state); the unit re-enters the queue and flips them
                    # back to RUNNING when re-dispatched
                    self._queue.append(_Unit(seq=unit.seq, jobs=jobs,
                                             packable=False,
                                             ckpt_dir=unit.ckpt_dir,
                                             attempts=unit.attempts,
                                             isolated=unit.isolated))
                    self._cv.notify_all()
                return
        now = self._clock()
        for j, jt in zip(jobs, last["jobs"]):
            if j.state in TERMINAL_STATES:
                continue
            j.result = dict(jt)
            j.result["best_params"] = [float(v) for v in jt["best_params"]]
            j.state = DONE
            j.finished_at = now
            self.registry.finish_job(j.job_id)
            safe = {k: j.result[k] for k in self._RESULT_JSON_KEYS
                    if k in j.result}
            safe["best_params"] = j.result["best_params"]
            self._journal.append({"ev": "done", "job_id": j.job_id,
                                  "result": safe})
            j.done.set()
