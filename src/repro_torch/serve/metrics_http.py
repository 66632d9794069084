"""Stdlib HTTP surface for the GA serving telemetry.

`GA_METRICS` (repro_torch.serve.engine) aggregates `run_chunked` telemetry
per job; this module makes that snapshot scrapeable AND streamable before a
full RPC stack lands: a `http.server` daemon thread rendering the registry
in Prometheus text exposition format plus JSON/SSE job endpoints.

    from repro_torch.serve.metrics_http import start_metrics_server
    server = start_metrics_server(9100)          # or 0 for an ephemeral port
    ... run GA jobs (serve.engine.run_ga_job / serve.scheduler) ...
    server.shutdown()

Endpoints:
  /metrics               Prometheus text (version 0.0.4) — per-job gauges,
                         fleet totals, and (when a GAScheduler attached its
                         stats to the registry) queue-depth / jobs-running /
                         compile-cache gauges.
  /healthz               liveness probe.
  /jobs                  JSON registry snapshot.
  /jobs/<id>             JSON one job; `?after=N&timeout=S` long-polls until
                         the job has recorded more than N chunks (or ended).
  /jobs/<id>/stream      Server-Sent Events: one `data:` JSON line per
                         telemetry chunk while the job runs, closing with an
                         `event: end` message — live streaming for curl /
                         EventSource clients.

Opt-in from the CLI with `repro_torch.launch.ga_serve --port PORT`.

The port's own copy of the JAX package's `repro.serve.metrics_http`: the
same endpoints and the same `repro_ga_*` metric names, so one dashboard
reads both packages.
"""

from __future__ import annotations

import json
import queue as _queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

_PREFIX = "repro_ga"

# per-job numeric gauges: (metrics()-dict key, prometheus suffix, help)
_JOB_GAUGES = (
    ("generations_done", "generations_done", "Generations completed"),
    ("generations_total", "generations_total", "Generations requested"),
    ("chunks", "chunks", "Telemetry chunks recorded"),
    ("generations_per_s", "generations_per_s", "Generations per second"),
    ("islands", "islands", "Concurrently evolving populations"),
    ("shards", "shards", "Mesh shards the island axis spans"),
    ("generations_per_s_per_shard", "generations_per_s_per_shard",
     "Island-generations per second per mesh shard"),
    ("best_fitness", "best_fitness", "Best fitness seen (real units)"),
    ("migration_count", "migrations", "Ring migrations performed"),
    ("n_vars", "n_vars", "Decoded variable count V"),
    ("wall_s", "wall_seconds", "Wall-clock seconds spent"),
    ("priority", "priority", "Scheduler priority (higher preempts)"),
    ("preemptions", "preemptions", "Times the scheduler parked this job"),
    ("retries", "retries", "Scheduler retry dispatches of this job"),
    ("pack_size", "pack_size", "Jobs sharing this job's launch"),
)

_FLEET_GAUGES = (
    ("job_count", "jobs", "GA jobs known to the registry"),
    ("jobs_done", "jobs_done", "GA jobs finished successfully"),
    ("jobs_running", "jobs_running", "GA jobs currently running"),
    ("jobs_queued", "jobs_queued", "GA jobs waiting in the scheduler queue"),
    ("jobs_preempted", "jobs_preempted", "GA jobs parked by preemption"),
    ("jobs_failed", "jobs_failed", "GA jobs that errored"),
    ("jobs_deadline_exceeded", "jobs_deadline_exceeded",
     "GA jobs that ran out of wall-clock budget"),
    ("generations_total", "fleet_generations", "Generations done, all jobs"),
    ("migrations_total", "fleet_migrations", "Migrations, all jobs"),
)

# scheduler gauges (snapshot["scheduler"], present when a GAScheduler is
# attached): queue depth / packing / compile-cache counters for the CI smoke
_SCHED_GAUGES = (
    ("queue_depth", "sched_queue_depth", "Jobs waiting for the mesh"),
    ("jobs_running", "sched_jobs_running", "Jobs in the running pack"),
    ("packs_launched", "sched_packs_launched", "Packed launches dispatched"),
    ("preemptions", "sched_preemptions", "Packs parked for priority work"),
    ("jobs_packed", "sched_jobs_packed", "Jobs that shared a launch"),
    ("cache_hits", "compile_cache_hits", "Compiled-runner cache hits"),
    ("cache_misses", "compile_cache_misses", "Compiled-runner cache misses"),
    ("cache_entries", "compile_cache_entries", "Compiled runners cached"),
    ("jobs_evicted", "sched_evicted_total",
     "Finished jobs TTL-evicted from the registry"),
    ("plans_measured", "plan_measured_total",
     "Launches planned from measured cost tables"),
    ("plans_heuristic", "plan_heuristic_total",
     "Launches planned by the static heuristic"),
    ("plan_table_entries", "plan_table_entries",
     "Cost-table points available to the planner"),
    ("retries", "sched_retries_total",
     "Job retry dispatches after transient failures"),
    ("quarantined", "sched_quarantined_total",
     "Poison jobs isolated from their pack and failed"),
    ("recovered", "sched_recovered_total",
     "Jobs re-enqueued by journal replay after a restart"),
    ("deadline_exceeded", "sched_deadline_exceeded_total",
     "Jobs terminated at their wall-clock deadline"),
    ("worker_alive", "sched_worker_alive",
     "1 while the scheduler worker thread is running"),
)


def _esc(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def render_prometheus(snapshot: dict) -> str:
    """Serialize a `GAMetricsRegistry.metrics()` snapshot as Prometheus
    text exposition format (one gauge family per numeric job stat, the job
    identity carried in labels)."""
    lines = []
    jobs = snapshot.get("jobs", {})

    def label_str(j):
        return (f'job_id="{_esc(j["job_id"])}",backend="{_esc(j["backend"])}"'
                f',problem="{_esc(j["problem"])}"')

    for key, suffix, help_ in _JOB_GAUGES:
        name = f"{_PREFIX}_{suffix}"
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} gauge")
        for j in jobs.values():
            val = j.get(key)
            if val is None:
                continue
            lines.append(f"{name}{{{label_str(j)}}} {float(val):g}")
    # job status as a one-hot info gauge
    name = f"{_PREFIX}_job_status"
    lines.append(f"# HELP {name} Job state (1 for the current status label)")
    lines.append(f"# TYPE {name} gauge")
    for j in jobs.values():
        lines.append(
            f'{name}{{{label_str(j)},status="{_esc(j["status"])}"}} 1')
    # the epoch-plan decision (mode × provenance × selection lane) as a
    # one-hot info gauge, so dashboards can see e.g. "auto" picking gather
    name = f"{_PREFIX}_plan_info"
    lines.append(f"# HELP {name} Epoch plan decision "
                 "(1 for the current mode/source/lane labels)")
    lines.append(f"# TYPE {name} gauge")
    for j in jobs.values():
        if j.get("epoch_mode", "-") == "-":
            continue
        lines.append(
            f'{name}{{{label_str(j)},mode="{_esc(j["epoch_mode"])}"'
            f',source="{_esc(j["plan_source"])}"'
            f',lane="{_esc(j.get("sel_lane", "-"))}"}} 1')
    for key, suffix, help_ in _FLEET_GAUGES:
        name = f"{_PREFIX}_{suffix}"
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {float(snapshot.get(key, 0)):g}")
    sched = snapshot.get("scheduler")
    if sched:
        for key, suffix, help_ in _SCHED_GAUGES:
            if key not in sched:
                continue
            name = f"{_PREFIX}_{suffix}"
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {float(sched[key]):g}")
    return "\n".join(lines) + "\n"


def _json_default(v):
    try:
        import numpy as np
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, np.generic):
            return v.item()
        import torch
        if isinstance(v, torch.Tensor):
            return v.item() if v.dim() == 0 else v.tolist()
    except Exception:
        pass
    return str(v)


def start_metrics_server(port: int = 0, registry=None,
                         host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """Serve `registry` (default: the process-global GA_METRICS) at
    /metrics (+ /jobs JSON, /jobs/<id> long-poll, /jobs/<id>/stream SSE) on
    a daemon thread.  Returns the server; its bound port is
    `server.server_address[1]` (useful with port=0), stop with
    `server.shutdown()`."""
    if registry is None:
        from repro_torch.serve.engine import GA_METRICS
        registry = GA_METRICS

    class Handler(BaseHTTPRequestHandler):
        def _send(self, body: bytes, ctype: str, code: int = 200):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, obj, code: int = 200):
            self._send(json.dumps(obj, default=_json_default).encode(),
                       "application/json", code)

        def _job_snapshot(self, job_id):
            return registry.metrics()["jobs"].get(job_id)

        def _long_poll(self, job_id, qs):
            """Block until the job has recorded more chunks than `after`
            (or ended / `timeout` seconds passed), then return its dict."""
            after = int(qs.get("after", ["-1"])[0])
            timeout = min(float(qs.get("timeout", ["30"])[0]), 300.0)
            snap = self._job_snapshot(job_id)
            if snap is None:
                self.send_error(404, f"no such job {job_id}")
                return
            sub = registry.subscribe(job_id)
            try:
                import time as _t
                deadline = _t.monotonic() + timeout
                while (snap["chunks"] <= after
                       and snap["status"] in ("pending", "queued", "running",
                                              "preempted")):
                    left = deadline - _t.monotonic()
                    if left <= 0:
                        break
                    try:
                        sub.get(timeout=min(left, 1.0))
                    except _queue.Empty:
                        pass
                    snap = self._job_snapshot(job_id)
            finally:
                registry.unsubscribe(job_id, sub)
            self._send_json(snap)

        def _stream_sse(self, job_id):
            """Server-Sent Events: chunk telemetry as `data:` JSON lines."""
            snap = self._job_snapshot(job_id)
            if snap is None:
                self.send_error(404, f"no such job {job_id}")
                return
            sub = registry.subscribe(job_id)
            try:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                # prime with the current snapshot so late subscribers see
                # where the job stands before live chunks arrive
                self.wfile.write(b"event: snapshot\ndata: " + json.dumps(
                    snap, default=_json_default).encode() + b"\n\n")
                self.wfile.flush()
                if snap["status"] in ("done", "failed", "deadline_exceeded"):
                    return
                while True:
                    try:
                        event = sub.get(timeout=15.0)
                    except _queue.Empty:
                        self.wfile.write(b": keepalive\n\n")   # SSE comment
                        self.wfile.flush()
                        continue
                    name = event.get("event", "chunk")
                    self.wfile.write(
                        f"event: {name}\n".encode() + b"data: " + json.dumps(
                            event, default=_json_default).encode() + b"\n\n")
                    self.wfile.flush()
                    if name == "end":
                        return
            except (BrokenPipeError, ConnectionResetError):
                pass                                 # client went away
            finally:
                registry.unsubscribe(job_id, sub)

        def do_GET(self):  # noqa: N802  (http.server API)
            url = urlparse(self.path)
            path, qs = url.path.rstrip("/") or "/", parse_qs(url.query)
            if path in ("/", "/metrics"):
                self._send(render_prometheus(registry.metrics()).encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/healthz":
                self._send(b"ok\n", "text/plain")
            elif path == "/jobs":
                self._send_json(registry.metrics())
            elif path.startswith("/jobs/") and path.endswith("/stream"):
                self._stream_sse(path[len("/jobs/"):-len("/stream")])
            elif path.startswith("/jobs/"):
                job_id = path[len("/jobs/"):]
                if "after" in qs or "timeout" in qs:
                    self._long_poll(job_id, qs)
                else:
                    snap = self._job_snapshot(job_id)
                    if snap is None:
                        self.send_error(404, f"no such job {job_id}")
                    else:
                        self._send_json(snap)
            else:
                self.send_error(404)

        def log_message(self, *a):   # keep scrapes out of stdout
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever,
                              name="ga-metrics-http", daemon=True)
    thread.start()
    return server
