"""Durable scheduler journal: append-only JSONL under the checkpoint root.

The in-memory job queue is the one scheduler structure a process death
loses — pack checkpoints already persist the *state* of running work, but
nothing persisted *which* jobs existed and where they stood.  This module
closes that gap with the smallest durable structure that can: an
append-only JSONL event log (`journal.jsonl` next to the pack checkpoint
dirs) that `GAScheduler(recover=True)` replays on startup.

Events (one JSON object per line, `"ev"` discriminates):

  * ``submit``   — job id, serialized GASpec, backend/priority/deadline/
    retry budget.  Blackbox specs (callable fitness) are not serializable;
    they journal with ``"spec": null`` and replay marks any such job still
    pending as FAILED with a clear reason instead of silently dropping it.
  * ``dispatch`` — a unit (job ids + ckpt dir) started running.
  * ``park``     — the unit was preempted (membership frozen, ckpt on disk).
  * ``requeue``  — the unit went back to the queue for a retry.
  * ``state``    — a job reached failed / deadline_exceeded (with error).
  * ``done``     — a job finished, with a JSON-safe result subset.

Replay folds the log in order: the LAST event wins per job/unit, so a job
that was submitted, dispatched, parked, re-dispatched and finished replays
straight to its final result.  Jobs left queued / preempted / running
re-enqueue; their latest unit's checkpoint directory lets the pack resume
bit-identically from its last completed chunk.

Appends are flushed + fsynced — events are per state transition (not per
chunk).  A torn final line (the process died mid-append) is treated as the
end of the log, never an error.

The port's own copy of the JAX package's `repro.serve.journal`: the same
events, file name and replay.  `spec_from_json` builds the port's
`GASpec`, whose fields are the JAX package's, so a journal written by
either package's scheduler recovers in the other (as their checkpoints
do).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

JOURNAL_NAME = "journal.jsonl"

# states a replayed job can rest in (mirrors serve.scheduler's constants;
# duplicated here so the journal stays import-light)
_TERMINAL = ("done", "failed", "deadline_exceeded")


def spec_to_json(spec) -> Optional[Dict[str, Any]]:
    """A GASpec as a JSON-safe dict, or None when it cannot round-trip (a
    blackbox callable fitness has no serialization)."""
    if getattr(spec, "fitness", None) is not None:
        return None
    d = dataclasses.asdict(spec)
    d.pop("fitness", None)
    return d


def spec_from_json(d: Dict[str, Any]):
    """Rebuild a GASpec from `spec_to_json` output (GASpec.__post_init__
    re-tuples bounds/mesh_axes, so JSON lists round-trip cleanly)."""
    from repro_torch.ga.spec import GASpec   # lazy: journal reads stay light
    kw = dict(d)
    for key in ("bounds", "mesh_axes"):
        if kw.get(key) is not None:
            kw[key] = tuple(tuple(x) if isinstance(x, list) else x
                            for x in kw[key])
    return GASpec(**kw)


class SchedulerJournal:
    """Append-only JSONL writer (thread-safe, flush+fsync per event)."""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        self._lock = threading.Lock()
        self._closed = False

    def append(self, event: Dict[str, Any]) -> None:
        line = json.dumps(event, separators=(",", ":"))
        with self._lock:
            if self._closed:
                return
            self._f.write(line + "\n")
            self._f.flush()
            os.fsync(self._f.fileno())

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                self._closed = True
                self._f.close()


def read_journal(path: str) -> List[Dict[str, Any]]:
    """All well-formed events in order.  A torn tail line — the process
    died mid-append — ends the log; everything before it is trusted."""
    events: List[Dict[str, Any]] = []
    if not os.path.exists(path):
        return events
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                break
    return events


@dataclasses.dataclass
class RecoveredJob:
    """One job's folded journal history."""

    job_id: str
    spec_json: Optional[Dict[str, Any]]
    backend: str = "auto"
    priority: int = 0
    deadline_s: Optional[float] = None
    max_retries: Optional[int] = None
    state: str = "queued"
    error: Optional[str] = None
    result: Optional[Dict[str, Any]] = None

    @property
    def terminal(self) -> bool:
        return self.state in _TERMINAL


def replay(events: List[Dict[str, Any]]) -> Tuple[
        Dict[str, RecoveredJob], Dict[int, Dict[str, Any]],
        Dict[str, int], int]:
    """Fold an event list into recovery state.

    Returns ``(jobs, units, job_unit, max_seq)``: every journaled job with
    its last known state/result, the last composition seen for each unit
    seq (job ids + ckpt dir), each job's latest unit seq, and the highest
    unit seq (so a recovering scheduler numbers new units past it)."""
    jobs: Dict[str, RecoveredJob] = {}
    units: Dict[int, Dict[str, Any]] = {}
    job_unit: Dict[str, int] = {}
    max_seq = -1
    for ev in events:
        t = ev.get("ev")
        if t == "submit":
            jobs[ev["job_id"]] = RecoveredJob(
                job_id=ev["job_id"], spec_json=ev.get("spec"),
                backend=ev.get("backend", "auto"),
                priority=int(ev.get("priority", 0)),
                deadline_s=ev.get("deadline_s"),
                max_retries=ev.get("max_retries"))
        elif t in ("dispatch", "park", "requeue"):
            seq = int(ev["seq"])
            max_seq = max(max_seq, seq)
            units[seq] = {"job_ids": list(ev["job_ids"]),
                          "ckpt_dir": ev.get("ckpt_dir")}
            state = {"dispatch": "running", "park": "preempted",
                     "requeue": "queued"}[t]
            for jid in ev["job_ids"]:
                job_unit[jid] = seq
                if jid in jobs and not jobs[jid].terminal:
                    jobs[jid].state = state
        elif t == "state":
            jid = ev["job_id"]
            if jid in jobs:
                jobs[jid].state = ev["state"]
                jobs[jid].error = ev.get("error")
        elif t == "done":
            jid = ev["job_id"]
            if jid in jobs:
                jobs[jid].state = "done"
                jobs[jid].result = ev.get("result")
    return jobs, units, job_unit, max_seq
