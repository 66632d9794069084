"""Process-wide cache of what an engine builds for a spec shape.

Two Engines built from specs of the same shape (`GASpec.compile_key()`:
everything but seed, generations and n_repeats) run the same computation,
so the second one need build nothing the first one built: the compiled
`FitnessProgram` with its FFM constants already on the device, the
executor around it, and the runner closures of each launch shape.  This
module holds them in one process-global LRU keyed by the spec's shape, the
backend composition, the device (`device_fingerprint`) and the mesh
(`mesh_fingerprint`).  Safe because `cfg.seed` is consumed only
by `init_state`, never inside a runner.  The epoch plan is not held here:
an engine plans anew, which costs a few dict operations (the card's
occupancy it reads is cached in `kernels.ga_step`) and follows the
planner's inputs wherever they change.

Counters (`hits` / `misses` / `evictions`) feed the serving metrics and
the tests; `RUNNER_CACHE` is the global instance.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, Optional, Tuple

import torch


def device_fingerprint(device) -> tuple:
    """Hashable identity of a torch device: its type and index, and on a
    card its name and compute capability (two cards of one kind run the
    same kernels; another kind may plan otherwise)."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return (dev.type, dev.index)
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    return ("cuda", index, torch.cuda.get_device_name(index),
            torch.cuda.get_device_capability(index))


def mesh_fingerprint(mesh) -> Optional[tuple]:
    """Hashable identity of a mesh: axis names, shape and the (type, index)
    of the device at each position (two meshes of the same layout over the
    same devices run the same launches)."""
    if mesh is None:
        return None
    return (tuple(mesh.axis_names),
            tuple(int(mesh.shape[a]) for a in mesh.axis_names),
            tuple((d.type, d.index) for d in mesh.devices.flat))


class CompileCache:
    """Thread-safe LRU of built engine parts with hit/miss counters."""

    def __init__(self, max_entries: int = 128):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Hashable, Any]" = OrderedDict()
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get_or_build(self, key: Hashable, builder: Callable[[], Any]) -> Any:
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.hits += 1
                return self._entries[key]
        # build outside the lock: a racing duplicate build is harmless —
        # the first writer wins and both callers get a working part
        fn = builder()
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.hits += 1
                return self._entries[key]
            self.misses += 1
            self._entries[key] = fn
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions += 1
            return fn

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._entries), "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions}

    def reset(self) -> None:
        """Drop every entry and zero the counters (tests)."""
        with self._lock:
            self._entries.clear()
            self.hits = self.misses = self.evictions = 0


RUNNER_CACHE = CompileCache()


def runner_key(spec, topology_name: str, executor_name: str, device,
               *parts: Hashable, mesh=None) -> Tuple:
    """Cache key for one built part.

    `spec.n_repeats` rides along because the runner closures branch on the
    R==1 vs stacked layout (not just shapes); `parts` carries part-local
    knobs (gens, solo flag, interval count, plan override, ...); `mesh` the
    mesh the part's island axis shards over."""
    return (spec.compile_key(), spec.n_repeats, topology_name,
            executor_name, device_fingerprint(device),
            mesh_fingerprint(mesh)) + parts


def stage_fingerprint(spec) -> str:
    """Problem-stage kind for autotune cost-table keying: registry problems
    are identified by name, blackboxes collapse to their variable count."""
    if spec.problem is not None:
        return f"{spec.problem}:v{spec.v}"
    return f"blackbox:v{spec.v}"


def plan_point(spec, *, executor: str, mode: str, n_shards: int,
               lane: Optional[str] = None) -> dict:
    """The autotune cost-table identity of one epoch-plan candidate, with
    the JAX package's fields: everything that changes the launch is in the
    key, seed/generations/n_repeats are not.  `lane` defaults to the
    spec's resolved selection lane."""
    i_local = max(1, spec.n_islands // max(1, n_shards))
    return {"executor": executor, "mode": mode, "migration": spec.migration,
            "n": spec.n, "i_local": i_local, "c": spec.bits_per_var,
            "stage": stage_fingerprint(spec), "shards": n_shards,
            "E": spec.migrate_every,
            "lane": spec.resolved_sel_lane if lane is None else lane}
