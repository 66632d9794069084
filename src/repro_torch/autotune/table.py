"""Versioned per-host cost tables: measured gens/s per epoch-plan point.

The epoch planner (`ga/backends.IslandRingTopology._epoch_plan`) picks a
launch shape by its heuristic; this module is the measured half of the
two-tier decision — a JSON-persisted table mapping each plan POINT to
observed generations/second:

  point  = (executor, epoch mode, migration, N, islands-per-shard, c,
            problem-stage kind, shard count, migrate_every,
            selection lane)                                   [POINT_FIELDS]
  axis   = gens_per_launch — the generations one launch folds; the one
           continuous knob, so `lookup` linearly interpolates between
           measured axis values (and returns None outside the measured
           range: no extrapolation, the planner falls back to the
           heuristic instead of trusting an invented number).

The port's copy of the JAX package's `repro.autotune.table`: the same
version, fields and JSON format, so a table file written by either package
loads in the other with equal `lookup` values.  Only the host fingerprint
reads torch: platform "cuda" (device kind `torch.cuda.get_device_name`,
count `torch.cuda.device_count()`) or, without a card, "cpu" with one
device.  Platform + count decide whether measurements transfer; the device
kind is recorded for the report but not gated.  `resolve_table` is the
single discovery entry point:

  resolve_table(False)          -> None (explicitly disabled — the pure
                                  heuristic, what the tests pin)
  resolve_table(CostTable)      -> itself
  resolve_table("path.json")    -> load, TRUSTED (no host check: the caller
                                  chose the file)
  resolve_table(None)           -> the ambient default: REPRO_GA_COST_TABLE
                                  ("", "0", "off", "none" disable; a path
                                  pins a trusted file) or else the per-host
                                  cache file (`default_table_path()`),
                                  loaded STRICTLY — version or host
                                  mismatch silently yields None.

The two packages share the environment variables and the cache directory
(``~/.cache/repro-ga``, or ``REPRO_GA_AUTOTUNE_CACHE``), but not the cache
FILE: the port discovers ``torch_cost_table.json`` where the JAX package
discovers ``cost_table.json``.  On a CPU host both fingerprints say "cpu"
with one device and the executor names are the same, so a shared file
would let a JAX sweep (XLA's timings) steer the port's plans; with two
files an ambient table only ever holds its own package's measurements.  A
table crosses between the packages only where a caller names it: a path,
a `CostTable`, or a ``REPRO_GA_COST_TABLE`` pin.

Loads are memoized by (path, mtime), so per-Engine-build resolution costs a
stat(2), not a parse.
"""

from __future__ import annotations

import bisect
import json
import os
import warnings
from typing import Any, Dict, Iterator, Optional, Tuple

TABLE_VERSION = 2   # v2: plan points gained the "lane" field (sel_lane)

# identity of one measured plan point (the table key; gens_per_launch is the
# interpolation axis, n_repeats is deliberately EXCLUDED — the replica axis
# rides the kernel grid / vmap and scales throughput, it does not change
# which mode wins, and keying on it would shatter the table)
POINT_FIELDS = ("executor", "mode", "migration", "n", "i_local", "c",
                "stage", "shards", "E", "lane")

_DISABLE_VALUES = {"", "0", "off", "none", "false"}


def point_key(point: Dict[str, Any]) -> Tuple:
    """Canonical hashable key of a plan point dict (POINT_FIELDS order)."""
    return tuple(point[f] for f in POINT_FIELDS)


def host_fingerprint() -> Dict[str, Any]:
    """This process's device identity (lazy torch import — table files are
    readable without touching a device): the card's platform, kind and
    count, or the CPU as one device."""
    import torch
    if torch.cuda.is_available():
        return {"platform": "cuda",
                "device_kind": torch.cuda.get_device_name(0),
                "device_count": torch.cuda.device_count()}
    return {"platform": "cpu", "device_kind": "cpu", "device_count": 1}


def hosts_match(a: Optional[dict], b: Optional[dict]) -> bool:
    """Platform + device count decide whether measurements transfer; the
    device kind is informational."""
    if not a or not b:
        return False
    return (a.get("platform") == b.get("platform")
            and a.get("device_count") == b.get("device_count"))


def default_cache_dir() -> str:
    override = os.environ.get("REPRO_GA_AUTOTUNE_CACHE")
    if override:
        return override
    return os.path.join(os.path.expanduser("~"), ".cache", "repro-ga")


def default_table_path() -> str:
    """The ambient per-host cost-table file `resolve_table(None)` discovers
    (host identity is checked at load, not encoded in the name; the JAX
    package's file beside it is never read, see the module docstring)."""
    return os.path.join(default_cache_dir(), "torch_cost_table.json")


class CostTable:
    """gens/s measurements keyed by plan point, with per-point linear
    interpolation over the gens_per_launch axis."""

    def __init__(self, host: Optional[dict] = None,
                 version: int = TABLE_VERSION):
        self.version = version
        self.host = dict(host) if host else None
        # point key tuple -> {gens_per_launch: {"gens_per_s", "reps", "cov"}}
        self._series: Dict[Tuple, Dict[int, Dict[str, Any]]] = {}

    # ---- mutation -------------------------------------------------------

    def add(self, point: Dict[str, Any], gens_per_launch: int,
            gens_per_s: float, *, reps: int = 1, cov: float = 0.0) -> None:
        series = self._series.setdefault(point_key(point), {})
        series[int(gens_per_launch)] = {"gens_per_s": float(gens_per_s),
                                        "reps": int(reps),
                                        "cov": round(float(cov), 5)}

    def merge(self, other: "CostTable") -> None:
        """Fold `other`'s points in (other wins on conflicts)."""
        for key, series in other._series.items():
            self._series.setdefault(key, {}).update(
                {g: dict(e) for g, e in series.items()})

    # ---- queries --------------------------------------------------------

    def lookup(self, point: Dict[str, Any],
               gens_per_launch: int) -> Optional[float]:
        """Measured (or interpolated) gens/s for a plan point, or None when
        the table does not cover it — exact axis hit wins; between two
        measured gens_per_launch values the estimate is linear; outside the
        measured range there is no answer (never extrapolate)."""
        series = self._series.get(point_key(point))
        if not series:
            return None
        g = int(gens_per_launch)
        if g in series:
            return series[g]["gens_per_s"]
        gs = sorted(series)
        if g < gs[0] or g > gs[-1]:
            return None
        i = bisect.bisect_left(gs, g)
        glo, ghi = gs[i - 1], gs[i]
        ylo, yhi = series[glo]["gens_per_s"], series[ghi]["gens_per_s"]
        t = (g - glo) / (ghi - glo)
        return ylo + t * (yhi - ylo)

    def entries(self) -> Iterator[Dict[str, Any]]:
        """Flat iterator of measured rows (point fields + axis + stats) —
        the serialization shape."""
        for key, series in sorted(self._series.items(),
                                  key=lambda kv: tuple(map(str, kv[0]))):
            point = dict(zip(POINT_FIELDS, key))
            for g in sorted(series):
                yield {**point, "gens_per_launch": g, **series[g]}

    def __len__(self) -> int:
        return sum(len(s) for s in self._series.values())

    # ---- persistence ----------------------------------------------------

    def to_json(self) -> Dict[str, Any]:
        return {"version": self.version, "host": self.host,
                "entries": list(self.entries())}

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)
            f.write("\n")
        return path

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "CostTable":
        table = cls(host=obj.get("host"),
                    version=int(obj.get("version", -1)))
        for e in obj.get("entries", ()):
            point = {f: e[f] for f in POINT_FIELDS}
            table.add(point, e["gens_per_launch"], e["gens_per_s"],
                      reps=e.get("reps", 1), cov=e.get("cov", 0.0))
        return table

    @classmethod
    def load(cls, path: str,
             expect_host: Optional[dict] = None) -> Optional["CostTable"]:
        """Load a table file, or None when it is unusable: missing/corrupt,
        a stale TABLE_VERSION, or (when `expect_host` is given — the strict
        ambient-discovery path) a host-fingerprint mismatch."""
        try:
            with open(path) as f:
                obj = json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as e:
            warnings.warn(f"cost table {path!r} is unreadable ({e!r}); "
                          "planner falls back to the heuristic",
                          stacklevel=2)
            return None
        if int(obj.get("version", -1)) != TABLE_VERSION:
            warnings.warn(
                f"cost table {path!r} has version {obj.get('version')!r} "
                f"(this build speaks {TABLE_VERSION}); ignoring it — "
                "re-run the autotune sweep", stacklevel=2)
            return None
        if expect_host is not None and not hosts_match(obj.get("host"),
                                                       expect_host):
            return None     # silently: another host's cache entry, not ours
        return cls.from_json(obj)


# memoized loads: (abspath, mtime_ns, strict?) -> CostTable | None
_LOAD_MEMO: Dict[Tuple, Optional[CostTable]] = {}


def _load_cached(path: str,
                 expect_host: Optional[dict]) -> Optional[CostTable]:
    apath = os.path.abspath(path)
    try:
        mtime = os.stat(apath).st_mtime_ns
    except OSError:
        if expect_host is None:     # an explicitly-named file should exist
            warnings.warn(f"cost table {path!r} not found; planner falls "
                          "back to the heuristic", stacklevel=3)
        return None
    memo_key = (apath, mtime, expect_host is None)
    if memo_key not in _LOAD_MEMO:
        _LOAD_MEMO[memo_key] = CostTable.load(apath, expect_host=expect_host)
    return _LOAD_MEMO[memo_key]


def resolve_table(cost_table=None) -> Optional[CostTable]:
    """The one cost-table discovery entry point (see module docstring):
    False disables, a CostTable passes through, a path loads TRUSTED, and
    None discovers the ambient default (env pin, else the strict per-host
    cache file)."""
    if cost_table is False:
        return None
    if isinstance(cost_table, CostTable):
        return cost_table
    if isinstance(cost_table, (str, os.PathLike)):
        return _load_cached(os.fspath(cost_table), expect_host=None)
    if cost_table is not None:
        raise TypeError(
            "cost_table must be False (disable), None (ambient discovery), "
            f"a path or a CostTable — got {type(cost_table).__name__}")
    env = os.environ.get("REPRO_GA_COST_TABLE")
    if env is not None:
        if env.strip().lower() in _DISABLE_VALUES:
            return None
        return _load_cached(env, expect_host=None)
    path = default_table_path()
    if not os.path.exists(path):
        return None
    return _load_cached(path, expect_host=host_fingerprint())
