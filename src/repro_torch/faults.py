"""Deterministic, seed-addressable fault injection for the serving stack.

A fault-tolerant scheduler is only as trustworthy as the failures it has
actually been exercised against.  This module is the repo's failure
*source*: a registry of named injection points threaded through the hot
paths of the serving stack, armed by a compact rule grammar and completely
inert (a dict lookup returning None) when disarmed.

Injection sites (`SITES`):

  * ``chunk_crash``  — raised between a chunk's compute and its checkpoint
    in `Engine.run_chunked` / `PackedEngine.run_chunked` (a worker dying
    mid-run; the chunk's work is lost but the previous checkpoint is not);
  * ``compile_fail`` — raised in a scheduler worker before the packed
    engine is built (a build blow-up, e.g. a transient OOM);
  * ``ckpt_corrupt`` — not an exception: `repro_torch.ckpt.checkpoint.save`
    flips bytes in the just-written shard AFTER its checksum was recorded
    (bit-rot / torn write; the manifest checksum then catches it on read);
  * ``slow_chunk``   — sleeps `delay` seconds before a chunk's compute
    (a straggler; drives deadline enforcement without wall-clock flake).

Rule grammar — rules separated by ``;``, fields by ``:``::

    site[@match][:at=N[,M...]][:after=K][:times=T][:p=P][:seed=S][:delay=D]

  * ``match``   substring that must appear in the site invocation's tag
    (the engine tags chunk sites with the scheduler's job ids, checkpoint
    saves with job ids + path, so ``chunk_crash@ga-3-F3`` targets one job);
  * ``at``      fire exactly on these 1-based matching occurrences;
  * ``after``/``times``  fire on occurrences ``after+1 .. after+times``
    (defaults: after=0, times=1; ``times=inf`` never stops firing);
  * ``p``/``seed``  fire when the deterministic hash of
    ``(seed, site, occurrence)`` lands under probability ``p`` — the
    seed-addressable mode: same seed, same decision sequence, every run;
  * ``delay``   seconds ``slow_chunk`` sleeps (default 0.05).

Arming: pass a rule string / `FaultInjector` through
``ga.EngineOptions(faults=...)`` (shared by `Engine`, `PackedEngine`
and `repack_checkpoint`), or set the ambient
``REPRO_GA_FAULTS`` environment variable.  `resolve_faults(None)` reads
the env (memoized per rule string so occurrence counters persist across
call sites); ``False`` disarms even against the env.

Everything here is deterministic — occurrence counters plus a seeded
hash, never `random` — so a chaos run that found a bug replays the exact
same fault sequence.

The port's own copy of the JAX package's `repro.faults`, with the same
rule grammar, sites, counters, environment variable and error taxonomy,
so one rule string arms both packages alike.  Import-light on purpose
(stdlib only): the scheduler and checkpoint code consult it on every
chunk/save.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import zlib
from typing import Dict, Optional, Tuple

SITES = ("chunk_crash", "compile_fail", "ckpt_corrupt", "slow_chunk")


class FaultError(RuntimeError):
    """Base class of every injected failure.  `site` names the injection
    point, `transient` steers the scheduler's retry classification."""

    site = "?"
    transient = True

    def __init__(self, msg: str, tag: str = ""):
        super().__init__(msg)
        self.tag = tag


class ChunkCrash(FaultError):
    """Injected mid-run crash between a chunk's compute and its checkpoint."""

    site = "chunk_crash"
    transient = True


class CompileFail(FaultError):
    """Injected engine-build failure (trace/compile blow-up)."""

    site = "compile_fail"
    transient = True


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One armed rule: which site fires, on which occurrences, for tags
    containing `match`.  Decision order: `at` if set, else `p` (seeded
    hash), else the `after`/`times` window."""

    site: str
    match: str = ""
    at: Tuple[int, ...] = ()
    after: int = 0
    times: float = 1.0           # float so "inf" parses
    p: Optional[float] = None
    seed: int = 0
    delay_s: float = 0.05

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"known sites: {SITES}")
        if self.p is not None and not (0.0 <= self.p <= 1.0):
            raise ValueError(f"p must be in [0, 1], got {self.p!r}")

    def decides(self, n: int) -> bool:
        """Does this rule fire on its n-th (1-based) matching occurrence?"""
        if self.at:
            return n in self.at
        if self.p is not None:
            return _hash01(self.seed, self.site, n) < self.p
        return self.after < n <= self.after + self.times


def _hash01(seed: int, site: str, n: int) -> float:
    """Deterministic hash of (seed, site, occurrence) onto [0, 1)."""
    return (zlib.crc32(f"{seed}:{site}:{n}".encode()) % 1_000_000) / 1_000_000


def parse_rule(text: str) -> FaultRule:
    """Parse one ``site[@match][:key=value...]`` rule."""
    fields = text.strip().split(":")
    head = fields[0]
    site, _, match = head.partition("@")
    kw: Dict[str, object] = {"site": site.strip(), "match": match.strip()}
    for field in fields[1:]:
        if not field:
            continue
        key, _, val = field.partition("=")
        key = key.strip()
        if key == "at":
            kw["at"] = tuple(int(v) for v in val.split(",") if v)
        elif key == "after":
            kw["after"] = int(val)
        elif key == "times":
            kw["times"] = float("inf") if val == "inf" else float(val)
        elif key == "p":
            kw["p"] = float(val)
        elif key == "seed":
            kw["seed"] = int(val)
        elif key == "delay":
            kw["delay_s"] = float(val)
        else:
            raise ValueError(f"unknown fault rule field {key!r} in {text!r}")
    return FaultRule(**kw)


def parse_faults(text: str) -> "FaultInjector":
    """Parse a ``;``-separated rule list into an armed injector."""
    rules = [parse_rule(r) for r in text.split(";") if r.strip()]
    return FaultInjector(rules)


class FaultInjector:
    """Thread-safe registry of armed `FaultRule`s with per-rule occurrence
    counters.  `inject(site, tag)` is the one call threaded through the
    serving stack: it counts the occurrence against every matching rule
    and, if one fires, performs the site's action (raise / sleep / signal
    the caller to corrupt).  Share ONE instance across the components of a
    run — the occurrence counters are the determinism contract."""

    def __init__(self, rules=()):
        self._lock = threading.Lock()
        self._rules = [r if isinstance(r, FaultRule) else parse_rule(r)
                       for r in rules]
        self._counts: Dict[int, int] = {}
        self.fired: Dict[str, int] = {}

    def add_rule(self, rule) -> FaultRule:
        """Arm one more rule (a `FaultRule` or rule string) — lets a chaos
        harness target job ids it only learns after submission."""
        rule = rule if isinstance(rule, FaultRule) else parse_rule(rule)
        with self._lock:
            self._rules.append(rule)
        return rule

    def fires(self, site: str, tag: str = "") -> Optional[FaultRule]:
        """Count this occurrence; return the first rule that fires (and
        bump the site's `fired` counter), or None."""
        hit = None
        with self._lock:
            for i, rule in enumerate(self._rules):
                if rule.site != site:
                    continue
                if rule.match and rule.match not in tag:
                    continue
                n = self._counts[i] = self._counts.get(i, 0) + 1
                if hit is None and rule.decides(n):
                    hit = rule
            if hit is not None:
                self.fired[site] = self.fired.get(site, 0) + 1
        return hit

    def inject(self, site: str, tag: str = "") -> Optional[FaultRule]:
        """The injection point: no-op unless a matching rule fires, then
        perform the site's action.  ``chunk_crash``/``compile_fail`` raise,
        ``slow_chunk`` sleeps, ``ckpt_corrupt`` returns the rule so the
        checkpoint writer corrupts the shard itself."""
        rule = self.fires(site, tag)
        if rule is None:
            return None
        if site == "chunk_crash":
            raise ChunkCrash(f"injected chunk crash (tag={tag!r})", tag)
        if site == "compile_fail":
            raise CompileFail(f"injected compile failure (tag={tag!r})", tag)
        if site == "slow_chunk":
            time.sleep(rule.delay_s)
        return rule

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.fired)

    def __repr__(self):
        return f"FaultInjector({len(self._rules)} rule(s), fired={self.fired})"


# ---------------------------------------------------------------------------
# Arming resolution (EngineOptions.faults / REPRO_GA_FAULTS)
# ---------------------------------------------------------------------------

ENV_VAR = "REPRO_GA_FAULTS"
_AMBIENT: Dict[str, FaultInjector] = {}
_AMBIENT_LOCK = threading.Lock()


def ambient() -> Optional[FaultInjector]:
    """The env-armed injector, memoized per rule string so occurrence
    counters persist across every call site in the process."""
    text = os.environ.get(ENV_VAR)
    if not text:
        return None
    with _AMBIENT_LOCK:
        inj = _AMBIENT.get(text)
        if inj is None:
            inj = _AMBIENT[text] = parse_faults(text)
        return inj


def resolve_faults(spec) -> Optional[FaultInjector]:
    """`EngineOptions.faults` semantics: None discovers the ambient env
    injector, False disarms, a rule string parses (resolve ONCE and share
    the instance — counters live on it), an injector passes through."""
    if spec is False:
        return None
    if spec is None:
        return ambient()
    if isinstance(spec, FaultInjector):
        return spec
    if isinstance(spec, str):
        return parse_faults(spec)
    raise TypeError(f"faults must be None, False, a rule string or a "
                    f"FaultInjector, got {type(spec).__name__}")


# ---------------------------------------------------------------------------
# Helpers for fault consumers
# ---------------------------------------------------------------------------


def corrupt_file(path: str, seed: int = 0, nbytes: int = 8) -> None:
    """Deterministically flip `nbytes` bytes of `path` in place (XOR 0xFF
    at seeded positions) — the ckpt_corrupt action, also usable directly
    by tests simulating bit-rot."""
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size == 0:
            return
        for i in range(nbytes):
            pos = zlib.crc32(f"{seed}:{i}".encode()) % size
            f.seek(pos)
            byte = f.read(1)
            f.seek(pos)
            f.write(bytes([byte[0] ^ 0xFF]))


# Exceptions that indicate the WORK is wrong, not the world: retrying them
# burns the budget on a deterministic failure.  Everything else — injected
# transients, I/O errors, runtime and CUDA errors (torch.cuda's
# OutOfMemoryError and CUDA failures are RuntimeError subclasses) — is
# worth a bounded retry.
PERMANENT_TYPES = (ValueError, TypeError, KeyError, IndexError,
                   AttributeError, AssertionError, NotImplementedError,
                   ZeroDivisionError)


def classify_error(exc: BaseException) -> str:
    """"transient" (bounded retry is worth it) or "permanent" (fail now)."""
    if isinstance(exc, FaultError):
        return "transient" if exc.transient else "permanent"
    if isinstance(exc, PERMANENT_TYPES):
        return "permanent"
    return "transient"
