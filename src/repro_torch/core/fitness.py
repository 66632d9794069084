"""Fitness Function Module (FFM) — paper Sec. 3.1, generalized to V variables.

The paper computes  y = γ(α(px) + β(qx))  with three ROMs per individual.  A
registered :class:`ProblemDef` (or a user blackbox) is *compiled* into a
:class:`FitnessProgram`, one object that lowers the same problem to every
evaluation mode the engine's executors consume:

  * ``lut``   — faithful: per-variable int32 fixed-point ROMs stacked into
    one [V, 2^c] table, one δ add tree and an optional γ ROM.  Available for
    separable problems ``f(x) = γ(Σ_i φ(x_i))``.
  * ``arith`` — the problem's torch expression evaluated in float32.  The
    fused CUDA kernel (`repro_torch.kernels.ga_step`) carries one device
    function per built-in problem that repeats this arithmetic operation for
    operation, so the two agree bit for bit on the card.

Every expression keeps the JAX reference's order of operations: ``x ** 3``
is ``x * (x * x)`` (what ``lax.integer_pow`` evaluates), ``x ** 2`` is
``x * x``, and sums over V run left to right, as XLA's reduce does.  The
decode ``lo + u * span`` is two separate roundings (no FMA).

All modes share the domain mapping: a c-bit unsigned gene u decodes to
v = lo + u * (hi - lo) / (2^c - 1), per variable.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Problem registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ProblemDef:
    """A registered n-variable optimisation problem.

    ``fn`` is the batch evaluator ``(..., V) f32 -> (...,) f32`` in torch.
    The optional separable form ``f(x) = gamma(Σ_i term(v, i))`` (``term`` in
    numpy, evaluated at ROM-synthesis time) enables the LUT lowering; leave
    it None for non-separable problems (rosenbrock, ackley, blackboxes),
    which then run mode='arith' only.
    """

    name: str
    fn: Callable[[torch.Tensor], torch.Tensor]
    domain: Tuple[float, float]          # per-variable decode box
    fixed_vars: Optional[int] = None     # paper problems pin V
    default_vars: int = 2
    min_vars: int = 1
    minimize: bool = True
    term: Optional[Callable[[np.ndarray, int], np.ndarray]] = None
    gamma: Optional[Callable[[np.ndarray], np.ndarray]] = None  # None = id

    @property
    def separable(self) -> bool:
        """Whether the LUT (stacked per-variable ROM) lowering exists."""
        return self.term is not None

    def f(self, vals) -> torch.Tensor:
        """Convenience single/batch evaluation over a trailing V axis."""
        return self.fn(torch.as_tensor(vals, dtype=torch.float32))


PROBLEMS: Dict[str, ProblemDef] = {}


def register_problem(pdef: ProblemDef) -> ProblemDef:
    """Add a problem to the registry."""
    PROBLEMS[pdef.name] = pdef
    return pdef


def resolve_problem(problem: str) -> Tuple[ProblemDef, Optional[int]]:
    """Look up ``"name"`` or ``"name:V"`` -> (ProblemDef, requested V or
    None).  The ``:V`` suffix is the CLI/spec shorthand for n_vars."""
    name, sep, vs = problem.partition(":")
    n_vars = None
    if sep:
        try:
            n_vars = int(vs)
        except ValueError:
            raise ValueError(f"bad problem spec {problem!r}: the :V suffix "
                             "must be an integer, e.g. 'rastrigin:8'")
    if name not in PROBLEMS:
        raise ValueError(f"unknown problem {name!r}; "
                         f"choose from {sorted(PROBLEMS)}")
    return PROBLEMS[name], n_vars


def resolve_vars(pdef: ProblemDef, n_vars: Optional[int]) -> int:
    """Validate a requested variable count against a problem's shape rules
    (fixed paper layout, minimum V) and return the effective V."""
    if pdef.fixed_vars is not None:
        if n_vars is not None and n_vars != pdef.fixed_vars:
            raise ValueError(f"problem {pdef.name!r} is defined at "
                             f"V={pdef.fixed_vars} (paper layout); "
                             f"got n_vars={n_vars}")
        return pdef.fixed_vars
    v = n_vars if n_vars is not None else pdef.default_vars
    if v < pdef.min_vars:
        raise ValueError(f"problem {pdef.name!r} needs at least "
                         f"{pdef.min_vars} variables; got n_vars={v}")
    return v


def check_mode(pdef: ProblemDef, mode: str) -> None:
    """Reject FFM modes the problem cannot lower to."""
    if mode not in ("lut", "arith"):
        raise ValueError(f"mode must be 'lut' or 'arith', got {mode!r}")
    if mode == "lut" and not pdef.separable:
        raise ValueError(f"problem {pdef.name!r} has no separable form for "
                         "the LUT ROMs (mode='lut'); run mode='arith'")


def vsum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the trailing V axis, left to right (XLA's reduce order; a
    library sum may pair the terms differently)."""
    acc = t[..., 0]
    for i in range(1, t.shape[-1]):
        acc = acc + t[..., i]
    return acc


def vmean(t: torch.Tensor) -> torch.Tensor:
    """`vsum` divided by V.  The divisor is a tensor: a CUDA division by a
    Python scalar multiplies by its rounded reciprocal instead."""
    s = vsum(t)
    return s / torch.full_like(s, float(t.shape[-1]))


def _cube(x):
    return x * (x * x)


def _f1(v):
    x = v[..., 1]
    return _cube(x) - 15.0 * (x * x) + 500.0


def _f2(v):
    return 8.0 * v[..., 0] + (-4.0 * v[..., 1] + 1020.0)


def _f3(v):
    return torch.sqrt(torch.clamp_min(
        v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1], 0.0))


def _sphere(v):
    return vsum(v * v)


def _rastrigin(v):
    return vsum(v * v - 10.0 * torch.cos(2.0 * np.pi * v) + 10.0)


def _rosenbrock(v):
    d = v[..., 1:] - v[..., :-1] * v[..., :-1]
    e = 1.0 - v[..., :-1]
    return vsum(100.0 * (d * d) + e * e)


def _ackley(v):
    return (-20.0 * torch.exp(-0.2 * torch.sqrt(vmean(v * v)))
            - torch.exp(vmean(torch.cos(2.0 * np.pi * v)))
            + 20.0 + np.e)


# --- The paper's three validation functions (Sec. 4), fixed at V=2 ---------

# F1: f(x) = x^3 - 15 x^2 + 500   (one variable; paper Eq. 24, range ±2^12).
# The paper still lays it out as px ‖ qx with α(px) = 0, so V stays 2.
F1 = register_problem(ProblemDef(
    name="F1", fn=_f1, domain=(-4096.0, 4095.0), fixed_vars=2,
    term=lambda v, i: (np.zeros_like(v) if i == 0
                       else v ** 3 - 15.0 * v ** 2 + 500.0),
))

# F2: f(x, y) = 8x - 4y + 1020   (paper Eq. 25)
F2 = register_problem(ProblemDef(
    name="F2", fn=_f2, domain=(-128.0, 127.0), fixed_vars=2,
    term=lambda v, i: 8.0 * v if i == 0 else -4.0 * v + 1020.0,
))

# F3: f(x, y) = sqrt(x^2 + y^2)   (paper Eq. 26)
F3 = register_problem(ProblemDef(
    name="F3", fn=_f3, domain=(-128.0, 127.0), fixed_vars=2,
    term=lambda v, i: v.astype(np.float64) ** 2,
    gamma=lambda d: np.sqrt(np.maximum(d, 0.0)),
))


# --- The standard n-variable GA benchmark suite (configurable V) -----------

register_problem(ProblemDef(
    name="sphere", fn=_sphere, domain=(-5.12, 5.12),
    term=lambda v, i: v.astype(np.float64) ** 2,
))

# 10V + Σ x² - 10 cos(2πx), folded as Σ (x² - 10 cos(2πx) + 10)
register_problem(ProblemDef(
    name="rastrigin", fn=_rastrigin, domain=(-5.12, 5.12),
    term=lambda v, i: (v.astype(np.float64) ** 2
                       - 10.0 * np.cos(2.0 * np.pi * v) + 10.0),
))

# coupled terms -> not separable -> arith/kernel modes only
register_problem(ProblemDef(
    name="rosenbrock", fn=_rosenbrock, domain=(-2.048, 2.048), min_vars=2,
))

# two coupled reductions -> not γ(Σφ)-separable -> arith/kernel only
register_problem(ProblemDef(
    name="ackley", fn=_ackley, domain=(-32.768, 32.768),
))

# the built-in definitions, by name: the fused kernel implements exactly these
BUILTIN: Dict[str, ProblemDef] = dict(PROBLEMS)


def decode(u: torch.Tensor, c: int, domain: tuple) -> torch.Tensor:
    """Decode a c-bit unsigned gene to its real value (single shared box)."""
    lo, hi = domain
    scale = np.float32((hi - lo) / float((1 << c) - 1))
    return lo + u.to(torch.float32) * float(scale)


# ---------------------------------------------------------------------------
# LUT (faithful) mode — per-variable ROMs stacked into one table
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LutTables:
    """Fixed-point ROM contents for one separable problem at width c.

    var_t: int32[V, 2^c] — per-variable term ROMs scaled by 2^frac_bits.
    gamma_t: int32[2^g] or None (None == identity γ).
    delta_min / delta_shift: the γ ROM is addressed by
             clip((δ - delta_min) >> delta_shift, 0, 2^g - 1).
    """

    c: int
    frac_bits: int
    var_t: np.ndarray
    gamma_t: Optional[np.ndarray]
    delta_min: int
    delta_shift: int
    g: int


def build_tables(pdef: ProblemDef, c: int, n_vars: int,
                 frac_bits: Optional[int] = None, g: int = 14) -> LutTables:
    """Quantize the per-variable terms + γ into ROM tables (FFM synthesis).

    frac_bits may be negative (coarser-than-integer fixed point) — exactly
    what a hardware synthesis would do when the fitness range exceeds the
    ROM word width.  If None, the largest value keeping |Σ terms| within
    int31 is chosen automatically (capped at 8 fractional bits).
    """
    if not pdef.separable:
        raise ValueError(f"problem {pdef.name!r} has no separable form — "
                         "the LUT ROMs cannot be synthesized; run "
                         "mode='arith'")
    u = np.arange(1 << c, dtype=np.float64)
    lo, hi = pdef.domain
    v = lo + u * (hi - lo) / float((1 << c) - 1)
    terms = [np.asarray(pdef.term(v, i), np.float64) for i in range(n_vars)]

    if frac_bits is None:
        peak = sum(np.abs(t).max() for t in terms)
        frac_bits = 8
        while frac_bits > -24 and peak * (2.0 ** frac_bits) >= 2 ** 30:
            frac_bits -= 1

    scale = float(2.0 ** frac_bits)
    fixed = [np.round(t * scale).astype(np.int64) for t in terms]

    # int32 saturation (the ROM word width)
    i32 = lambda t: np.clip(t, -(2 ** 31), 2 ** 31 - 1).astype(np.int32)
    var_t = np.stack([i32(t) for t in fixed])

    if pdef.gamma is None:
        return LutTables(c, frac_bits, var_t, None, 0, 0, 0)

    dmin = int(sum(t.min() for t in fixed))
    dmax = int(sum(t.max() for t in fixed))
    span = max(dmax - dmin, 1)
    shift = max(0, int(np.ceil(np.log2(span / ((1 << g) - 1) + 1e-12))) if span >= (1 << g) else 0)
    # γ table: value at address k represents δ = dmin + (k << shift)
    k = np.arange(1 << g, dtype=np.int64)
    delta = (dmin + (k << shift)).astype(np.float64) / scale
    gamma_t = i32(np.round(pdef.gamma(delta) * scale))
    return LutTables(c, frac_bits, var_t, gamma_t, dmin, shift, g)


def lut_fitness(x: torch.Tensor, t: LutTables) -> torch.Tensor:
    """Faithful FFM: V ROM reads, a δ add tree, one more ROM read.

    x: int32 (..., V) chromosome matrix; int32 fitness out."""
    idx = (x & ((1 << t.c) - 1)).to(torch.int64)
    tabs = torch.from_numpy(t.var_t).to(x.device)
    d = tabs[0][idx[..., 0]]
    for i in range(1, t.var_t.shape[0]):
        d = d + tabs[i][idx[..., i]]
    if t.gamma_t is None:
        return d
    addr = torch.clamp((d - t.delta_min) >> t.delta_shift, 0, (1 << t.g) - 1)
    return torch.from_numpy(t.gamma_t).to(x.device)[addr.to(torch.int64)]


# ---------------------------------------------------------------------------
# FitnessProgram — one problem compiled for every executor
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FitnessProgram:
    """A problem (or blackbox) lowered to the engine's evaluation modes.

    ``stage`` is THE arith lowering: bits -> fitness, evaluated by the
    reference executor and by the fused kernel's plain version; the CUDA
    kernel repeats it for the built-in problems.  ``lut_stage`` is the
    faithful ROM pipeline (separable problems only).  ``fitness(mode)``
    dispatches for the executors.
    """

    name: str
    n_vars: int
    bits_per_var: int
    domains: Tuple[Tuple[float, float], ...]   # per-variable (lo, hi)
    minimize: bool
    fn: Callable[[torch.Tensor], torch.Tensor]
    supports_lut: bool
    tables: Optional[LutTables] = None   # synthesized only for mode='lut'

    @property
    def modes(self) -> Tuple[str, ...]:
        return ("lut", "arith") if self.supports_lut else ("arith",)

    def scale(self, mode: str) -> float:
        """Raw-fitness units per real unit (lut mode is fixed-point)."""
        if mode == "lut":
            return 2.0 ** self._tables().frac_bits
        return 1.0

    def _tables(self) -> LutTables:
        if self.tables is None:
            raise ValueError(
                f"program for {self.name!r} was not compiled with "
                "mode='lut'" if self.supports_lut else
                f"problem {self.name!r} has no LUT lowering (not "
                "separable); run mode='arith'")
        return self.tables

    # ---- lowerings ------------------------------------------------------

    def decode_consts(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-variable float32 (lo, span) of the decode — the arrays the
        fused kernel takes as arguments."""
        c = self.bits_per_var
        lo = np.asarray([d[0] for d in self.domains], np.float32)
        span = np.asarray([(d[1] - d[0]) / ((1 << c) - 1)
                           for d in self.domains], np.float32)
        return lo, span

    def device_consts(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """`decode_consts` as tensors on `device`, made once per device."""
        cache = self.__dict__.setdefault("_consts", {})
        key = str(device)
        if key not in cache:
            cache[key] = tuple(torch.from_numpy(a).to(device)
                               for a in self.decode_consts())
        return cache[key]

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        """int32 bits (..., V) -> f32 values (..., V), per-variable box."""
        lo, span = self.device_consts(x.device)
        u = (x & ((1 << self.bits_per_var) - 1)).to(torch.float32)
        return lo + u * span

    def stage(self, x: torch.Tensor) -> torch.Tensor:
        """The arith FFM stage: int32 bits (..., V) -> f32 (...,)."""
        return self.fn(self.decode(x)).to(torch.float32)

    def lut_stage(self, x: torch.Tensor) -> torch.Tensor:
        """The faithful ROM pipeline: int32 bits (..., V) -> int32 (...,)."""
        return lut_fitness(x, self._tables())

    def fitness(self, mode: str) -> Callable[[torch.Tensor], torch.Tensor]:
        """The executor-facing fitness function for one FFM mode."""
        if mode == "lut":
            self._tables()          # fail loudly before running
            return self.lut_stage
        if mode != "arith":
            raise ValueError(f"mode must be 'lut' or 'arith', got {mode!r}")
        return self.stage


def compile_program(problem: Optional[str] = None,
                    fitness: Optional[Callable] = None,
                    bounds=None, *,
                    n_vars: Optional[int] = None,
                    bits_per_var: int,
                    mode: str = "arith",
                    minimize: bool = True) -> FitnessProgram:
    """Lower a registered problem name (``"F3"``, ``"rastrigin:8"``) or a
    blackbox ``(N, V) -> (N,)`` + bounds into a :class:`FitnessProgram`.

    LUT ROMs are synthesized only when mode='lut'; ``supports_lut`` still
    reports availability either way.
    """
    if (problem is None) == (fitness is None):
        raise ValueError("pass exactly one of problem= or fitness=")
    if mode not in ("lut", "arith"):
        raise ValueError(f"mode must be 'lut' or 'arith', got {mode!r}")

    if problem is not None:
        pdef, v_suffix = resolve_problem(problem)
        if v_suffix is not None and n_vars is not None and v_suffix != n_vars:
            raise ValueError(f"problem {problem!r} pins V={v_suffix} but "
                             f"n_vars={n_vars} was also given")
        v = resolve_vars(pdef, v_suffix if v_suffix is not None else n_vars)
        check_mode(pdef, mode)
        tables = (build_tables(pdef, bits_per_var, v)
                  if mode == "lut" else None)
        return FitnessProgram(name=pdef.name, n_vars=v,
                              bits_per_var=bits_per_var,
                              domains=(pdef.domain,) * v,
                              minimize=minimize, fn=pdef.fn,
                              supports_lut=pdef.separable, tables=tables)

    if bounds is None:
        raise ValueError("blackbox fitness requires bounds=")
    domains = tuple((float(lo), float(hi)) for lo, hi in bounds)
    if n_vars is not None and n_vars != len(domains):
        raise ValueError(f"n_vars={n_vars} does not match "
                         f"len(bounds)={len(domains)}")
    if mode == "lut":
        raise ValueError("blackbox fitness has no LUT lowering; "
                         "run mode='arith'")
    return FitnessProgram(name="blackbox", n_vars=len(domains),
                          bits_per_var=bits_per_var, domains=domains,
                          minimize=minimize, fn=fitness, supports_lut=False)
