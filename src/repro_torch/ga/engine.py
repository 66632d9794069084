"""The Engine: one entry point for every GA execution strategy.

    from repro_torch import ga

    spec = ga.GASpec(problem="F3", n=64, bits_per_var=10, generations=100)
    result = ga.solve(spec)                      # auto-picks a backend
    result = ga.solve(spec, backend="fused")     # or pin one explicitly
    result = ga.solve(spec, options=ga.EngineOptions(device="cpu"))

Runs live on the card (``EngineOptions(device="cuda")``, the default)
unless the options ask for the CPU; without a card an engine refuses to
build instead of carrying on on the CPU.  Backend selection
(`backend="auto"`) walks the capability matrix: fused on CUDA when the
kernel's constraints hold, reference otherwise.  Pinning a backend that
cannot run the spec warns and falls back to the next capable one — a
decision about what the spec needs, never about the device or a kernel.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.ga import telemetry as RT
from repro_torch.ga.backends import BACKENDS, Backend, Segment
from repro_torch.ga.options import EngineOptions, resolve_options
from repro_torch.ga.spec import GASpec


class BackendUnsupported(ValueError):
    """Raised when no backend can run a spec."""


def capability_matrix(spec: GASpec) -> Dict[str, Optional[str]]:
    """Backend name -> None (supported) or the reason it cannot run."""
    return {name: cls.supports(spec) for name, cls in BACKENDS.items()}


def _auto_order(spec: GASpec, device: torch.device):
    order = []
    if device.type == "cuda":
        order.append("fused")   # the hand-written kernel
    order.append("reference")
    return order


def resolve_backend(spec: GASpec, backend: str = "auto",
                    device="cuda") -> str:
    """Pick the backend name for a spec, with graceful fallback."""
    device = torch.device(device)
    caps = capability_matrix(spec)
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


class Engine:
    """A spec bound to a backend on the options' device."""

    def __init__(self, spec: GASpec, backend: str = "auto", *,
                 options: Optional[EngineOptions] = None):
        self.spec = spec
        self.options = resolve_options(options)
        self.device = self.options.torch_device()
        self.backend_name = resolve_backend(spec, backend, self.device)
        self.backend: Backend = BACKENDS[self.backend_name](
            spec, options=self.options)

    def init_state(self):
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
        t0 = time.perf_counter()
        if state is None:
            state = self.init_state()
        seg = self.backend.segment(state, gens)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self._result(seg, time.perf_counter() - t0)


def solve(spec: GASpec, backend: str = "auto", *,
          generations: Optional[int] = None,
          options: Optional[EngineOptions] = None) -> EngineResult:
    """Run a GASpec end to end and return the uniform result."""
    return Engine(spec, backend, options=options).run(generations)
