"""`EngineOptions` — one frozen options object for every engine entry point.

    opts = ga.EngineOptions(device="cpu", plan_override="gridded")
    ga.solve(spec, backend="fused-islands", options=opts)

Knobs:
  * device — the torch device the run lives on.  Defaults to ``"cuda"``:
    the port runs on the card unless the caller asks for the CPU.  When
    CUDA is unavailable and the CPU was not asked for, building an engine
    raises instead of carrying on on the CPU.
  * plan_override — force an island-ring epoch mode ("gridded",
    "resident", "resident-free", "streamed"; a dict with a "mode" key is
    read the same way); a mode the spec cannot run raises with the
    candidates it can.
  * stream_tile_islands — pin the streamed mode's island tile (islands one
    thread block walks in turn; must divide the island count, and on a
    card its blocks must co-reside as the planner's tile's do).  A launch
    shape only: every tile gives the same result.
  * faults — arm the `repro_torch.faults` injection sites of the chunked
    runs and their checkpoint writes: None reads the ambient
    ``REPRO_GA_FAULTS`` rules, False disarms, a rule string or a
    `FaultInjector` arms those rules.

The launch options only choose launch shapes, never results: every plan
is bit-identical in state and best tracking.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

# the JAX package's modes less "resident-sharded", which needs a mesh
PLAN_MODES = ("gridded", "resident", "resident-free", "streamed")


def plan_mode(plan_override: Any) -> Optional[str]:
    """The mode name a `plan_override` asks for (a string, or a dict with
    a "mode" key), None for no override."""
    if isinstance(plan_override, dict):
        return plan_override.get("mode")
    return plan_override


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    device: str = "cuda"
    plan_override: Any = None
    stream_tile_islands: Optional[int] = None
    faults: Any = None

    def __post_init__(self):
        dev = torch.device(self.device)
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"device must be a CUDA device or 'cpu', "
                             f"got {self.device!r}")
        if (self.plan_override is not None
                and plan_mode(self.plan_override) not in PLAN_MODES):
            raise ValueError(
                f"plan_override must be one of {PLAN_MODES} (or a dict with "
                f"such a 'mode'), got {self.plan_override!r}")
        tile = self.stream_tile_islands
        if tile is not None and int(tile) < 1:
            raise ValueError(f"stream_tile_islands must be >= 1, got {tile!r}")

    def torch_device(self) -> torch.device:
        """The run's device; raises when it is CUDA and no card is there."""
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"EngineOptions(device={self.device!r}) needs a CUDA device "
                "and torch.cuda.is_available() is False; pass "
                "EngineOptions(device='cpu') to run on the CPU")
        return dev


def resolve_options(options: Optional[EngineOptions] = None
                    ) -> EngineOptions:
    """The options an entry point runs with: the given ones, or defaults."""
    if options is None:
        return EngineOptions()
    if not isinstance(options, EngineOptions):
        raise TypeError(f"options must be ga.EngineOptions, "
                        f"got {type(options).__name__}")
    return options
