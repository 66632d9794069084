"""`EngineOptions` — one frozen options object for every engine entry point.

    opts = ga.EngineOptions(device="cpu")
    ga.solve(spec, backend="fused", options=opts)

Knobs:
  * device — the torch device the run lives on.  Defaults to ``"cuda"``:
    the port runs on the card unless the caller asks for the CPU.  When
    CUDA is unavailable and the CPU was not asked for, building an engine
    raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    device: str = "cuda"

    def __post_init__(self):
        dev = torch.device(self.device)
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"device must be a CUDA device or 'cpu', "
                             f"got {self.device!r}")

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
