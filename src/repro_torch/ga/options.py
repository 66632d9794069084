"""`EngineOptions` — one frozen options object for every engine entry point.

    opts = ga.EngineOptions(device="cpu", plan_override="gridded")
    ga.solve(spec, backend="fused-islands", options=opts)

Knobs:
  * device — the torch device the run lives on.  Unset (None) it is
    ``"cuda"``: the port runs on the card unless the caller asks for the
    CPU.  When CUDA is unavailable and the CPU was not asked for, building
    an engine raises instead of carrying on on the CPU.
  * mesh — a `repro_torch.launch.mesh.Mesh` the island axis shards over
    (None = one device).  The run's device is then the mesh's first
    device, where its state lives between segments: `device` must be
    unset or that device.
  * cost_table — the measured tier of the island-ring epoch planner
    (`repro_torch.autotune.resolve_table`): None discovers the ambient
    per-host table, False disables measured planning (the pure
    heuristic), a path or a `CostTable` pins one.
  * plan_override — force an island-ring epoch mode ("gridded",
    "resident", "resident-sharded", "resident-free", "streamed"; a dict
    with a "mode" key is read the same way); a mode the spec cannot run
    (resident-sharded without a mesh, resident with one) raises with the
    candidates it can.
  * smem_budget — a shared-memory budget in bytes for PLANNING only (the
    JAX package's `vmem_budget`): a resident or resident-free epoch whose
    blocks take more (`kernels.ga_step.resident_smem_bytes`) is refused,
    and the streamed mode is offered where one K3 block fits it.  The
    kernels and their limits are unchanged, so it never changes a result;
    it lets smokes and sweeps reach the streamed mode at 8 islands or
    fewer.  None: the card's own limits alone.
  * stream_tile_islands — pin the streamed mode's island tile (islands one
    thread block walks in turn; must divide the island count, and on a
    card its blocks must co-reside as the planner's tile's do).  A launch
    shape only: every tile gives the same result.
  * sel_lane — override the spec's tournament gather lane ("onehot" |
    "gather" | "auto"); None keeps the spec's own setting.  The backend
    rebuilds the spec with the override, so it is validated (the onehot
    N cap) and keyed like a spec-level pin.
  * fitness_workers — eager backend only: size of the bounded thread pool
    that evaluates host-side fitness population-parallel (1 = the serial
    batch call; chunks come back in order, so any worker count is
    bit-identical).
  * faults — arm the `repro_torch.faults` injection sites of the chunked
    runs, their checkpoint writes and the scheduler's engine builds: None
    reads the ambient ``REPRO_GA_FAULTS`` rules, False disarms, a rule
    string or a `FaultInjector` arms those rules.

`add_cli_args` and `from_args` are the one flags-to-options parser of the
CLIs (``python -m repro_torch.launch.ga_serve``, ``ga_run``,
``ga_autotune``).

The launch options only choose launch shapes, never results: every plan
is bit-identical in state and best tracking.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

PLAN_MODES = ("gridded", "resident", "resident-sharded", "resident-free",
              "streamed")
SEL_LANES = ("onehot", "gather", "auto")


def plan_mode(plan_override: Any) -> Optional[str]:
    """The mode name a `plan_override` asks for (a string, or a dict with
    a "mode" key), None for no override."""
    if isinstance(plan_override, dict):
        return plan_override.get("mode")
    return plan_override


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    device: Optional[str] = None
    mesh: Any = None
    cost_table: Any = None
    plan_override: Any = None
    smem_budget: Optional[int] = None
    stream_tile_islands: Optional[int] = None
    sel_lane: Optional[str] = None
    fitness_workers: int = 1
    faults: Any = None

    def __post_init__(self):
        dev = torch.device(self.device or "cuda")
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"device must be a CUDA device or 'cpu', "
                             f"got {self.device!r}")
        if self.mesh is not None:
            first = self.mesh.first_device
            if self.device is not None and _index0(dev) != _index0(first):
                raise ValueError(
                    f"EngineOptions(device={self.device!r}) is not the "
                    f"mesh's first device {first}, where a sharded run "
                    "keeps its state: leave device unset")
        if (self.plan_override is not None
                and plan_mode(self.plan_override) not in PLAN_MODES):
            raise ValueError(
                f"plan_override must be one of {PLAN_MODES} (or a dict with "
                f"such a 'mode'), got {self.plan_override!r}")
        if self.sel_lane is not None and self.sel_lane not in SEL_LANES:
            raise ValueError(f"sel_lane must be one of {SEL_LANES}, "
                             f"got {self.sel_lane!r}")
        for field in ("smem_budget", "stream_tile_islands"):
            val = getattr(self, field)
            if val is not None and int(val) < 1:
                raise ValueError(f"{field} must be >= 1, got {val!r}")
        if int(self.fitness_workers) < 1:
            raise ValueError(f"fitness_workers must be >= 1, "
                             f"got {self.fitness_workers!r}")

    def torch_device(self) -> torch.device:
        """The run's device (the mesh's first device on a mesh); raises
        when it is CUDA and no card is there."""
        dev = (self.mesh.first_device if self.mesh is not None
               else torch.device(self.device or "cuda"))
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"EngineOptions(device={str(dev)!r}) needs a CUDA device "
                "and torch.cuda.is_available() is False; pass "
                "EngineOptions(device='cpu') to run on the CPU")
        return dev

    # ---- one flags->options parser shared by the CLIs -------------------

    @staticmethod
    def add_cli_args(ap) -> None:
        """Attach the shared engine-option flags to an ArgumentParser."""
        ap = ap.add_argument_group(
            "engine options",
            "--smem-budget is the JAX package's --vmem-budget for the "
            "card's shared memory: a planning budget only.")
        ap.add_argument("--device", default=None,
                        help="torch device the jobs run on: 'cuda' (the "
                             "default; raises without a card) or 'cpu'")
        ap.add_argument("--cost-table", default=None, metavar="PATH",
                        help="autotune cost table for measured epoch plans "
                             "(default: ambient per-host table; 'off' "
                             "disables measured planning)")
        ap.add_argument("--plan-override", default=None, choices=PLAN_MODES,
                        help="force an island-ring epoch mode instead of "
                             "the planner's choice (errors if infeasible)")
        ap.add_argument("--smem-budget", type=int, default=None,
                        metavar="BYTES",
                        help="override the planner's shared-memory "
                             "feasibility budget (exercises the streamed "
                             "mode at 8 islands or fewer)")
        ap.add_argument("--stream-tile-islands", type=int, default=None,
                        metavar="T",
                        help="pin the streamed mode's island tile size")
        ap.add_argument("--sel-lane", default=None, choices=SEL_LANES,
                        help="tournament gather lane: 'onehot' (N <= "
                             "1024), 'gather' (no cap) or 'auto' "
                             "(default: the spec's setting)")
        ap.add_argument("--fitness-workers", type=int, default=1,
                        metavar="W",
                        help="eager backend: thread-pool width for "
                             "host-side fitness dispatch (1 = serial batch "
                             "call)")
        ap.add_argument("--faults", default=None, metavar="RULES",
                        help="arm deterministic fault injection "
                             "(repro_torch.faults rule grammar, e.g. "
                             "'chunk_crash:at=2'; 'off' disarms even the "
                             "REPRO_GA_FAULTS env; default: env-armed)")

    @classmethod
    def from_args(cls, args, *, mesh=None) -> "EngineOptions":
        """Build options from parsed CLI args (+ an already-built mesh)."""
        ct = getattr(args, "cost_table", None)
        if isinstance(ct, str) and ct.lower() in ("off", "none", "0"):
            ct = False
        flt = getattr(args, "faults", None)
        if isinstance(flt, str) and flt.lower() in ("off", "none", "0"):
            flt = False
        return cls(device=getattr(args, "device", None), mesh=mesh,
                   cost_table=ct,
                   plan_override=getattr(args, "plan_override", None),
                   smem_budget=getattr(args, "smem_budget", None),
                   stream_tile_islands=getattr(args, "stream_tile_islands",
                                               None),
                   sel_lane=getattr(args, "sel_lane", None),
                   fitness_workers=getattr(args, "fitness_workers", 1),
                   faults=flt)


def _index0(dev: torch.device) -> torch.device:
    """`dev` with a CUDA device's missing index read as card 0."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", 0)
    return dev


def resolve_options(options: Optional[EngineOptions] = None, *,
                    mesh=None) -> EngineOptions:
    """The options an entry point runs with: the given ones, or defaults
    holding a constructor's `mesh=`.  With `options=`, a `mesh=` as well
    is rejected, as in the JAX package: one source of truth a knob."""
    if options is None:
        return EngineOptions(mesh=mesh)
    if not isinstance(options, EngineOptions):
        raise TypeError(f"options must be ga.EngineOptions, "
                        f"got {type(options).__name__}")
    if mesh is not None:
        raise ValueError(
            "got both options= and legacy kwarg(s) ['mesh']: move them "
            "into EngineOptions (dataclasses.replace(options, ...))")
    return options
