"""repro_torch.autotune — measured cost tables for the GA epoch planner.

Three layers, as in the JAX package's `repro.autotune`:

  * `table`     — versioned per-host CostTable store + `resolve_table`
                  discovery (what `ga/backends.py` consults);
  * `stability` — repeat-until-stable replay timing with an injectable
                  clock;
  * `runner`    — the sweep: force each feasible epoch mode with
                  `plan_override`, replay to stability, persist.

The table/stability layers are import-light (torch only inside
`host_fingerprint`) and re-exported here; the runner pulls in the engine
stack, so its entry points are wrapped lazily — `ga/backends.py` imports
this package and must not recurse back into itself.
"""

from repro_torch.autotune.stability import Replay, replay_until_stable
from repro_torch.autotune.table import (CostTable, POINT_FIELDS,
                                        TABLE_VERSION, default_table_path,
                                        host_fingerprint, resolve_table)

__all__ = [
    "CostTable", "POINT_FIELDS", "TABLE_VERSION", "Replay",
    "default_table_path", "estimate_gens_per_s", "host_fingerprint",
    "measure_candidate", "plan_candidates", "replay_until_stable",
    "resolve_table", "sweep",
]


def sweep(*args, **kwargs):
    from repro_torch.autotune import runner
    return runner.sweep(*args, **kwargs)


def plan_candidates(*args, **kwargs):
    from repro_torch.autotune import runner
    return runner.plan_candidates(*args, **kwargs)


def measure_candidate(*args, **kwargs):
    from repro_torch.autotune import runner
    return runner.measure_candidate(*args, **kwargs)


def estimate_gens_per_s(*args, **kwargs):
    from repro_torch.autotune import runner
    return runner.estimate_gens_per_s(*args, **kwargs)
