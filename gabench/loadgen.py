"""The one traffic generator: a mix's data file and a configuration's file
turned into the work a run offers.

A mix is a JSON file under ``traffic/`` with a ``kind`` the generator
knows:

  * ``jobs``: a closed loop of one client, handing the next job to the
    system only when its last one came back.  Job j is the
    configuration's spec with its own seed, `job_seed(base, j, R)`, so no
    two jobs share a replica seed (replica r of a job is seeded
    seed + r).  ``sample`` jobs are kept for the check.
  * ``stream``: one long chunked run of ``run_generations`` generations in
    chunks of the configuration's ``chunk_generations``; the first chunk,
    which includes the initial state, belongs to set-up, and the window
    takes chunks until it ends.  ``sample`` window chunks are kept for the
    check besides the first.

Both kinds name ``trace_slice_s``, the seconds a traced run profiles, from
the first unit that starts past a third of the window.  Every seed gets
the same sizes; the seed changes values only.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

KINDS = ("jobs", "stream")
M32 = 0xFFFFFFFF


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, manifest: dict, workload: str):
    """(cell entry, configuration file, traffic file) of a workload named
    in the manifest; raises KeyError or FileNotFoundError for a name that
    does not resolve."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    cell = cells[workload]
    conf_entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = read_json(root / conf_entry["file"])
    traffic = read_json(root / "gabench" / "traffic" / f"{cell['traffic']}.json")
    if traffic.get("kind") not in KINDS:
        raise ValueError(f"traffic {cell['traffic']!r}: kind must be one of "
                         f"{KINDS}, got {traffic.get('kind')!r}")
    return cell, config, traffic


def seed_base(seed: int) -> int:
    """A 32-bit spec seed from the run's seed (a splitmix64 finaliser), so
    neighbouring run seeds give unrelated populations."""
    z = (int(seed) + 0x9E3779B97F4A7C15) & (2 ** 64 - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2 ** 64 - 1)
    return (z ^ (z >> 31)) & M32


def job_seed(base: int, j: int, replicas: int) -> int:
    """Spec seed of job j: consecutive jobs R seeds apart."""
    return (base + j * replicas) & M32


def sample_times(seed: int, seconds: float, count: int) -> list:
    """Offsets into the window, drawn from the seed: the first unit that
    starts at or past each is kept for the check.  The first is 0, so the
    window's first unit is always kept."""
    rng = np.random.default_rng(int(seed) & (2 ** 64 - 1))
    draws = sorted(float(u) * seconds for u in rng.random(count - 1))
    return [0.0] + draws
