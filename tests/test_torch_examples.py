"""The port's examples run to their end on the CPU, each well inside 20 s
(examples/torch_quickstart.py and examples/torch_custom_fitness.py; on the
card they run from chip_smoke.py phase 13)."""

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name,expect", [
    ("torch_quickstart.py", ["F1 best fitness", "F3 [fused    ]",
                             "evolve() found"]),
    ("torch_custom_fitness.py", ["blackbox [fused    ] ran on reference",
                                 "blackbox [auto     ] ran on reference",
                                 "styblinski_tang:6", "ackley:8"]),
])
def test_example_runs_on_the_cpu(name, expect):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                          "--device", "cpu"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    took = time.perf_counter() - t0
    assert out.returncode == 0, out.stderr
    for line in expect:
        assert line in out.stdout, (line, out.stdout)
    assert took < 20, f"{name} took {took:.1f} s"
