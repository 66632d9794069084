"""The port's streaming and autotune smokes run to their end on the CPU
(`scripts/torch_streaming_smoke.py`, `scripts/torch_autotune_smoke.py`,
each ~3 s alone and within 120 s here beside the suite's other workers),
and `scripts/ci_torch.sh`, which runs them, parses as bash.  On the card
they run from `chip_smoke.py` phase 15 and from `ci_torch.sh`."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(args, tmp_path, timeout):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               TMPDIR=str(tmp_path), OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_streaming_smoke_on_the_cpu(tmp_path):
    out = _run([str(ROOT / "scripts" / "torch_streaming_smoke.py"),
                "--device", "cpu"], tmp_path, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "streamed plan on cpu: tile=1" in out.stdout, out.stdout
    assert out.stdout.rstrip().endswith("streaming smoke OK")


def test_autotune_smoke_on_the_cpu(tmp_path):
    table = tmp_path / "table.json"
    out = _run([str(ROOT / "scripts" / "torch_autotune_smoke.py"),
                "--device", "cpu", "--out", str(table)], tmp_path,
               timeout=120)
    assert out.returncode == 0, out.stderr
    assert "streamed/" in out.stdout and "resident-free/" in out.stdout
    assert table.is_file()
    assert out.stdout.rstrip().endswith("autotune smoke OK")


def test_ci_torch_script_parses():
    bash = shutil.which("bash")
    assert bash is not None
    script = ROOT / "scripts" / "ci_torch.sh"
    out = subprocess.run([bash, "-n", str(script)], capture_output=True,
                         text=True, timeout=30)
    assert out.returncode == 0, out.stderr
    text = script.read_text()
    for step in ("tests/test_torch_*.py", "torch_scheduler_smoke.py",
                 "torch_chaos_smoke.py", "torch_autotune_smoke.py",
                 "torch_streaming_smoke.py", "--mesh auto",
                 "repro_torch.launch.dryrun", "CI OK"):
        assert step in text, step
