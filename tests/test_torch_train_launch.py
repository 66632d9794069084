"""`python -m repro_torch.launch.train` on the CPU: a run of 6 steps with a
checkpoint directory, then a second run on the same directory that resumes
from it; and without `--device` on a host with no card (the card hidden
from the subprocess) it exits 2."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CMD = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
       "minitron-8b", "--reduced", "--seq-len", "32", "--global-batch", "4"]


def _run(args, **env_kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2",
               **env_kw)
    return subprocess.run(CMD + args, cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_train_then_resume_on_the_cpu(tmp_path):
    d = str(tmp_path / "run")
    first = _run(["--steps", "6", "--ckpt-every", "3", "--ckpt-dir", d,
                  "--device", "cpu"])
    assert first.returncode == 0, first.stderr
    assert "device: cpu" in first.stdout
    assert "final loss" in first.stdout and "after 6 steps" in first.stdout
    assert "[resume]" not in first.stdout
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000006"]
    second = _run(["--steps", "8", "--ckpt-dir", d, "--device", "cpu"])
    assert second.returncode == 0, second.stderr
    assert "[resume] restored step 6" in second.stdout
    assert "after 8 steps" in second.stdout
    assert "step_00000008" in os.listdir(d)
    third = _run(["--steps", "8", "--ckpt-dir", d, "--device", "cpu"])
    assert third.returncode == 0, third.stderr
    assert "[resume] restored step 8" in third.stdout
    assert "nothing to train: the run is at step 8 of 8" in third.stdout


def test_without_a_device_exits_2_where_there_is_no_card():
    out = _run(["--steps", "1"], CUDA_VISIBLE_DEVICES="")
    assert out.returncode == 2
    assert "pass --device cpu" in out.stderr
