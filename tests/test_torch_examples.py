"""The port's examples run to their end on the CPU: examples/torch_quickstart.py
and examples/torch_custom_fitness.py well inside 20 s each (on the card
they run from chip_smoke.py phase 13), and the two training examples,
examples/torch_train_lm_e2e.py (at a few steps) and
examples/torch_evolve_hparams.py, well inside 90 s each (on the card from
phase 14); without `--device` on a host with no card (the card hidden
from the subprocess) the training examples exit 2."""

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
    ("torch_custom_fitness.py", ["blackbox [fused    ] ran on fused",
                                 "blackbox [auto     ] ran on reference",
                                 "styblinski_tang:6 [fused-islands]",
                                 "ackley:8"]),
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


@pytest.mark.parametrize("name,args,expect", [
    ("torch_train_lm_e2e.py",
     ["--steps", "2", "--seq-len", "16", "--global-batch", "2"],
     ["~80M params on cpu", "stopped after step 1", "[resume] restored step 1",
      "stopped after step 2", "decode throughput",
      "pattern-continuation accuracy"]),
    ("torch_evolve_hparams.py", [],
     ["[backend=reference] best hparams", "best trial loss"]),
])
def test_training_example_runs_on_the_cpu(name, args, expect, tmp_path):
    # two torch threads, as the training test modules run: a thread a core
    # beside the suite's other workers made the e2e example take 108 s
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               TMPDIR=str(tmp_path), OMP_NUM_THREADS="2")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                          "--device", "cpu", *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    took = time.perf_counter() - t0
    assert out.returncode == 0, out.stderr
    for line in expect:
        assert line in out.stdout, (line, out.stdout)
    assert took < 90, f"{name} took {took:.1f} s"


@pytest.mark.parametrize("name", ["torch_train_lm_e2e.py",
                                  "torch_evolve_hparams.py"])
def test_training_example_needs_a_device_where_there_is_no_card(name):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "examples" / name)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 2
    assert "pass --device cpu" in out.stderr
