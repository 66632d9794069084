"""The port's streaming and autotune smokes run to their end on the CPU
(`scripts/torch_streaming_smoke.py`, `scripts/torch_autotune_smoke.py`,
each ~3 s alone and within 120 s here beside the suite's other workers),
`scripts/torch_roofline_table.py` prints the tables of
`scripts/roofline_table.py` line for line from the same inputs, and
`scripts/ci_torch.sh`, which runs them, parses as bash.  On the card the
smokes run from `chip_smoke.py` phase 15 and from `ci_torch.sh`."""

import json
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


def _tables(args, tmp_path):
    """Both scripts' standard output on the same arguments."""
    outs = []
    for script in ("torch_roofline_table.py", "roofline_table.py"):
        out = _run([str(ROOT / "scripts" / script), *args], tmp_path,
                   timeout=120)
        assert out.returncode == 0, (script, out.stderr)
        outs.append(out.stdout.splitlines())
    return outs


def test_roofline_table_of_a_port_cost_table(tmp_path):
    """A cost table the port wrote (the two packages share its version and
    JSON): two spec families, three modes, two launch folds."""
    from repro_torch.autotune import CostTable
    table = CostTable(host={"platform": "cuda", "device_count": 1})
    for n, modes in ((256, {"gridded": 8000.0, "resident": 51000.0,
                            "streamed": 43000.5}),
                     (1024, {"gridded": 1600.25, "streamed": 9000.0})):
        for mode, rate in modes.items():
            point = {"executor": "fused", "mode": mode,
                     "migration": "ring", "n": n, "i_local": 8, "c": 16,
                     "stage": "rastrigin:8", "shards": 1, "E": 1,
                     "lane": "onehot"}
            table.add(point, 16, rate, reps=5, cov=0.0123)
            table.add(point, 64, rate * 1.5, reps=3, cov=0.04)
    path = table.save(str(tmp_path / "table.json"))
    port, jax_ = _tables(["--ga-cost-table", path], tmp_path)
    assert len(port) == 2 + 10
    assert port == jax_


def test_roofline_table_of_a_dryrun_directory(tmp_path):
    """Two records with the keys `repro_torch.launch.dryrun._save` writes,
    one counted and one skipped, beside a record of another mesh."""
    results = tmp_path / "results"
    results.mkdir()
    ok = {"status": "ok", "t_lower_s": 0.04, "t_compile_s": 7.6,
          "arch": "minitron-8b", "shape": "train_4k", "mesh": "pod1",
          "n_devices": 256, "flops_per_dev": 4.775e15,
          "hbm_bytes_per_dev": 4.251e13, "coll_bytes_per_dev": 9.287e11,
          "coll_breakdown": {"param_gather": 5.0e11,
                             "grad_scatter": 4.287e11},
          "t_compute": 4.82829, "t_memory": 12.68981,
          "t_collective": 2.06378, "model_flops_total": 6.217e16,
          "xla_flops_reported": None,
          "memory_analysis": {"argument_size_in_bytes": 2.0e10,
                              "output_size_in_bytes": 1.0e9,
                              "temp_size_in_bytes": 3.752e11,
                              "generated_code_size_in_bytes": 0},
          "compute_devices": 16, "placement": "16 batch shard(s)",
          "dominant": "memory", "useful_flops_ratio": 0.81372,
          "roofline_fraction": 0.019351}
    skipped = {"arch": "whisper-large-v3", "shape": "long_500k",
               "mesh": "pod1", "status": "skipped",
               "reason": "no long context"}
    for rec in (ok, skipped, dict(ok, mesh="pod2")):
        name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
        (results / name).write_text(json.dumps(rec, indent=1))
    for mesh, rows in (("pod1", 2), ("pod2", 1)):
        port, jax_ = _tables([str(results), mesh], tmp_path)
        assert len(port) == 2 + rows
        assert port == jax_
        assert "| minitron-8b | train_4k | 4828.3 | 12689.8 | 2063.8 |" \
            in port[2]
        assert any("*skipped*" in line for line in port) == (mesh == "pod1")


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
                 "repro_torch.launch.dryrun", "torch_roofline_table.py",
                 "CI OK"):
        assert step in text, step
