"""The port's `ga_run` and `ga_autotune` launchers (and `ga_serve`'s cost
table) on the CPU, through `main()` at small sizes: every backend's run
equals `ga.solve` of the same spec, the deprecated `--kernel`, chunked
runs that resume, the metrics endpoint, a measured plan from
`--cost-table`, and a sweep written, merged and read back — its grid the
JAX launcher's."""

import json
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.launch import ga_autotune as JTUNE  # noqa: E402
from repro_torch import ga  # noqa: E402
from repro_torch.autotune import CostTable  # noqa: E402
from repro_torch.ga import compile_cache as CC  # noqa: E402
from repro_torch.launch import ga_autotune, ga_run, ga_serve  # noqa: E402

CPU = ga.EngineOptions(device="cpu")


@pytest.fixture(autouse=True)
def _no_ambient_cost_table(monkeypatch):
    """Only the tables a test names plan here."""
    monkeypatch.setenv("REPRO_GA_COST_TABLE", "off")


def _run(capsys, *argv):
    ga_run.main(["--device", "cpu", *argv])
    return capsys.readouterr().out.splitlines()


def _line(lines, prefix):
    got = [ln for ln in lines if ln.startswith(prefix)]
    assert got, f"no {prefix!r} line in {lines}"
    return got[0]


ISLAND_ARGS = ("--problem", "rastrigin:4", "--n", "16", "--m", "16",
               "--mode", "arith", "--islands", "2", "--repeats", "2",
               "--migrate-every", "4", "--gens-per-epoch", "8", "--k", "16")
ISLAND_SPEC = dict(problem="rastrigin:4", n=16, bits_per_var=8,
                   mode="arith", n_islands=2, n_repeats=2, migrate_every=4,
                   gens_per_epoch=8, generations=16, mutation_rate=0.02,
                   seed=1)


@pytest.mark.parametrize("backend", ["reference", "fused", "eager",
                                     "islands", "fused-islands"])
def test_ga_run_equals_solve(capsys, backend):
    if backend.endswith("islands"):
        args, kw = ISLAND_ARGS, dict(ISLAND_SPEC)
    else:
        args = ("--problem", "F3", "--n", "16", "--k", "12", "--mode",
                "arith")
        kw = dict(problem="F3", n=16, bits_per_var=10, mode="arith",
                  generations=12, mutation_rate=0.02, seed=1)
    lines = _run(capsys, *args, "--backend", backend)
    want = ga.solve(ga.GASpec(**kw), backend=backend, options=CPU)
    assert _line(lines, "backend:").split()[1] == backend
    assert "device: cpu" in lines
    assert _line(lines, "best fitness:") == \
        f"best fitness: {want.best_fitness:.4f}"
    if backend.endswith("islands"):
        assert _line(lines, "epoch plan:").endswith(
            f"({want.telemetry.plan.source}, lane=onehot)")
        assert _line(lines, "migrations:") == "migrations: 4"


def test_ga_run_kernel_alias_and_lut_switch(capsys):
    lines = _run(capsys, "--problem", "F1", "--n", "16", "--k", "4",
                 "--kernel")
    assert _line(lines, "backend:").split()[1] == "fused"
    assert "mode=arith" in _line(lines, "problem:")


def test_ga_run_chunked_resumes(capsys, tmp_path):
    args = ("--problem", "F2", "--n", "16", "--k", "30", "--chunk", "10",
            "--ckpt-dir", str(tmp_path), "--backend", "eager")
    first = _run(capsys, *args)
    chunks = [ln for ln in first if ln.startswith("[eager] chunk")]
    assert len(chunks) == 3 and "30/30 gens" in chunks[-1]
    again = _run(capsys, *args)        # the finished run, resumed
    assert _line(again, "decoded vars:") == _line(first, "decoded vars:")
    assert len([ln for ln in again if ln.startswith("[eager]")]) == 1


def test_ga_run_serves_metrics_while_it_streams(capsys):
    lines = _run(capsys, "--problem", "F3", "--n", "16", "--k", "8",
                 "--metrics-port", "0", "--backend", "reference")
    assert _line(lines, "metrics: http://0.0.0.0:").endswith("/metrics")
    assert sum(ln.startswith("[reference] chunk") for ln in lines) >= 1


def _table_for(spec, path):
    """A table that makes the gridded plan win for `spec`'s shape."""
    t = CostTable()
    for mode, g, rate in (("resident", 8, 10.0), ("gridded", 4, 100.0)):
        t.add(CC.plan_point(spec, executor="fused", mode=mode, n_shards=1),
              g, rate)
    return t.save(str(path))


def test_ga_run_plans_from_a_cost_table(capsys, tmp_path):
    path = _table_for(ga.GASpec(**ISLAND_SPEC), tmp_path / "t.json")
    lines = _run(capsys, *ISLAND_ARGS, "--backend", "fused-islands",
                 "--cost-table", path)
    assert _line(lines, "epoch plan:") == \
        "epoch plan: gridded (measured, lane=onehot)"
    off = _run(capsys, *ISLAND_ARGS, "--backend", "fused-islands",
               "--cost-table", "off")
    assert _line(off, "epoch plan:") == \
        "epoch plan: resident (heuristic, lane=onehot)"
    assert _line(lines, "best fitness:") == _line(off, "best fitness:")


def test_ga_run_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        ga_run.main(["--problem", "F3", "--n", "16", "--k", "2"])


TUNE = ("--device", "cpu", "--problems", "F3", "--n", "16", "--m", "16",
        "--islands", "2", "--migrate-every", "4", "--reps", "3")


def test_ga_autotune_writes_merges_and_plans(capsys, tmp_path):
    out = str(tmp_path / "table.json")
    ga_autotune.main([*TUNE, "--gens-per-epoch", "8", "--out", out])
    lines = capsys.readouterr().out.splitlines()
    assert _line(lines, "sweeping 2 spec(s)")
    table = CostTable.load(out)
    # ring: resident + gridded, none: gridded + resident-free; two lanes
    assert len(table) == 8
    assert _line(lines, "wrote 8 measured point(s)")
    ga_autotune.main([*TUNE, "--gens-per-epoch", "16", "--migration",
                      "ring", "--out", out, "--merge"])
    lines = capsys.readouterr().out.splitlines()
    assert _line(lines, "merging into 8 existing point(s)")
    merged = CostTable.load(out)
    # the ring's resident points gain g=16 on both lanes; its gridded
    # launch folds min(16, 4) = 4 generations again, and is re-measured
    assert len(merged) == 10
    assert {e["gens_per_launch"] for e in merged.entries()
            if e["mode"] == "resident"} == {8, 16}
    spec = ga.GASpec(problem="F3", n=16, bits_per_var=8, mode="arith",
                     n_islands=2, migrate_every=4, gens_per_epoch=8,
                     generations=8)
    plan = ga.Engine(spec, "fused-islands", options=ga.EngineOptions(
        device="cpu", cost_table=out)).backend.topology.plan
    assert plan["plan_source"] == "measured"


def test_ga_autotune_grid_is_the_jax_launchers():
    kw = dict(n=32, bits_per_var=10, n_islands=8, migrate_every=16,
              gens_per_epoch=[16, 32], migrations=["ring", "none"])
    got = ga_autotune.build_specs(["F3", "rastrigin:4"], **kw)
    want = JTUNE.build_specs(["F3", "rastrigin:4"], **kw)
    fields = ("problem", "n", "bits_per_var", "n_vars", "mode", "seed",
              "generations", "n_islands", "migrate_every", "gens_per_epoch",
              "migration", "sel_lane")
    assert [[getattr(s, f) for f in fields] for s in got] == \
        [[getattr(s, f) for f in fields] for s in want]


def test_ga_serve_reports_its_cost_table(capsys, tmp_path, monkeypatch):
    spec_kw = dict(problem="F3", n=16, bits_per_var=8, mode="arith",
                   n_islands=2, migrate_every=4, gens_per_epoch=8,
                   generations=16)
    path = _table_for(ga.GASpec(**spec_kw), tmp_path / "t.json")
    jobs = tmp_path / "jobs.json"
    jobs.write_text(json.dumps([dict(spec_kw, seed=s) for s in (1, 2)]))
    monkeypatch.setattr(sys, "argv", [
        "ga_serve", "--jobs", str(jobs), "--device", "cpu", "--backend",
        "fused-islands", "--cost-table", path, "--ckpt-root",
        str(tmp_path / "root"), "--stream", "none"])
    ga_serve.main()
    lines = capsys.readouterr().out.splitlines()
    assert "cost table: 2 measured point(s)" in lines
    plans = _line(lines, "plans:").split()
    # one plan a dispatch: the two jobs may or may not share a pack
    assert int(plans[1]) >= 1 and plans[4] == "0"
    solo = ga.solve(ga.GASpec(**dict(spec_kw, seed=1)),
                    backend="fused-islands", options=CPU)
    assert any(f"best={solo.best_fitness:.6f}" in ln for ln in lines)
