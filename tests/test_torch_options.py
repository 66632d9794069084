"""`EngineOptions` of the port against the JAX package's: the `sel_lane`
override (it rebuilds the spec, so the lane reaches the plan, the onehot
cap and the compile key as a spec-level pin does) and the CLI parser the
serving launcher shares (`add_cli_args` / `from_args`)."""

import argparse
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import ga as JGA  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import ga  # noqa: E402


@pytest.fixture(autouse=True)
def _no_ambient_cost_table(monkeypatch):
    """The plans here are the heuristic's: no cost table found on the host
    may move them."""
    monkeypatch.setenv("REPRO_GA_COST_TABLE", "off")


def _kw(**kw):
    base = dict(problem="F3", n=32, bits_per_var=8, mode="arith",
                mutation_rate=0.05, seed=7, generations=16,
                n_islands=2, migrate_every=4, gens_per_epoch=8)
    base.update(kw)
    return base


def _solve(spec, backend="fused-islands", **opt):
    return ga.solve(spec, backend=backend,
                    options=ga.EngineOptions(device="cpu", **opt))


@pytest.mark.parametrize("lane", ["gather", "onehot"])
def test_sel_lane_override_reaches_the_plan_as_in_jax(lane):
    """The spec says "auto"; the option pins the lane.  The plan's lane is
    the JAX package's from the same spec and option."""
    spec = ga.GASpec(**_kw())
    res = _solve(spec, sel_lane=lane)
    want = JGA.solve(JGA.GASpec(**_kw()), backend="fused-islands",
                     options=JGA.EngineOptions(cost_table=False,
                                               sel_lane=lane))
    assert res.telemetry.plan.lane == want.telemetry.plan.lane == lane
    eng = ga.Engine(spec, "fused-islands",
                    options=ga.EngineOptions(device="cpu", sel_lane=lane))
    assert eng.backend.spec.sel_lane == lane
    assert eng.backend.topology.cfg.sel_lane == lane
    assert eng.backend.spec.compile_key() == dataclasses.replace(
        spec, sel_lane=lane).compile_key()


def test_sel_lane_none_keeps_the_spec_lane():
    spec = ga.GASpec(**_kw(sel_lane="gather"))
    eng = ga.Engine(spec, "fused-islands",
                    options=ga.EngineOptions(device="cpu"))
    assert eng.backend.spec is spec
    assert _solve(spec).telemetry.plan.lane == "gather"


def test_onehot_past_the_cap_raises_the_jax_message():
    kw = _kw(n=2048, n_islands=1, generations=2, gens_per_epoch=1)
    with pytest.raises(ValueError, match="sel_lane='gather'") as got:
        _solve(ga.GASpec(**kw), backend="reference", sel_lane="onehot")
    with pytest.raises(ValueError, match="sel_lane='gather'") as want:
        JGA.Engine(JGA.GASpec(**kw), "reference",
                   options=JGA.EngineOptions(cost_table=False,
                                             sel_lane="onehot"))
    assert str(got.value) == str(want.value)


def test_unknown_lane_refused_as_in_jax():
    with pytest.raises(ValueError, match="sel_lane") as got:
        ga.EngineOptions(device="cpu", sel_lane="vpu")
    with pytest.raises(ValueError, match="sel_lane") as want:
        JGA.EngineOptions(sel_lane="vpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("backend", ["fused-islands", "fused"])
def test_results_bit_identical_under_both_lanes(backend):
    kw = _kw() if backend == "fused-islands" else _kw(n_islands=1)
    spec = ga.GASpec(**kw)
    on, gather = (_solve(spec, backend, sel_lane=lane)
                  for lane in ("onehot", "gather"))
    assert on.best_fitness == gather.best_fitness
    np.testing.assert_array_equal(on.best_x, gather.best_x)
    np.testing.assert_array_equal(on.traj_best, gather.traj_best)
    for a, b in zip(convert.state_to_numpy(on.state),
                    convert.state_to_numpy(gather.state)):
        np.testing.assert_array_equal(a, b)


def test_cli_flags_build_the_options():
    ap = argparse.ArgumentParser()
    ga.EngineOptions.add_cli_args(ap)
    opts = ga.EngineOptions.from_args(ap.parse_args(
        ["--device", "cpu", "--plan-override", "streamed",
         "--stream-tile-islands", "2", "--sel-lane", "gather",
         "--faults", "chunk_crash:at=2"]))
    assert opts == ga.EngineOptions(device="cpu", plan_override="streamed",
                                    stream_tile_islands=2, sel_lane="gather",
                                    faults="chunk_crash:at=2")
    default = ga.EngineOptions.from_args(ap.parse_args([]))
    assert default == ga.EngineOptions()
    assert ga.EngineOptions.from_args(
        ap.parse_args(["--faults", "off"])).faults is False
    assert ga.EngineOptions.from_args(ap.parse_args(
        ["--plan-override", "resident-sharded"])).plan_override == \
        "resident-sharded"
    with pytest.raises(SystemExit):
        ap.parse_args(["--plan-override", "sharded"])


def test_cost_table_and_fitness_workers_flags_as_in_jax():
    ap = argparse.ArgumentParser()
    ga.EngineOptions.add_cli_args(ap)
    jap = argparse.ArgumentParser()
    JGA.EngineOptions.add_cli_args(jap)
    for argv, ct in ((["--cost-table", "t.json", "--fitness-workers", "4"],
                      "t.json"), (["--cost-table", "off"], False), ([], None)):
        opts = ga.EngineOptions.from_args(ap.parse_args(argv))
        jopts = JGA.EngineOptions.from_args(jap.parse_args(argv))
        assert (opts.cost_table, opts.fitness_workers) == (
            jopts.cost_table, jopts.fitness_workers)
        assert opts.cost_table == ct


@pytest.mark.parametrize("workers", [0, -2])
def test_fitness_workers_refused_as_in_jax(workers):
    with pytest.raises(ValueError, match="fitness_workers") as got:
        ga.EngineOptions(device="cpu", fitness_workers=workers)
    with pytest.raises(ValueError, match="fitness_workers") as want:
        JGA.EngineOptions(fitness_workers=workers)
    assert str(got.value) == str(want.value)
