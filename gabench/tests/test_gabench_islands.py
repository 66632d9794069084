"""The island deployment (`configs/cec17-rastrigin-d30-islands.json`): its
plain reference (`reference/islands.py`) has the port's semantics, bit
for bit at the reference's CPU cut, on `fused-islands` (K2's plain twin
on its resident plan) and on `islands` (the reference executor, one
interval a launch), for a job and for a chunked run; the check sees the
ring; its yardstick (`work_islands.py`) is pinned; and its readers
(`metrics/*.resident.py`) read synthetic spans and records."""

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from gabench import harness as H  # noqa: E402
from gabench import program_spans as PS  # noqa: E402
from gabench import work as W  # noqa: E402
from repro_torch import ga  # noqa: E402
from repro_torch import trace as TR  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = "cec17-rastrigin-d30-islands"
CELL = NAME + ".stream"
CONFIG = json.loads((ROOT / f"gabench/configs/{NAME}.json").read_text())
REF = H.reference_of(ROOT, CONFIG)
WORK = H.work_of(ROOT, CONFIG)
CUT = REF.cpu_cut(CONFIG)
CPU = ga.EngineOptions(device="cpu", cost_table=False, faults=False)
SEED = 2 ** 31 + 41
MS = 1_000_000      # nanoseconds a millisecond
READERS = ("gen_roofline.resident", "launches_per_kgen.resident",
           "device_idle_share.resident", "host_us_per_launch.resident",
           "boundary_idle_share.resident", "fold_ms.resident")


@pytest.fixture(autouse=True)
def _no_cost_table(monkeypatch):
    """No ambient cost table moves a plan."""
    monkeypatch.setenv("REPRO_GA_COST_TABLE", "off")


def _spec(**kw):
    return ga.GASpec(**dict(CUT["spec"], seed=SEED, **kw))


def _sampling(backend):
    """(trajectory unit, means) of a backend's island segment at the cut:
    a resident launch of two intervals, or one interval a launch."""
    spec = CUT["spec"]
    if backend == "fused-islands":
        return spec["gens_per_epoch"], "migration"
    return spec["migrate_every"], "generations"


def _same(run, state, rep):
    for mine, theirs in zip(run.state, state):
        assert mine.shape == theirs.shape
        assert torch.equal(mine, theirs)
    assert np.array_equal(run.best.numpy().view(np.uint32),
                          rep.best.view(np.uint32))
    assert np.array_equal(run.best_x.numpy().view(np.uint32), rep.best_x)
    for mine, theirs in ((run.traj_best, rep.traj_best),
                         (run.traj_mean, rep.traj_mean)):
        assert mine.shape == theirs.shape
        assert np.array_equal(mine.numpy().view(np.uint32),
                              theirs.view(np.uint32))


def _seeds(replicas):
    return [SEED + r for r in range(replicas)]


@pytest.mark.parametrize("backend", ["fused-islands", "islands"])
def test_a_job_equals_the_reference(backend):
    spec = _spec()
    res = ga.solve(spec, backend, options=CPU)
    plan = "resident" if backend == "fused-islands" else "gridded"
    assert res.telemetry.plan.mode == plan
    unit, means = _sampling(backend)
    shape = REF.shape_of(CUT)
    st = REF.init(shape, _seeds(spec.n_repeats), "cpu")
    _same(REF.run(shape, st, spec.generations, unit, means=means),
          res.state, res.telemetry.per_repeat)


@pytest.mark.parametrize("backend", ["fused-islands", "islands"])
def test_a_stream_equals_the_reference_chunk_by_chunk(backend):
    """Three chunks: the first from the reference's own initial state,
    each later one from the state the port handed it."""
    spec = _spec()
    eng = ga.Engine(spec, backend, options=CPU)
    handed, segment = [], eng.backend.segment

    def keep(state, gens):
        handed.append(tuple(t.clone() for t in state))
        seg = segment(state, gens)
        handed[-1] += (seg.state,)
        return seg
    eng.backend.segment = keep
    chunk = CUT["chunk_generations"]
    teles = list(eng.run_chunked(chunk_generations=chunk,
                                 generations=3 * chunk))
    assert len(teles) == len(handed) == 3
    unit, means = _sampling(backend)
    shape = REF.shape_of(CUT)
    start = REF.init(shape, _seeds(spec.n_repeats), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(start, handed[0][:5]))
    for c, (tele, given) in enumerate(zip(teles, handed)):
        st = start if c == 0 else REF.State(*given[:5])
        _same(REF.run(shape, st, chunk, unit, means=means), given[5],
              tele["telemetry"].per_repeat)


def test_the_cut_keeps_the_resident_plan():
    spec = CUT["spec"]
    assert 2 <= spec["n_islands"] <= 8
    assert spec["gens_per_epoch"] % spec["migrate_every"] == 0
    for gens in (spec["generations"], CUT["chunk_generations"]):
        assert gens // spec["migrate_every"] >= 2
    assert REF.leaf_shapes(REF.shape_of(CUT), 3) == (
        (3, 4, 16, 4), (3, 4, 2, 16), (3, 4, 4, 8), (3, 4, 4, 16), (3, 4))
    assert REF.evals_per_generation(REF.shape_of(CONFIG)) == 8 * 256
    assert REF.traj_unit(CONFIG) == 32


def test_the_check_sees_the_ring(tmp_path, copy_bench):
    """The cell run with the port's ring switched off, the rest of the
    configuration as it is, is not correct."""
    copy_bench(tmp_path)
    for c in MANIFEST["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        cut = H.reference_of(ROOT, conf).cpu_cut(conf)
        if c["name"] == NAME:
            cut = dict(cut, spec=dict(cut["spec"], migration="none"))
        path = tmp_path / c["file"]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(cut))
    res = H.run_cell(tmp_path, MANIFEST, CELL, SEED, 0.3, False,
                     device="cpu", t0=time.perf_counter())
    assert not res["correct"]
    assert res["check"]["state_words_differing"]["value"] > 0


def test_the_control_moves_the_population():
    shape = REF.shape_of(CUT)
    st = REF.init(shape, _seeds(3), "cpu")
    a = REF.run(shape, st, 8, 4)
    b = REF.run(shape, st, 8, 4, fitness_dtype=torch.bfloat16)
    assert not torch.equal(a.state.x, b.state.x)


@pytest.mark.parametrize("unit", [3, 1])
def test_a_unit_of_part_intervals_is_refused(unit):
    shape = REF.shape_of(CUT)
    st = REF.init(shape, _seeds(1), "cpu")
    with pytest.raises(ValueError):
        REF.run(shape, st, 8, unit)


# (unit, least time of a unit and of a chunk in ms, as the op-class
# bound's), at the cell's 51 replicas of 8 islands
PINNED = (32, 0.06881113647761194, 2.2019563672835822, 0.1378111771120294,
          4.409957667584941)


def test_the_yardstick_is_pinned():
    unit, unit_ms, chunk_ms, unit_cls, chunk_cls = PINNED
    shape = REF.shape_of(CONFIG)
    replicas = CONFIG["spec"]["n_repeats"]
    assert WORK.launch_unit(shape, CONFIG["spec"]) == unit
    assert WORK.form(shape) == "resident"
    assert WORK.KERNELS == W.KERNELS and "ga_epoch" in WORK.KERNELS
    chunk = CONFIG["chunk_generations"]
    for g, ms, cls in ((unit, unit_ms, unit_cls),
                       (chunk, chunk_ms, chunk_cls)):
        b = WORK.generations_bound(shape, replicas, g, unit)
        assert b["bound_ms"] == ms and b["bound_by"] == "operations"
        assert b["class_bound_ms"] == cls
    # a unit is R x I islands' state read and written, and their ops
    b = WORK.generations_bound(shape, replicas, unit, unit)
    assert b["bytes"] == replicas * 8 * 2 * 4 * shape.state_words
    one = WORK.generations_bound(dataclasses.replace(shape, n_islands=1),
                                 1, unit, unit)
    assert b["ops"] == {k: replicas * 8 * v for k, v in one["ops"].items()}


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "gabench_metric_test_" + name.replace(".", "_"),
        ROOT / "gabench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _span(name, sid, t0, t1, parent=None, run=None, **attrs):
    return {"name": name, "id": sid, "parent": parent, "run": run,
            "t0": t0, "t1": t1, "attrs": attrs}


def _stream(launch_ms, fold_ms, device_ms, gaps_ms):
    """An island run_chunked run: chunk c's segment holds two K2 launch
    spans and a result span, its counters and timing events; chunk 1 is
    the set-up's.  Chunk c starts at 100 c ms."""
    spans, sid = [], 0
    for c, (dev, gap, fold) in enumerate(zip(device_ms, gaps_ms, fold_ms),
                                         start=1):
        base, run, seg = 100 * c * MS, (1, c), sid + 1
        for i in range(2):
            t = base + i * MS
            spans.append(_span("topology.launch", sid + 3 + i, t,
                               t + int(launch_ms * MS), seg, run))
        spans.append(_span("segment.result", sid + 5, base + 40 * MS,
                           base + 40 * MS + int(fold * MS), seg, run))
        attrs = {"plan": "resident", "intervals": 4, "migrations": 4,
                 "kernel_launches.ga_epoch": 2, "device_ms": dev}
        if gap is not None:
            attrs["gap_before_ms"] = gap
        spans.append(_span("topology.segment", seg, base, base + 50 * MS,
                           sid + 2, run, **attrs))
        spans.append(_span("engine.chunk", sid + 2, base, base + 60 * MS,
                           None, run))
        sid += 5
    return spans


SPANS = _stream(0.2, [9.0, 3.0, 5.0], [6.0] * 3, [None, 1.0, 2.0])
SLICE = SimpleNamespace(prof=None, t0=0.0, done=True, gens=2048,
                        launches=64, least_ms=4.4, units=2,
                        trace={"busy_s": 0.011, "window_s": 0.044})
# what each reader gives on SPANS and SLICE (the window: chunks 2 and 3;
# the first of them has no gap inside the window)
WANT = {"gen_roofline.resident": 100 * 4.4e-3 / 0.011,
        "launches_per_kgen.resident": 31.25,
        "device_idle_share.resident": 75.0,
        "host_us_per_launch.resident": 200.0,
        "boundary_idle_share.resident": 100 * 2.0 / 14.0,
        "fold_ms.resident": 4.0}


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_resident_form_only(name, monkeypatch):
    entry = {m["name"]: m for m in MANIFEST["per_layer"]}[name]
    assert entry["workloads"] == [CELL]
    assert entry["moves"] == "evals_per_s.block"
    mod = _reader(name)
    monkeypatch.setattr(PS, "_trace",
                        SimpleNamespace(records=lambda: SPANS,
                                        clear=TR.clear, enable=TR.enable))
    rec = SimpleNamespace(form="resident", slice=SLICE)
    assert mod.read(rec) == pytest.approx(WANT[name])
    for form in ("block", "global"):
        assert mod.read(SimpleNamespace(form=form, slice=SLICE)) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_reports_nothing_where_nothing_was_recorded(name,
                                                          monkeypatch):
    """No recorder (a port without `repro_torch.trace`), no spans of the
    island ring, or no traced slice: nothing, and nothing raised."""
    monkeypatch.setattr(PS, "_trace", None)
    mod = _reader(name)
    empty = SimpleNamespace(prof=None, t0=0.0, done=False, gens=0,
                            launches=0, least_ms=0.0, trace=None)
    assert mod.read(SimpleNamespace(form="resident", slice=empty)) is None
