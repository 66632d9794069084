"""The rotated deployment (`configs/cec17-rastrigin-sr-d30-islands.json`):
CEC 2017 F5's form, a seeded shift and rotation, on the island cell's
shapes.  Its plain reference (`reference/islands_sr.py`) restates the
data's recipe and the objective bit for bit with the port's, and the
island GA bit for bit on every backend at the reference's CPU cut; the
check rejects the objective without its rotation or shift, or unrotated
and unshifted; its yardstick (`work_rotated.py`) is pinned; and its
readers (`metrics/*.rotated.py`) read synthetic spans and records."""

import dataclasses
import hashlib
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
from gabench import work_islands as WI  # noqa: E402
from repro_torch import ga  # noqa: E402
from repro_torch import trace as TR  # noqa: E402
from repro_torch.core import fitness as F  # noqa: E402
from repro_torch.core import ga as G  # noqa: E402
from repro_torch.ga import compile_cache as CC  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = "cec17-rastrigin-sr-d30-islands"
CELL = NAME + ".stream"
CONFIG = json.loads((ROOT / f"gabench/configs/{NAME}.json").read_text())
ISLANDS = json.loads(
    (ROOT / "gabench/configs/cec17-rastrigin-d30-islands.json").read_text())
REF = H.reference_of(ROOT, CONFIG)
WORK = H.work_of(ROOT, CONFIG)
CUT = REF.cpu_cut(CONFIG)
CPU = ga.EngineOptions(device="cpu", cost_table=False, faults=False)
SEED = 2 ** 31 + 77
MS = 1_000_000      # nanoseconds a millisecond
READERS = ("gen_roofline.rotated", "waves_per_launch.rotated",
           "device_idle_share.rotated")
# sha256 of o then M (float64, as made) and of the program's float32 data
DATA_SHA256 = {
    4: ("03db7bdcde894c457d2d127c268723dcd74eb9bd065d18d306607a71a6e3dafc",
        "39ad6033e637f06dfedbd1a766a0f471943897857a3c39499cfe4d3c97355637"),
    30: ("f9c59f9fb17a4524421fe053c18dca838bb26f503ceaffc0f97ae8b0fe157e44",
         "493626c2dcc8f9e1b2e585c5829ea183adfd0599227fdfe051f73f240f6505aa"),
}


@pytest.fixture(autouse=True)
def _no_cost_table(monkeypatch):
    """No ambient cost table moves a plan."""
    monkeypatch.setenv("REPRO_GA_COST_TABLE", "off")


def test_the_configuration_is_the_island_cells_but_the_problem():
    assert CONFIG["reduced"] == [] and CONFIG["backend"] == "fused-islands"
    assert CONFIG["spec"] == dict(ISLANDS["spec"], problem="rastrigin_sr:30")
    assert CONFIG["chunk_generations"] == ISLANDS["chunk_generations"]
    assert "F5" in CONFIG["source"] and "seeded" in CONFIG["source"]
    assert len(CONFIG["source"]) <= 200
    assert any("default_rng([2017, 5, D])" in a for a in CONFIG["assumed"])
    shape = REF.shape_of(CONFIG)
    assert (shape.problem, shape.v, shape.n, shape.n_islands) == (
        "rastrigin_sr", 30, 256, 8)


def test_the_reference_is_plain_float32_torch():
    """No product of matrices (each sum left to right, as the port sums),
    TF32 off, and only torch and NumPy imported."""
    import ast
    tree = ast.parse((ROOT / CONFIG["reference"]).read_text())
    for node in ast.walk(tree):
        assert not (isinstance(node, ast.BinOp)
                    and isinstance(node.op, ast.MatMult))
        assert not (isinstance(node, ast.Call)
                    and getattr(node.func, "attr", None)
                    in ("matmul", "mm", "bmm", "einsum"))
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("v", sorted(DATA_SHA256))
def test_both_recipes_make_the_same_pinned_bytes(v):
    o, m = REF.sr_data(v)
    po, pm = F.rastrigin_sr_data64(v)
    assert o.dtype == m.dtype == np.float64
    assert o.tobytes() == po.tobytes() and m.tobytes() == pm.tobytes()
    raw, packed = DATA_SHA256[v]
    assert hashlib.sha256(o.tobytes() + m.tobytes()).hexdigest() == raw
    data = F.rastrigin_sr_data(v)
    assert data.dtype == np.float32 and data.shape == (v + v * v,)
    assert hashlib.sha256(data.tobytes()).hexdigest() == packed
    assert np.array_equal(data[:v], o.astype(np.float32))
    assert np.array_equal(data[v:], m.astype(np.float32).ravel())


@pytest.mark.parametrize("v", [4, 30])
def test_the_rotation_is_orthogonal_and_the_shift_in_range(v):
    o, m = REF.sr_data(v)
    assert np.abs(m @ m.T - np.eye(v)).max() <= 1e-10
    assert np.all(np.abs(o) <= 80.0)


@pytest.mark.parametrize("v", [4, 30])
def test_the_ports_stage_equals_the_references_fitness(v):
    prog = F.compile_program(problem=f"rastrigin_sr:{v}", bits_per_var=16)
    shape = dataclasses.replace(REF.shape_of(CONFIG), v=v)
    g = torch.Generator().manual_seed(v)
    x = torch.randint(0, 1 << 16, (3, 64, v), generator=g,
                      dtype=torch.int64).to(torch.int32)
    x[0, 0] = 0                      # the domain's corners
    x[0, 1] = (1 << 16) - 1
    got, want = prog.stage(x), REF.fitness(shape, x)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # the shift and rotation move it off classic Rastrigin on the box
    lo, span = prog.device_consts(x.device)
    val = lo + (x & 0xFFFF).to(torch.float32) * span
    plain = F.vsum(val * val - 10.0 * torch.cos(2.0 * np.pi * val) + 10.0)
    assert not torch.equal(got, plain + 500.0)


def _spec(**kw):
    return ga.GASpec(**dict(CUT["spec"], seed=SEED, **kw))


def _seeds(replicas):
    return [SEED + r for r in range(replicas)]


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


@pytest.mark.parametrize("backend", ["fused-islands", "islands"])
def test_an_island_job_equals_the_reference(backend):
    spec = _spec()
    res = ga.solve(spec, backend, options=CPU)
    fused = backend == "fused-islands"
    assert res.telemetry.plan.mode == ("resident" if fused else "gridded")
    unit = spec.gens_per_epoch if fused else spec.migrate_every
    shape = REF.shape_of(CUT)
    st = REF.init(shape, _seeds(spec.n_repeats), "cpu")
    _same(REF.run(shape, st, spec.generations, unit,
                  means="migration" if fused else "generations"),
          res.state, res.telemetry.per_repeat)


@pytest.mark.parametrize("backend", ["fused", "reference"])
def test_a_single_population_job_equals_the_references_ga(backend):
    """One population a replica (no ring): the port's state and best after
    `generations` equal the reference's own fitness and operators run from
    the port's initial state, folded as the reference folds a best."""
    spec = _spec(n_islands=1, gens_per_epoch=1)
    eng = ga.Engine(spec, backend, options=CPU)
    start = eng.init_state()
    res = eng.run(state=start)
    shape = REF.shape_of(CUT)
    flat = REF.State(*(t.clone() for t in start))
    best = torch.full((spec.n_repeats,), float("inf"))
    rows = torch.arange(spec.n_repeats)
    for _ in range(spec.generations):
        y = REF.fitness(shape, flat.x)
        idx = torch.argmin(y, dim=-1)
        best = torch.minimum(best, y[rows, idx])
        flat = REF.generation(shape, flat, y)
    for mine, theirs in zip(flat[:4], res.state[:4]):
        assert torch.equal(mine, theirs)
    assert np.array_equal(best.numpy().view(np.uint32),
                          res.telemetry.per_repeat.best.view(np.uint32))


def _patched(monkeypatch, **kw):
    """The port's rastrigin_sr replaced (`kw` on its ProblemDef), its
    programs recompiled."""
    pdef = dataclasses.replace(F.PROBLEMS["rastrigin_sr"], **kw)
    monkeypatch.setitem(F.PROBLEMS, "rastrigin_sr", pdef)
    monkeypatch.setitem(F.BUILTIN, "rastrigin_sr", pdef)
    CC.RUNNER_CACHE.reset()


def _identity_m(v):
    d = F.rastrigin_sr_data(v)
    d[v:] = np.eye(v, dtype=np.float32).ravel()
    return d


def _zero_o(v):
    d = F.rastrigin_sr_data(v)
    d[:v] = 0.0
    return d


def _plain(v, d):
    return F.vsum(v * v - 10.0 * torch.cos(2.0 * np.pi * v) + 10.0) + 500.0


@pytest.mark.parametrize("fault", ["identity M", "zero o",
                                   "plain rastrigin"])
def test_the_check_rejects_the_objective_unrotated_or_unshifted(
        fault, tmp_path, copy_bench, monkeypatch):
    copy_bench(tmp_path)
    for c in MANIFEST["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        path = tmp_path / c["file"]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(H.reference_of(ROOT, conf).cpu_cut(conf)))
    kw = {"identity M": dict(data=_identity_m), "zero o": dict(data=_zero_o),
          "plain rastrigin": dict(fn=_plain)}[fault]
    try:
        _patched(monkeypatch, **kw)
        res = H.run_cell(tmp_path, MANIFEST, CELL, SEED, 0.3, False,
                         device="cpu", t0=time.perf_counter())
    finally:
        CC.RUNNER_CACHE.reset()
    assert not res["correct"]
    assert res["check"]["state_words_differing"]["value"] > 0


def test_the_cell_is_correct_at_the_cut(tmp_path, copy_bench):
    copy_bench(tmp_path)
    for c in MANIFEST["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        path = tmp_path / c["file"]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(H.reference_of(ROOT, conf).cpu_cut(conf)))
    res = H.run_cell(tmp_path, MANIFEST, CELL, SEED, 0.3, False,
                     device="cpu", t0=time.perf_counter())
    assert res["correct"], res["check"]
    assert set(res["metrics"]) == {"evals_per_s.block", "setup_s"}


def test_the_control_moves_the_population():
    shape = REF.shape_of(CUT)
    st = REF.init(shape, _seeds(3), "cpu")
    a = REF.run(shape, st, 8, 4)
    b = REF.run(shape, st, 8, 4, fitness_dtype=torch.bfloat16)
    assert not torch.equal(a.state.x, b.state.x)


def test_the_yardstick_adds_the_rotation_to_the_island_cells():
    """At the cell: 5.0047 us a generation by operations (the island
    cell's 2.1503 plus 2V^2 + V + 1 = 1,831 float32 operations for each of
    its 104,448 evaluations), 10.0232 us by op class (issue)."""
    shape = REF.shape_of(CONFIG)
    replicas = CONFIG["spec"]["n_repeats"]
    unit = WORK.launch_unit(shape, CONFIG["spec"])
    assert unit == 32 and WORK.form(shape) == "rotated"
    assert WORK.rotation_ops(30) == 1831
    assert "ga_epoch" in WORK.KERNELS
    b = WORK.generations_bound(shape, replicas, unit, unit)
    base = WI.generations_bound(dataclasses.replace(shape,
                                                    problem="rastrigin"),
                                replicas, unit, unit)
    assert b["bytes"] == base["bytes"]
    evals = unit * replicas * 8 * 256
    assert evals == 32 * 104_448
    assert b["ops"]["fp32"] == base["ops"]["fp32"] + evals * 1831
    assert b["ops"]["int32"] == base["ops"]["int32"]
    assert b["ops"]["slow"] == base["ops"]["slow"]
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] / unit * 1e3 == pytest.approx(5.004740373, 1e-9)
    assert b["class_bound_ms"] / unit * 1e3 == pytest.approx(10.02322004,
                                                             1e-9)
    assert b["class_bound_by"] == "issue"


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


def _stream(waves, launches):
    """A rotated run_chunked run: chunk c's segment counts `waves[c]`
    cluster waves over `launches[c]` K2 launches; chunk 1 is the
    set-up's.  Chunk c starts at 100 c ms."""
    spans, sid = [], 0
    for c, (w, n) in enumerate(zip(waves, launches), start=1):
        base, run, seg = 100 * c * MS, (1, c), sid + 1
        attrs = {"plan": "resident", "population_bits": 16,
                 "intervals": 2 * n, "migrations": 2 * n,
                 "ffm_data_bytes": 3720, "device_ms": 20.0}
        if w is not None:
            attrs["cluster_waves"] = w
        if n:
            attrs["kernel_launches.ga_epoch"] = n
        spans.append(_span("topology.segment", seg, base, base + 50 * MS,
                           sid + 2, run, **attrs))
        spans.append(_span("engine.chunk", sid + 2, base, base + 60 * MS,
                           None, run))
        sid += 2
    return spans


# the set-up's chunk (two waves a launch) falls outside the window; of the
# window's, one counted no launches
SPANS = _stream([64, 32, 64, None], [32, 32, 32, 0])
SLICE = SimpleNamespace(prof=None, t0=0.0, done=True, gens=2048,
                        launches=64, least_ms=10.0, units=2,
                        trace={"busy_s": 0.05, "window_s": 0.0625})
WANT = {"gen_roofline.rotated": 100 * 10.0e-3 / 0.05,
        "waves_per_launch.rotated": 1.5,
        "device_idle_share.rotated": 20.0}


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_rotated_form_only(name, monkeypatch):
    entry = {m["name"]: m for m in MANIFEST["per_layer"]}[name]
    assert entry["workloads"] == [CELL]
    assert entry["moves"] == "evals_per_s.block"
    mod = _reader(name)
    monkeypatch.setattr(PS, "_trace",
                        SimpleNamespace(records=lambda: SPANS,
                                        clear=TR.clear, enable=TR.enable))
    assert mod.read(SimpleNamespace(form="rotated", slice=SLICE)) == \
        pytest.approx(WANT[name])
    for form in ("block", "global", "resident"):
        assert mod.read(SimpleNamespace(form=form, slice=SLICE)) is None


def test_waves_per_launch_is_one_where_every_cluster_fits():
    mod = _reader("waves_per_launch.rotated")
    assert mod.waves_per_launch(_stream([32, 32], [32, 32])) == 1.0
    assert mod.waves_per_launch(_stream([None, None], [32, 32])) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_reports_nothing_where_nothing_was_recorded(name,
                                                          monkeypatch):
    """No recorder (a port without `repro_torch.trace`), no counters of
    the island ring, or no traced slice: nothing, and nothing raised."""
    monkeypatch.setattr(PS, "_trace", None)
    mod = _reader(name)
    empty = SimpleNamespace(prof=None, t0=0.0, done=False, gens=0,
                            launches=0, least_ms=0.0, trace=None)
    assert mod.read(SimpleNamespace(form="rotated", slice=empty)) is None
