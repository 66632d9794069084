"""The port's span recorder (`repro_torch.trace`): off it records nothing;
on, its spans nest through `Engine.run`, `run_chunked` and `init_state`
with parent and run ids, the store stays bounded, the spans appear in a
torch.profiler trace only while one records, and no result changes.  The
`cuda` cases hold a segment's launch counters and timing events on the
card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_trace.py
"""

import json
import threading

import numpy as np
import pytest
import torch

from repro_torch import ga
from repro_torch import trace as TR
from repro_torch.kernels import ga_step as K

CPU = ga.EngineOptions(device="cpu", cost_table=False, faults=False)
SPEC = ga.GASpec(problem="rastrigin:3", n=16, bits_per_var=10, mode="arith",
                 generations=12, n_repeats=2, gens_per_epoch=4, seed=7)


@pytest.fixture(autouse=True)
def _recorder():
    """Each test starts and ends with the recorder off and empty."""
    TR.disable()
    TR.clear()
    yield
    TR.disable()
    TR.clear()


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r["name"], []).append(r)
    return out


def _chunks(backend, states=None):
    """`SPEC`'s run_chunked telemetry, in chunks of 8 generations; with a
    list `states`, each chunk's output state is appended to it."""
    eng = ga.Engine(SPEC, backend, options=CPU)
    if states is not None:
        segment = eng.backend.segment

        def keep(state, gens):
            seg = segment(state, gens)
            states.append(seg.state)
            return seg
        eng.backend.segment = keep
    return list(eng.run_chunked(chunk_generations=8))


def test_off_records_nothing():
    assert TR.span("a") is TR.OFF and TR.span("b", 3, x=1) is TR.OFF
    with TR.span("a") as sp:
        TR.count("n", 2)
        sp.count("n")
        sp.set("k", 1)
    ga.solve(SPEC, "fused", options=CPU)
    assert TR.records() == [] and TR.dropped() == 0


def test_spans_nest_through_run_and_init_state():
    TR.enable()
    eng = ga.Engine(SPEC, "fused", options=CPU)
    eng.run()
    recs = TR.records()
    names = _by_name(recs)
    run = (eng.trace_run, None)
    assert {r["run"] for r in recs} == {run}
    ids = {r["id"]: r for r in recs}
    parent = lambda r: ids[r["parent"]]["name"] if r["parent"] else None
    assert [parent(r) for r in names["engine.run"]] == [None]
    assert [parent(r) for r in names["engine.init_state"]] == ["engine.run"]
    assert [parent(r) for r in names["init.seed_hash"]] == [
        "engine.init_state"]
    assert [parent(r) for r in names["topology.segment"]] == ["engine.run"]
    assert [parent(r) for r in names["segment.result"]] == [
        "topology.segment"]
    # 12 generations at 4 a launch: three K1 calls under the segment
    assert [parent(r) for r in names["executor.launch"]] == [
        "topology.segment"] * 3
    # the result packed once after the last launch, then read back once:
    # 3 samples x 2 replicas of means and of bests, 2 bests, 2 x 3 words
    (fold,), (res,) = names["segment.fold"], names["segment.result"]
    assert parent(fold) == "topology.segment" and fold["attrs"] == {}
    assert names["executor.launch"][-1]["t1"] <= fold["t0"]
    assert fold["t1"] <= res["t0"]
    assert res["attrs"] == {"readback_bytes": 4 * (6 + 2 + 2 * 3 + 6)}
    for r in recs:
        assert 0 < r["t0"] <= r["t1"]
        if r["parent"]:
            up = ids[r["parent"]]
            assert up["t0"] <= r["t0"] and r["t1"] <= up["t1"]
    # on the CPU a segment has no timing events and no launch counts
    assert names["topology.segment"][0]["attrs"] == {}
    assert "segment.wait" not in names


def _seed_hash_attrs(device, n_repeats):
    spec = ga.GASpec(problem="rastrigin:3", n=16, bits_per_var=10,
                     mode="arith", generations=4, n_repeats=n_repeats,
                     gens_per_epoch=4, seed=7)
    opts = ga.EngineOptions(device=device, cost_table=False, faults=False)
    eng = ga.Engine(spec, "fused", options=opts)
    TR.enable()
    eng.init_state()
    (sp,) = _by_name(TR.records())["init.seed_hash"]
    # a replica's words: sel 2N, cross V*N/2, mut V*N, population V*N
    return sp["attrs"], n_repeats * (2 * 16 + 3 * 8 + 2 * 3 * 16)


@pytest.mark.parametrize("n_repeats", [1, 2, 5])
def test_seed_hash_counts_host_words_on_the_cpu(n_repeats):
    attrs, words = _seed_hash_attrs("cpu", n_repeats)
    assert attrs == {"host_words": words}


def test_run_ids_follow_the_chunks():
    TR.enable()
    eng = ga.Engine(SPEC, "reference", options=CPU)
    teles = list(eng.run_chunked(chunk_generations=5))
    names = _by_name(TR.records())
    e = eng.trace_run
    assert [t["chunk"] for t in teles] == [1, 2, 3]
    assert [r["run"] for r in names["engine.chunk"]] == [(e, 1), (e, 2),
                                                        (e, 3)]
    chunk_of = {r["id"]: r["run"] for r in names["engine.chunk"]}
    assert [chunk_of[r["parent"]] for r in names["topology.segment"]] == [
        (e, 1), (e, 2), (e, 3)]
    assert [r["run"] for r in names["topology.segment"]] == [
        (e, 1), (e, 2), (e, 3)]
    assert [r["run"] for r in names["segment.result"]] == [
        (e, 1), (e, 2), (e, 3)]
    assert [r["run"] for r in names["segment.fold"]] == [
        (e, 1), (e, 2), (e, 3)]
    # chunks of 5, 5 and 2 generations, a sample each, 2 replicas of V=3
    assert [r["attrs"]["readback_bytes"] for r in names["segment.result"]
            ] == [4 * (2 * g * 2 + 2 + 2 * 3) for g in (5, 5, 2)]
    # init_state runs before the first chunk, under the engine's own id
    assert [r["run"] for r in names["engine.init_state"]] == [(e, None)]
    assert names["engine.init_state"][0]["parent"] is None
    # the reference executor launches nothing
    assert "executor.launch" not in names
    # two engines, two ids
    other = ga.Engine(SPEC, "reference", options=CPU)
    assert other.trace_run != e


def test_counts_go_to_the_innermost_span_of_their_thread():
    TR.enable()
    seen = {}

    def worker():
        with TR.span("worker", "w"):
            TR.count("items", 3)
        seen["parent"] = TR.records()[-1]["parent"]

    with TR.span("outer", "r") as outer:
        with TR.span("inner", x=1):
            TR.count("items")
            TR.count("items", 4)
        outer.set("k", "v")
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    TR.count("nowhere")      # no span open: nothing to add to
    recs = _by_name(TR.records())
    assert recs["inner"][0]["attrs"] == {"x": 1, "items": 5}
    assert recs["inner"][0]["run"] == "r"
    assert recs["outer"][0]["attrs"] == {"k": "v"}
    assert recs["worker"][0]["attrs"] == {"items": 3}
    assert seen["parent"] is None and recs["worker"][0]["run"] == "w"


def test_store_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(TR, "CAPACITY", 5)
    TR.enable()
    for i in range(8):
        with TR.span("s", i=i):
            pass
    recs = TR.records()
    assert [r["attrs"]["i"] for r in recs] == [0, 1, 2, 3, 4]
    assert TR.dropped() == 3
    TR.clear()
    assert TR.records() == [] and TR.dropped() == 0


def test_profiler_sees_the_spans_as_annotations(tmp_path):
    TR.enable()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        _chunks("fused")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"
              and e.get("name", "").startswith(TR.PREFIX)]
    chunks = [e for e in events if e["name"] == "repro_torch.engine.chunk"]
    segs = [e for e in events if e["name"] == "repro_torch.topology.segment"]
    launches = [e for e in events
                if e["name"] == "repro_torch.executor.launch"]
    assert len(chunks) == len(segs) == 2 and len(launches) == 3
    for c, s in zip(sorted(chunks, key=lambda e: e["ts"]),
                    sorted(segs, key=lambda e: e["ts"])):
        assert c["ts"] <= s["ts"]
        assert s["ts"] + s["dur"] <= c["ts"] + c["dur"]


def test_no_profiler_no_record_function(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    TR.enable()
    _chunks("fused")
    ga.solve(SPEC, "fused", options=CPU)
    assert TR.records() and entered == []


def _words(state):
    return [leaf.cpu().numpy() for leaf in state]


@pytest.mark.parametrize("backend", ["fused", "reference"])
def test_results_are_bit_equal_on_and_off(backend):
    def both():
        states = []
        res = ga.solve(SPEC, backend, options=CPU)
        return res, _chunks(backend, states), states

    off_res, off_chunks, off_states = both()
    TR.enable()
    on_res, on_chunks, on_states = both()
    assert TR.records()
    assert len(off_states) == len(on_states) == 2
    for sa, sb in zip([off_res.state] + off_states,
                      [on_res.state] + on_states):
        for a, b in zip(_words(sa), _words(sb)):
            np.testing.assert_array_equal(a, b)
    rep_a, rep_b = off_res.telemetry.per_repeat, on_res.telemetry.per_repeat
    for name in ("best", "best_x", "traj_best", "traj_mean"):
        np.testing.assert_array_equal(getattr(rep_a, name),
                                      getattr(rep_b, name))
    assert off_res.best_fitness == on_res.best_fitness
    assert len(off_chunks) == len(on_chunks) == 2
    for a, b in zip(off_chunks, on_chunks):
        ra, rb = a["telemetry"].per_repeat, b["telemetry"].per_repeat
        for name in ("best", "best_x", "traj_best", "traj_mean"):
            np.testing.assert_array_equal(getattr(ra, name),
                                          getattr(rb, name))
        assert a["best_fitness"] == b["best_fitness"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("problem,n,gpe", [("rastrigin:10", 1024, 32),
                                           ("rastrigin:100", 4096, 1)])
def test_segment_counts_and_times_on_the_card(cuda_device, problem, n, gpe):
    """Both forms of K1: a segment's `kernel_launches.*` counters are the
    `LAUNCHES` delta over it, and its timing events give non-negative
    `device_ms` and, after the first segment, `gap_before_ms`."""
    spec = ga.GASpec(problem=problem, n=n, bits_per_var=16, mode="arith",
                     mutation_rate=0.02, generations=3 * gpe, n_repeats=4,
                     gens_per_epoch=gpe, seed=11)
    opts = ga.EngineOptions(device="cuda", cost_table=False, faults=False)
    eng = ga.Engine(spec, "fused", options=opts)
    TR.enable()
    before = dict(K.LAUNCHES)
    teles = list(eng.run_chunked(chunk_generations=gpe))
    delta = {k: v - before[k] for k, v in K.LAUNCHES.items()
             if v != before[k]}
    segs = _by_name(TR.records())["topology.segment"]
    assert len(segs) == len(teles) == 3
    counted = {}
    for s in segs:
        for key, n_k in s["attrs"].items():
            if key.startswith("kernel_launches."):
                name = key[len("kernel_launches."):]
                counted[name] = counted.get(name, 0) + n_k
    assert counted == delta and sum(delta.values()) > 0
    for i, s in enumerate(segs):
        assert s["attrs"]["device_ms"] >= 0
        assert ("gap_before_ms" in s["attrs"]) == (i > 0)
        if i:
            assert s["attrs"]["gap_before_ms"] >= 0
    waits = _by_name(TR.records())["segment.wait"]
    assert len(waits) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("n_repeats", [1, 51])
def test_seed_hash_counts_device_words_on_the_card(cuda_device, n_repeats):
    attrs, words = _seed_hash_attrs("cuda", n_repeats)
    assert attrs == {"device_words": words}
