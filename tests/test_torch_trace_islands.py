"""The island ring's spans (`IslandRingTopology.segment`): a
`topology.segment` span under each run or chunk with the plan's mode and
its intervals and migrations, a `topology.launch` span a runner call, a
`segment.fold` span around the fold's enqueue after the last launch
(counter `intervals_folded`), a `segment.result` span around the
read-back (counter `readback_bytes`); on a mesh the
same spans without timing events; no result changes with the recorder
on.  The `cuda` case holds the segment's launch counters and timing
events on the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_trace_islands.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import ga
from repro_torch import trace as TR
from repro_torch.kernels import ga_step as K
from repro_torch.launch.mesh import Mesh

CPU = ga.EngineOptions(device="cpu", cost_table=False, faults=False)
# 16 generations: 8 intervals of 2, 4 resident launches of 2 intervals
SPEC = ga.GASpec(problem="rastrigin:3", n=16, bits_per_var=10, mode="arith",
                 generations=16, n_repeats=2, n_islands=4, migrate_every=2,
                 gens_per_epoch=4, seed=7)


@pytest.fixture(autouse=True)
def _recorder(monkeypatch):
    """Each test starts and ends with the recorder off and empty, and no
    ambient cost table moves a plan."""
    monkeypatch.setenv("REPRO_GA_COST_TABLE", "off")
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


# bytes read back a chunk: launch means [L, R, I * samples a launch], best
# [R], best_x [R, V], traj_best [L, R] (R 2, I 4, V 3); a gridded launch's
# means are its 2 generations'
READBACK = {"resident": 4 * (2 * 8 + 2 + 6 + 2 * 2),
            "gridded": 4 * (4 * 16 + 2 + 6 + 4 * 2)}


@pytest.mark.parametrize("backend,plan,launches", [
    ("fused-islands", "resident", 2), ("islands", "gridded", 4)])
def test_segment_spans_follow_the_chunks(backend, plan, launches):
    """Two chunks of 8 generations: each chunk's segment holds its plan,
    its 4 intervals and migrations, a launch span a runner call, one fold
    span after the last launch and one result span, under the chunk's run
    id."""
    TR.enable()
    eng = ga.Engine(SPEC, backend, options=CPU)
    teles = list(eng.run_chunked(chunk_generations=8))
    recs = TR.records()
    names = _by_name(recs)
    ids = {r["id"]: r for r in recs}
    e = eng.trace_run
    segs = names["topology.segment"]
    assert [r["run"] for r in segs] == [(e, 1), (e, 2)]
    assert [ids[r["parent"]]["name"] for r in segs] == ["engine.chunk"] * 2
    # K2 holds c = 10 words in 16 bits, at N = 16 one thread a pair; the
    # plain islands backend runs no kernel and has no layout
    layout = ({"population_bits": 16, "pair_threads": 1}
              if plan == "resident" else {})
    for seg, tele in zip(segs, teles):
        topo = tele["telemetry"].topology
        assert seg["attrs"] == {"plan": plan, "intervals": 4,
                                "migrations": topo.migrations, **layout}
        assert topo.migrations == 4 and topo.launches == launches
        assert tele["telemetry"].plan.mode == plan
    seg_ids = [r["id"] for r in segs]
    for name, each in (("topology.launch", launches), ("segment.fold", 1),
                       ("segment.result", 1)):
        under = [r["parent"] for r in names[name]]
        assert under == [i for i in seg_ids for _ in range(each)], name
        assert [r["run"] for r in names[name]] == [
            (e, c) for c in (1, 2) for _ in range(each)]
    # the fold is enqueued after the last launch, before the read-back
    for seg, fold, res in zip(segs, names["segment.fold"],
                              names["segment.result"]):
        assert fold["attrs"] == {"intervals_folded":
                                 seg["attrs"]["intervals"]}
        last = max(r["t1"] for r in names["topology.launch"]
                   if r["parent"] == seg["id"])
        assert last <= fold["t0"] and fold["t1"] <= res["t0"]
        assert res["attrs"] == {"readback_bytes": READBACK[plan]}
    for r in recs:
        if r["parent"]:
            up = ids[r["parent"]]
            assert up["t0"] <= r["t0"] and r["t1"] <= up["t1"]
    # on the CPU no timing events
    assert "segment.wait" not in names


def test_without_a_ring_the_segment_counts_no_migrations():
    spec = dataclasses.replace(SPEC, migration="none")
    TR.enable()
    res = ga.solve(spec, "fused-islands", options=CPU)
    (seg,) = _by_name(TR.records())["topology.segment"]
    assert res.telemetry.topology.migrations == 0
    # gridded: K1's one-block form, 32-bit words, one thread a pair
    assert seg["attrs"] == {"plan": res.telemetry.plan.mode,
                            "population_bits": 32, "pair_threads": 1,
                            "intervals": 8, "migrations": 0}


def test_a_mesh_records_the_spans_without_timing_events():
    mesh = Mesh([torch.device("cpu")] * 2, ("islands",))
    opts = ga.EngineOptions(mesh=mesh, cost_table=False, faults=False)
    TR.enable()
    res = ga.solve(SPEC, "fused-islands", options=opts)
    names = _by_name(TR.records())
    (seg,) = names["topology.segment"]
    assert res.telemetry.plan.mode == "resident-sharded"
    assert seg["attrs"] == {"plan": "resident-sharded",
                            "population_bits": 16, "pair_threads": 1,
                            "intervals": 8, "migrations": 8}
    assert len(names["topology.launch"]) == res.telemetry.topology.launches
    assert len(names["segment.result"]) == 1
    (fold,) = names["segment.fold"]
    assert fold["parent"] == seg["id"]
    assert fold["attrs"] == {"intervals_folded": 8}
    assert "segment.wait" not in names


@pytest.mark.parametrize("bits,at_once,waves", [
    (10, 1, 2), (10, 2, 1), (17, 1, 2)])
def test_segment_reports_the_layout_and_cluster_waves(monkeypatch, bits,
                                                      at_once, waves):
    """A resident segment carries K2's population layout (16 bits at
    c <= 16, else 32) and counts `cluster_waves`: its launches times the
    waves its replicas' clusters take at the plan's clusters at once (a
    pretended count here, as the CPU has no clusters; without one the
    counter is absent)."""
    spec = dataclasses.replace(SPEC, bits_per_var=bits)
    monkeypatch.setattr(K, "clusters_at_once",
                        lambda cfg, i_local, device, *a: at_once)
    TR.enable()
    res = ga.solve(spec, "fused-islands", options=CPU)
    (seg,) = _by_name(TR.records())["topology.segment"]
    plan, topo = res.telemetry.plan, res.telemetry.topology
    assert plan.mode == "resident" and plan.clusters_at_once == at_once
    assert plan.population_bits == seg["attrs"]["population_bits"] \
        == (16 if bits <= 16 else 32)
    assert topo.launches == 4
    assert seg["attrs"]["cluster_waves"] == topo.launches * waves
    monkeypatch.setattr(K, "clusters_at_once",
                        lambda cfg, i_local, device, *a: None)
    TR.clear()
    ga.solve(spec, "fused-islands", options=CPU)
    (seg,) = _by_name(TR.records())["topology.segment"]
    assert "cluster_waves" not in seg["attrs"]


# (c, N, clusters of the pair block, of the two-lane block at once, the
# threads a pair): the two-lane form where K2's 16-bit block without data
# has one thread an individual at 32 <= N <= 512 and the card holds as
# many of its clusters as of the pair block's
LANE_CASES = [(10, 64, 62, 62, 2), (16, 256, 62, 62, 2),
              (10, 64, None, None, 2), (10, 64, 62, 61, 1),
              (17, 64, 62, 62, 1), (10, 16, 62, 62, 1), (10, 1024, 62, 62, 1)]


@pytest.mark.parametrize("c,n,pair,two,lanes", LANE_CASES)
def test_resident_plan_and_segment_carry_pair_threads(monkeypatch, c, n,
                                                     pair, two, lanes):
    """The resident plan records K2's threads a pair (`pair_threads`), the
    mapping `kernels.ga_step.pair_threads` picks from the shape and the
    clusters at once of either block (pretended here, as the CPU has none;
    without a count the shape decides), in the telemetry and on every
    `topology.segment`; the run is the same bit for bit under either."""
    spec = dataclasses.replace(SPEC, bits_per_var=c, n=n,
                               generations=8, n_repeats=1)
    monkeypatch.setattr(K, "clusters_at_once",
                        lambda cfg, i_local, device, program=None, lanes=1:
                        pair if lanes == 1 else two)
    TR.enable()
    res = ga.solve(spec, "fused-islands", options=CPU)
    (seg,) = _by_name(TR.records())["topology.segment"]
    plan = res.telemetry.plan
    assert plan.mode == "resident"
    assert plan.pair_threads == seg["attrs"]["pair_threads"] == lanes
    assert plan.clusters_at_once == (pair if lanes == 1 else two)
    ref = ga.solve(spec, "islands", options=CPU)
    for a, b in zip(_words(res.state), _words(ref.state)):
        np.testing.assert_array_equal(a, b)


def test_the_kernel_takes_two_lanes_only_where_they_fit():
    """`ga_epoch_kernel` refuses a second lane where K2 has no two-lane
    build (32-bit words, problem data, N past a block or below a warp) on
    every device, as the card would, and runs either mapping to the same
    outputs off the card."""
    cfg = SPEC.ga_config()
    for changes in (dict(c=17), dict(n=16), dict(n=1024)):
        assert not K.two_lanes_fit(dataclasses.replace(cfg, **changes))
    sized = dataclasses.replace(SPEC, n=64)
    prog, cfg = sized.program(), sized.ga_config()
    assert K.two_lanes_fit(cfg) and not K.two_lanes_fit(
        cfg, ga.GASpec(problem="rastrigin_sr:3", n=64, bits_per_var=10,
                       mode="arith").program())
    # [R, I, ...]: 2 groups of 4 islands
    g = list(ga.Engine(sized, "fused-islands", options=CPU).init_state()[:4])
    kw = dict(cfg=cfg, program=prog, migrate_every=2, intervals=2)
    one, two = (K.ga_epoch_kernel(*g, lanes=k, **kw) for k in (1, 2))
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="lanes=2"):
        K.ga_epoch_kernel(*g, lanes=2,
                          **dict(kw, cfg=dataclasses.replace(cfg, c=17)))
    with pytest.raises(ValueError, match="lanes=3"):
        K.ga_epoch_kernel(*g, lanes=3, **kw)


def _words(state):
    return [leaf.cpu().numpy() for leaf in state]


@pytest.mark.parametrize("backend", ["fused-islands", "islands"])
def test_results_are_bit_equal_on_and_off(backend):
    def both():
        res = ga.solve(SPEC, backend, options=CPU)
        eng = ga.Engine(SPEC, backend, options=CPU)
        return res, list(eng.run_chunked(chunk_generations=8))

    off_res, off_chunks = both()
    TR.enable()
    on_res, on_chunks = both()
    assert TR.records()
    for a, b in zip(_words(off_res.state), _words(on_res.state)):
        np.testing.assert_array_equal(a, b)
    pairs = [(off_res.telemetry.per_repeat, on_res.telemetry.per_repeat)]
    pairs += [(a["telemetry"].per_repeat, b["telemetry"].per_repeat)
              for a, b in zip(off_chunks, on_chunks)]
    assert len(pairs) == 3
    for ra, rb in pairs:
        for name in ("best", "best_x", "traj_best", "traj_mean"):
            np.testing.assert_array_equal(getattr(ra, name),
                                          getattr(rb, name))
    assert off_res.best_fitness == on_res.best_fitness


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_island_segment_counts_and_times_on_the_card(cuda_device):
    """A resident segment's `kernel_launches.ga_epoch` is the `LAUNCHES`
    delta over it, one `topology.launch` span a K2 call, and its timing
    events give non-negative `device_ms` and, after the first segment,
    `gap_before_ms`."""
    spec = ga.GASpec(problem="rastrigin:30", n=256, bits_per_var=16,
                     mode="arith", mutation_rate=0.02, generations=192,
                     n_repeats=4, n_islands=8, migrate_every=16,
                     gens_per_epoch=32, seed=11)
    opts = ga.EngineOptions(device="cuda", cost_table=False, faults=False)
    eng = ga.Engine(spec, "fused-islands", options=opts)
    TR.enable()
    before = dict(K.LAUNCHES)
    teles = list(eng.run_chunked(chunk_generations=64))
    delta = {k: v - before[k] for k, v in K.LAUNCHES.items()
             if v != before[k]}
    names = _by_name(TR.records())
    segs = names["topology.segment"]
    assert len(segs) == len(teles) == 3
    assert delta == {"ga_epoch": 6}
    at_once = teles[0]["telemetry"].plan.clusters_at_once
    assert at_once == K.max_active_clusters(spec.ga_config(), 8) >= 4
    for i, s in enumerate(segs):
        assert s["attrs"]["plan"] == "resident"
        assert s["attrs"]["population_bits"] == 16
        # 4 replicas' clusters: one wave a launch
        assert s["attrs"]["cluster_waves"] == 2
        assert s["attrs"]["kernel_launches.ga_epoch"] == 2
        assert s["attrs"]["migrations"] == 4
        assert s["attrs"]["device_ms"] >= 0
        assert ("gap_before_ms" in s["attrs"]) == (i > 0)
    assert len(names["topology.launch"]) == 6
    assert len(names["segment.wait"]) == 3
    # one fold a segment, enqueued before the segment's wait
    for s, fold, wait, res in zip(segs, names["segment.fold"],
                                  names["segment.wait"],
                                  names["segment.result"]):
        assert fold["parent"] == wait["parent"] == res["parent"] == s["id"]
        assert fold["attrs"] == {"intervals_folded": 4}
        assert fold["t1"] <= wait["t0"] and wait["t1"] <= res["t0"]
