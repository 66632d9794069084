"""CEC 2017 F5's form as a built-in problem of the port (`rastrigin_sr`):
its registry entry, its data (made once a program in a `fitness.data`
span, carried by the program to the executors and counted by the
constant gate), its equations, its place in the kernels' planning (the
data in the blocks' shared memory, the rows form of ga_ffm, a V past the
registers routed by a stated reason), and the segments' `ffm_data_bytes`.
The card's side is in `tests/test_torch_cuda.py`:

    PYTHONPATH=src python -m pytest -q tests/test_torch_rastrigin_sr.py
"""

import numpy as np
import pytest
import torch

from repro_torch import ga
from repro_torch import trace as TR
from repro_torch.core import fitness as F
from repro_torch.core import ga as G
from repro_torch.kernels import ga_step as K

CPU = ga.EngineOptions(device="cpu", cost_table=False, faults=False)
# the rotated cell's shape
CELL = G.GAConfig(n=256, c=16, v=30, mutation_rate=0.02, mode="arith",
                  sel_lane="gather")


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


def _prog(v, c=16):
    return F.compile_program(problem=f"rastrigin_sr:{v}", bits_per_var=c)


def test_the_registry_entry():
    pdef = F.PROBLEMS["rastrigin_sr"]
    assert pdef is F.BUILTIN["rastrigin_sr"]
    assert pdef.domain == (-100.0, 100.0) and pdef.min_vars == 2
    assert not pdef.separable and pdef.data is F.rastrigin_sr_data
    assert "rastrigin_sr" in F.PORT_ONLY
    prog = _prog(30)
    assert prog.modes == ("arith",) and prog.domains == ((-100.0, 100.0),) * 30
    assert K.problem_id(prog) == K.PROBLEM_IDS["rastrigin_sr"] == 7


@pytest.mark.parametrize("v", [2, 4, 30])
def test_the_program_carries_its_data(v):
    prog = _prog(v)
    assert prog.data.dtype == np.float32 and prog.data.shape == (v + v * v,)
    assert prog.data_bytes == 4 * (v + v * v)
    assert np.array_equal(prog.data, F.rastrigin_sr_data(v))
    assert prog.device_data("cpu") is prog.device_data("cpu")
    assert torch.equal(prog.device_data("cpu"), torch.from_numpy(prog.data))
    assert K.ffm_const_bytes(prog) == 8 * v + prog.data_bytes
    assert _prog(30).data_bytes == 3720
    plain = F.compile_program(problem=f"rastrigin:{v}", bits_per_var=16)
    assert plain.data is None and plain.data_bytes == 0
    assert plain.device_data("cpu") is None


def test_the_optimum_is_the_bias_at_the_shift():
    """At x = o every y and z is 0, so F5 is its bias, 500, exactly; one
    step away along a variable it is not."""
    pdef = F.PROBLEMS["rastrigin_sr"]
    for v in (2, 10, 30):
        o = torch.from_numpy(F.rastrigin_sr_data(v)[:v])
        assert pdef.f(o.numpy()).item() == 500.0
        off = o.clone()
        off[0] += 1.0
        assert pdef.f(off.numpy()).item() > 500.0


def test_the_objective_follows_its_equations_in_float64():
    """The float32 stage within float32 rounding of the equations in
    float64: y = 0.0512 (x - o), z = M y, Σ z^2 - 10 cos 2πz + 10, + 500."""
    v = 30
    prog = _prog(v)
    g = torch.Generator().manual_seed(1)
    x = torch.randint(0, 1 << 16, (256, v), generator=g,
                      dtype=torch.int64).to(torch.int32)
    lo, span = (t.double() for t in prog.device_consts("cpu"))
    val = lo + (x & 0xFFFF).double() * span
    o, m = F.rastrigin_sr_data64(v)
    z = ((val - torch.from_numpy(o)) * 0.0512) @ torch.from_numpy(m).T
    want = (z * z - 10.0 * torch.cos(2.0 * np.pi * z) + 10.0).sum(-1) + 500
    got = prog.stage(x).double()
    assert torch.allclose(got, want, rtol=2e-5, atol=0.0)


def test_the_blocks_hold_the_data():
    """At the rotated cell K2's block holds o and M (M's rows at a stride
    of 32) past the island cell's 51,900 B: 55,868 B, four a Hopper SM's
    233,472 B with their reserves; the island cell's block is unchanged."""
    prog = _prog(30)
    assert K.data_words(prog) == 32 * 31
    assert K.data_words(None) == 0
    assert K.data_words(F.compile_program(problem="rastrigin:30",
                                          bits_per_var=16)) == 0
    assert K.resident_block_bytes(CELL) == 51900
    assert K.resident_block_bytes(CELL, prog) == 51900 + 4 * 992 == 55868
    assert 4 * (55868 + 1024) <= 233472
    assert K.epoch_smem_bytes(256, 30, 6, 32, 992) == 82620 + 3968
    assert K.smem_bytes(256, 30, 6, 992) == K.smem_bytes(256, 30, 6) + 3968
    assert K.resident_smem_bytes(CELL, 8, prog) == 8 * 55868
    assert K.resident_fit_reason(CELL, 8, program=prog) is None
    assert K.resident_fit_reason(CELL, 8, budget=8 * 55868 - 1,
                                 program=prog) is not None
    assert K.resident_fit_reason(CELL, 8, budget=8 * 55868 - 1) is None


def test_ga_ffm_takes_its_rows_form():
    for n, r in ((256, 3), (1024, 512)):
        assert not K.ffm_spreads(n, 30, r, K.data_words(_prog(30)))
    assert K.ffm_spreads(256, 30, 3)


@pytest.mark.parametrize("v,routed", [(2, False), (32, False), (33, True),
                                      (64, True)])
def test_a_v_past_the_registers_is_routed_by_a_reason(v, routed):
    prog = _prog(v)
    cfg = G.GAConfig(n=16, c=16, v=v, mutation_rate=0.02, mode="arith",
                     sel_lane="gather")
    reason = K.block_reason(cfg, prog)
    assert (K.data_reason(prog) is not None) == routed
    assert (reason is not None) == routed
    assert K.hopper_reason(cfg, prog) is None
    if routed:
        assert "registers" in reason and "PyTorch stage" in reason
        with pytest.raises(ValueError, match="registers"):
            K.ga_ffm_kernel(torch.zeros((1, 16, v), dtype=torch.int32),
                            cfg=cfg, program=prog)
        cands = K.epoch_mode_candidates(
            cfg, 4, executor="fused", migration="ring", gens_per_epoch=4,
            migrate_every=2, program=prog)
        assert [c["mode"] for c in cands] == ["gridded"]
        assert cands[0]["fallback"] == reason


@pytest.mark.parametrize("v,plan", [(4, "resident"), (33, "gridded")])
def test_the_spec_runs_on_the_normal_path(v, plan):
    spec = ga.GASpec(problem=f"rastrigin_sr:{v}", n=16, bits_per_var=16,
                     mode="arith", generations=8, n_repeats=2, n_islands=4,
                     migrate_every=2, gens_per_epoch=4, seed=9)
    res = ga.solve(spec, "fused-islands", options=CPU)
    assert res.telemetry.plan.mode == plan
    ref = ga.solve(spec, "islands", options=CPU)
    for a, b in zip(res.state, ref.state):
        assert torch.equal(a, b)
    eng = ga.Engine(spec, "fused-islands", options=CPU)
    chunks = list(eng.run_chunked(chunk_generations=4, generations=8))
    assert len(chunks) == 2
    single = ga.GASpec(problem=f"rastrigin_sr:{v}", n=16, bits_per_var=16,
                       mode="arith", generations=8, n_repeats=2, seed=9)
    a = ga.solve(single, "fused", options=CPU)
    b = ga.solve(single, "reference", options=CPU)
    for x, y in zip(a.state, b.state):
        assert torch.equal(x, y)


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r["name"], []).append(r)
    return out


@pytest.mark.parametrize("problem,data", [("rastrigin_sr:30", 3720),
                                          ("rastrigin:30", None)])
@pytest.mark.parametrize("backend,islands", [("fused-islands", 4),
                                             ("fused", 1)])
def test_the_spans_count_the_data(problem, data, backend, islands):
    """`fitness.data` (counter `data_bytes`) where a program's data is
    made, and `ffm_data_bytes` on both topologies' `topology.segment`,
    3,720 at V = 30; neither for classic Rastrigin."""
    kw = (dict(n_islands=islands, migrate_every=2, gens_per_epoch=4)
          if islands > 1 else {})
    spec = ga.GASpec(problem=problem, n=16, bits_per_var=16, mode="arith",
                     generations=4, n_repeats=2, seed=1234 + islands, **kw)
    TR.enable()
    F.compile_program(problem=problem, bits_per_var=16)
    ga.solve(spec, backend, options=CPU)
    TR.disable()
    spans = _by_name(TR.records())
    made = spans.get("fitness.data", [])
    segs = spans["topology.segment"]
    if data is None:
        assert not made
        assert all("ffm_data_bytes" not in s["attrs"] for s in segs)
    else:
        assert made and all(s["attrs"] == {"data_bytes": data}
                            for s in made)
        assert all(s["attrs"]["ffm_data_bytes"] == data for s in segs)
