"""`repro_torch.roofline.ga_measured_points` against the JAX package's
`repro.roofline.ga_measured_points`, row for row, on one cost table the
port's sweep wrote on the CPU (tables cross between the packages: the
same format and point fields).  The rows are dicts of strings, integers
and floats, compared exactly."""

import pytest

pytest.importorskip("torch")

from repro import roofline as JR  # noqa: E402
from repro.autotune import CostTable as JCostTable  # noqa: E402
from repro_torch import ga, roofline  # noqa: E402
from repro_torch.autotune import CostTable, sweep  # noqa: E402
from repro_torch.kernels import ga_step as K  # noqa: E402

BASE = dict(n=16, bits_per_var=8, mode="arith", mutation_rate=0.02, seed=1,
            generations=8, n_islands=2, migrate_every=4, gens_per_epoch=8)


@pytest.fixture(scope="module")
def table_path(tmp_path_factory):
    """One small sweep of the port on the CPU: two ring families, a
    resident-free one, and an 8-island one under a planning budget (so a
    streamed point), written to disk."""
    opts = ga.EngineOptions(device="cpu", cost_table=False)
    specs = [ga.GASpec(problem=p, **BASE) for p in ("F3", "rastrigin:4")]
    specs.append(ga.GASpec(problem="F3", migration="none",
                           **dict(BASE, generations=16, gens_per_epoch=16)))
    table = sweep(specs, backend="fused-islands", options=opts,
                  min_reps=2, max_reps=2)
    wide = ga.GASpec(problem="F3", **dict(BASE, n_islands=8))
    budget = K.resident_smem_bytes(wide.ga_config(), 5)
    sweep([wide], backend="fused-islands", table=table, min_reps=2,
          max_reps=2, options=ga.EngineOptions(device="cpu",
                                               cost_table=False,
                                               smem_budget=budget))
    path = tmp_path_factory.mktemp("roofline") / "table.json"
    table.save(str(path))
    return str(path)


def test_rows_match_jax_row_for_row(table_path):
    got = roofline.ga_measured_points(CostTable.load(table_path))
    want = JR.ga_measured_points(JCostTable.load(table_path))
    assert len(got) == len(want) > 0
    assert got == want
    assert {r["mode"] for r in got} >= {"resident", "gridded",
                                        "resident-free", "streamed"}


def test_frac_of_best_marks_each_family_winner(table_path):
    rows = roofline.ga_measured_points(CostTable.load(table_path))
    fams = {}
    for r in rows:
        key = (r["stage"], r["migration"], r["n"], r["i_local"], r["c"],
               r["shards"], r["E"])
        fams.setdefault(key, []).append(r["frac_of_best"])
    assert len(fams) == 4
    for fracs in fams.values():
        assert max(fracs) == 1.0
        assert all(0.0 < f <= 1.0 for f in fracs)
