"""The island ring on a device mesh (`repro_torch.launch.mesh`, the sharded
migration of `core.islands`, the sharded plans of `IslandRingTopology`,
`restore(shardings=)`, the scheduler's `mesh=` and the launchers'
`--mesh`) on the CPU, held against the JAX package from the same seeds.

* Meshes of 1, 2, 4 and 2x4 logical shards of the CPU stand where the JAX
  tests use XLA's fake host devices: every sharded code path runs, the
  ring's order is the shards' logical order.
* `migrate_ring_sharded` is exact selects: bit-exact against both
  packages' `migrate_ring`.
* Sharded runs of `islands` and `fused-islands` (every plan a mesh has:
  gridded, resident-sharded, streamed) against the JAX package's
  unsharded `islands` on JAX's `_spec` of tests/test_topology.py with 8
  islands: state and best_x bit for bit.  In LUT mode best_y and
  traj_best are bit for bit as well.  In arith mode XLA's CPU jit
  contracts the decode into an FMA (hazard H1), so there best_y and
  traj_best are held bit for bit to the port's own unsharded `islands`,
  and to JAX within ``1e-6 * max|y|`` (the bound of
  tests/test_torch_islands.py).
* One subprocess runs JAX's `islands` on a (2, 4) mesh of 8 fake XLA
  devices and checkpoints it; the port's 2x4 CPU mesh equals that run and
  resumes that checkpoint.
"""

import functools
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import autotune as JAT  # noqa: E402
from repro import ga as JGA  # noqa: E402
from repro.core import ga as JG  # noqa: E402
from repro.core import islands as JISL  # noqa: E402
from repro.ga import compile_cache as JCC  # noqa: E402
from repro.kernels import ga_step as JK  # noqa: E402
from repro_torch import convert, ga  # noqa: E402
from repro_torch.autotune import CostTable  # noqa: E402
from repro_torch.autotune import runner as RUN  # noqa: E402
from repro_torch.ckpt import checkpoint as CKPT  # noqa: E402
from repro_torch.core import ga as TG  # noqa: E402
from repro_torch.core import islands as TISL  # noqa: E402
from repro_torch.ga import compile_cache as CC  # noqa: E402
from repro_torch.ga.options import resolve_options  # noqa: E402
from repro_torch.kernels import ga_step as K  # noqa: E402
from repro_torch.launch import ga_run  # noqa: E402
from repro_torch.launch.mesh import Mesh, parse_mesh  # noqa: E402
from repro_torch.serve.engine import GAMetricsRegistry  # noqa: E402
from repro_torch.serve.scheduler import GAScheduler  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_DEV = torch.device("cpu")


@pytest.fixture(autouse=True)
def _no_ambient_cost_table(monkeypatch):
    """The plans here are the heuristic's: no cost table found on the host
    may move them."""
    monkeypatch.setenv("REPRO_GA_COST_TABLE", "off")


def _mesh(name: str) -> Mesh:
    """A mesh of logical shards of the CPU: "4" is 1-D, "2x4" (data, model)."""
    dims = tuple(int(d) for d in name.split("x"))
    axes = ("islands",) if len(dims) == 1 else ("data", "model")
    devs = np.empty(int(np.prod(dims)), dtype=object)
    devs[:] = [CPU_DEV] * devs.size
    return Mesh(devs.reshape(dims), axes)


MESHES = ["1", "2", "4", "2x4"]
STATE_NAMES = ("x", "sel", "cross", "mut", "k")


def _kw(**kw):
    """JAX's `_spec` of tests/test_topology.py with 8 islands and one
    interval a launch, so every plan samples the trajectory as `islands`
    does."""
    base = dict(problem="F3", n=32, bits_per_var=10, mode="arith",
                mutation_rate=0.05, seed=11, generations=15,
                n_islands=8, migrate_every=5, gens_per_epoch=5)
    base.update(kw)
    return base


def _opts(mesh=None, **kw):
    if mesh is None:
        return ga.EngineOptions(device="cpu", **kw)
    return ga.EngineOptions(mesh=mesh, **kw)


def _segment(kw, backend, mesh=None, **opts):
    eng = ga.Engine(ga.GASpec(**kw), backend, options=_opts(mesh, **opts))
    return eng.backend.segment(eng.init_state(), kw["generations"])


@functools.lru_cache(maxsize=None)
def _jax_islands(items):
    kw = dict(items)
    eng = JGA.Engine(JGA.GASpec(**kw), "islands")
    seg = eng.backend.segment(eng.init_state(), kw["generations"])
    state = tuple(np.asarray(t) for t in (seg.state.x, seg.state.sel_lfsr,
                                          seg.state.cross_lfsr,
                                          seg.state.mut_lfsr, seg.state.k))
    # the H1 bound of tests/test_torch_islands.py: 1e-6 of the final
    # populations' max|y|
    y = JGA.GASpec(**kw).program().stage(seg.state.x)
    bound = 1e-6 * float(np.max(np.abs(np.asarray(y))))
    return (state, seg.best_y, np.asarray(seg.best_x),
            np.asarray(seg.traj_best), bound)


@functools.lru_cache(maxsize=None)
def _port_islands(items):
    return _segment(dict(items), "islands")


def _refs(kw):
    items = tuple(sorted(kw.items()))
    return _jax_islands(items), _port_islands(items)


def _assert_state(got, want, tag=""):
    for name, a, b in zip(STATE_NAMES, got, want):
        np.testing.assert_array_equal(a, b, err_msg=f"{tag} {name}")


def _assert_matches(seg, kw, tag):
    """`seg` against JAX's unsharded islands and the port's (see the
    module docstring for which fields are bit for bit where)."""
    (jstate, jbest, jbx, jtraj, bound), port = _refs(kw)
    _assert_state(convert.state_to_numpy(seg.state), jstate, tag)
    np.testing.assert_array_equal(seg.best_x, jbx, err_msg=tag)
    assert seg.best_y == port.best_y, tag
    np.testing.assert_array_equal(seg.traj_best, port.traj_best,
                                  err_msg=tag)
    if kw["mode"] == "lut":
        assert seg.best_y == jbest, tag
        np.testing.assert_array_equal(seg.traj_best, jtraj, err_msg=tag)
    else:
        assert abs(seg.best_y - jbest) <= bound, tag
        assert np.max(np.abs(seg.traj_best - jtraj)) <= bound, tag


# ---------------------------------------------------------------------------
# the mesh and the sharded migration
# ---------------------------------------------------------------------------


def test_shard_order_is_row_major_over_the_named_axes():
    cards = np.empty(8, dtype=object)
    cards[:] = [torch.device("cuda", i) for i in range(8)]
    mesh = Mesh(cards.reshape(2, 4), ("data", "model"))
    assert mesh.shape == {"data": 2, "model": 4} and mesh.size == 8
    idx = lambda axes: [d.index for d in mesh.shard_devices(axes)]
    assert idx(("data", "model")) == list(range(8))
    assert idx(("model", "data")) == [0, 4, 1, 5, 2, 6, 3, 7]
    assert idx(("model",)) == [0, 1, 2, 3]
    assert idx(("data",)) == [0, 4]
    assert mesh.first_device == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="not in the mesh"):
        mesh.shard_devices(("x",))


@pytest.mark.parametrize("minimize", [True, False])
@pytest.mark.parametrize("lead", [(), (2,)], ids=["solo", "replicas"])
@pytest.mark.parametrize("mesh_name", MESHES + ["none"])
def test_migrate_ring_sharded_matches_migrate_ring(mesh_name, lead,
                                                    minimize):
    rng = np.random.default_rng(5)
    islands, n, v = 8, 16, 3
    x = rng.integers(0, 2 ** 32, size=lead + (islands, n, v),
                     dtype=np.uint32)
    y = rng.integers(0, 4, size=lead + (islands, n)).astype(np.float32)
    zeros = np.zeros(lead + (islands, 1), np.uint32)
    k = np.zeros(lead + (islands,), np.int32)
    state = convert.state_from_numpy(x, zeros, zeros, zeros, k,
                                     device=CPU_DEV)
    yt = torch.from_numpy(y)
    whole, wex, wey = TISL.migrate_ring(state, yt, minimize=minimize)

    # "none": no mesh, the whole stack as one shard
    mesh = None if mesh_name == "none" else _mesh(mesh_name)
    axes = () if mesh is None else mesh.axis_names
    s = 1 if mesh is None else mesh.size
    a, il = len(lead), islands // s
    parts = [TG.GAState(*(t.narrow(a, j * il, il) for t in state))
             for j in range(s)]
    ys = [yt.narrow(a, j * il, il) for j in range(s)]
    got, gex, gey = TISL.migrate_ring_sharded(parts, ys, minimize=minimize,
                                              mesh=mesh, axis_names=axes)
    x_sharded = torch.cat([p.x for p in got], dim=a)
    assert torch.equal(x_sharded, whole.x)
    assert torch.equal(torch.cat(gex, dim=a), wex)
    assert torch.equal(torch.cat(gey, dim=a), wey)

    for r in (range(lead[0]) if lead else [None]):
        sl = (lambda t: t) if r is None else (lambda t: t[r])
        jst = JG.GAState(jnp.asarray(sl(x)), jnp.asarray(sl(zeros)),
                         jnp.asarray(sl(zeros)), jnp.asarray(sl(zeros)),
                         jnp.asarray(sl(k)))
        jnew, jex, _ = JISL.migrate_ring(jst, jnp.asarray(sl(y)),
                                         minimize=minimize)
        np.testing.assert_array_equal(
            sl(convert.words_to_numpy(x_sharded)), np.asarray(jnew.x))
        np.testing.assert_array_equal(
            sl(convert.words_to_numpy(torch.cat(gex, dim=a))),
            np.asarray(jex))


# ---------------------------------------------------------------------------
# sharded runs against the JAX package's unsharded islands
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("migration", ["ring", "none"])
@pytest.mark.parametrize("n_repeats", [1, 2])
@pytest.mark.parametrize("mesh_name", MESHES)
def test_sharded_runs_match_jax_islands(mesh_name, n_repeats, migration):
    mesh = _mesh(mesh_name)
    kw = _kw(n_repeats=n_repeats, migration=migration)
    heur = "resident-sharded" if migration == "ring" else "gridded"
    for backend, plan, mode in (("islands", None, "gridded"),
                                ("fused-islands", None, heur),
                                ("fused-islands", "gridded", "gridded")):
        seg = _segment(kw, backend, mesh, plan_override=plan)
        tag = f"{backend} {mode} on {mesh_name}"
        assert seg.telemetry.plan.mode == mode, tag
        _assert_matches(seg, kw, tag)
        topo = seg.telemetry.topology
        assert (topo.n_shards, topo.sharded, topo.launches,
                topo.migrations) == (mesh.size, True, 3,
                                     3 if migration == "ring" else 0), tag


@pytest.mark.parametrize("mesh_name", MESHES)
def test_sharded_islands_bit_exact_against_jax_in_lut_mode(mesh_name):
    kw = _kw(mode="lut", n_repeats=2)
    seg = _segment(kw, "islands", _mesh(mesh_name))
    _assert_matches(seg, kw, f"lut on {mesh_name}")


@pytest.mark.parametrize("n_repeats", [1, 2])
@pytest.mark.parametrize("mesh_name", MESHES)
def test_sharded_streamed_matches_jax_islands(mesh_name, n_repeats):
    """72 islands: 9 or more a shard on every mesh, past the 8-island
    cluster, so the heuristic is streamed (K3's one-interval form a shard
    and interval, the splice in PyTorch)."""
    mesh = _mesh(mesh_name)
    kw = _kw(n_islands=72, n_repeats=n_repeats)
    seg = _segment(kw, "fused-islands", mesh)
    plan = seg.telemetry.plan
    assert (plan.mode, plan.tile_islands) == ("streamed", 1)
    assert "cluster" in plan.fallback
    _assert_matches(seg, kw, f"streamed on {mesh_name}")


def test_streamed_on_a_mesh_launches_one_interval_a_shard(monkeypatch):
    """Two intervals a launch on 2 shards: 2 launches of the one-interval
    form a shard and interval (never splice=True), and the run equals the
    unsharded streamed run (K3 with the ring inside) in everything."""
    calls = []
    real = K.ga_streamed_epoch_kernel

    def counted(*a, **kw):
        calls.append((kw.get("intervals", 1), kw.get("splice", False)))
        return real(*a, **kw)

    kw = _kw(n_islands=18, gens_per_epoch=10, generations=20)
    whole = _segment(kw, "fused-islands")
    monkeypatch.setattr(K, "ga_streamed_epoch_kernel", counted)
    seg = _segment(kw, "fused-islands", _mesh("2"))
    assert seg.telemetry.plan.mode == whole.telemetry.plan.mode == "streamed"
    assert seg.telemetry.topology.launches == 2
    assert calls == [(1, False)] * (2 * 2 * 2)
    _assert_state(convert.state_to_numpy(seg.state),
                  convert.state_to_numpy(whole.state))
    assert seg.best_y == whole.best_y
    np.testing.assert_array_equal(seg.best_x, whole.best_x)
    np.testing.assert_array_equal(seg.traj_best, whole.traj_best)


def test_sharded_candidates_follow_jax(monkeypatch):
    """The sharded candidate lists: resident-sharded (one interval a
    launch) then gridded where the local islands fit a cluster, as the
    JAX planner lists them; streamed past the cluster, its tile from the
    card's capacity (pretended here); only gridded without migration."""
    cfg = TG.GAConfig(n=32, c=10, v=2, mode="arith", sel_lane="gather")
    args = dict(executor="fused", gens_per_epoch=10, migrate_every=5)
    jcfg = JGA.GASpec(**_kw(sel_lane="gather")).ga_config()
    keys = ("mode", "epochs_per_launch", "gens_per_launch")
    for migration in ("ring", "none"):
        for i_local in (1, 4, 8):
            got = K.epoch_mode_candidates(cfg, i_local, migration=migration,
                                          sharded=True, **args)
            want = JK.epoch_mode_candidates(
                jcfg, i_local, migration=migration, sharded=True, **args)
            assert [{k: c[k] for k in keys} for c in got] == \
                [{k: c[k] for k in keys} for c in want]
    monkeypatch.setattr(K, "streamed_capacity", lambda cfg, device, *a: 8)
    got = K.epoch_mode_candidates(cfg, 16, migration="ring", sharded=True,
                                  groups=2, device=torch.device("cuda"),
                                  **args)
    assert [c["mode"] for c in got] == ["streamed", "gridded"]
    assert got[0]["tile_islands"] == 4


# ---------------------------------------------------------------------------
# JAX on 8 fake XLA devices
# ---------------------------------------------------------------------------


JAX_MESH_RUN = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from repro import ga
out = sys.argv[1]
mesh = jax.make_mesh((2, 4), ("data", "model"))
spec = ga.GASpec(**{kw})
eng = ga.Engine(spec, "islands", mesh=mesh)
seg = eng.backend.segment(eng.init_state(), spec.generations)
t = seg.telemetry.topology
np.savez(os.path.join(out, "seg.npz"), x=np.asarray(seg.state.x),
         sel=np.asarray(seg.state.sel_lfsr),
         cross=np.asarray(seg.state.cross_lfsr),
         mut=np.asarray(seg.state.mut_lfsr), k=np.asarray(seg.state.k),
         best_y=seg.best_y, best_x=np.asarray(seg.best_x),
         traj_best=np.asarray(seg.traj_best), n_shards=t.n_shards,
         sharded=t.sharded)
chunks = ga.Engine(spec, "islands", mesh=mesh).run_chunked(
    chunk_generations=5, ckpt_dir=os.path.join(out, "ckpt"))
for _ in range(2):
    next(chunks)
print("JAX_MESH_OK")
"""


@pytest.fixture(scope="module")
def jax_mesh_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_mesh")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c",
                        JAX_MESH_RUN.format(kw=repr(_kw())), str(out)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "JAX_MESH_OK" in r.stdout
    return out


def test_jax_8_device_mesh_equals_the_port_on_a_2x4_mesh(jax_mesh_run):
    want = np.load(jax_mesh_run / "seg.npz")
    assert (int(want["n_shards"]), bool(want["sharded"])) == (8, True)
    seg = _segment(_kw(), "islands", _mesh("2x4"))
    _assert_state(convert.state_to_numpy(seg.state),
                  [want[n] for n in STATE_NAMES], "2x4")
    np.testing.assert_array_equal(seg.best_x, want["best_x"])
    assert (seg.telemetry.topology.n_shards,
            seg.telemetry.topology.sharded) == (8, True)
    # fitness: the H1 bound against XLA's jitted stage (module docstring)
    bound = _refs(_kw())[0][4]
    assert abs(seg.best_y - float(want["best_y"])) <= bound
    assert np.max(np.abs(seg.traj_best - want["traj_best"])) <= bound


@pytest.mark.parametrize("target", ["4", None])
def test_jax_sharded_checkpoint_resumes_in_the_port(jax_mesh_run, tmp_path,
                                                    target):
    import shutil
    ckpt = tmp_path / "ckpt"
    shutil.copytree(jax_mesh_run / "ckpt", ckpt)
    assert CKPT.latest_step(str(ckpt)) == 10
    mesh = _mesh(target) if target else None
    spec = ga.GASpec(**_kw())
    last = list(ga.Engine(spec, "islands", options=_opts(mesh)).run_chunked(
        chunk_generations=5, ckpt_dir=str(ckpt)))
    assert [t["resumed_from"] for t in last] == [10]
    straight = tmp_path / "straight"
    list(ga.Engine(spec, "islands", options=_opts()).run_chunked(
        chunk_generations=5, ckpt_dir=str(straight)))
    _assert_same_checkpoint(str(ckpt), str(straight), 15)


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------


def _jax_mesh_stub(mesh: Mesh):
    """What the JAX capability gates read of a mesh (names and shape), so
    they can be asked without 8 XLA devices."""
    return types.SimpleNamespace(axis_names=mesh.axis_names,
                                 shape=dict(mesh.shape))


@pytest.mark.parametrize("kw", [
    dict(), dict(n_islands=6), dict(mesh_axes=("x",)),
    dict(mesh_axes=("model",), n_islands=4), dict(n_islands=1)],
    ids=["divides", "does-not-divide", "axis-missing", "sub-axes",
         "single"])
def test_capability_gates_match_jax(kw):
    """Every backend's answer on a 2x4 mesh, message for message."""
    mesh = _mesh("2x4")
    got = ga.capability_matrix(ga.GASpec(**_kw(**kw)), mesh)
    want = JGA.capability_matrix(JGA.GASpec(**_kw(**kw)),
                                 _jax_mesh_stub(mesh))
    assert got == want


def test_auto_never_picks_a_single_topology_on_a_mesh():
    single = ga.GASpec(**_kw(n_islands=1))
    assert ga.resolve_backend(single, "auto", "cpu", _mesh("1")) == "islands"
    assert JGA.resolve_backend(JGA.GASpec(**_kw(n_islands=1)), "auto",
                               _jax_mesh_stub(_mesh("1"))) == "islands"
    with pytest.raises(ga.BackendUnsupported):
        ga.resolve_backend(single, "auto", "cpu", _mesh("2"))
    with pytest.warns(UserWarning, match="falling back to 'islands'"):
        assert ga.resolve_backend(single, "reference", "cpu",
                                  _mesh("1")) == "islands"
    assert "silently ignore the mesh" in \
        ga.backends.SingleTopology.supports(single, _mesh("1"))


def test_resident_sharded_needs_a_mesh():
    kw = _kw()
    with pytest.raises(ValueError, match="resident-sharded needs a mesh"):
        _segment(kw, "fused-islands", plan_override="resident-sharded")
    seg = _segment(kw, "fused-islands", _mesh("2"),
                   plan_override="resident-sharded")
    assert (seg.telemetry.plan.mode, seg.telemetry.plan.source) == \
        ("resident-sharded", "forced")
    with pytest.raises(ValueError, match="not feasible"):
        _segment(kw, "fused-islands", _mesh("2"), plan_override="resident")


def test_parse_mesh_counts_real_devices(monkeypatch):
    assert parse_mesh("auto", device="cpu").size == 1
    assert parse_mesh("1x1", device="cpu").shape == {"data": 1, "model": 1}
    for spec in ("2", "2x4"):
        with pytest.raises(ValueError, match="asked for .* devices, have 1"):
            parse_mesh(spec, device="cpu")
    with pytest.raises(ValueError, match="want N, NxM or NxMxK"):
        parse_mesh("1x1x1x1", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    m = parse_mesh("2x2")
    assert [d.index for d in m.devices.flat] == [0, 1, 2, 3]
    assert parse_mesh("auto").shape == {"islands": 4}
    with pytest.raises(ValueError, match="asked for 8 devices, have 4"):
        parse_mesh("8")


def test_engine_options_take_the_device_from_the_mesh():
    mesh = _mesh("2")
    assert ga.EngineOptions(mesh=mesh).torch_device() == CPU_DEV
    assert ga.EngineOptions(mesh=mesh, device="cpu").torch_device() == \
        CPU_DEV
    with pytest.raises(ValueError, match="leave device unset"):
        ga.EngineOptions(mesh=mesh, device="cuda")
    assert resolve_options(None, mesh=mesh).mesh is mesh
    with pytest.raises(ValueError, match="both options= and legacy"):
        resolve_options(ga.EngineOptions(), mesh=mesh)
    with pytest.raises(ValueError, match="both options= and legacy"):
        GAScheduler(mesh=mesh, options=ga.EngineOptions())


def test_ga_run_takes_a_mesh(capsys):
    args = ["--device", "cpu", "--problem", "F3", "--n", "32", "--m", "20",
            "--mode", "arith", "--islands", "8", "--migrate-every", "5",
            "--gens-per-epoch", "5", "--k", "15", "--seed", "11",
            "--mutation-rate", "0.05", "--backend", "fused-islands"]
    ga_run.main(args + ["--mesh", "auto"])
    out = capsys.readouterr().out
    assert "mesh: {'islands': 1} (1 device(s))" in out
    assert "epoch plan: resident-sharded" in out
    assert "shards: 1 (8 island(s) each)" in out
    with pytest.raises(SystemExit) as e:
        ga_run.main(args + ["--mesh", "2"])
    assert e.value.code == 2


# ---------------------------------------------------------------------------
# keys and cost tables
# ---------------------------------------------------------------------------


def test_runner_keys_differ_across_meshes():
    spec = ga.GASpec(**_kw())
    key = lambda m: CC.runner_key(spec, "island_ring", "fused", "cpu",
                                  "gridded", mesh=m)
    assert key(_mesh("2")) == key(_mesh("2"))
    assert len({key(None), key(_mesh("2")), key(_mesh("4")),
                key(_mesh("2x4")), key(_mesh("1"))}) == 5
    cards = Mesh([torch.device("cuda", 0), torch.device("cuda", 1)],
                 ("islands",))
    assert CC.mesh_fingerprint(cards) != CC.mesh_fingerprint(_mesh("2"))
    CC.RUNNER_CACHE.reset()
    ga.Engine(spec, "fused-islands", options=_opts(_mesh("2")))
    misses = CC.RUNNER_CACHE.stats()["misses"]
    ga.Engine(spec, "fused-islands", options=_opts(_mesh("2")))
    assert CC.RUNNER_CACHE.stats()["misses"] == misses
    _segment(_kw(), "fused-islands", _mesh("4"))
    assert CC.RUNNER_CACHE.stats()["misses"] > misses


def test_a_sharded_cost_table_point_crosses_from_jax(tmp_path):
    kw = _kw(gens_per_epoch=10)
    jspec, spec = JGA.GASpec(**kw), ga.GASpec(**kw)
    jt = JAT.table.CostTable(host={"platform": "cpu", "device_count": 1})
    for mode, rate in (("resident-sharded", 100.0), ("gridded", 300.0)):
        pt = JCC.plan_point(jspec, executor="fused", mode=mode, n_shards=2)
        assert pt == CC.plan_point(spec, executor="fused", mode=mode,
                                   n_shards=2)
        assert pt["shards"] == 2 and pt["i_local"] == 4
        jt.add(pt, 5, rate, reps=3, cov=0.01)
    path = str(tmp_path / "t.json")
    jt.save(path)
    plan = ga.Engine(spec, "fused-islands", options=_opts(
        _mesh("2"), cost_table=path)).backend.topology.plan
    assert (plan["mode"], plan["plan_source"], plan["plan_gens_per_s"]) == \
        ("gridded", "measured", 300.0)
    # the same table does not cover the 4-shard point: the heuristic
    plan4 = ga.Engine(spec, "fused-islands", options=_opts(
        _mesh("4"), cost_table=path)).backend.topology.plan
    assert (plan4["mode"], plan4["plan_source"]) == \
        ("resident-sharded", "heuristic")


def test_a_sweep_on_a_mesh_measures_the_sharded_candidates():
    spec = ga.GASpec(**_kw(gens_per_epoch=10, sel_lane="gather"))
    ticks = iter(np.arange(0.0, 1000.0, 0.5))
    table = RUN.sweep([spec], backend="fused-islands",
                      options=_opts(_mesh("2")), min_reps=2, max_reps=2,
                      timer=lambda: float(next(ticks)))
    points = sorted((e["mode"], e["shards"], e["i_local"])
                    for e in table.entries())
    assert points == [("gridded", 2, 4), ("resident-sharded", 2, 4)]


# ---------------------------------------------------------------------------
# checkpoints across meshes
# ---------------------------------------------------------------------------


def _ckpt_arrays(ckpt_dir, step):
    with np.load(os.path.join(ckpt_dir, f"step_{step:08d}",
                              "shard_0.npz")) as data:
        return {k: data[k] for k in data.files}


def _assert_same_checkpoint(a, b, step):
    got, want = _ckpt_arrays(a, step), _ckpt_arrays(b, step)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with open(os.path.join(a, f"step_{step:08d}", "manifest.json")) as f:
        ea = json.load(f)["extra"]
    with open(os.path.join(b, f"step_{step:08d}", "manifest.json")) as f:
        eb = json.load(f)["extra"]
    assert ea["best_y"] == eb["best_y"] and ea["best_x"] == eb["best_x"]


@pytest.mark.parametrize("target", ["4", "2x4", None])
def test_a_crashed_sharded_run_resumes_on_another_mesh(tmp_path, target):
    spec = ga.GASpec(**_kw(generations=20))
    crashed = str(tmp_path / "crashed")
    eng = ga.Engine(spec, "fused-islands", options=_opts(
        _mesh("2"), faults="chunk_crash:at=2"))
    with pytest.raises(Exception, match="injected chunk crash"):
        list(eng.run_chunked(chunk_generations=5, ckpt_dir=crashed))
    assert CKPT.latest_step(crashed) == 5
    mesh = _mesh(target) if target else None
    resumed = list(ga.Engine(spec, "fused-islands", options=_opts(
        mesh, faults=False)).run_chunked(chunk_generations=5,
                                          ckpt_dir=crashed))
    assert resumed[0]["resumed_from"] == 5
    want_mode = "resident-sharded" if target else "resident"
    assert resumed[-1]["telemetry"].plan.mode == want_mode
    straight = str(tmp_path / "straight")
    list(ga.Engine(spec, "fused-islands", options=_opts(
        _mesh("2"), faults=False)).run_chunked(chunk_generations=5,
                                                ckpt_dir=straight))
    _assert_same_checkpoint(crashed, straight, 20)


def test_restore_places_leaves_by_shardings(tmp_path):
    spec = ga.GASpec(**_kw(n_repeats=2))
    eng = ga.Engine(spec, "islands", options=_opts())
    state = eng.init_state()
    CKPT.save(str(tmp_path), step=1, tree=state, extra={})
    like = eng.init_state()
    for place in ((_mesh("2x4"), 1), (_mesh("4"), 1, ("islands",)),
                  CPU_DEV, None):
        got, _ = CKPT.restore(str(tmp_path), 1, like,
                              shardings=TG.GAState(*(place for _ in like)))
        for a, b in zip(got, state):
            assert a.device == CPU_DEV and torch.equal(a, b)
    three = Mesh([CPU_DEV] * 3, ("islands",))
    with pytest.raises(ValueError, match="cannot shard its axis 1 evenly"):
        CKPT.restore(str(tmp_path), 1, like,
                     shardings=TG.GAState(*((three, 1) for _ in like)))


# ---------------------------------------------------------------------------
# the scheduler on a mesh
# ---------------------------------------------------------------------------


def test_scheduler_on_a_mesh_matches_solo_runs():
    mesh = _mesh("2")
    reg = GAMetricsRegistry()
    sched = GAScheduler(mesh=mesh, registry=reg, backend="fused-islands",
                        chunk_generations=5, cost_table=False, paused=True)
    specs = [ga.GASpec(**_kw(seed=s)) for s in (11, 12, 13)]
    specs.append(ga.GASpec(**_kw(problem="rastrigin:4", seed=5)))
    try:
        assert sched.mesh is mesh and sched.device == CPU_DEV
        ids = [sched.submit(s) for s in specs]
        sched.resume_dispatch()
        results = [sched.result(j, timeout=300) for j in ids]
    finally:
        sched.shutdown()
    assert max(r["pack_size"] for r in results) == 3
    for spec, job_id, res in zip(specs, ids, results):
        solo = ga.solve(spec, "fused-islands",
                        options=_opts(mesh, cost_table=False))
        assert res["best_fitness"] == solo.best_fitness, job_id
        assert solo.telemetry.topology.n_shards == 2
        stats = reg.metrics()["jobs"][job_id]
        assert (stats["shards"], stats["epoch_mode"]) == \
            (2, "resident-sharded"), stats
