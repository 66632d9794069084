"""The port's chunked runs and checkpoints (`Engine.run_chunked`,
`repro_torch.ckpt.checkpoint`) against the JAX package's.

The on-disk format is shared (hazard H7): a checkpoint the JAX engine
writes resumes in the port and ends bit-identical to the JAX straight run,
and one the port writes restores through `repro.ckpt.checkpoint` into the
JAX state's structure with equal arrays.  Runs use LUT fitness so best
and trajectory compare bit for bit (H1 does not arise).  The rest mirrors
the JAX package's own chunk, resume, CRC and fault-site tests.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import ga as JGA  # noqa: E402
from repro.ckpt import checkpoint as JCK  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import faults as FLT  # noqa: E402
from repro_torch import ga  # noqa: E402
from repro_torch.ckpt import checkpoint as CKPT  # noqa: E402


@pytest.fixture(autouse=True)
def _no_ambient_cost_table(monkeypatch):
    """The plans here are the heuristic's: no cost table found on the host
    may move them."""
    monkeypatch.setenv("REPRO_GA_COST_TABLE", "off")


CPU = ga.EngineOptions(device="cpu")
CROSS = [("reference", dict(n_repeats=2)),
         ("islands", dict(n_islands=4, migrate_every=5))]


def _kw(**kw):
    base = dict(problem="F3", n=32, bits_per_var=8, mode="lut",
                mutation_rate=0.05, seed=11, generations=40)
    base.update(kw)
    return base


def _spec(**kw):
    return ga.GASpec(**_kw(**kw))


def _eng(spec, backend="reference", **opts):
    return ga.Engine(spec, backend, options=ga.EngineOptions(device="cpu",
                                                             **opts))


def _arrays(ckpt_dir):
    step = CKPT.latest_step(ckpt_dir)
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "shard_0.npz")
    with np.load(path) as data:
        return step, dict(data)


# ---------------------------------------------------------------------------
# H7: the format is shared with the JAX package, in both directions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,kw", CROSS)
def test_jax_checkpoint_resumes_in_the_port(tmp_path, backend, kw):
    spec_kw = _kw(generations=20, **kw)
    ck = str(tmp_path / "jax")
    it = JGA.Engine(JGA.GASpec(**spec_kw), backend).run_chunked(
        chunk_generations=10, ckpt_dir=ck)
    next(it)                                  # the JAX run stops at step 10
    del it
    want = JGA.solve(JGA.GASpec(**spec_kw), backend=backend)
    teles = list(_eng(ga.GASpec(**spec_kw), backend).run_chunked(
        chunk_generations=10, ckpt_dir=ck))
    assert [t["gens_done"] for t in teles] == [20]
    assert teles[0]["resumed_from"] == 10
    assert teles[-1]["best_fitness"] == want.best_fitness
    np.testing.assert_array_equal(teles[-1]["best_params"], want.best_params)
    np.testing.assert_array_equal(teles[-1]["traj_best"],
                                  want.traj_best[-len(teles[-1]["traj_best"]):])
    # the port's final state equals the JAX straight run's, leaf for leaf
    ck_full = str(tmp_path / "jax_full")
    list(JGA.Engine(JGA.GASpec(**spec_kw), backend).run_chunked(
        chunk_generations=20, ckpt_dir=ck_full))
    step_j, arr_j = _arrays(ck_full)
    step_t, arr_t = _arrays(ck)
    assert step_j == step_t == 20 and set(arr_j) == set(arr_t)
    for k in arr_j:
        assert arr_t[k].dtype == arr_j[k].dtype, k
        np.testing.assert_array_equal(arr_t[k], arr_j[k], err_msg=k)


@pytest.mark.parametrize("backend,kw", CROSS)
def test_port_checkpoint_restores_in_jax(tmp_path, backend, kw):
    spec_kw = _kw(generations=10, **kw)
    ck = str(tmp_path / "port")
    list(_eng(ga.GASpec(**spec_kw), backend).run_chunked(
        chunk_generations=10, ckpt_dir=ck))
    like = JGA.Engine(JGA.GASpec(**spec_kw), backend).init_state()
    jstate, extra = JCK.restore(ck, 10, like)
    tstate, textra = CKPT.restore(
        ck, 10, _eng(ga.GASpec(**spec_kw), backend).init_state())
    assert extra == textra and extra["backend"] == backend
    for a, b in zip(jstate, convert.state_to_numpy(tstate)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    with open(os.path.join(ck, "step_00000010", "manifest.json")) as f:
        keys = json.load(f)["keys"]
    assert {k: v["dtype"] for k, v in keys.items()} == {
        ".x": "uint32", ".sel_lfsr": "uint32", ".cross_lfsr": "uint32",
        ".mut_lfsr": "uint32", ".k": "int32"}


# ---------------------------------------------------------------------------
# Chunks, resume, a finished run, a checkpoint of another backend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,kw", CROSS)
def test_chunked_equals_straight_run(backend, kw):
    spec = _spec(**kw)
    teles = list(_eng(spec, backend).run_chunked(chunk_generations=10))
    assert [t["gens_done"] for t in teles] == [10, 20, 30, 40]
    straight = ga.solve(spec, backend=backend, options=CPU)
    assert teles[-1]["best_fitness"] == straight.best_fitness
    np.testing.assert_array_equal(
        np.concatenate([t["traj_best"] for t in teles]), straight.traj_best)


@pytest.mark.parametrize("backend,kw", CROSS)
def test_checkpoint_resume(tmp_path, backend, kw):
    spec = _spec(**kw)
    ckpt = str(tmp_path / "ga_ck")
    full = list(_eng(spec, backend).run_chunked(chunk_generations=10))
    it = _eng(spec, backend).run_chunked(chunk_generations=10, ckpt_dir=ckpt)
    next(it), next(it)      # 20 generations, then "crash"
    del it
    resumed = list(_eng(spec, backend).run_chunked(chunk_generations=10,
                                                   ckpt_dir=ckpt))
    assert [t["gens_done"] for t in resumed] == [30, 40]
    assert resumed[-1]["best_fitness"] == full[-1]["best_fitness"]
    assert resumed[-1]["migrations"] == full[-1]["migrations"]
    assert resumed[0]["telemetry"].resumed_from == 20


def test_finished_run_yields_its_stored_result(tmp_path):
    spec = _spec(generations=20)
    ckpt = str(tmp_path / "done")
    last = list(_eng(spec).run_chunked(chunk_generations=10,
                                       ckpt_dir=ckpt))[-1]
    again = list(_eng(spec).run_chunked(chunk_generations=10, ckpt_dir=ckpt))
    assert len(again) == 1 and again[0]["already_complete"]
    assert again[0]["best_fitness"] == last["best_fitness"]
    np.testing.assert_array_equal(again[0]["best_params"],
                                  last["best_params"])
    assert again[0]["gens_done"] == 20 and again[0]["chunk_gens"] == 0


def test_checkpoint_of_another_backend_refused(tmp_path):
    spec = _spec(generations=20, n_islands=4, migrate_every=5, mode="arith")
    ckpt = str(tmp_path / "isl")
    next(_eng(spec, "islands").run_chunked(chunk_generations=10,
                                           ckpt_dir=ckpt))
    with pytest.raises(ValueError, match="written by the 'islands'"):
        next(_eng(spec, "fused-islands").run_chunked(chunk_generations=10,
                                                     ckpt_dir=ckpt))


def test_restore_places_leaves_on_the_like_tree_device(tmp_path):
    st = _eng(_spec()).init_state()
    CKPT.save(str(tmp_path), 1, st, extra={"a": 1})
    like = ga.backends.G.GAState(*(t.to(torch.float64) if i == 4 else t
                                   for i, t in enumerate(st)))
    got, extra = CKPT.restore(str(tmp_path), 1, like)
    assert extra == {"a": 1}
    for a, b in zip(got, like):
        assert a.device == b.device and a.dtype == b.dtype
    np.testing.assert_array_equal(convert.words_to_numpy(got.x),
                                  convert.words_to_numpy(st.x))


# ---------------------------------------------------------------------------
# Integrity: CRC fallback, legacy manifests, the ckpt_corrupt site
# ---------------------------------------------------------------------------


def _save_steps(ckpt_dir, steps):
    tree = {"w": np.arange(16, dtype=np.float32),
            "b": np.ones((2, 3), np.int32)}
    for s in steps:
        CKPT.save(str(ckpt_dir), step=s, tree=tree, extra={"s": s})
    return tree


def test_ckpt_validate_and_fallback(tmp_path):
    tree = _save_steps(tmp_path, [5, 10])
    assert CKPT.validate_step(str(tmp_path), 10) is None
    assert CKPT.latest_step(str(tmp_path)) == 10
    FLT.corrupt_file(os.path.join(str(tmp_path), "step_00000010",
                                  "shard_0.npz"))
    assert "checksum" in CKPT.validate_step(str(tmp_path), 10)
    with pytest.warns(UserWarning, match="failed validation"):
        assert CKPT.latest_step(str(tmp_path)) == 5   # falls back
    assert CKPT.latest_step(str(tmp_path), validate=False) == 10
    with pytest.raises(CKPT.CheckpointCorrupt):
        CKPT.restore(str(tmp_path), 10, tree)
    restored, extra = CKPT.restore(str(tmp_path), 5, tree)
    np.testing.assert_array_equal(restored["w"], tree["w"])
    assert extra["s"] == 5
    # the JAX package reads the same tree back from the port's files
    jrest, jextra = JCK.restore(str(tmp_path), 5, tree)
    np.testing.assert_array_equal(np.asarray(jrest["b"]), tree["b"])
    assert jextra == extra


def test_ckpt_legacy_manifest_without_shards_validates(tmp_path):
    _save_steps(tmp_path, [3])
    mpath = os.path.join(str(tmp_path), "step_00000003", "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    del manifest["shards"]      # pre-checksum manifest format
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    assert CKPT.validate_step(str(tmp_path), 3) is None
    assert CKPT.latest_step(str(tmp_path)) == 3


def test_ckpt_corrupt_injection_site(tmp_path):
    inj = FLT.parse_faults("ckpt_corrupt:at=1")
    tree = {"w": np.arange(8, dtype=np.float32)}
    CKPT.save(str(tmp_path), step=1, tree=tree, faults=inj, fault_tag="t")
    assert inj.stats() == {"ckpt_corrupt": 1}
    # corruption lands AFTER the checksum was recorded: validation catches it
    assert "checksum" in CKPT.validate_step(str(tmp_path), 1)
    assert JCK.validate_step(str(tmp_path), 1) is not None


# ---------------------------------------------------------------------------
# Injected crash / corruption: resume stays bit-identical
# ---------------------------------------------------------------------------


def test_engine_chunk_crash_then_resume_bit_identical(tmp_path):
    spec = _spec()
    want = ga.solve(spec, backend="reference", options=CPU)
    inj = FLT.parse_faults("chunk_crash:at=3")
    seen = []
    with pytest.raises(FLT.ChunkCrash):
        for tele in _eng(spec, faults=inj).run_chunked(
                chunk_generations=10, ckpt_dir=str(tmp_path),
                fault_tag="job-1"):
            seen.append(tele["gens_done"])
    assert seen == [10, 20]     # chunk 3's work was lost pre-checkpoint
    last = None
    for tele in _eng(spec).run_chunked(chunk_generations=10,
                                       ckpt_dir=str(tmp_path)):
        assert tele["resumed_from"] == (20 if last is None else None)
        last = tele
    assert last["gens_done"] == 40
    assert last["best_fitness"] == want.best_fitness
    np.testing.assert_array_equal(last["best_params"], want.best_params)
    np.testing.assert_array_equal(convert.state_to_numpy(want.state)[0],
                                  _arrays(str(tmp_path))[1][".x"])


def test_chunk_sites_carry_the_fault_tag(tmp_path):
    """`chunk_crash@...` matches the tag `f"{fault_tag}|{backend}|chunk=i"`."""
    inj = FLT.parse_faults("chunk_crash@job-9|reference|chunk=2:at=1")
    seen = []
    with pytest.raises(FLT.ChunkCrash) as e:
        for tele in _eng(_spec(), faults=inj).run_chunked(
                chunk_generations=10, fault_tag="job-9"):
            seen.append(tele["gens_done"])
    assert seen == [10] and e.value.tag == "job-9|reference|chunk=2"


def test_engine_corrupt_ckpt_falls_back_a_step(tmp_path):
    spec = _spec()
    want = ga.solve(spec, backend="reference", options=CPU)
    inj = FLT.parse_faults("ckpt_corrupt:at=2")
    for _ in _eng(spec, faults=inj).run_chunked(
            chunk_generations=10, ckpt_dir=str(tmp_path), generations=20):
        pass
    assert inj.stats() == {"ckpt_corrupt": 1}   # step 20's shard is rotten
    last = None
    with pytest.warns(UserWarning, match="failed validation"):
        for tele in _eng(spec).run_chunked(chunk_generations=10,
                                           ckpt_dir=str(tmp_path)):
            if last is None:
                assert tele["resumed_from"] == 10   # fell back past step 20
            last = tele
    assert last["gens_done"] == 40
    assert last["best_fitness"] == want.best_fitness


def test_ambient_rules_arm_the_engine(tmp_path, monkeypatch):
    monkeypatch.setenv(FLT.ENV_VAR, "chunk_crash@ambient-test:at=1")
    with pytest.raises(FLT.ChunkCrash):
        next(_eng(_spec()).run_chunked(chunk_generations=10,
                                       fault_tag="ambient-test"))
    # False disarms against the environment
    assert next(_eng(_spec(), faults=False).run_chunked(
        chunk_generations=10, fault_tag="ambient-test"))["gens_done"] == 10


# ---------------------------------------------------------------------------
# H6: an asynchronous save writes the state as it was when it was called
# ---------------------------------------------------------------------------


def test_async_save_snapshots_before_the_next_chunk(tmp_path):
    eng = _eng(_spec())
    st = eng.init_state()
    seg = eng.backend.segment(st, 5)
    want = [a.copy() for a in convert.state_to_numpy(seg.state)]
    ac = CKPT.AsyncCheckpointer()
    ac.save(str(tmp_path), 5, seg.state, extra={"gens_done": 5})
    # the next chunk, and an in-place write into the saved tensors
    eng.backend.segment(seg.state, 5)
    seg.state.x.fill_(-1)
    seg.state.k.add_(100)
    ac.wait()
    assert ac.last_path.endswith("step_00000005")
    got, extra = CKPT.restore(str(tmp_path), 5, st)
    for a, b in zip(convert.state_to_numpy(got), want):
        np.testing.assert_array_equal(a, b)
    assert extra == {"gens_done": 5}


def test_async_save_raises_its_error_on_wait(tmp_path):
    ac = CKPT.AsyncCheckpointer()
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ac.save(str(blocker), 1, {"w": np.zeros(2, np.float32)})
    with pytest.raises(OSError):
        ac.wait()
    ac.wait()                       # the error is raised once
