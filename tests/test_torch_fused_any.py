"""K1's global form on the CPU: the port's `fused` runs every spec the JAX
package's `fused` runs — a blackbox or registered fitness, and replicas
past one thread block's shared memory.

* The capability matrix: `fused` (and `fused-islands`) is None in the port
  exactly where it is None in the JAX package, over the specs the one-block
  form refused and the refusals that stay, and at the FFM-constant gate's
  limit plus and minus one byte.
* Each such spec runs `fused` bit for bit as the port's `reference` (and
  `fused-islands` as `islands`): on the CPU the wrapper runs K1's plain
  version, and on the card the global form calls the same PyTorch stage or
  a CUDA FFM stage that repeats it (tests/test_torch_cuda.py, the card).
* Against the JAX package: where the two FFM stages agree bit for bit (the
  sphere, whose port `reference` equals JAX's `eager`, and a fitness written
  as the same left-to-right sum in both packages, checked first on the
  initial population), the port's `fused` equals JAX's `eager` in state,
  best and trajectory of bests; the trajectory means are float32 sums over
  N in another order and agree within ``1e-6 * max(|mean|, |best|)``
  (tests/test_torch_engine.py's rule).  A PyTorch `.sum(-1)` and a JAX
  `jnp.sum` may part in the last bit, so the plain blackbox is held against
  the port's own `reference` only.
* The three plain twins of the global form's kernels against `core.ga`
  (and the operators against the JAX package's `generation_with_y`), a tie
  in y resolved to its first occurrence, a NaN leaving the best alone.
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import ga as JGA  # noqa: E402
from repro.core import fitness as JF  # noqa: E402
from repro.core import ga as JG  # noqa: E402
from repro.core import islands as JISL  # noqa: E402
from repro.kernels import ga_step as JK  # noqa: E402
from repro.kernels import ref as JREF  # noqa: E402
from repro_torch import convert, ga  # noqa: E402
from repro_torch.core import fitness as TF  # noqa: E402
from repro_torch.core import ga as TG  # noqa: E402
from repro_torch.kernels import ga_step as K  # noqa: E402
from repro_torch.kernels import ops as TOPS  # noqa: E402

CPU = ga.EngineOptions(device="cpu")
MEAN_REL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _lr_sum(t):
    """t[..., 0] + t[..., 1] + ... left to right, in either package."""
    acc = t[..., 0]
    for j in range(1, t.shape[-1]):
        acc = acc + t[..., j]
    return acc


def _segment(spec, backend, gens, jax_pkg=False):
    eng = (JGA.Engine(spec, backend) if jax_pkg
           else ga.Engine(spec, backend, options=CPU))
    return eng.backend.segment(eng.init_state(), gens)


def _same_state(a, b):
    for name, x, y in zip(("x", "sel", "cross", "mut"),
                          convert.state_to_numpy(a)[:4],
                          convert.state_to_numpy(b)[:4]):
        np.testing.assert_array_equal(x, y.reshape(x.shape), err_msg=name)


def _same_result(a, b):
    """Two port results bit for bit: state, best, best_x, trajectories."""
    _same_state(a.state, b.state)
    assert a.best_fitness == b.best_fitness
    np.testing.assert_array_equal(a.best_x, b.best_x)
    np.testing.assert_array_equal(a.traj_best, b.traj_best)
    np.testing.assert_array_equal(a.traj_mean, b.traj_mean)


def _same_as_jax_eager(ts, js):
    """A port segment against a JAX `eager` segment: state, best and
    trajectory of bests bit for bit, the means within MEAN_REL."""
    for name, a, b in zip(("x", "sel", "cross", "mut"),
                          (js.state.x, js.state.sel_lfsr,
                           js.state.cross_lfsr, js.state.mut_lfsr),
                          convert.state_to_numpy(ts.state)[:4]):
        a = np.asarray(a)
        np.testing.assert_array_equal(a, b.reshape(a.shape), err_msg=name)
    assert ts.best_y == js.best_y
    np.testing.assert_array_equal(ts.best_x, np.asarray(js.best_x))
    np.testing.assert_array_equal(ts.traj_best, np.asarray(js.traj_best))
    jm = np.asarray(js.traj_mean)
    scale = np.maximum(np.abs(jm), np.abs(np.asarray(js.traj_best)))
    assert np.all(np.abs(ts.traj_mean - jm) <= MEAN_REL * scale)


def _stages_agree(tspec, jspec):
    """The two packages' FFM stages on the port's initial population, bit
    for bit."""
    st = TG.init_state(tspec.ga_config(), device="cpu")
    words = convert.words_to_numpy(st.x)
    got = tspec.program().stage(st.x).numpy()
    want = np.asarray(jspec.program().stage(jnp.asarray(words)))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the JAX package's acceptance cases, with the fitness written in PyTorch
# ---------------------------------------------------------------------------

def test_blackbox_runs_fused_bit_exact():
    """tests/test_engine.py::test_blackbox_runs_fused_bit_exact in the
    port: a blackbox that captures its own tensor runs `fused`, equal to
    `reference` in state, best and both trajectories."""
    target = torch.tensor([0.25, -1.5, 2.0])
    spec = ga.GASpec(fitness=lambda p: torch.sum((p - target) ** 2, dim=-1),
                     bounds=((-4.0, 4.0),) * 3, n=32, bits_per_var=12,
                     mutation_rate=0.05, seed=13, generations=12)
    assert ga.capability_matrix(spec)["fused"] is None
    r = ga.solve(spec, backend="reference", options=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        f = ga.solve(spec, backend="fused", options=CPU)
    assert f.backend == "fused" and r.best_params.shape == (3,)
    _same_result(r, f)


@pytest.mark.parametrize("gens_per_epoch", [1, 4])
def test_left_to_right_blackbox_matches_jax_eager(gens_per_epoch):
    """The same blackbox as one left-to-right sum in both packages: the
    stages agree bit for bit, and the port's `fused` equals JAX's `eager`
    (the trajectory at one sample a launch against JAX's every
    generation)."""
    tt = torch.tensor([0.25, -1.5, 2.0])
    jt = jnp.asarray([0.25, -1.5, 2.0], jnp.float32)
    kw = dict(bounds=((-4.0, 4.0),) * 3, n=32, bits_per_var=12,
              mutation_rate=0.05, seed=13, generations=12)
    tspec = ga.GASpec(fitness=lambda p: _lr_sum((p - tt) * (p - tt)),
                      gens_per_epoch=gens_per_epoch, **kw)
    jspec = JGA.GASpec(fitness=lambda p: _lr_sum((p - jt) * (p - jt)), **kw)
    _stages_agree(tspec, jspec)
    ts = _segment(tspec, "fused", 12)
    js = _segment(jspec, "eager", 12, jax_pkg=True)
    if gens_per_epoch > 1:
        per = gens_per_epoch
        js = dataclasses.replace(
            js, traj_best=np.asarray(js.traj_best)[per - 1::per],
            traj_mean=np.asarray(js.traj_mean)[per - 1::per])
    _same_as_jax_eager(ts, js)


def test_registered_problem_runs_fused():
    """tests/test_engine.py's registered problem on `fused` in the port,
    equal to `reference` bit for bit."""
    ga.register_problem(ga.ProblemDef(
        name="_test_tilted",
        fn=lambda v: torch.sum(v * v + 0.5 * v, dim=-1),
        domain=(-3.0, 3.0)))
    try:
        spec = ga.GASpec(problem="_test_tilted:3", n=64, bits_per_var=10,
                         mode="arith", mutation_rate=0.05, seed=11,
                         generations=10)
        assert "no Hopper FFM stage" in K.block_reason(spec.ga_config(),
                                                       spec.program())
        assert ga.capability_matrix(spec)["fused"] is None
        r = ga.solve(spec, backend="reference", options=CPU)
        f = ga.solve(spec, backend="fused", options=CPU)
        assert f.backend == "fused" and np.isfinite(f.best_fitness)
        _same_result(r, f)
    finally:
        del ga.PROBLEMS["_test_tilted"]


def test_fused_islands_blackbox_bit_identical():
    """tests/test_topology.py::test_fused_islands_blackbox_bit_identical in
    the port: the plan is gridded (K2 and K3 have no stage for the
    blackbox: the fallback names it), and the run equals `islands`."""
    t = torch.tensor([1.0, -0.5, 0.25])
    spec = ga.GASpec(fitness=lambda p: torch.sum(torch.abs(p - t), dim=-1),
                     bounds=((-2.0, 2.0),) * 3, n=32, bits_per_var=10,
                     mutation_rate=0.05, seed=11, generations=15,
                     n_islands=4, migrate_every=5, gens_per_epoch=10)
    assert ga.capability_matrix(spec)["fused-islands"] is None
    seg_r = _segment(spec, "islands", 15)
    seg_f = _segment(spec, "fused-islands", 15)
    plan = seg_f.telemetry.plan
    assert plan.mode == "gridded" and "no Hopper FFM stage" in plan.fallback
    assert plan.smem_estimate_bytes is None
    _same_state(seg_f.state, seg_r.state)
    assert seg_f.best_y == seg_r.best_y
    np.testing.assert_array_equal(seg_f.best_x, seg_r.best_x)
    np.testing.assert_array_equal(seg_f.traj_best, seg_r.traj_best)


# ---------------------------------------------------------------------------
# replicas past one block's shared memory
# ---------------------------------------------------------------------------

PAST = dict(bits_per_var=8, mode="arith", mutation_rate=0.05, seed=5,
            generations=3)


@pytest.mark.parametrize("problem,n", [("sphere:2", 8192),
                                       ("sphere:32", 1024)])
def test_past_one_block_matches_reference_and_jax_eager(problem, n):
    spec = ga.GASpec(problem=problem, n=n, **PAST)
    assert "bytes of shared memory" in K.block_reason(spec.ga_config(),
                                                      spec.program())
    assert ga.capability_matrix(spec)["fused"] is None
    f = ga.solve(spec, backend="fused", options=CPU)
    r = ga.solve(spec, backend="reference", options=CPU)
    assert f.backend == "fused"
    _same_result(r, f)
    jspec = JGA.GASpec(problem=problem, n=n, **PAST)
    _stages_agree(spec, jspec)
    _same_as_jax_eager(_segment(spec, "fused", 3),
                       _segment(jspec, "eager", 3, jax_pkg=True))


def test_rastrigin_past_one_block_matches_reference():
    spec = ga.GASpec(problem="rastrigin:2", n=8192, **PAST)
    assert K.block_reason(spec.ga_config(), spec.program()) is not None
    f = ga.solve(spec, backend="fused", options=CPU)
    assert f.backend == "fused"
    _same_result(ga.solve(spec, backend="reference", options=CPU), f)


@pytest.mark.parametrize("problem,n,track", [("rastrigin:2", 8192, True),
                                              ("sphere:32", 1024, False),
                                              ("blackbox", 64, True)])
def test_global_form_composes_to_the_plain_generation(problem, n, track):
    """K1's global form as the card runs it (the FFM stage, the best fold
    and the operators a generation, each wrapper on the CPU running its
    plain twin) equals `ga_generation_plain` bit for bit, the y of the last
    pre-update population and the best over every generation included."""
    if problem == "blackbox":
        prog = TF.compile_program(
            fitness=lambda p: torch.sum(torch.abs(p - 0.25), dim=-1),
            bounds=((-1.0, 1.0),) * 3, bits_per_var=8)
    else:
        prog = TF.compile_program(problem=problem, bits_per_var=8)
    cfg = TG.GAConfig(n=n, c=8, v=prog.n_vars, mutation_rate=0.05, seed=3,
                      minimize=n != 1024, mode="arith", sel_lane="gather")
    assert K.block_reason(cfg, prog) is not None
    st = _stack(cfg, 2)
    args = (st.x, st.sel_lfsr, st.cross_lfsr, st.mut_lfsr)
    got = K._global_generations(*args, cfg, prog, 3, track)
    want = K.ga_generation_plain(*args, cfg=cfg, program=prog, gens=3,
                                 track_best=track)
    assert len(got) == len(want) == (7 if track else 5)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_a_spec_that_fits_keeps_the_one_block_form():
    """sphere:64 at N=256 fits a block: the control, whose K1 call takes the
    one-block form (`block_reason` None)."""
    spec = ga.GASpec(problem="sphere:64", n=256, **PAST)
    cfg, prog = spec.ga_config(), spec.program()
    assert K.hopper_reason(cfg, prog) is None
    assert K.block_reason(cfg, prog) is None
    assert K.smem_bytes(256, 64, cfg.p) <= K.SMEM_LIMIT
    _same_result(ga.solve(spec, backend="reference", options=CPU),
                 ga.solve(spec, backend="fused", options=CPU))


# ---------------------------------------------------------------------------
# the capability matrix, spec for spec against the JAX package's
# ---------------------------------------------------------------------------

def _blackbox(pkg, **kw):
    if pkg == "jax":
        return JGA.GASpec(fitness=lambda p: jnp.sum(p * p, axis=-1),
                          bounds=((-1.0, 1.0),) * 3, **kw)
    return ga.GASpec(fitness=lambda p: torch.sum(p * p, dim=-1),
                     bounds=((-1.0, 1.0),) * 3, **kw)


def _problem(name, **kw):
    kw = dict(dict(mode="arith"), **kw)
    return lambda pkg: (JGA if pkg == "jax" else ga).GASpec(problem=name,
                                                            **kw)


def _onehot_past_cap(pkg):
    """A onehot pin past N=1024, which GASpec validation refuses: set as
    a lane pin that bypassed it, the case the fused gate still answers."""
    spec = (JGA if pkg == "jax" else ga).GASpec(
        problem="F3", n=2048, mode="arith", sel_lane="gather")
    object.__setattr__(spec, "sel_lane", "onehot")
    return spec


SPECS = {
    "blackbox": lambda pkg: _blackbox(pkg, n=64),
    "blackbox-islands": lambda pkg: _blackbox(pkg, n=32, n_islands=4,
                                              migrate_every=5),
    "sphere:2@8192": _problem("sphere:2", n=8192),
    "sphere:32@1024": _problem("sphere:32", n=1024),
    "rastrigin:2@8192": _problem("rastrigin:2", n=8192),
    "sphere:64@256": _problem("sphere:64", n=256),
    "rastrigin:8@65536-islands": _problem("rastrigin:8", n=65536,
                                          n_islands=2),
    "lut": _problem("F3", n=64, mode="lut"),
    "n48": _problem("F3", n=48),
    "onehot@2048": _onehot_past_cap,
    "jit_fitness=False": lambda pkg: _blackbox(pkg, n=64, jit_fitness=False),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_capability_matrix_matches_jax(name):
    got = ga.capability_matrix(SPECS[name]("torch"))
    want = JGA.capability_matrix(SPECS[name]("jax"))
    assert sorted(got) == sorted(want)
    assert {b: r is None for b, r in got.items()} == \
        {b: r is None for b, r in want.items()}, (got, want)


def test_ffm_constant_gate_at_its_limit(monkeypatch):
    """A fitness that closes over a 4000-byte array: the port counts the
    bytes the JAX package counts (its captured array and the decode's lo
    and span), and both refuse `fused` one byte under that count, with
    the same words, and route `auto` to `reference`."""
    big = torch.ones(1000)
    jbig = np.ones(1000, np.float32)
    kw = dict(bounds=((-1.0, 1.0),) * 3, n=64, bits_per_var=10)
    spec = ga.GASpec(fitness=lambda p: torch.sum(p * p, dim=-1) + big.sum(),
                     **kw)
    jspec = JGA.GASpec(
        fitness=lambda p: jnp.sum(p * p, axis=-1) + jnp.sum(jnp.asarray(jbig)),
        **kw)
    nbytes = K.ffm_const_bytes(spec.program())
    assert nbytes == 4000 + 8 * 3
    assert nbytes == JK.ffm_const_bytes(jspec.program().stage,
                                        jspec.ga_config())
    monkeypatch.setenv("REPRO_FFM_CONST_LIMIT", str(nbytes))
    assert ga.capability_matrix(spec)["fused"] is None
    assert JGA.capability_matrix(jspec)["fused"] is None
    monkeypatch.setenv("REPRO_FFM_CONST_LIMIT", str(nbytes - 1))
    reason = ga.capability_matrix(spec)["fused"]
    assert reason == JGA.capability_matrix(jspec)["fused"]
    assert f"captures {nbytes} bytes" in reason
    assert ga.capability_matrix(spec)["fused-islands"] == reason
    assert ga.resolve_backend(spec, "auto", "cuda") == "reference"


def test_ffm_const_bytes_looks_one_level_into_containers():
    pair = (torch.ones(10), torch.ones(20, dtype=torch.float64))
    table = {"w": np.ones(5, np.float32), "nested": [torch.ones(100)]}
    prog = TF.compile_program(
        fitness=lambda p: (p.sum(-1) + pair[0].sum() + float(pair[1].sum())
                           + float(table["w"].sum())),
        bounds=((-1.0, 1.0),) * 2, bits_per_var=8)
    assert K.ffm_const_bytes(prog) == 8 * 2 + 40 + 160 + 20


# ---------------------------------------------------------------------------
# the global form's three plain twins and the kernels' ops path
# ---------------------------------------------------------------------------

def _stack(cfg, replicas=3):
    return TG.init_states(cfg, range(cfg.seed, cfg.seed + replicas),
                          device="cpu")


def test_ga_best_twin_is_gen_best_then_fold_best():
    cfg = TG.GAConfig(n=64, c=10, v=3, seed=4, mode="arith")
    st = _stack(cfg, 4)
    y = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 64)).astype(np.float32))
    y[0, 9] = y[0, 5] = y[0].min() - 1.0      # a tie: the first wins
    y[1, 3] = float("nan")                    # a NaN: nothing taken
    by = torch.tensor([np.inf, np.inf, -5.0, np.inf], dtype=torch.float32)
    bx = torch.arange(12, dtype=torch.int32).reshape(4, 3)
    got = K.ga_best_kernel(st.x, y, by, bx, minimize=True)
    gb, gx = TG.gen_best(st.x, y, True)
    want = TG.fold_best(by, bx, gb, gx, True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[0][0] == y[0, 5] and torch.equal(got[1][0], st.x[0, 5])
    assert got[0][1] == np.inf and torch.equal(got[1][1], bx[1])
    assert got[0][2] == -5.0 and torch.equal(got[1][2], bx[2])
    mx = K.ga_best_kernel(st.x, y, torch.full((4,), -np.inf), bx,
                          minimize=False)
    assert torch.equal(mx[1][0], st.x[0, int(torch.argmax(y[0]))])


def test_ga_operators_twin_matches_both_packages():
    """The operators from external y: the port's twin equals
    `core.ga.generation_with_y` and the JAX package's, bit for bit."""
    kw = dict(n=64, c=10, v=3, mutation_rate=0.1, seed=6, mode="arith")
    cfg, jcfg = TG.GAConfig(**kw), JG.GAConfig(**kw)
    st = _stack(cfg, 2)
    y = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 64)).astype(np.float32))
    got = K.ga_operators_kernel(st.x, y, st.sel_lfsr, st.cross_lfsr,
                                st.mut_lfsr, cfg=cfg)
    nxt = TG.generation_with_y(st, y, cfg)
    for a, b in zip(got, nxt[:4]):
        assert torch.equal(a, b)
    words = [convert.words_to_numpy(t) for t in st[:4]]
    for r in range(2):
        jst = JG.GAState(*(jnp.asarray(w[r]) for w in words),
                         jnp.int32(0))
        want = JG.generation_with_y(jst, jnp.asarray(y[r].numpy()), jcfg)
        for a, b in zip(got, want[:4]):
            np.testing.assert_array_equal(convert.words_to_numpy(a[r]),
                                          np.asarray(b))


def test_ga_ffm_twin_is_the_stage():
    cfg = TG.GAConfig(n=64, c=10, v=4, seed=2, mode="arith")
    st = _stack(cfg, 2)
    for problem in ("sphere:4", "rastrigin:4", "ackley:4", "rosenbrock:4"):
        prog = TF.compile_program(problem=problem, bits_per_var=10)
        assert torch.equal(K.ga_ffm_kernel(st.x, cfg=cfg, program=prog),
                           prog.stage(st.x))
    jprog = JF.compile_program(problem="sphere:4", bits_per_var=10)
    np.testing.assert_array_equal(
        K.ga_ffm_kernel(st.x, cfg=cfg, program=TF.compile_program(
            problem="sphere:4", bits_per_var=10)).numpy(),
        np.stack([np.asarray(jprog.stage(jnp.asarray(w)))
                  for w in convert.words_to_numpy(st.x)]))


def test_ops_ga_generation_runs_a_capturing_blackbox():
    """tests/test_kernels.py::test_ga_step_blackbox_closure_constants in
    the port: a blackbox that closes over two tensors runs through
    `kernels.ops.ga_generation`, equal to the plain generation through the
    program's stage; written as the same left-to-right sum in both
    packages, its stages agree bit for bit and the new state and y equal
    `repro.kernels.ref.ga_generation_ref`'s."""
    kw = dict(n=32, c=12, v=5, mutation_rate=0.05, seed=9, mode="arith")
    jcfg, cfg = JG.GAConfig(**kw), TG.GAConfig(**kw)
    jst = JISL.init_islands_fast(JISL.IslandConfig(ga=jcfg, n_islands=2))
    st = convert.state_from_numpy(jst.x, jst.sel_lfsr, jst.cross_lfsr,
                                  jst.mut_lfsr, 0, device="cpu")
    args = (st.x, st.sel_lfsr, st.cross_lfsr, st.mut_lfsr)
    target = torch.from_numpy(np.linspace(-1.0, 1.0, 5).astype(np.float32))
    weight = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0])
    bounds = ((-2.0, 2.0),) * 5
    prog = TF.compile_program(
        fitness=lambda p: torch.sum(weight * (p - target) ** 2, dim=-1),
        bounds=bounds, bits_per_var=cfg.c)
    assert K.block_reason(cfg, prog) is not None
    got = TOPS.ga_generation(*args, cfg=cfg, program=prog)
    nxt, y = TG.generation(st, cfg, prog.stage)
    for a, b in zip(got, tuple(nxt[:4]) + (y,)):
        assert torch.equal(a, b)
    jt, jw = jnp.asarray(target.numpy()), jnp.asarray(weight.numpy())
    lr = TF.compile_program(
        fitness=lambda p: _lr_sum(weight * ((p - target) * (p - target))),
        bounds=bounds, bits_per_var=cfg.c)
    jlr = JF.compile_program(
        fitness=lambda p: _lr_sum(jw * ((p - jt) * (p - jt))),
        bounds=bounds, bits_per_var=jcfg.c)
    for r in range(2):
        np.testing.assert_array_equal(lr.stage(st.x[r]).numpy(),
                                      np.asarray(jlr.stage(jst.x[r])))
    got = TOPS.ga_generation(*args, cfg=cfg, program=lr)
    want = JREF.ga_generation_ref(jst.x, jst.sel_lfsr, jst.cross_lfsr,
                                  jst.mut_lfsr, cfg=jcfg, ffm=jlr.stage)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(
            convert.words_to_numpy(a) if a.dtype == torch.int32
            else a.numpy(), np.asarray(b))
