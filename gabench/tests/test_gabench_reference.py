"""The benchmark's plain reference has the port's semantics: at small
sizes on the CPU it produces, bit for bit, the state, best and
trajectories of `repro_torch.ga.solve` with the `reference` backend (a
sample every generation) and with `fused` (a sample every launch of
`gens_per_epoch`, the fused kernel's plain twin on the CPU)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from gabench.reference import plain as P  # noqa: E402
from repro_torch import ga  # noqa: E402
from repro_torch.core import lfsr  # noqa: E402

CPU = ga.EngineOptions(device="cpu", cost_table=False, faults=False)


def _solve(v, n, replicas, gens, seed, backend, gpe=1):
    spec = ga.GASpec(problem=f"rastrigin:{v}", n=n, bits_per_var=16,
                     mode="arith", n_repeats=replicas, generations=gens,
                     seed=seed, gens_per_epoch=gpe)
    return spec, ga.solve(spec, backend, options=CPU)


def _shape(spec):
    return P.Shape("rastrigin", spec.n, spec.v, spec.bits_per_var,
                   spec.mutation_rate, spec.steps_per_draw, spec.minimize)


def _same(out: P.Run, res) -> None:
    for mine, theirs in zip(out.state, res.state):
        assert torch.equal(mine, theirs)
    rep = res.telemetry.per_repeat
    assert np.array_equal(out.best.numpy().view(np.uint32),
                          rep.best.view(np.uint32))
    assert np.array_equal(out.best_x.numpy().view(np.uint32), rep.best_x)
    for mine, theirs in ((out.traj_best, rep.traj_best),
                         (out.traj_mean, rep.traj_mean)):
        assert mine.shape == theirs.shape
        assert np.array_equal(mine.numpy().view(np.uint32),
                              theirs.view(np.uint32))


@pytest.mark.parametrize("v,n,seed", [
    (2, 8, 1), (2, 64, 2**31 + 5), (3, 16, 7), (5, 32, 123456789),
    (7, 128, 99), (10, 256, 4000000000), (10, 8, 0)])
def test_reference_backend_bit_for_bit(v, n, seed):
    spec, res = _solve(v, n, 3, 24, seed, "reference")
    st = P.init(_shape(spec), [seed + r for r in range(3)], "cpu")
    _same(P.run(_shape(spec), st, 24, 1), res)


@pytest.mark.parametrize("v,n,gpe,gens", [
    (10, 64, 8, 32), (4, 128, 5, 23), (2, 256, 32, 96)])
def test_fused_launch_samples_bit_for_bit(v, n, gpe, gens):
    spec, res = _solve(v, n, 2, gens, 31337, "fused", gpe)
    st = P.init(_shape(spec), [31337, 31338], "cpu")
    _same(P.run(_shape(spec), st, gens, gpe), res)


def test_chunks_follow_from_the_handed_state():
    """A run continued from a chunk's output state equals the run done in
    one piece, as the stream check assumes."""
    spec, res = _solve(6, 64, 2, 40, 5, "reference")
    sh = _shape(spec)
    st = P.init(sh, [5, 6], "cpu")
    half = P.run(sh, st, 17, 1)
    rest = P.run(sh, half.state, 23, 1)
    for mine, theirs in zip(rest.state, res.state):
        assert torch.equal(mine, theirs)


@pytest.mark.parametrize("t", [1, 3, 8, 31])
def test_clock_and_top_bits_match_the_port(t):
    g = torch.Generator().manual_seed(t)
    w = torch.randint(-2**31, 2**31 - 1, (4096,), dtype=torch.int32,
                      generator=g)
    assert torch.equal(P.clock(w, t), lfsr.steps(w, t))
    assert torch.equal(P.top_bits(w, t), lfsr.truncate(w, t))


def test_seed_words_match_the_port():
    for seed in (0, 1, 2**32 - 1, 2**32 + 17, 123456789):
        assert np.array_equal(P.seed_words(seed, 1000),
                              lfsr.np_seeds(seed, 1000))


def test_bf16_control_differs():
    """The control's fitness in bfloat16 moves the population."""
    sh = P.Shape("rastrigin", 64, 5, 16, 0.02, 3)
    st = P.init(sh, [11, 12], "cpu")
    a = P.run(sh, st, 10, 1)
    b = P.run(sh, st, 10, 1, fitness_dtype=torch.bfloat16)
    assert not torch.equal(a.state.x, b.state.x)
