"""The port's `evolve` against the JAX package's on the CPU.  `fn` takes and
returns tensors in the port (arrays in JAX), written here so both compute
the same float32 operations in the same order.

* `jit_fitness=False` runs the eager backend in both packages: bit for bit
  (best, best_params, both trajectories).
* `jit_fitness=True` runs the plain reference loop in the port and XLA's
  jitted scan in JAX, whose CPU jit contracts the decode into an FMA (H1):
  the port is held to its own eager run bit for bit in best and the
  trajectory of bests, and to JAX's within the H1 bound.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.evolve import evolve as jax_evolve  # noqa: E402
from repro_torch import ga  # noqa: E402
from repro_torch.core import EvolveResult, evolve  # noqa: E402

CPU = ga.EngineOptions(device="cpu")
BOUNDS = [(-5.0, 5.0), (-2.0, 3.0), (0.0, 4.0)]


def _sphere(x):
    """(..., N, 3) -> (..., N), the same adds in the same order in both
    packages (the island backend hands the port a stack of islands)."""
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + \
        (x[..., 2] - 1.0) * (x[..., 2] - 1.0)


def _both(jit_fitness, **kw):
    kw = dict(dict(population=32, generations=30, bits_per_var=12, seed=3),
              **kw)
    got = evolve(_sphere, BOUNDS, jit_fitness=jit_fitness, options=CPU, **kw)
    want = jax_evolve(_sphere, BOUNDS, jit_fitness=jit_fitness, **kw)
    return got, want


@pytest.mark.parametrize("minimize", [True, False])
@pytest.mark.parametrize("selection", ["tournament", "rank"])
def test_evolve_on_the_host_loop_matches_jax_bit_for_bit(selection,
                                                         minimize):
    got, want = _both(False, selection=selection, minimize=minimize)
    assert isinstance(got, EvolveResult)
    assert got.best_fitness == want.best_fitness
    np.testing.assert_array_equal(got.best_params, want.best_params)
    np.testing.assert_array_equal(got.traj_best, want.traj_best)
    np.testing.assert_array_equal(got.traj_mean, want.traj_mean)


def test_evolve_in_the_step_matches_the_host_loop_and_jax_within_h1():
    got, want = _both(True)
    host = evolve(_sphere, BOUNDS, jit_fitness=False, options=CPU,
                  population=32, generations=30, bits_per_var=12, seed=3)
    assert got.best_fitness == host.best_fitness
    np.testing.assert_array_equal(got.traj_best, host.traj_best)
    np.testing.assert_array_equal(got.best_params, host.best_params)
    bound = 1e-6 * np.maximum(np.abs(want.traj_best), 1.0)
    assert np.all(np.abs(got.traj_best - want.traj_best) <= bound)
    assert abs(got.best_fitness - want.best_fitness) <= \
        1e-6 * max(abs(want.best_fitness), 1.0)
    np.testing.assert_allclose(got.best_params, want.best_params, atol=1e-9)


def test_evolve_islands_run_in_the_step():
    """n_islands > 1 always runs the fitness inside the step (the island
    backend), whatever jit_fitness says, as in JAX."""
    res = evolve(_sphere, BOUNDS, population=16, generations=32,
                 n_islands=4, migrate_every=8, jit_fitness=False,
                 options=CPU)
    assert res.traj_best.shape == (4,)
    assert np.isfinite(res.best_fitness) and res.best_fitness >= 0.0
    assert res.best_fitness <= res.traj_best[0]
    assert all(lo <= p <= hi for p, (lo, hi) in zip(res.best_params, BOUNDS))


def test_evolve_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        evolve(_sphere, BOUNDS, population=16, generations=2)
