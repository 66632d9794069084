"""The port's global gradient norm (`repro_torch.optim.adamw.global_norm`)
where the float32 sum of squares overflows (hazard H9), and everywhere
else against the JAX package's `_global_norm`.

- Finite sums: the norm is the plain float32 value, sqrt of the sum of
  every leaf's `_sum_squares`, bit for bit, and within NORM_REL = 1e-6 of
  JAX's `_global_norm` on float32 and bf16 leaves.  The two libraries sum
  a leaf in other orders (XLA's reduce-window against PyTorch's row sums),
  so the two norms part by a few ulps (measured: up to 3 float32 ulps on
  float32 leaves and 13 on bf16 leaves of up to 64 000 elements), as
  `test_torch_train_adamw.test_clip_path_matches_jax` bounds them.
- Finite leaves whose float32 sum of squares overflows (a deviation by
  design): the norm is m * sqrt(sum((g / m) ** 2)) with m the largest
  |g|, finite and within OVERFLOW_ULPS = 2 float32 ulps of the float64
  norm, where JAX's is inf, its clip factor 0, and its update weight decay
  alone; the port's update moves the parameters past weight decay, and a
  sliced update with the whole gradient's norm equals the whole update.
- A leaf that is itself inf keeps the plain value (inf), as JAX does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JO
from repro_torch.optim import adamw as TO
from test_torch_train_common import few_threads  # noqa: F401

SHAPES = {"a": (4, 256), "b": (300,), "c": (2, 3, 128), "d": (5, 7),
          "e": (128,)}
NORM_REL = 1e-6
OVERFLOW_ULPS = 2


def _grads(seed: int, scale: float, dtype: str):
    rng = np.random.default_rng(seed)
    g = {k: (rng.normal(size=s) * scale).astype(np.float32)
         for k, s in SHAPES.items()}
    if dtype == "bfloat16":
        t = {k: torch.tensor(v).bfloat16() for k, v in g.items()}
        return t, {k: v.float().numpy() for k, v in t.items()}
    return {k: torch.tensor(v) for k, v in g.items()}, g


def _plain(grads) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.stack(
        [TO._sum_squares(g) for g in grads.values()])).double()).float()


def _ulps(a: float, b: float) -> int:
    a, b = np.float32(a), np.float32(b)
    return abs(int(a.view(np.int32)) - int(b.view(np.int32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
@pytest.mark.parametrize("seed", range(4))
def test_finite_norm_is_the_plain_value(seed, scale, dtype):
    grads, g_np = _grads(seed, scale, dtype)
    got = TO.global_norm(grads)
    assert torch.equal(got, _plain(grads))
    want = float(JO._global_norm({k: jnp.asarray(v, jnp.bfloat16
                                                  if dtype == "bfloat16"
                                                  else jnp.float32)
                                  for k, v in g_np.items()}))
    assert abs(float(got) - want) <= NORM_REL * want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", range(3))
def test_overflowing_sum_gives_a_finite_norm(seed, dtype):
    """Leaves of |g| up to ~4e19: every square past float32's range in
    part, the plain sum inf, JAX's norm inf."""
    grads, g_np = _grads(seed, 1e19, dtype)
    assert torch.isinf(_plain(grads))
    assert np.isinf(float(JO._global_norm(
        {k: jnp.asarray(v) for k, v in g_np.items()})))
    got = float(TO.global_norm(grads))
    want = float(np.sqrt(sum(np.sum(v.astype(np.float64) ** 2)
                             for v in g_np.values())))
    assert np.isfinite(got)
    assert _ulps(got, want) <= OVERFLOW_ULPS, (got, want)


def test_overflowing_update_moves_past_weight_decay():
    """One update from the overflowing gradient: JAX's clip factor is 0,
    so its parameters move by weight decay alone; the port's are finite and
    move by the Adam step (~lr an element) as well."""
    rng = np.random.default_rng(7)
    cfg_kw = dict(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads, g_np = _grads(1, 1e19, "float32")
    jp, _, jm = JO.update({k: jnp.asarray(v) for k, v in params.items()},
                          {k: jnp.asarray(v) for k, v in g_np.items()},
                          JO.init(params, JO.AdamWConfig(**cfg_kw)),
                          JO.AdamWConfig(**cfg_kw))
    assert np.isinf(float(jm["grad_norm"]))
    decay_only = {k: v - np.float32(1e-2) * (np.float32(0.1) * v)
                  for k, v in params.items()}
    for k in SHAPES:
        np.testing.assert_allclose(np.asarray(jp[k]), decay_only[k],
                                   rtol=1e-6, atol=0)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    tcfg = TO.AdamWConfig(**cfg_kw)
    _, tm = TO.update(tp, grads, TO.init(tp, tcfg), tcfg)
    assert torch.isfinite(tm["grad_norm"])
    for k in SHAPES:
        p = tp[k].numpy()
        assert np.isfinite(p).all(), k
        assert np.abs(p - decay_only[k]).max() > 1e-3, k


def test_sliced_update_with_the_whole_norm_is_the_whole_update():
    """As `train(mesh=)` updates: the norm of the whole overflowing
    gradient, then the rows of each leaf as separate leaves."""
    rng = np.random.default_rng(3)
    cfg = TO.AdamWConfig(lr=1e-2)
    shapes = {"a": (4, 256), "c": (6, 128)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = {k: torch.tensor((rng.normal(size=s) * 1e19).astype(np.float32))
             for k, s in shapes.items()}
    gnorm = TO.global_norm(grads)
    assert torch.isfinite(gnorm)
    whole = {k: torch.tensor(v) for k, v in params.items()}
    TO.update(whole, {k: v.clone() for k, v in grads.items()},
              TO.init(whole, cfg), cfg)
    halves = {f"{k}@{i}": torch.tensor(v[i * (v.shape[0] // 2):
                                         (i + 1) * (v.shape[0] // 2)])
              for k, v in params.items() for i in range(2)}
    g_halves = {f"{k}@{i}": v[i * (v.shape[0] // 2):
                              (i + 1) * (v.shape[0] // 2)].clone()
                for k, v in grads.items() for i in range(2)}
    TO.update(halves, g_halves, TO.init(halves, cfg), cfg, gnorm=gnorm)
    for k in shapes:
        assert torch.equal(torch.cat([halves[f"{k}@0"], halves[f"{k}@1"]]),
                           whole[k]), k


def test_an_inf_leaf_keeps_the_plain_norm():
    grads, _ = _grads(0, 1.0, "float32")
    grads["b"][5] = float("inf")
    assert torch.isinf(TO.global_norm(grads))
    grads["b"][5] = float("nan")
    assert torch.isnan(TO.global_norm(grads))


def test_meta_leaves_give_the_plain_norm_unread():
    grads = {k: torch.empty(s, device="meta") for k, s in SHAPES.items()}
    got = TO.global_norm(grads)
    assert got.device.type == "meta" and got.shape == ()
