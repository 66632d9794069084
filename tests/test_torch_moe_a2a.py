"""The port's expert-parallel MoE (`repro_torch.models.moe_a2a`) against
the JAX package's `moe_a2a_forward` under `shard_map` on 8 fake XLA
devices, from the same numpy weights and inputs.

JAX runs once, in a subprocess, for every case of the file: meshes (2, 4)
and (1, 8) of ("data", "model"), each at capacity_factor 8.0 (nothing
dropped) and 1.0 (rows dropped), the forward and the gradients of
sum(y ** 2) with respect to the four weights, each jitted (eager
`shard_map` on 8 fake devices takes minutes).  Its meshes are built with
`axis_types=(AxisType.Auto,) * 2`: jax 0.9's `jax.make_mesh` gives
Explicit axes, under which `jax.grad` of the module fails (the JAX
package's own test, tests/test_moe_a2a.py, fails there for that reason).

Bounds: the forward within 1e-6 * max|y| of JAX's, every weight gradient
within 1e-5 * max|g| of JAX's leaf; and the (token, choice) rows the port
drops are the ones JAX drops.  JAX's output does not name its dropped
rows, so they are read off its forward: each token's output is the sum of
its kept choices' contributions (weight times expert FFN, computed here
in float64), and the subset of choices whose sum is nearest JAX's output
is JAX's kept set.
"""

import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import logical_mesh
from repro_torch.models import common as C
from repro_torch.models import moe as MOE
from repro_torch.models.moe_a2a import moe_a2a_forward

ROOT = Path(__file__).resolve().parents[1]
D, E, K, F_ = 32, 8, 2, 16
B, S = 4, 16
MESHES = [(2, 4), (1, 8)]
FACTORS = [8.0, 1.0]
LEAVES = ("router", "w_gate", "w_up", "w_down")
FWD_REL = 1e-6
GRAD_REL = 1e-5

JAX_A2A = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.models.moe import MoEConfig, route
from repro.models.moe_a2a import moe_a2a_forward
src = np.load(sys.argv[1])
params = {k: jnp.asarray(src[k]) for k in %(leaves)r}
x = jnp.asarray(src["x"])
out = {}
for shape in %(meshes)r:
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    for cf in %(factors)r:
        cfg = MoEConfig(d_model=%(d)d, n_experts=%(e)d, top_k=%(k)d,
                        expert_ff=%(f)d, n_shared=0, capacity_factor=cf)
        tag = f"{shape[0]}x{shape[1]}_{cf}"
        fwd = lambda p: moe_a2a_forward(p, x, cfg, mesh)
        out["y_" + tag] = np.asarray(jax.jit(fwd)(params))
        g = jax.jit(jax.grad(lambda p: jnp.sum(fwd(p) ** 2)))(params)
        for k in %(leaves)r:
            out[f"g_{k}_{tag}"] = np.asarray(g[k])
w, idx, _ = route(params["router"], x, cfg)
out["route_w"], out["route_idx"] = np.asarray(w), np.asarray(idx)
np.savez(sys.argv[2], **out)
print("JAX_A2A_OK")
""" % dict(leaves=LEAVES, meshes=MESHES, factors=FACTORS, d=D, e=E, k=K,
           f=F_)


def _inputs():
    rng = np.random.default_rng(22)
    return {
        "router": (rng.normal(size=(D, E)) / np.sqrt(D)).astype(np.float32),
        "w_gate": (rng.normal(size=(E, D, F_)) / np.sqrt(D)
                   ).astype(np.float32),
        "w_up": (rng.normal(size=(E, D, F_)) / np.sqrt(D)
                 ).astype(np.float32),
        "w_down": (rng.normal(size=(E, F_, D)) / np.sqrt(F_)
                   ).astype(np.float32),
        "x": (rng.normal(size=(B, S, D)) * 0.5).astype(np.float32),
    }


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("a2a")
    np.savez(tmp / "src.npz", **_inputs())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", JAX_A2A, str(tmp / "src.npz"),
                        str(tmp / "out.npz")], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


def _port(cf):
    cfg = MOE.MoEConfig(d_model=D, n_experts=E, top_k=K, expert_ff=F_,
                        capacity_factor=cf)
    moe = MOE.MoE(cfg, C.Init(torch.float32, torch.device("cpu")))
    src = _inputs()
    with torch.no_grad():
        for k in LEAVES:
            getattr(moe, k).copy_(torch.from_numpy(src[k]))
    return cfg, moe, torch.from_numpy(src["x"])


def _jax_kept(y, x, route_w, route_idx, src):
    """JAX's kept (token, choice) set, from its forward (see above)."""
    xf = x.astype(np.float64).reshape(-1, D)
    w = route_w.reshape(-1, K).astype(np.float64)
    idx = route_idx.reshape(-1, K)
    yf = y.reshape(-1, D).astype(np.float64)
    kept = np.zeros((xf.shape[0], K), bool)
    subsets = list(itertools.product([False, True], repeat=K))
    for t in range(xf.shape[0]):
        contrib = []
        for c in range(K):
            e = idx[t, c]
            h = xf[t] @ src["w_gate"][e]
            h = h / (1 + np.exp(-h)) * (xf[t] @ src["w_up"][e])
            contrib.append(w[t, c] * (h @ src["w_down"][e]))
        errs = [np.abs(yf[t] - sum((contrib[c] for c in range(K) if m[c]),
                                   np.zeros(D))).max() for m in subsets]
        kept[t] = subsets[int(np.argmin(errs))]
    return kept.reshape(B, S, K)


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_forward_and_gradients_match_jax(jax_out, shape, cf):
    tag = f"{shape[0]}x{shape[1]}_{cf}"
    cfg, moe, x = _port(cf)
    for k in LEAVES:
        getattr(moe, k).requires_grad_(True)
    mesh = logical_mesh("cpu", shape)
    y = moe_a2a_forward(moe, x, cfg, mesh)
    want = jax_out["y_" + tag]
    err = np.abs(y.detach().numpy() - want).max()
    assert err <= FWD_REL * np.abs(want).max(), (tag, err)
    torch.sum(y ** 2).backward()
    for k in LEAVES:
        g = getattr(moe, k).grad.numpy()
        gw = jax_out[f"g_{k}_{tag}"]
        gerr = np.abs(g - gw).max()
        assert gerr <= GRAD_REL * np.abs(gw).max(), (tag, k, gerr)


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_dropped_rows_match_jax(jax_out, shape, cf):
    tag = f"{shape[0]}x{shape[1]}_{cf}"
    cfg, moe, x = _port(cf)
    mesh = logical_mesh("cpu", shape)
    with torch.no_grad():
        y, dropped = moe_a2a_forward(moe, x, cfg, mesh, with_dropped=True)
        _, idx, _ = moe.route(x)
    np.testing.assert_array_equal(idx.numpy(), jax_out["route_idx"])
    kept = _jax_kept(jax_out["y_" + tag], x.numpy(), jax_out["route_w"],
                     jax_out["route_idx"], _inputs())
    np.testing.assert_array_equal(~dropped.numpy(), kept)
    if cf == 8.0:
        assert not dropped.any()
    else:
        assert dropped.any()


def test_refuses_experts_that_do_not_split():
    cfg, moe, x = _port(8.0)
    mesh = logical_mesh("cpu", (1, 3))
    with pytest.raises(ValueError, match="do not split"):
        moe_a2a_forward(moe, x, cfg, mesh)
