"""Gradient compression of the port against the JAX package's: int8
quantization bit-equal, JAX's bounded-error and error-feedback tests
ported, `compress_psum` over per-shard gradients against JAX's under
`shard_map` on 4 fake XLA devices (in a subprocess, as
tests/test_compressed_dp.py runs them), and the compressed data-parallel
step learning on a 4-shard logical CPU mesh (JAX's test, ported)."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compress as JGC
from repro_torch import configs as TCONF
from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm as TLM
from repro_torch.optim import adamw as OPT
from repro_torch.optim import compress as GC
from repro_torch.train import dp_compressed as DPC
from repro_torch.train.loop import batch_to
from test_torch_train_common import few_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 1e4),
                                        (3, 0.0)])
def test_quantize_int8_is_bit_equal(seed, scale):
    g = (np.random.default_rng(seed).normal(size=(37, 129)) * scale
         ).astype(np.float32)
    jq, js = JGC.quantize_int8(jnp.asarray(g))
    tq, ts = GC.quantize_int8(torch.tensor(g))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(GC.dequantize_int8(tq, ts).numpy(),
                                  np.asarray(JGC.dequantize_int8(jq, js)))


def test_int8_quantization_bounded_error():
    rng = np.random.default_rng(0)
    g = torch.tensor(rng.normal(size=(1000,)).astype(np.float32))
    q, s = GC.quantize_int8(g)
    deq = GC.dequantize_int8(q, s)
    assert float(torch.max(torch.abs(deq - g))) <= float(s) * 0.5 + 1e-7


def test_error_feedback_unbiased_over_time():
    """EF accumulates what quantization drops: summed compressed updates
    converge to summed true gradients."""
    rng = np.random.default_rng(1)
    true_sum = np.zeros(64, np.float32)
    sent_sum = np.zeros(64, np.float32)
    r = torch.zeros(64)
    for _ in range(200):
        g = torch.tensor(rng.normal(size=64).astype(np.float32))
        true_sum += g.numpy()
        gq = g + r
        q, s = GC.quantize_int8(gq)
        deq = GC.dequantize_int8(q, s)
        r = gq - deq
        sent_sum += deq.numpy()
    resid = np.abs(true_sum - sent_sum)
    assert resid.max() <= float(torch.max(torch.abs(r))) + 1e-5


JAX_PSUM = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.sharding import shard_map
from repro.optim import compress as GC
src = np.load(sys.argv[1])
mesh = jax.make_mesh((4,), ("data",))
names = ("a", "b")

def inner(grads, residual):
    g = {k: v[0] for k, v in grads.items()}
    r = {k: v[0] for k, v in residual.items()}
    mean, new_r = GC.compress_psum(g, r, ("data",))
    return mean, {k: v[None] for k, v in new_r.items()}

spec = {k: P("data") for k in names}
f = jax.jit(shard_map(inner, mesh, in_specs=(spec, spec),
                      out_specs=({k: P() for k in names}, spec)))
grads = {k: jnp.asarray(src["g_" + k]) for k in names}
res = {k: jnp.asarray(src["r_" + k]) for k in names}
out = {}
for step in range(3):
    mean, res = f(grads, res)
    for k in names:
        out[f"mean{step}_{k}"] = np.asarray(mean[k])
        out[f"res{step}_{k}"] = np.asarray(res[k])
np.savez(sys.argv[2], **out)
print("JAX_PSUM_OK")
"""


def test_compress_psum_matches_jax_shard_map(tmp_path):
    """Four shards' gradients through three rounds of error feedback (the
    same gradients each round, the residuals carried): the mean within 1
    float32 ulp of JAX's psum on 4 fake devices, and every shard's
    residual after round t (from 1) within t ulps of the largest |g + r|
    it was taken from: XLA's CPU jit contracts `g - q * scale` into one
    FMA (hazard H1), which rounds once where PyTorch rounds the product
    (at most 127 * scale, an ulp of that largest element) and then the
    difference, and the residual carries the difference to the next
    round."""
    rng = np.random.default_rng(7)
    src = {"g_a": rng.normal(size=(4, 64, 33)).astype(np.float32),
           "g_b": (rng.normal(size=(4, 100)) * 1e-3).astype(np.float32),
           "r_a": np.zeros((4, 64, 33), np.float32),
           "r_b": (rng.normal(size=(4, 100)) * 1e-6).astype(np.float32)}
    np.savez(tmp_path / "src.npz", **src)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", JAX_PSUM,
                        str(tmp_path / "src.npz"), str(tmp_path / "out.npz")],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    want = np.load(tmp_path / "out.npz")
    grads = [{k: torch.tensor(src["g_" + k][s]) for k in "ab"}
             for s in range(4)]
    res = [{k: torch.tensor(src["r_" + k][s]) for k in "ab"}
           for s in range(4)]

    def ulps(a, b):
        return np.abs(np.asarray(a, np.float32).view(np.int32).astype(
            np.int64) - np.asarray(b, np.float32).view(np.int32)).max()

    for step in range(3):
        taken = [{k: (grads[s][k] + res[s][k]).numpy() for k in "ab"}
                 for s in range(4)]
        mean, res = GC.compress_psum(grads, res)
        for k in "ab":
            assert ulps(mean[k].numpy(), want[f"mean{step}_{k}"]) <= 1, k
            for s in range(4):
                d = np.abs(res[s][k].numpy() - want[f"res{step}_{k}"][s])
                bound = (step + 1) * np.spacing(np.abs(taken[s][k]).max())
                assert d.max() <= bound, (k, s, d.max(), bound)


def test_compressed_dp_training_learns():
    mesh = Mesh([torch.device("cpu")] * 4, ("data",))
    cfg = TCONF.reduced(TCONF.get_config("minitron-8b"))
    model = TLM.init_params(cfg, max_seq=32, device="cpu", seed=0)
    ocfg = OPT.AdamWConfig(lr=1e-3)
    opt = OPT.init(model, ocfg)
    residual = DPC.init_residual(model, mesh)
    step = DPC.make_compressed_dp_step(cfg, mesh, ocfg)
    it = DataIterator(DataConfig(vocab=cfg.vocab_, seq_len=32,
                                 global_batch=8))
    losses = []
    for i in range(25):
        opt, residual, m = step(model, opt, residual,
                                batch_to(it.batch_at(i), torch.device("cpu")))
        losses.append(float(m["loss"]))
    it.close()
    assert losses[-1] < losses[0] - 0.5, losses
    assert len(residual) == 4 and opt.step == 25
    # each shard carries its own residual
    assert not torch.equal(residual[0]["embed"], residual[1]["embed"])


def test_compressed_dp_refuses_a_batch_that_does_not_split():
    mesh = Mesh([torch.device("cpu")] * 4, ("data",))
    cfg = TCONF.reduced(TCONF.get_config("minitron-8b"))
    model = TLM.init_params(cfg, max_seq=8, device="cpu", seed=0)
    step = DPC.make_compressed_dp_step(cfg, mesh)
    batch = {"tokens": torch.zeros(6, 8, dtype=torch.long),
             "labels": torch.zeros(6, 8, dtype=torch.long)}
    with pytest.raises(ValueError, match="does not split"):
        step(model, OPT.init(model, OPT.AdamWConfig()),
             DPC.init_residual(model, mesh), batch)
