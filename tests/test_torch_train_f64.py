"""One train step's loss and gradients at the JAX package's init as drawn
(no query and key redraw), with both packages widened to float64: they
agree to F64_REL of each leaf's max|g|.

The float32 step tests (tests/test_torch_train_step_*.py) redraw the query
and key projections at 1/sqrt(fan-in) (`repro_torch.train.parity`): at the
init's 1/sqrt(heads) each attention softmax of a reduced model is near an
argmax, where float32 rounding grows, and there the two packages'
float32 gradients part by up to 1.2e-3 of max|g| (zamba2).  This file shows
that the gap is rounding and not a difference of the function: the same
step in float64 leaves no gap above 1e-10.

Both packages read their float32 type by name at call time, so a
subprocess (jax_enable_x64 is process-wide) widens them by pointing
`jnp.float32`, `torch.float32` and `torch.Tensor.float` at float64, and
replaces the port's two float32 tables (RoPE's frequencies by the C
library's powf, whisper's sinusoid) by float64 ones.  The weights are
JAX's float32 draws, widened exactly.

    python tests/test_torch_train_f64.py --f32 zamba2-2.7b whisper-large-v3

prints, per architecture, the float64 gap and also the float32 gaps: the
port against JAX, and each package against the float64 step.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# the architectures whose float32 gradients part most at JAX's init, and
# deepseek-v3 for MLA's w_uq / w_uk
ARCHS = ("zamba2-2.7b", "whisper-large-v3", "minitron-8b",
         "moonshot-v1-16b-a3b", "deepseek-v3-671b")
F64_REL = 1e-10
LOSS_REL = 1e-12


def _grads(jax, jnp, np, cfg, tcfg, params, data):
    """JAX's and the port's loss and gradients (port names, float64
    numpy) of one step from `params` (a JAX tree of numpy arrays)."""
    import test_torch_train_common as T
    from repro.train import step as JTS
    from repro_torch.models import convert as CV
    from repro_torch.train import step as TTS
    vg = jax.jit(jax.value_and_grad(JTS.make_loss_fn(cfg, remat=False),
                                    has_aux=True))
    (jl, _), jg = vg(jax.tree.map(jnp.asarray, params),
                     {k: jnp.asarray(v) for k, v in data.items()})
    model = CV.lm_params_from_numpy(tcfg, params, device="cpu")
    tl, _, tg = TTS.value_and_grad(TTS.make_loss_fn(tcfg, remat=False),
                                   model, T.port_batch(data))
    want = CV.unstack_named(jax.tree.map(np.asarray, jg), list(tg))
    return (float(jl), float(tl),
            {n: want[n].numpy().astype(np.float64) for n in tg},
            {n: g.detach().numpy().astype(np.float64)
             for n, g in tg.items()})


def _gap(np, a, b):
    """The largest |a - b| over max|b|, leaf by leaf: (gap, leaf)."""
    return max((float(np.abs(a[n] - b[n]).max())
                / max(float(np.abs(b[n]).max()), 1e-300), n) for n in a)


def main(argv) -> None:
    f32 = "--f32" in argv
    archs = [a for a in argv if a != "--f32"]
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(2)
    import test_torch_lm_common as H
    import test_torch_train_common as T
    from repro_torch.models import common as TC

    def freqs(theta, half, device):
        expo = -np.arange(half, dtype=np.float64) / half
        return torch.tensor(theta ** expo, device=device)

    def sinusoid(seq, dim, device=None):
        angle = (np.arange(seq)[:, None]
                 / np.power(10000.0, 2 * np.arange(dim // 2)[None] / dim))
        return torch.as_tensor(np.concatenate([np.sin(angle),
                                               np.cos(angle)], -1),
                               device=device)

    names = (jnp, "float32"), (torch, "float32"), (torch.Tensor, "float"), \
        (TC, "_rope_freqs"), (TC, "sinusoidal_pos")
    narrow = [getattr(o, n) for o, n in names]
    wide = [jnp.float64, torch.float64, torch.Tensor.double, freqs,
            sinusoid]
    for arch in archs:
        cfg, tcfg = H.configs(arch, "float32")
        data = T.batch(cfg)
        params = jax.tree.map(np.asarray, H.jax_params(cfg, T.S, "float32"))
        out = {"arch": arch}
        if f32:
            jl, tl, jg, tg = _grads(jax, jnp, np, cfg, tcfg, params, data)
        for (o, n), v in zip(names, wide):
            setattr(o, n, v)
        try:
            p64 = jax.tree.map(lambda a: a.astype(np.float64), params)
            jl64, tl64, jg64, tg64 = _grads(jax, jnp, np, cfg, tcfg, p64,
                                            data)
        finally:
            for (o, n), v in zip(names, narrow):
                setattr(o, n, v)
        out.update(loss64=(tl64, jl64), gap64=_gap(np, tg64, jg64),
                   dtypes=sorted({str(g.dtype) for g in tg64.values()}))
        if f32:
            out.update(loss32=(tl, jl), gap32=_gap(np, tg, jg),
                       jax32_to_64=_gap(np, jg, jg64),
                       port32_to_64=_gap(np, tg, tg64))
        print("F64 " + json.dumps(out), flush=True)


@pytest.fixture(scope="module")
def readings():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        *ARCHS], capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    rows = [json.loads(line[4:]) for line in r.stdout.splitlines()
            if line.startswith("F64 ")]
    return {row["arch"]: row for row in rows}


@pytest.mark.parametrize("arch", ARCHS)
def test_step_at_jax_init_matches_in_float64(readings, arch):
    """Loss within LOSS_REL, every gradient leaf within F64_REL of its
    max|g| (measured: 1.8e-12 at most, whisper), all in float64."""
    row = readings[arch]
    assert row["dtypes"] == ["float64"], row
    tl, jl = row["loss64"]
    assert abs(tl - jl) <= LOSS_REL * abs(jl), row
    gap, leaf = row["gap64"]
    assert gap <= F64_REL, (leaf, gap)


if __name__ == "__main__":
    main(sys.argv[1:])
