"""The port's LM serving (`repro_torch.serve.engine.Engine`, `serve_queue`,
`python -m repro_torch.launch.serve`) against the JAX package's.

Greedy float32 generation gives the same tokens as JAX's `Engine` for one
architecture of each family, at reduced size with JAX's weights carried
across.  The JAX engine's cache defs are widened to float32 on the instance
(its `ParamDef`s default to bf16 whatever the weights), so both engines
decode against float32 caches, as the port does for a float32 config.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import common as JC
from repro.models import lm as JLM
from repro.serve import engine as JE
from repro_torch import configs as TCONF
from repro_torch.models import convert as CV
from repro_torch.models import lm as TLM
from repro_torch.serve import engine as TE
from test_torch_lm_common import f32_cache_defs

ROOT = Path(__file__).resolve().parents[1]
B, S, NEW, MAX_LEN = 2, 32, 6, 64


def pair(arch):
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    tcfg = dataclasses.replace(TCONF.reduced(TCONF.get_config(arch)),
                               dtype="float32")
    params = jax.tree.map(
        lambda a: a.astype(jnp.float32),
        JC.init_params(JLM.model_defs(cfg, max_seq=MAX_LEN),
                       jax.random.key(0)))
    model = CV.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    return cfg, params, tcfg, model


def engines(arch, monkeypatch, batch=B):
    cfg, params, tcfg, model = pair(arch)
    jeng = JE.Engine(cfg, params, JE.EngineConfig(batch=batch,
                                                  max_len=MAX_LEN))
    monkeypatch.setattr(jeng, "_cache_defs", f32_cache_defs(jeng._cache_defs))
    teng = TE.Engine(tcfg, model, TE.EngineConfig(batch=batch,
                                                  max_len=MAX_LEN),
                     device="cpu")
    return cfg, jeng, teng


@pytest.mark.parametrize("arch", ["minitron-8b", "moonshot-v1-16b-a3b",
                                  "whisper-large-v3", "pixtral-12b",
                                  "mamba2-1.3b", "zamba2-2.7b"])
def test_greedy_generate_matches_jax(arch, monkeypatch):
    cfg, jeng, teng = engines(arch, monkeypatch)
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    kw = {}
    if cfg.family == "audio":
        kw["frames"] = (rng.normal(size=(B, cfg.enc_seq, cfg.d_model))
                        * 0.1).astype(np.float32)
    if cfg.family == "vlm":
        kw["patches"] = (rng.normal(size=(B, cfg.n_patches, cfg.d_model))
                         * 0.1).astype(np.float32)
    want, _ = jeng.generate(prompts, NEW,
                            **{k: jnp.asarray(v) for k, v in kw.items()})
    got, stats = teng.generate(prompts, NEW, **kw)
    assert got.dtype == np.int32 and got.shape == (B, NEW)
    assert np.array_equal(got, np.asarray(want))
    assert stats["prefill_s"] > 0 and stats["decode_tok_per_s"] > 0


def test_serve_queue_matches_jax(monkeypatch):
    """Requests of several lengths, left-padded into batches of 2 (the last
    batch padded with a copy): the same tokens for every uid."""
    cfg, jeng, teng = engines("minitron-8b", monkeypatch)
    rng = np.random.default_rng(4)
    lens = (8, 12, 12, 5, 9)
    reqs = [dict(uid=u, prompt=rng.integers(0, cfg.vocab, n).astype(np.int32))
            for u, n in enumerate(lens)]
    want = JE.serve_queue(jeng, [JE.Request(**r) for r in reqs], 4)
    got = TE.serve_queue(teng, [TE.Request(**r) for r in reqs], 4)
    assert sorted(got) == sorted(want) == list(range(len(lens)))
    for uid in want:
        assert np.array_equal(got[uid], np.asarray(want[uid])), uid


def test_sampling_is_seeded():
    """Non-greedy draws come from a generator seeded from `seed`: the same
    seed gives the same tokens (they are not jax.random's)."""
    _, _, tcfg, model = pair("minitron-8b")
    eng = TE.Engine(tcfg, model, TE.EngineConfig(batch=B, max_len=MAX_LEN,
                                                 greedy=False,
                                                 temperature=2.0),
                    device="cpu")
    prompts = np.random.default_rng(5).integers(0, tcfg.vocab, (B, 8))
    a, _ = eng.generate(prompts, 8, seed=1)
    b, _ = eng.generate(prompts, 8, seed=1)
    c, _ = eng.generate(prompts, 8, seed=2)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < tcfg.vocab_


def test_engine_without_a_device_needs_a_card(monkeypatch):
    """No device means the card; where there is none the engine raises
    (no fallback to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = TCONF.reduced(TCONF.get_config("minitron-8b"))
    model = TLM.init_params(tcfg, max_seq=MAX_LEN, device="cpu", seed=0)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        TE.Engine(tcfg, model, TE.EngineConfig(batch=B, max_len=MAX_LEN))
    with pytest.raises(ValueError, match="build the model there"):
        TE.Engine(tcfg, TLM.init_params(tcfg, device="meta"),
                  TE.EngineConfig(batch=B, max_len=MAX_LEN), device="cpu")


def test_position_past_the_cache_is_refused():
    """JAX clamps a decode position past the cache onto its last slot; the
    port refuses it, in the engine before any work and in decode_step."""
    tcfg = TCONF.reduced(TCONF.get_config("minitron-8b"))
    model = TLM.init_params(tcfg, max_seq=16, device="cpu", seed=0)
    eng = TE.Engine(tcfg, model, TE.EngineConfig(batch=1, max_len=16),
                    device="cpu")
    prompts = np.zeros((1, 12), np.int32)
    eng.generate(prompts, 5)                  # positions 12..15: fits
    with pytest.raises(ValueError, match="past the cache"):
        eng.generate(prompts, 6)
    cache = TLM.new_cache(tcfg, 1, 16, device="cpu")
    cache["pos"] = 16
    with pytest.raises(ValueError, match="outside the cache"):
        model.decode_step(torch.zeros(1, 1, dtype=torch.long), cache)
    # a mamba2 cache holds no positions: decoding has no such limit
    scfg = TCONF.reduced(TCONF.get_config("mamba2-1.3b"))
    smodel = TLM.init_params(scfg, device="cpu", seed=0)
    scache = TLM.new_cache(scfg, 1, 16, device="cpu")
    scache["pos"] = 40
    smodel.decode_step(torch.zeros(1, 1, dtype=torch.long), scache)
    assert scache["pos"] == 41


def _launch(*args, device_flag=True):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *args]
    if device_flag:
        cmd += ["--device", "cpu"]
    return subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)


@pytest.mark.parametrize("arch", ["minitron-8b", "gemma3-27b"])
def test_launcher_serves_on_the_cpu(arch):
    out = _launch("--arch", arch, "--reduced", "--batch", "2",
                  "--new-tokens", "4")
    assert out.returncode == 0, out.stderr
    assert "device: cpu" in out.stdout and "tok/s" in out.stdout


def test_launcher_without_a_card_exits_2():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the launcher would run there")
    out = _launch("--arch", "minitron-8b", "--reduced", device_flag=False)
    assert out.returncode == 2
    assert "--device cpu" in out.stderr
