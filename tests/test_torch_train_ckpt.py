"""Training checkpoints cross between the packages (hazard H7), at reduced
size with bfloat16 parameters and 32- and 8-bit AdamW states: a step the
port wrote restores through the JAX package's `CKPT.restore` into JAX's
state tree and equals the port's state, converted; a step JAX wrote
restores in the port and equals JAX's; JAX's `train()` resumes from a
directory the port wrote and runs to its end, and the port's from one JAX
wrote.  Also: the bfloat16 and int8 leaves of the format on their own,
with the keys JAX spells."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as JCKPT
from repro.configs import get_config, reduced
from repro.data.pipeline import DataConfig as JDataConfig
from repro.models import common as JC
from repro.models import lm as JLM
from repro.optim import adamw as JOPT
from repro.train import loop as JLOOP
from repro_torch import configs as TCONF
from repro_torch.ckpt import checkpoint as CKPT
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import convert as CV
from repro_torch.models import lm as TLM
from repro_torch.optim import adamw as OPT
from repro_torch.train import loop as LOOP
from test_torch_train_common import few_threads  # noqa: F401

ARCH = "minitron-8b"
SEQ = 16
QUIET = dict(log_every=1000)


def _cfgs():
    return reduced(get_config(ARCH)), TCONF.reduced(TCONF.get_config(ARCH))


def _data(cfg, cls):
    return cls(vocab=cfg.vocab_, seq_len=SEQ, global_batch=2)


def _jax_like(cfg, bits):
    params = JC.init_params(JLM.model_defs(cfg, max_seq=SEQ),
                            jax.random.key(0))
    return {"params": params,
            "opt": JOPT.init(params, JOPT.AdamWConfig(state_bits=bits))}


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


def _same_params(jax_params, model):
    want = jax.tree.map(_f32, jax_params)
    got = CV.lm_params_to_numpy(model)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    for path, w in flat_w:
        g = got
        for p in path:
            g = g[p.key]
        np.testing.assert_array_equal(g, w, err_msg=str(path))


def _same_opt(jax_opt, state):
    want = CV.opt_state_to_numpy(state)
    assert int(jax_opt.step) == int(want.step) == state.step
    is_q = lambda x: isinstance(x, JOPT.QTensor)
    for jt, wt in ((jax_opt.m, want.m), (jax_opt.v, want.v)):
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                jt, is_leaf=is_q):
            w = wt
            for p in path:
                w = w[p.key]
            if is_q(leaf):
                assert isinstance(w, OPT.QTensor)
                assert np.asarray(leaf.q).dtype == np.int8
                np.testing.assert_array_equal(np.asarray(leaf.q), w.q)
                np.testing.assert_array_equal(np.asarray(leaf.scale),
                                              w.scale)
            else:
                np.testing.assert_array_equal(np.asarray(leaf), w)


@pytest.mark.parametrize("bits", [32, 8])
def test_port_step_restores_in_jax(tmp_path, bits):
    cfg, tcfg = _cfgs()
    d = str(tmp_path)
    out = LOOP.train(tcfg, LOOP.TrainConfig(steps=2, ckpt_dir=d, **QUIET),
                     _data(tcfg, DataConfig),
                     OPT.AdamWConfig(state_bits=bits), device="cpu")
    assert next(out["params"].parameters()).dtype == torch.bfloat16
    assert JCKPT.latest_step(d) == 2
    restored, extra = JCKPT.restore(d, 2, _jax_like(cfg, bits))
    assert extra["data_step"] == 2
    assert jax.tree.leaves(restored["params"])[0].dtype == jnp.bfloat16
    _same_params(restored["params"], out["params"])
    _same_opt(restored["opt"], out["opt_state"])


@pytest.mark.parametrize("bits", [32, 8])
def test_jax_step_restores_in_the_port(tmp_path, bits):
    cfg, tcfg = _cfgs()
    d = str(tmp_path)
    JLOOP.train(cfg, JLOOP.TrainConfig(steps=2, ckpt_dir=d, **QUIET),
                _data(cfg, JDataConfig), JOPT.AdamWConfig(state_bits=bits),
                log_fn=lambda s: None)
    want, _ = JCKPT.restore(d, 2, _jax_like(cfg, bits))
    model = TLM.init_params(tcfg, max_seq=SEQ, device="cpu", seed=5)
    state0 = OPT.init(model, OPT.AdamWConfig(state_bits=bits))
    restored, extra = CKPT.restore(d, 2, LOOP.state_tree(model, state0))
    assert restored["params"]["embed"].dtype == torch.bfloat16
    state = LOOP.load_state(restored, model)
    assert extra["data_step"] == 2 and state.step == 2
    _same_params(want["params"], model)
    _same_opt(want["opt"], state)


@pytest.mark.parametrize("bits", [32, 8])
def test_jax_train_resumes_a_port_run(tmp_path, bits):
    cfg, tcfg = _cfgs()
    d = str(tmp_path)
    LOOP.train(tcfg, LOOP.TrainConfig(steps=2, ckpt_dir=d, **QUIET),
               _data(tcfg, DataConfig), OPT.AdamWConfig(state_bits=bits),
               device="cpu")
    logs = []
    out = JLOOP.train(cfg, JLOOP.TrainConfig(steps=4, ckpt_dir=d, **QUIET),
                      _data(cfg, JDataConfig),
                      JOPT.AdamWConfig(state_bits=bits), log_fn=logs.append)
    assert "[resume] restored step 2" in logs
    assert out["final_step"] == 4 and len(out["history"]) == 2
    assert np.isfinite(out["loss"])


@pytest.mark.parametrize("bits", [32, 8])
def test_port_train_resumes_a_jax_run(tmp_path, bits):
    cfg, tcfg = _cfgs()
    d = str(tmp_path)
    JLOOP.train(cfg, JLOOP.TrainConfig(steps=2, ckpt_dir=d, **QUIET),
                _data(cfg, JDataConfig), JOPT.AdamWConfig(state_bits=bits),
                log_fn=lambda s: None)
    logs = []
    out = LOOP.train(tcfg, LOOP.TrainConfig(steps=4, ckpt_dir=d, **QUIET),
                     _data(tcfg, DataConfig),
                     OPT.AdamWConfig(state_bits=bits), device="cpu",
                     log_fn=logs.append)
    assert "[resume] restored step 2" in logs
    assert out["final_step"] == 4 and len(out["history"]) == 2
    assert CKPT.latest_step(d) == 4


def test_bf16_and_int8_leaves_keep_the_jax_format(tmp_path):
    """bfloat16 leaves are stored as raw uint16 words with logical dtype
    "bfloat16" (what the JAX writer stores), int8 as int8, both packages
    read each other's, and restore gives bf16 tensors on the device asked
    for."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 5)).astype(np.float32)
    q = rng.integers(-127, 128, (4, 128)).astype(np.int8)
    port_tree = {"w": torch.tensor(w).to(torch.bfloat16),
                 "q": torch.tensor(q)}
    jax_tree = {"w": jnp.asarray(w, jnp.bfloat16), "q": jnp.asarray(q)}
    CKPT.save(str(tmp_path / "port"), 1, port_tree)
    JCKPT.save(str(tmp_path / "jax"), 1, jax_tree)
    for d in ("port", "jax"):
        with open(tmp_path / d / "step_00000001" / "manifest.json") as f:
            keys = json.load(f)["keys"]
        assert keys["w"] == {"shape": [3, 5], "dtype": "bfloat16"}
        assert keys["q"] == {"shape": [4, 128], "dtype": "int8"}
        with np.load(tmp_path / d / "step_00000001" / "shard_0.npz") as z:
            assert z["w"].dtype == np.uint16 and z["q"].dtype == np.int8
        got, _ = CKPT.restore(str(tmp_path / d), 1, {
            "w": torch.zeros(3, 5, dtype=torch.bfloat16),
            "q": torch.zeros(4, 128, dtype=torch.int8)},
            shardings={"w": torch.device("cpu"), "q": None})
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"], port_tree["w"])
        assert torch.equal(got["q"], port_tree["q"])
        back, _ = JCKPT.restore(str(tmp_path / d), 1, jax_tree)
        assert back["w"].dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(back["w"], np.float32),
                                      np.asarray(jax_tree["w"], np.float32))


def test_training_keys_are_spelled_as_jax_spells_them(tmp_path):
    """The port's training checkpoint has exactly the keys, shapes and
    dtypes of the JAX package's, in 8-bit mode (a quantized moment's q and
    scale as children 0 and 1)."""
    cfg, tcfg = _cfgs()
    model = TLM.init_params(tcfg, max_seq=SEQ, device="cpu", seed=0)
    state = OPT.init(model, OPT.AdamWConfig(state_bits=8))
    CKPT.save(str(tmp_path / "port"), 1, LOOP.state_tree(model, state))
    JCKPT.save(str(tmp_path / "jax"), 1, _jax_like(cfg, 8))
    keys = []
    for d in ("port", "jax"):
        with open(tmp_path / d / "step_00000001" / "manifest.json") as f:
            keys.append(json.load(f)["keys"])
    assert keys[0] == keys[1]
    assert "opt/.m/embed/0" in keys[0] and "opt/.m/embed/1" in keys[0]
    assert keys[0]["opt/.step"]["dtype"] == "int32"
