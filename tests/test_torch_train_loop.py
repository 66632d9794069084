"""The port's training loop: ten steps of `train()` against ten steps of the
JAX package's `train()` from the same weights, and the JAX package's
integration tests (tests/test_train_integration.py) ported — the loss falls
on learnable data, a checkpointed resume is exact, the 8-bit optimizer
trains, the watchdog counts stragglers — with the loop's faults: a SIGTERM
during step k stops after it with a save that resumes at k + 1, a step that
raises leaves no new checkpoint, and a run with no step left writes none."""

import dataclasses
import os
import signal

import jax
import numpy as np
import pytest
import torch

import test_torch_lm_common as H
from repro.data.pipeline import DataConfig as JDataConfig
from repro.optim import adamw as JOPT
from repro.train import loop as JLOOP
from repro_torch import configs as TCONF
from repro_torch.ckpt import checkpoint as CKPT
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import convert as CV
from repro_torch.optim import adamw as OPT
from repro_torch.train import loop as LOOP
from repro_torch.train.loop import TrainConfig, Watchdog, train
from test_torch_train_common import few_threads  # noqa: F401

QUIET = dict(log_every=1000)


def test_ten_steps_match_jax_train(monkeypatch):
    """minitron-8b reduced in float32, both loops from JAX's weights (cast
    to float32: JAX's init draws bfloat16 leaves whatever the config's
    dtype, and the port's float32 config keeps float32 parameters), their
    query and key projections made well-conditioned as the step tests
    make them.  The loss histories agree within 1e-3 x the first loss
    (measured: 1e-6).  From JAX's init as drawn, whose attention is near
    an argmax, an ulp of a score picks another key and the histories part
    by 4.4e-3 at step 7, two thirds of the bound (measured)."""
    cfg, tcfg = H.configs("minitron-8b", "float32")
    seq = 32
    jparams = H.well_conditioned(H.jax_params(cfg, seq, "float32"))
    monkeypatch.setattr(JLOOP.C, "init_params", lambda defs, key: jparams)
    jout = JLOOP.train(cfg, JLOOP.TrainConfig(steps=10, **QUIET),
                       JDataConfig(vocab=cfg.vocab_, seq_len=seq,
                                   global_batch=4), JOPT.AdamWConfig(),
                       log_fn=lambda s: None)
    model = CV.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    monkeypatch.setattr(LOOP.LM, "init_params", lambda *a, **kw: model)
    tout = train(tcfg, TrainConfig(steps=10, **QUIET),
                 DataConfig(vocab=tcfg.vocab_, seq_len=seq, global_batch=4),
                 OPT.AdamWConfig(), device="cpu", log_fn=lambda s: None)
    got, want = np.array(tout["history"]), np.array(jout["history"])
    assert got.shape == want.shape == (10,)
    assert np.abs(got - want).max() <= 1e-3 * want[0], (got - want, want)
    assert tout["final_step"] == jout["final_step"] == 10
    assert tout["params"] is model


def test_loss_decreases_on_learnable_data():
    cfg = TCONF.reduced(TCONF.get_config("minitron-8b"))
    out = train(cfg, TrainConfig(steps=60, **QUIET),
                DataConfig(vocab=cfg.vocab_, seq_len=64, global_batch=8),
                OPT.AdamWConfig(lr=1e-3), device="cpu")
    h = out["history"]
    assert np.mean(h[-10:]) < np.mean(h[:10]) - 0.5, \
        f"loss did not drop: {np.mean(h[:10]):.3f} -> {np.mean(h[-10:]):.3f}"


def test_checkpoint_resume_is_exact(tmp_path):
    """Training 30 steps straight equals training 20, 'crashing', and
    resuming for 10 (the loss within 1e-5)."""
    cfg = TCONF.reduced(TCONF.get_config("mamba2-1.3b"))
    data = DataConfig(vocab=cfg.vocab_, seq_len=32, global_batch=4)
    opt = OPT.AdamWConfig(lr=5e-4)
    a = train(cfg, TrainConfig(steps=30, ckpt_dir=str(tmp_path / "a"),
                               ckpt_every=1000, **QUIET), data, opt,
              device="cpu")
    d2 = str(tmp_path / "b")
    train(cfg, TrainConfig(steps=20, ckpt_dir=d2, ckpt_every=10, **QUIET),
          data, opt, device="cpu")
    logs = []
    b = train(cfg, TrainConfig(steps=30, ckpt_dir=d2, ckpt_every=1000,
                               resume=True, **QUIET), data, opt,
              device="cpu", log_fn=logs.append)
    assert "[resume] restored step 20" in logs
    assert abs(a["loss"] - b["loss"]) < 1e-5, (a["loss"], b["loss"])
    assert b["history"] == a["history"][20:]


def test_8bit_optimizer_trains():
    cfg = TCONF.reduced(TCONF.get_config("minitron-8b"))
    out = train(cfg, TrainConfig(steps=30, **QUIET),
                DataConfig(vocab=cfg.vocab_, seq_len=32, global_batch=4),
                OPT.AdamWConfig(lr=1e-3, state_bits=8), device="cpu")
    losses = out["history"]
    assert losses[-1] < losses[0] - 0.3
    # 8-bit states really are int8
    q = [m for m in out["opt_state"].m.values()
         if isinstance(m, OPT.QTensor)]
    assert q and all(m.q.dtype == torch.int8 for m in q)


def test_watchdog_counts_stragglers():
    wd = Watchdog(factor=3.0)
    assert not wd.observe(0.1)
    for _ in range(5):
        wd.observe(0.1)
    assert wd.observe(1.0)      # 10x slower -> flagged
    assert wd.events == 1


def _tiny():
    cfg = TCONF.reduced(TCONF.get_config("minitron-8b"))
    return cfg, DataConfig(vocab=cfg.vocab_, seq_len=16, global_batch=2)


def test_sigterm_stops_after_the_step_and_resumes_next(tmp_path,
                                                       monkeypatch):
    """SIGTERM delivered while step 3's batch is fetched: the loop finishes
    step 3, saves step 4 (data step 4) and stops; a second run resumes
    there and takes steps 4-5 only."""
    cfg, data = _tiny()
    d = str(tmp_path)
    real = LOOP.DataIterator.batch_at

    def batch_at(self, step):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(self, step)

    monkeypatch.setattr(LOOP.DataIterator, "batch_at", batch_at)
    logs = []
    out = train(cfg, TrainConfig(steps=6, ckpt_dir=d, ckpt_every=1000,
                                 **QUIET), data, device="cpu",
                log_fn=logs.append)
    assert out["final_step"] == 4 and len(out["history"]) == 4
    assert "[preempt] signal at step 3; saving" in logs
    assert CKPT.latest_step(d) == 4
    monkeypatch.setattr(LOOP.DataIterator, "batch_at", real)
    assert signal.getsignal(signal.SIGTERM) is not None
    logs = []
    again = train(cfg, TrainConfig(steps=6, ckpt_dir=d, ckpt_every=1000,
                                   **QUIET), data, device="cpu",
                  log_fn=logs.append)
    assert "[resume] restored step 4" in logs
    assert len(again["history"]) == 2 and again["final_step"] == 6
    straight = train(cfg, TrainConfig(steps=6, **QUIET), data, device="cpu")
    assert abs(again["loss"] - straight["loss"]) < 1e-5


def test_a_step_that_raises_saves_nothing_more(tmp_path, monkeypatch):
    """An exception inside step 3 (its in-place update may have run part
    way) leaves the checkpoint of step 2 the newest, where the JAX loop
    would save the state as step 4."""
    cfg, data = _tiny()
    d = str(tmp_path)
    real = LOOP.TS.make_train_step

    def make(*a, **kw):
        step_fn, calls = real(*a, **kw), []

        def step(model, opt, batch):
            calls.append(1)
            if len(calls) == 4:
                raise RuntimeError("lost the device")
            return step_fn(model, opt, batch)
        return step

    monkeypatch.setattr(LOOP.TS, "make_train_step", make)
    with pytest.raises(RuntimeError, match="lost the device"):
        train(cfg, TrainConfig(steps=6, ckpt_dir=d, ckpt_every=2, **QUIET),
              data, device="cpu")
    assert CKPT.latest_step(d) == 2


def test_a_finished_run_writes_no_new_step(tmp_path):
    cfg, data = _tiny()
    d = str(tmp_path)
    train(cfg, TrainConfig(steps=3, ckpt_dir=d, **QUIET), data,
          device="cpu")
    assert sorted(os.listdir(d)) == ["step_00000003"]
    out = train(cfg, TrainConfig(steps=3, ckpt_dir=d, **QUIET), data,
                device="cpu")
    assert out["history"] == [] and out["final_step"] == 3
    assert sorted(os.listdir(d)) == ["step_00000003"]


def test_train_needs_a_device_where_there_is_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, data = _tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg, TrainConfig(steps=1), data)
