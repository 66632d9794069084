"""Fault-tolerant training loop; the JAX package's `repro.train.loop`, on the
card unless the caller asks for the CPU.

  * auto-resume: on start, restore the latest valid checkpoint (params,
    optimizer state, data step) and continue exactly (the data pipeline is
    step-indexed, so batch k after a restart is batch k before the crash);
  * async checkpointing every `ckpt_every` steps: the state is copied to
    the host before `save` returns, so the next step's in-place update
    cannot change what is written (hazard H6), and the files are written
    on a thread;
  * preemption safety: SIGTERM/SIGINT stop the run after the current step,
    and a last synchronous save follows;
  * straggler watchdog: an EMA of the step time flags steps slower than
    `watchdog_factor` x the average; here it logs and counts;
  * a device mesh (`mesh=`): the run goes under `sharding.use_mesh(mesh)`;
    the batch splits over the "batch" rule's shards and the parameters and
    32-bit moments are held as slices between steps
    (`repro_torch.train.sharded`);
  * elastic restart: a checkpoint holds whole arrays, restored onto the
    run's device (the mesh's first) and cut into the slices of the
    restoring run's mesh, so a run saved under one mesh resumes under
    another, or under none.

A checkpoint is the JAX package's training checkpoint, key for key:
``params/...`` in the stacked layout, ``opt/.step``, ``opt/.m/...`` and
``opt/.v/...`` (a quantized moment's ``q`` and ``scale`` as its children
``0`` and ``1``), with the data step in the manifest's extra, so a run of
either package resumes in the other.

Where the JAX loop saves a last time in every case, this one saves only a
state whose step completed: after an exception inside a step (whose
in-place update may have run part way) it writes nothing more, and a
resumed run that has no step left to take writes no new step.

The host clock runs up to a `torch.cuda.synchronize` around each step, as
the JAX loop blocks on the loss.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import sharding as SH
from repro_torch.ckpt import checkpoint as CKPT
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.models import convert as CV
from repro_torch.models import lm as LM
from repro_torch.optim import adamw as OPT
from repro_torch.train import sharded as SHT
from repro_torch.train import step as TS


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    resume: bool = True
    watchdog_factor: float = 3.0
    seed: int = 0


class Watchdog:
    """EMA step-time straggler detector."""

    def __init__(self, factor: float):
        self.factor = factor
        self.ema: Optional[float] = None
        self.events = 0

    def observe(self, dt: float) -> bool:
        slow = self.ema is not None and dt > self.factor * self.ema
        if slow:
            self.events += 1
        self.ema = dt if self.ema is None else 0.9 * self.ema + 0.1 * dt
        return slow


def state_tree(model: LM.LM, opt_state: OPT.AdamState) -> Dict[str, Any]:
    """The training state in the JAX package's checkpoint layout, copied
    to host memory: {"params": stacked tensors, "opt": AdamState(step
    int32, m, v)}, a quantized moment as its (q, scale) pair."""
    host = lambda t: t.detach().cpu()

    def moments(named):
        tree = CV.stack_moments(named, host)
        return CV.map_tree(tree, lambda x: (x.q, x.scale)
                            if isinstance(x, OPT.QTensor) else x)

    return {"params": CV.stack_named(dict(model.named_parameters()), host),
            "opt": OPT.AdamState(torch.tensor(opt_state.step,
                                              dtype=torch.int32),
                                 moments(opt_state.m), moments(opt_state.v))}


def load_state(tree: Dict[str, Any], model: LM.LM) -> OPT.AdamState:
    """A restored `state_tree` into `model` (its parameters overwritten in
    place) and a new AdamState on the parameters' devices."""
    named = dict(model.named_parameters())
    flat = CV.unstack_named(tree["params"], named)
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(flat[n])
    opt = tree["opt"]
    as_q = lambda t: CV.map_tree(
        t, lambda x: OPT.QTensor(x[0], x[1]) if isinstance(x, tuple) else x)
    return CV.opt_state_from_numpy(
        OPT.AdamState(int(opt.step), as_q(opt.m), as_q(opt.v)), model)


def batch_to(batch: Dict[str, np.ndarray], device: torch.device
             ) -> Dict[str, torch.Tensor]:
    """A host batch on `device`: token ids as int64, the rest as given."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if k in ("tokens", "labels"):
            t = t.long()
        out[k] = t.to(device)
    return out


def _sync(devices) -> None:
    for device in devices:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def train(model_cfg: ModelConfig, tcfg: TrainConfig,
          data_cfg: Optional[DataConfig] = None,
          opt_cfg: Optional[OPT.AdamWConfig] = None, *,
          mesh=None, device=None, log_fn: Callable[[str], None] = print
          ) -> Dict[str, Any]:
    """Run (or resume) a training job on `device` (default the card; raises
    without one), or over `mesh` (a `repro_torch.launch.mesh.Mesh`; the
    run's device is then the mesh's first), from
    `LM.init_params(seed=tcfg.seed)`.  Returns the final metrics, the loss
    history, each step's host-clock seconds ("step_s"), the trained LM
    under "params" and its AdamW state under "opt_state" (whole, on the
    run's device, after a mesh run too)."""
    if mesh is not None:
        if device is not None and torch.device(device) != mesh.first_device:
            raise ValueError(f"device {device} is not the mesh's first "
                             f"device {mesh.first_device}")
        device = mesh.first_device
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "False); pass device='cpu' to train on the CPU")
    with SH.use_mesh(mesh):
        return _train(model_cfg, tcfg, data_cfg, opt_cfg, mesh, dev, log_fn)


def _train(model_cfg: ModelConfig, tcfg: TrainConfig,
           data_cfg: Optional[DataConfig],
           opt_cfg: Optional[OPT.AdamWConfig], mesh, dev: torch.device,
           log_fn: Callable[[str], None]) -> Dict[str, Any]:
    opt_cfg = opt_cfg or OPT.AdamWConfig()
    data_cfg = data_cfg or DataConfig(
        vocab=model_cfg.vocab_, seq_len=128, global_batch=8)
    devices = (set(mesh.devices.flat) if mesh is not None else {dev})

    model = LM.init_params(model_cfg, max_seq=data_cfg.seq_len, device=dev,
                           seed=tcfg.seed)
    opt_state = OPT.init(model, opt_cfg)
    start_step = 0

    if tcfg.resume and tcfg.ckpt_dir:
        latest = CKPT.latest_step(tcfg.ckpt_dir)
        if latest is not None:
            restored, extra = CKPT.restore(tcfg.ckpt_dir, latest,
                                           state_tree(model, opt_state))
            opt_state = load_state(restored, model)
            start_step = int(extra.get("data_step", latest))
            log_fn(f"[resume] restored step {latest}")

    if mesh is not None:
        run = SHT.ShardedTrain(model, opt_state, mesh, model_cfg, opt_cfg)
        take_step, snapshot = run.step, run.state_tree
    else:
        train_step = TS.make_train_step(model_cfg, opt_cfg)
        held = {"opt": opt_state}

        def take_step(batch):
            held["opt"], m = train_step(model, held["opt"], batch)
            return m

        def snapshot():
            return state_tree(model, held["opt"])

    it = DataIterator(data_cfg, start_step=start_step)
    ckpt = CKPT.AsyncCheckpointer()
    wd = Watchdog(tcfg.watchdog_factor)

    stop = {"now": False}

    def handle(sig, frame):
        stop["now"] = True

    old_handlers = {}
    for s in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[s] = signal.signal(s, handle)
        except ValueError:
            pass  # not on the main thread

    history, step_s = [], []
    metrics: Dict[str, Any] = {}
    done = saved = start_step  # steps whose update completed, saved
    in_step = False
    try:
        for step in range(start_step, tcfg.steps):
            batch = batch_to(it.batch_at(step), dev)
            _sync(devices)
            t0 = time.perf_counter()
            in_step = True
            metrics = take_step(batch)
            _sync(devices)
            in_step = False
            done = step + 1
            dt = time.perf_counter() - t0
            loss = float(metrics["loss"])
            if wd.observe(dt):
                log_fn(f"[watchdog] step {step} took {dt:.3f}s "
                       f"(ema {wd.ema:.3f}s) — straggler event")
            if step % tcfg.log_every == 0:
                log_fn(f"step {step}: loss={loss:.4f} ({dt*1e3:.0f} ms)")
            history.append(loss)
            step_s.append(dt)
            if tcfg.ckpt_dir and done % tcfg.ckpt_every == 0:
                ckpt.save(tcfg.ckpt_dir, done, snapshot(),
                          extra={"data_step": done})
                saved = done
            if stop["now"]:
                log_fn(f"[preempt] signal at step {step}; saving")
                break
    finally:
        it.close()
        try:
            if tcfg.ckpt_dir:
                ckpt.wait()
                if not in_step and done > saved:
                    CKPT.save(tcfg.ckpt_dir, done, snapshot(),
                              extra={"data_step": done})
        finally:
            for s, h in old_handlers.items():
                signal.signal(s, h)

    opt_state = run.finish() if mesh is not None else held["opt"]

    return {"loss": float(metrics["loss"]) if metrics else float("nan"),
            "history": history,
            "step_s": step_s,
            "straggler_events": wd.events,
            "final_step": done,
            "params": model,
            "opt_state": opt_state}
