"""The systems a run can drive: the port (`Port`), and the plain reference
computed one precision down and put in its place (`Control`), whose
output the check has to reject.

Both are built from the configuration, the device and the
configuration's reference module, and offer `job(seed, spans)` ->
`check.Out`, one job of the configuration's spec with spec seed `seed`,
and `stream(seed, chunk, total, tap)`, an iterator of `check.Out` a
chunk.  `tap` wraps the function that advances the state one chunk
(`state, gens -> result with .state`), so the harness can copy a chunk's
input and output state for the check and time the segment in a traced
run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gabench.check import Out


class Port:
    """`repro_torch.ga` as a user drives it: `solve` a job, or
    `Engine.run_chunked` a long run, with `EngineOptions(device=...,
    cost_table=False, faults=False)` so that no ambient cost table or
    fault rule decides anything.  It takes nothing of the reference."""

    name = "repro_torch"

    def __init__(self, config: dict, device: str, ref):
        from repro_torch import ga
        from repro_torch.kernels import ga_step
        self.ga, self.kernels = ga, ga_step
        self.backend = config["backend"]
        self.options = ga.EngineOptions(device=device, cost_table=False,
                                        faults=False)
        self.spec0 = ga.GASpec(**config["spec"])

    def launches(self) -> int:
        """Kernel launches the port's wrappers have counted so far."""
        return sum(self.kernels.LAUNCHES.values())

    def _spec(self, seed: int):
        return dataclasses.replace(self.spec0, seed=seed)

    def job(self, seed: int, spans=None) -> Out:
        spec = self._spec(seed)
        if spans is None:
            res = self.ga.solve(spec, self.backend, options=self.options)
        else:
            # solve spelled out, so that spans fall on the layer boundaries
            with spans.span("engine_build"):
                eng = self.ga.Engine(spec, self.backend, options=self.options)
            with spans.span("init_state"):
                state = eng.init_state()
            eng.backend.segment = spans.wrap("segment", eng.backend.segment)
            with spans.span("run"):
                res = eng.run(state=state)
        rep = res.telemetry.per_repeat
        return Out(tuple(res.state), rep.best, rep.best_x, rep.traj_best,
                   rep.traj_mean, res.generations)

    def stream(self, seed: int, chunk: int, total: int, tap):
        eng = self.ga.Engine(self._spec(seed), self.backend,
                             options=self.options)
        eng.backend.segment = tap(eng.backend.segment)
        for tele in eng.run_chunked(chunk_generations=chunk,
                                    generations=total):
            rep = tele["telemetry"].per_repeat
            yield Out(None, rep.best, rep.best_x, rep.traj_best,
                      rep.traj_mean, tele["chunk_gens"])


class Control:
    """The configuration's reference with its fitness computed in
    bfloat16, the precision below the configuration's float32, in the
    program's place."""

    name = "control-bf16"

    def __init__(self, config: dict, device: str, ref):
        self.ref = ref
        self.shape = ref.shape_of(config)
        self.replicas = config["spec"]["n_repeats"]
        self.gens = config["spec"]["generations"]
        self.unit = ref.traj_unit(config)
        self.device = device

    def launches(self) -> int:
        return 0

    def _init(self, seed: int):
        return self.ref.init(self.shape,
                             [seed + r for r in range(self.replicas)],
                             self.device)

    def _run(self, state, gens: int):
        return self.ref.run(self.shape, self.ref.State(*state), gens,
                            self.unit, fitness_dtype=torch.bfloat16)

    @staticmethod
    def _out(run, state, gens: int) -> Out:
        return Out(state, run.best.cpu().numpy(),
                   run.best_x.cpu().numpy().view(np.uint32),
                   run.traj_best.cpu().numpy(), run.traj_mean.cpu().numpy(),
                   gens)

    def job(self, seed: int, spans=None) -> Out:
        run = self._run(self._init(seed), self.gens)
        return self._out(run, tuple(run.state), self.gens)

    def stream(self, seed: int, chunk: int, total: int, tap):
        step = tap(self._run)
        state, done = self._init(seed), 0
        while done < total:
            gens = min(chunk, total - done)
            run = step(state, gens)
            state, done = run.state, done + gens
            yield self._out(run, None, gens)


SYSTEMS = {Port.name: Port, Control.name: Control}
