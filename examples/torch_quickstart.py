"""Quickstart on the PyTorch/CUDA port: the paper's parallel GA through
`repro_torch.ga`, then the same engine as a blackbox tuner.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on the card unless `--device cpu` asks for the CPU; the port of
examples/quickstart.py.
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import ga
from repro_torch.core import evolve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu'")
    ap.add_argument("--generations", type=int, default=100)
    args = ap.parse_args(argv)
    opts = ga.EngineOptions(device=args.device)
    dev = opts.torch_device()
    gens = args.generations

    # --- 1. The paper's F1 experiment (Fig. 11): N=32, m=26 --------------
    spec1 = ga.paper_spec("F1", n=32, m=26, mode="lut", mutation_rate=0.05,
                          seed=7, generations=gens)
    out = ga.solve(spec1, options=opts)
    print(f"F1 best fitness after {gens} generations: "
          f"{out.best_fitness:.4g} (global minimum ≈ -6.897e10) "
          f"[backend={out.backend}, device={dev}]")
    print(f"decoded solution: {out.best_params}")

    # --- 2. F3 on every backend from the SAME spec -----------------------
    spec3 = ga.paper_spec("F3", n=64, m=20, mode="arith", mutation_rate=0.05,
                          seed=3, generations=gens)
    for backend in ("reference", "fused", "eager"):
        r = ga.solve(spec3, backend=backend, options=opts)
        print(f"F3 [{backend:9s}] best: {r.best_fitness:.4f} (optimum 0)")
    r = ga.solve(dataclasses.replace(spec3, n_islands=8), backend="islands",
                 options=opts)
    print(f"F3 [islands x8] best: {r.best_fitness:.4f}")

    # --- 3. Another selection scheme, 8 seeds stacked in one run ----------
    r = ga.solve(dataclasses.replace(spec3, selection="tournament4",
                                     n_repeats=8), options=opts)
    print(f"F3 [tournament4, 8 repeats] best: {r.best_fitness:.4f}, "
          f"per-seed: {np.round(r.telemetry.per_repeat.best, 3)}")

    # --- 4. The GA as a tuning service: minimize a 4-var blackbox --------
    target = torch.tensor([0.5, -1.0, 2.0, 0.0], device=dev)

    def objective(p):          # (N, 4) -> (N,)
        return torch.sum((p - target) ** 2, dim=-1)

    r = evolve(objective, bounds=[(-4, 4)] * 4, population=128,
               generations=2 * gens, mutation_rate=0.05, seed=0,
               options=opts)
    print(f"evolve() found {np.round(r.best_params, 3)} "
          f"(target {target.cpu().numpy()}) fitness={r.best_fitness:.2e}")


if __name__ == "__main__":
    main()
