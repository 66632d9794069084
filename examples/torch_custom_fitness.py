"""Bring your own fitness on the PyTorch/CUDA port: three ways to put a
custom objective on the GA engine — including the fused CUDA kernel K1,
whose global form runs YOUR function as its FFM stage (no closed-form or
two-variable restriction), bit-identical to the reference.

    PYTHONPATH=src python examples/torch_custom_fitness.py [--device cpu]

The port of examples/custom_fitness.py.  `auto` picks `fused` on a card
and `reference` on the CPU.
"""

import argparse

import numpy as np
import torch

from repro_torch import ga


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu'")
    ap.add_argument("--generations", type=int, default=150)
    args = ap.parse_args(argv)
    opts = ga.EngineOptions(device=args.device)
    dev = opts.torch_device()
    gens = args.generations

    # --- 1. One-off blackbox: any (N, V) -> (N,) torch function -----------
    target = torch.tensor([0.5, -1.0, 2.0], device=dev)
    weights = torch.tensor([1.0, 2.0, 4.0], device=dev)

    def weighted_offset(pop):                     # (N, 3) -> (N,)
        return torch.sum(weights * (pop - target) ** 2, dim=-1)

    spec = ga.GASpec(fitness=weighted_offset, bounds=((-4.0, 4.0),) * 3,
                     n=64, bits_per_var=12, mutation_rate=0.05,
                     seed=0, generations=gens)
    for backend in ("reference", "fused", "auto"):   # identical results
        r = ga.solve(spec, backend=backend, options=opts)
        print(f"blackbox [{backend:9s}] ran on {r.backend}: "
              f"best={r.best_fitness:.3e} "
              f"params={np.round(r.best_params, 3)}")

    # --- 2. Register a reusable problem (name + default box) -------------
    # A separable `term` additionally unlocks the LUT (ROM) lowering.
    ga.register_problem(ga.ProblemDef(
        name="styblinski_tang",
        fn=lambda v: 0.5 * torch.sum(v ** 4 - 16.0 * v ** 2 + 5.0 * v,
                                     dim=-1),
        domain=(-5.0, 5.0),
        term=lambda v, i: 0.5 * (v ** 4 - 16.0 * v ** 2 + 5.0 * v),
    ))
    spec = ga.GASpec(problem="styblinski_tang:6", n=64, bits_per_var=12,
                     mutation_rate=0.05, seed=1, generations=gens + 50,
                     n_islands=4, migrate_every=16)
    r = ga.solve(spec, backend="fused-islands", options=opts)
    print(f"styblinski_tang:6 [{r.backend}] best={r.best_fitness:.2f} "
          f"(optimum {-39.166 * 6:.2f})")

    # --- 3. The built-in n-variable suite at any V, on the kernel ---------
    for problem in ("sphere:8", "rastrigin:8", "rosenbrock:8", "ackley:8"):
        r = ga.solve(ga.GASpec(problem=problem, n=64, bits_per_var=12,
                               mutation_rate=0.05, seed=2,
                               generations=gens), backend="fused",
                     options=opts)
        print(f"{problem:13s} [{r.backend}] best={r.best_fitness:.4f}")


if __name__ == "__main__":
    main()
