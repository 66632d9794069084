"""The paper's engine as the platform's tuning service, on the PyTorch
port: evolve training hyperparameters (log-LR, weight decay) of a tiny LM —
each GA fitness evaluation trains it for 10 steps.

    PYTHONPATH=src python examples/torch_evolve_hparams.py [--device cpu]

The port of examples/evolve_hparams.py, on the card unless `--device cpu`.
The fitness is a blackbox torch function over the population, so `auto`
runs it on the `reference` backend (the CUDA kernel's FFM stage holds only
the built-in problems); the script prints the backend it chose.
"""

import argparse
import copy

import torch

from repro_torch import ga
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.models import lm as LM
from repro_torch.train import step as TS
from repro_torch.train.loop import batch_to

TINY = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=256)
TRIAL_STEPS = 10


def make_fitness(dev: torch.device):
    model0 = LM.init_params(TINY, max_seq=64, device=dev, seed=0)
    it = DataIterator(DataConfig(vocab=TINY.vocab_, seq_len=64,
                                 global_batch=4))
    batches = [batch_to(it.batch_at(i), dev) for i in range(TRIAL_STEPS)]
    it.close()
    loss_fn = TS.make_loss_fn(TINY, remat=False)

    def trial(lr: float, wd: float) -> float:
        """The last loss of TRIAL_STEPS plain Adam steps (no clip), as the
        JAX example's trial takes them."""
        model = copy.deepcopy(model0)
        params = dict(model.named_parameters())
        m = {k: torch.zeros_like(p, dtype=torch.float32)
             for k, p in params.items()}
        v = {k: torch.zeros_like(p, dtype=torch.float32)
             for k, p in params.items()}
        b1, b2, eps = 0.9, 0.95, 1e-8
        for t, batch in enumerate(batches, start=1):
            loss, _, grads = TS.value_and_grad(loss_fn, model, batch)
            with torch.no_grad():
                for k, p in params.items():
                    g = grads[k].float()
                    m[k] = b1 * m[k] + (1 - b1) * g
                    v[k] = b2 * v[k] + (1 - b2) * g * g
                    u = (m[k] / (1 - b1 ** t)) / (
                        torch.sqrt(v[k] / (1 - b2 ** t)) + eps)
                    pf = p.float()
                    p.copy_(pf - lr * (u + wd * pf))
        return float(loss)

    def fitness(pop: torch.Tensor) -> torch.Tensor:   # (..., N, 2) -> (..., N)
        flat = pop.reshape(-1, 2).tolist()
        out = [trial(10.0 ** lr, wd) for lr, wd in flat]
        return torch.tensor(out, dtype=pop.dtype,
                            device=pop.device).reshape(pop.shape[:-1])

    return fitness


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default; exits 2 without a card) or "
                         "'cpu'")
    ap.add_argument("--generations", type=int, default=5)
    args = ap.parse_args(argv)
    dev = torch.device(args.device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device (torch.cuda.is_available() is False); "
                 "pass --device cpu")

    # small population/generations — each fitness eval trains a model
    spec = ga.GASpec(fitness=make_fitness(dev),
                     bounds=((-4.0, -1.0), (0.0, 0.2)), n=8, bits_per_var=8,
                     mutation_rate=0.1, seed=1, generations=args.generations)
    r = ga.solve(spec, options=ga.EngineOptions(device=str(dev)))
    print(f"[backend={r.backend}] best hparams: "
          f"log10_lr={r.best_params[0]:.2f} wd={r.best_params[1]:.3f}")
    print(f"best trial loss: {r.best_fitness:.4f}")
    assert 10.0 ** r.best_params[0] > 3e-4, "GA should avoid tiny LRs"


if __name__ == "__main__":
    main()
