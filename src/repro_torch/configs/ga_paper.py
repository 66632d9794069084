"""The paper's own experiment grid: F1/F2/F3 × N ∈ {4..64} × m ∈ {20..28}
(the JAX package's `repro.configs.ga_paper`; not an LM architecture, so
not in `REGISTRY`)."""
from repro_torch.core.ga import GAConfig

POPULATIONS = (4, 8, 16, 32, 64)
BIT_WIDTHS = (20, 22, 24, 26, 28)
K_GENERATIONS = 100          # paper's default
MUTATION_RATE = 0.02         # paper: 0.1%–2%


def paper_config(n: int = 32, m: int = 20, mode: str = "lut",
                 seed: int = 1) -> GAConfig:
    return GAConfig(n=n, c=m // 2, v=2, mutation_rate=MUTATION_RATE,
                    minimize=True, seed=seed, mode=mode)
