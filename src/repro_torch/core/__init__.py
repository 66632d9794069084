"""The paper's datapath: LFSR source, fitness programs, GA operators, and
`evolve`, the blackbox-tuning service on top of the engine."""

from repro_torch.core.evolve import EvolveResult, evolve

__all__ = ["evolve", "EvolveResult"]
