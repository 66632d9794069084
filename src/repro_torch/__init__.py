"""`repro_torch` — the GA engine ported to PyTorch, with hand-written CUDA
kernels for Hopper, and the LM serving path in plain PyTorch.

The JAX package `repro` is the reference this package is held against; the
two share module names (`core.lfsr`, `core.fitness`, `core.ga`,
`core.islands`, `ga.*`, `kernels.ga_step`, `kernels.lfsr_kernel`,
`configs.*`, `models.*`, `serve.engine`, `launch.serve`) so each module's
counterpart is easy to find.  This package never imports `jax` or `repro`.
`repro_torch.convert` carries GA state between the two, and
`repro_torch.models.convert` LM weights and caches.
"""
