"""`repro_torch` — the GA engine ported to PyTorch, with hand-written CUDA
kernels for Hopper.

The JAX package `repro` is the reference this package is held against; the
two share module names (`core.lfsr`, `core.fitness`, `core.ga`, `ga.*`,
`kernels.ga_step`) so each module's counterpart is easy to find.  This
package never imports `jax` or `repro`.  `repro_torch.convert` carries GA
state between the two.
"""
