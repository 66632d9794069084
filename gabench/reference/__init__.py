"""The plain reference the benchmark holds the port's output against.

A frozen, self-contained copy of the GA's semantics in NumPy and plain
PyTorch: it imports nothing of `repro_torch` (nor `jax` or `repro`) and
takes nothing the program made."""
