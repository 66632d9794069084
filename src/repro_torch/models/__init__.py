"""The LM substrate of the port: blocks, the assembled `LM` and the
converter from the JAX package's parameter and cache trees."""
