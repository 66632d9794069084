"""Checkpoints of GA state in the JAX package's on-disk format."""
