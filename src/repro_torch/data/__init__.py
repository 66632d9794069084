"""The data pipeline of the port (`pipeline`): the JAX package's synthetic and
mmap token streams, bit-equal batch for batch."""
