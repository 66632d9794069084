"""LM training in the port: the loss and the step (`step`), the
fault-tolerant loop (`loop`) and compressed data parallelism
(`dp_compressed`)."""
