"""yi-34b — llama-architecture GQA [arXiv:2403.04652; hf].

56 q-heads are padded to 64 (`pad_heads_to=16`, for even 16-way tensor
parallelism); kv=8 stays.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab=64000, rope_theta=5_000_000.0, pad_heads_to=16,
)
