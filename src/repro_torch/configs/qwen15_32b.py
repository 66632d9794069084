"""qwen1.5-32b — GQA with QKV bias [hf:Qwen/Qwen1.5-0.5B family; hf].

40 heads (MHA-style kv=40) padded to 48 for even 16-way TP.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, head_dim=128,
    d_ff=27392, vocab=152064, qkv_bias=True, rope_theta=1_000_000.0,
    pad_heads_to=16,
)
