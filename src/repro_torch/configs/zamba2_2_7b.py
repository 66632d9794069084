"""zamba2-2.7b — Mamba2 backbone + one SHARED attention block applied every
6 layers [arXiv:2411.15242; hf].  d_state 64; shared block = GQA(32h, hd 80)
+ gated MLP (d_ff 10240).  Per-invocation LoRA specialization of the shared
block is not implemented."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab=32000, d_state=64, ssm_headdim=64, attn_every=6,
    tie_embeddings=True,
)
