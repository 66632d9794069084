"""gemma3-27b — 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt scaled; unverified].

62 layers = 10 × (5 local + 1 global) + 2 trailing local.  Local layers use a
1024-token sliding window (ring KV cache at decode) + 10k RoPE; globals use
1M RoPE.  QK-norm, tied embeddings, head_dim fixed at 128.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=21504, vocab=262144, qk_norm=True, tie_embeddings=True,
    global_every=6, window_size=1024,
    rope_theta=1_000_000.0, rope_theta_local=10_000.0,
)
