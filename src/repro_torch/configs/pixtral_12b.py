"""pixtral-12b backbone — mistral-nemo-style decoder + ViT patch prefix
[hf:mistralai/Pixtral-12B-2409; unverified].  The vision tower is a STUB:
callers pass precomputed (B, 1024, 5120) patch embeddings, which are
prepended to the token sequence."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131072, rope_theta=1_000_000.0, n_patches=1024,
)
