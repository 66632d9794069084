"""whisper-large-v3 backbone — enc-dec transformer [arXiv:2212.04356;
unverified].  The conv frontend is a STUB: callers pass precomputed
(B, 1500, 1280) frame embeddings.  32 enc + 32 dec layers, LayerNorm +
GELU, learned decoder positions, tied decoder embeddings.  Vocab 51866
padded to 51968; 20 heads padded to 32 (`pad_heads_to=16`)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, enc_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    head_dim=64, d_ff=5120, vocab=51866, norm="ln", act="gelu",
    enc_seq=1500, tie_embeddings=True, pad_heads_to=16,
)
