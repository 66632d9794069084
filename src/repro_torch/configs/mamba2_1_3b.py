"""mamba2-1.3b — SSD state-space model, attention-free [arXiv:2405.21060;
unverified].  d_state 128, headdim 64 (64 SSM heads), chunked SSD scan
(chunk 256).  Vocab 50280 padded to 50432."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, vocab=50280,
    d_state=128, ssm_headdim=64, tie_embeddings=True,
)
