"""moonshot-v1-16b-a3b — Moonlight-16B-A3B-style MoE
[hf:moonshotai/Moonlight-16B-A3B; hf].

64 routed experts, top-6, 2 shared experts, first layer dense (DeepSeek-V3
routing recipe at small scale, softmax top-k here).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    vocab=163840, rope_theta=50_000.0,
    n_experts=64, top_k=6, expert_ff=1408, n_shared_experts=2,
    n_dense_layers=1, moe_ff_dense=5632,
)
