"""deepseek-v3-671b — MLA + 256-expert MoE [arXiv:2412.19437; hf].

Faithful: MLA latent attention (q_lora 1536 / kv_lora 512 / rope 64, the
compressed-latent KV cache), 1 shared + 256 routed experts top-8, first 3
layers dense (d_ff 18432).  Deviations: softmax top-k routing in place of
sigmoid+group-bias; the MTP head is not implemented.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    vocab=129280, rope_theta=10_000.0,
    n_experts=256, top_k=8, expert_ff=2048, n_shared_experts=1,
    n_dense_layers=3, moe_ff_dense=18432,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
)
