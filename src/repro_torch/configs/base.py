"""ModelConfig — one dataclass describes every assigned architecture.

The JAX package's `repro.configs.base`, copied so the port imports nothing
of it.  `reduced()` gives the small same-family variant the CPU tests run;
`torch_dtype` is the activation and weight dtype the port follows.
"""

from __future__ import annotations

import dataclasses
import torch


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | audio | vlm | ssm | hybrid
    n_layers: int
    d_model: int
    vocab: int
    # --- attention ---
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False           # qwen1.5
    qk_norm: bool = False            # gemma3
    rope_theta: float = 10_000.0
    # gemma3 local:global pattern — every `global_every`-th layer is global
    global_every: int = 0            # 0 = all layers global attention
    window_size: int = 1024
    rope_theta_local: float = 10_000.0
    # --- mlp ---
    d_ff: int = 0
    act: str = "silu"                # silu | gelu
    # --- moe ---
    n_experts: int = 0
    top_k: int = 0
    expert_ff: int = 0
    n_shared_experts: int = 0
    n_dense_layers: int = 0          # deepseek: first k layers dense
    moe_ff_dense: int = 0            # hidden dim of those dense layers
    capacity_factor: float = 1.25
    # --- MLA (deepseek) ---
    use_mla: bool = False
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # --- ssm / hybrid ---
    d_state: int = 0
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    attn_every: int = 0              # zamba2: shared attn block cadence
    # --- enc-dec (whisper) ---
    enc_layers: int = 0
    enc_seq: int = 1500              # stubbed conv frontend output length
    # --- vlm (pixtral) ---
    n_patches: int = 0               # stubbed ViT patch embeddings
    # --- misc ---
    norm: str = "rms"                # rms | ln
    tie_embeddings: bool = False
    vocab_pad_to: int = 256
    dtype: str = "bfloat16"
    # head padding for even 16-way TP (qwen 40 -> 48)
    pad_heads_to: int = 0

    # ----- derived -----
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def n_heads_(self) -> int:
        if self.pad_heads_to:
            return _round_up(self.n_heads, self.pad_heads_to)
        return self.n_heads

    @property
    def n_kv_heads_(self) -> int:
        if self.pad_heads_to and self.n_kv_heads == self.n_heads:
            return self.n_heads_          # MHA-style: pad kv along with q
        return self.n_kv_heads

    @property
    def vocab_(self) -> int:
        return _round_up(self.vocab, self.vocab_pad_to)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """sub-quadratic decode: SSM, hybrid, or sliding-window-dominated."""
        return self.family in ("ssm", "hybrid") or self.global_every > 1

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers), for 6ND."""
        d, v = self.d_model, self.vocab_
        total = v * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "vlm"):
            total += self.n_layers * self._dense_layer_params()
        elif self.family == "moe":
            att = self._attn_params()
            moe = (3 * self.n_experts * d * self.expert_ff
                   + d * self.n_experts
                   + 3 * d * self.expert_ff * self.n_shared_experts)
            dense_l = att + 3 * d * self.moe_ff_dense
            total += self.n_dense_layers * dense_l
            total += (self.n_layers - self.n_dense_layers) * (att + moe)
        elif self.family == "audio":
            total += (self.enc_layers * self._dense_layer_params(causal=False)
                      + self.n_layers * self._dec_layer_params())
        elif self.family == "ssm":
            total += self.n_layers * self._ssm_layer_params()
        elif self.family == "hybrid":
            total += self.n_layers * self._ssm_layer_params()
            total += self._dense_layer_params()  # one shared block
        return total

    def active_param_count(self) -> int:
        """MoE: params touched per token (for 6·N_active·D)."""
        if self.family != "moe":
            return self.param_count()
        d, v = self.d_model, self.vocab_
        total = v * d * 2
        att = self._attn_params()
        act_moe = (3 * (self.top_k + self.n_shared_experts) * d * self.expert_ff
                   + d * self.n_experts)
        total += self.n_dense_layers * (att + 3 * d * self.moe_ff_dense)
        total += (self.n_layers - self.n_dense_layers) * (att + act_moe)
        return total

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim_
        if self.use_mla:
            return (d * self.q_lora_rank
                    + self.q_lora_rank * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                    + d * self.kv_lora_rank + d * self.qk_rope_dim
                    + self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * d)
        return d * hd * (self.n_heads_ + 2 * self.n_kv_heads_) + self.n_heads_ * hd * d

    def _dense_layer_params(self, causal: bool = True) -> int:
        return self._attn_params() + 3 * self.d_model * self.d_ff

    def _dec_layer_params(self) -> int:
        # self-attn + cross-attn + plain mlp
        return 2 * self._attn_params() + 2 * self.d_model * self.d_ff

    def _ssm_layer_params(self) -> int:
        di = 2 * self.d_model
        gn = self.d_state  # n_groups = 1
        h = di // self.ssm_headdim
        in_proj = self.d_model * (2 * di + 2 * gn + h)
        return in_proj + di * self.d_model + 4 * (di + 2 * gn)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests."""
    kw = dict(
        n_layers=min(cfg.n_layers, 2 if cfg.attn_every == 0 else cfg.attn_every + 1),
        d_model=128,
        vocab=512,
        d_ff=256 if cfg.d_ff else 0,
        head_dim=32 if cfg.n_heads else 0,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        pad_heads_to=0,
        vocab_pad_to=64,
    )
    if cfg.n_kv_heads == cfg.n_heads:
        kw["n_kv_heads"] = 4
    if cfg.family == "moe":
        kw.update(n_experts=4, top_k=2, expert_ff=64,
                  n_shared_experts=min(cfg.n_shared_experts, 1),
                  n_dense_layers=min(cfg.n_dense_layers, 1), moe_ff_dense=256)
        kw["n_layers"] = 3
    if cfg.use_mla:
        kw.update(q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=32,
                  qk_rope_dim=16, v_head_dim=32)
    if cfg.d_state:
        kw.update(d_state=16, ssm_headdim=32, ssm_chunk=32)
    if cfg.attn_every:
        kw.update(attn_every=2, n_layers=4)
    if cfg.enc_layers:
        kw.update(enc_layers=2, enc_seq=64)
    if cfg.n_patches:
        kw.update(n_patches=16)
    if cfg.global_every:
        kw.update(global_every=3, window_size=16, n_layers=6)
    return dataclasses.replace(cfg, name=cfg.name + "-reduced", **kw)
