"""Multi-head Latent Attention (DeepSeek-V2/V3); the JAX package's
`repro.models.mla`.

Queries and KV are projected through low-rank latents; only the compressed
KV latent (kv_lora_rank) and the shared decoupled RoPE key (rope_dim) are
cached at decode time.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.models import attention as ATT
from repro_torch.models import common as C

NEG_INF = ATT.NEG_INF


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10_000.0

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim

    @property
    def scale(self) -> float:
        return self.qk_dim ** -0.5


def mla_defs(cfg: MLAConfig) -> Dict[str, C.ParamDef]:
    d, h = cfg.d_model, cfg.n_heads
    return {
        "w_dq": C.ParamDef((d, cfg.q_lora_rank), ("embed", None)),
        "q_norm": C.ParamDef((cfg.q_lora_rank,), (None,), init="zeros"),
        "w_uq": C.ParamDef((cfg.q_lora_rank, h, cfg.qk_dim),
                          (None, "heads", None)),
        "w_dkv": C.ParamDef((d, cfg.kv_lora_rank), ("embed", None)),
        "kv_norm": C.ParamDef((cfg.kv_lora_rank,), (None,), init="zeros"),
        "w_uk": C.ParamDef((cfg.kv_lora_rank, h, cfg.qk_nope_dim),
                          (None, "heads", None)),
        "w_uv": C.ParamDef((cfg.kv_lora_rank, h, cfg.v_head_dim),
                          (None, "heads", None)),
        "w_kr": C.ParamDef((d, cfg.qk_rope_dim), ("embed", None)),
        "wo": C.ParamDef((h, cfg.v_head_dim, d), ("heads", None, "embed")),
    }


def cache_defs(cfg: MLAConfig, batch: int, max_len: int
               ) -> Dict[str, C.ParamDef]:
    return {
        "c_kv": C.ParamDef((batch, max_len, cfg.kv_lora_rank),
                           ("batch", "act_seq", None), init="zeros"),
        "k_rope": C.ParamDef((batch, max_len, cfg.qk_rope_dim),
                             ("batch", "act_seq", None), init="zeros"),
    }


def _causal_bias(positions: torch.Tensor) -> torch.Tensor:
    causal = positions[:, :, None] >= positions[:, None, :]
    bias = torch.zeros(causal.shape, dtype=torch.float32,
                       device=positions.device)
    return bias.masked_fill_(~causal, NEG_INF)[:, None]


class MLA(C.ParamModule):
    def __init__(self, cfg: MLAConfig, init: C.Init):
        super().__init__(mla_defs(cfg), init)
        self.cfg = cfg

    def queries(self, x, positions):
        cfg = self.cfg
        cq = C.rmsnorm(C.dense(x, self.w_dq), self.q_norm)
        q = torch.einsum("bsr,rhk->bshk", cq, self.w_uq)
        q_nope, q_rope = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
        cos, sin = C.rope_tables(positions, cfg.qk_rope_dim, cfg.rope_theta)
        q_rope = C.apply_rope(q_rope, cos, sin)
        return torch.cat([q_nope, q_rope], dim=-1)

    def latent_kv(self, x, positions):
        """Compressed latent c_kv (B,S,R) + decoupled rope key (B,S,rope)."""
        cfg = self.cfg
        c_kv = C.rmsnorm(C.dense(x, self.w_dkv), self.kv_norm)
        k_rope = C.dense(x, self.w_kr)[:, :, None, :]      # (B,S,1,rope)
        cos, sin = C.rope_tables(positions, cfg.qk_rope_dim, cfg.rope_theta)
        k_rope = C.apply_rope(k_rope, cos, sin)[:, :, 0, :]
        return c_kv, k_rope

    def attend(self, q, c_kv, k_rope, bias):
        """q: (B,Sq,H,qk); c_kv: (B,Sk,R); k_rope: (B,Sk,rope)."""
        cfg = self.cfg
        k_nope = torch.einsum("btr,rhk->bthk", c_kv, self.w_uk)
        v = torch.einsum("btr,rhv->bthv", c_kv, self.w_uv)
        q_nope, q_rope = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
        s_nope = torch.einsum("bshk,bthk->bhst", q_nope, k_nope)
        s_rope = torch.einsum("bshk,btk->bhst", q_rope, k_rope)
        scores = (s_nope + s_rope).float() * cfg.scale + bias
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bhst,bthv->bshv", probs, v)
        return torch.einsum("bshv,hvd->bsd", out, self.wo)

    def forward(self, x, positions: Optional[torch.Tensor] = None):
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        q = self.queries(x, positions)
        c_kv, k_rope = self.latent_kv(x, positions)
        return self.attend(q, c_kv, k_rope, _causal_bias(positions))

    def prefill(self, x, cache):
        b, s, _ = x.shape
        if s > cache["c_kv"].shape[1]:
            raise ValueError(f"a prompt of {s} positions does not fit the "
                             f"cache's {cache['c_kv'].shape[1]} slots")
        positions = torch.arange(s, device=x.device)[None, :]
        q = self.queries(x, positions)
        c_kv, k_rope = self.latent_kv(x, positions)
        out = self.attend(q, c_kv, k_rope, _causal_bias(positions))
        cache["c_kv"][:, :s] = c_kv.to(cache["c_kv"].dtype)
        cache["k_rope"][:, :s] = k_rope.to(cache["k_rope"].dtype)
        return out, cache

    def decode_step(self, x, cache, pos: int):
        """x: (B,1,D); caches only the latents."""
        b = x.shape[0]
        c_kv, k_rope = cache["c_kv"], cache["k_rope"]
        s_max = c_kv.shape[1]
        ATT._check_pos(pos, s_max)
        positions = torch.full((b, 1), pos, dtype=torch.int64,
                               device=x.device)
        q = self.queries(x, positions)
        c_kv_new, k_rope_new = self.latent_kv(x, positions)
        c_kv[:, pos:pos + 1] = c_kv_new.to(c_kv.dtype)
        k_rope[:, pos:pos + 1] = k_rope_new.to(k_rope.dtype)
        valid = torch.arange(s_max, device=x.device)[None, :] <= pos
        bias = torch.zeros(valid.shape, dtype=torch.float32,
                           device=x.device).masked_fill_(~valid, NEG_INF)
        out = self.attend(q, c_kv, k_rope, bias[:, None, None, :])
        return out, cache
