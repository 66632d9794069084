"""Mixture-of-Experts: GShard-style capacity routing; the JAX package's
`repro.models.moe`.

Routing: softmax over float32 router logits, top-k with the lower expert
first on ties (a stable descending sort, as `jax.lax.top_k` orders them),
renormalised weights and a Switch-style load-balance loss.  Tokens route
within their own sequence (G = batch); each (token, choice) takes the next
slot of its expert's capacity buffer in token-major order, and choices past
the capacity are dropped.  Dispatch and combine are the dense one-hot
einsums of the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common as C
from repro_torch.models import mlp as MLP


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    n_experts: int            # routed experts
    top_k: int
    expert_ff: int            # per-expert hidden dim
    n_shared: int = 0         # shared (always-on) experts
    shared_ff: Optional[int] = None
    capacity_factor: float = 1.25

    @property
    def shared_dim(self) -> int:
        return (self.shared_ff or self.expert_ff) * max(self.n_shared, 0)


def moe_defs(cfg: MoEConfig) -> Dict[str, C.ParamDef]:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.expert_ff
    return {
        "router": C.ParamDef((d, e), ("embed", None), dtype=torch.float32),
        "w_gate": C.ParamDef((e, d, f), ("expert", "embed", None)),
        "w_up": C.ParamDef((e, d, f), ("expert", "embed", None)),
        "w_down": C.ParamDef((e, f, d), ("expert", None, "embed")),
    }


def capacity(tokens_per_group: int, cfg: MoEConfig) -> int:
    c = int(math.ceil(tokens_per_group * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts))
    return max(c, cfg.top_k)


def route(router_w: torch.Tensor, x: torch.Tensor, cfg: MoEConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (G, S, D) -> (weights (G,S,k), idx (G,S,k), aux_loss scalar)."""
    # operands in the activation dtype, products summed in float32
    # (`preferred_element_type=f32`): bf16 values are exact in float32
    logits = torch.matmul(x.float(), router_w.to(x.dtype).float())
    probs = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = vals[..., :cfg.top_k], order[..., :cfg.top_k]
    weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(idx[..., 0], cfg.n_experts).float().mean(dim=(0, 1))
    aux = cfg.n_experts * torch.sum(me * ce)
    return weights.to(x.dtype), idx, aux


class MoE(C.ParamModule):
    def __init__(self, cfg: MoEConfig, init: C.Init):
        super().__init__(moe_defs(cfg), init)
        self.cfg = cfg
        if cfg.n_shared > 0:
            self.shared = MLP.GatedMLP(cfg.d_model, cfg.shared_dim, init)

    def route(self, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: (G, S, D) -> (weights (G,S,k), idx (G,S,k), aux_loss)."""
        return route(self.router, x, self.cfg)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, S, D). Returns (out, aux_loss). B is the routing group."""
        cfg = self.cfg
        g, s, d = x.shape
        cap = capacity(s, cfg)
        weights, idx, aux = self.route(x)

        # position of each (token, choice) within its expert's buffer
        onehot = F.one_hot(idx, cfg.n_experts)                # (G,S,k,E)
        flat = onehot.reshape(g, s * cfg.top_k, cfg.n_experts)
        pos_in_expert = torch.cumsum(flat, dim=1) - 1         # (G,S*k,E)
        pos = torch.sum(pos_in_expert * flat, dim=-1).reshape(g, s,
                                                              cfg.top_k)
        keep = pos < cap

        pos_oh = F.one_hot(torch.where(keep, pos, cap),
                           cap + 1).to(x.dtype)[..., :cap]    # (G,S,k,C)
        oh = onehot.to(x.dtype)
        disp = torch.einsum("gske,gskc->gsec", oh, pos_oh)    # (G,S,E,C)
        expert_in = torch.einsum("gsec,gsd->gecd", disp, x)

        gate = torch.einsum("gecd,edf->gecf", expert_in, self.w_gate)
        up = torch.einsum("gecd,edf->gecf", expert_in, self.w_up)
        act = (C.silu(gate) * up).to(x.dtype)
        expert_out = torch.einsum("gecf,efd->gecd", act, self.w_down)

        w_oh = oh * weights[..., None]                         # (G,S,k,E)
        combine = torch.einsum("gske,gskc->gsec", w_oh, pos_oh)
        out = torch.einsum("gsec,gecd->gsd", combine, expert_out)
        if cfg.n_shared > 0:
            out = out + self.shared(x)
        return out, aux
