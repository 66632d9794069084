"""Feed-forward blocks: gated SiLU (llama family) and plain GELU (whisper);
the JAX package's `repro.models.mlp`."""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import common as C


def gated_defs(d_model: int, d_ff: int) -> Dict[str, C.ParamDef]:
    return {
        "w_gate": C.ParamDef((d_model, d_ff), ("embed", "mlp")),
        "w_up": C.ParamDef((d_model, d_ff), ("embed", "mlp")),
        "w_down": C.ParamDef((d_ff, d_model), ("mlp", "embed")),
    }


class GatedMLP(C.ParamModule):
    def __init__(self, d_model: int, d_ff: int, init: C.Init):
        super().__init__(gated_defs(d_model, d_ff), init)

    def forward(self, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
        g = C.dense(x, self.w_gate)
        u = C.dense(x, self.w_up)
        a = C.silu(g) if act == "silu" else C.gelu_tanh(g)
        return C.dense((a * u).to(x.dtype), self.w_down)


def plain_defs(d_model: int, d_ff: int) -> Dict[str, C.ParamDef]:
    return {
        "w_in": C.ParamDef((d_model, d_ff), ("embed", "mlp")),
        "b_in": C.ParamDef((d_ff,), ("mlp",), init="zeros"),
        "w_out": C.ParamDef((d_ff, d_model), ("mlp", "embed")),
        "b_out": C.ParamDef((d_model,), ("embed",), init="zeros"),
    }


class PlainMLP(C.ParamModule):
    def __init__(self, d_model: int, d_ff: int, init: C.Init):
        super().__init__(plain_defs(d_model, d_ff), init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = C.dense(x, self.w_in, self.b_in)
        h = C.gelu_tanh(h).to(x.dtype)
        return C.dense(h, self.w_out, self.b_out)
