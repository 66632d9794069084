"""Gradient compression for the data-parallel reduction: int8 quantization
with error feedback (EF-SGD residual carrying); the JAX package's
`repro.optim.compress`.

The JAX `compress_psum` runs inside `shard_map` and reduces with
`lax.psum`; the port's mesh is single-controller, so `compress_psum`
takes the shards' gradient trees as a list and sums their dequantized
values in shard order on the first shard's device.  Each shard carries its
own residual (what quantization dropped from its gradient), added to its
next gradient before quantizing.

    mean, residuals = compress_psum([grads_0, grads_1], residuals)
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One absmax scale for the whole tensor: (q int8, scale float32)."""
    scale = torch.amax(torch.abs(g)) / torch.tensor(127.0, device=g.device)
    q = torch.round(g / torch.clamp_min(scale, 1e-12)).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_psum(grads: Sequence[Dict[str, torch.Tensor]],
                  residuals: Sequence[Dict[str, torch.Tensor]]
                  ) -> Tuple[Dict[str, torch.Tensor],
                             List[Dict[str, torch.Tensor]]]:
    """The shards' gradient trees (name -> tensor, one dict a shard) and
    their residuals -> (the mean of the dequantized int8 gradients on the
    first shard's device, each shard's new residual on its device)."""
    if len(grads) != len(residuals) or not grads:
        raise ValueError(f"{len(grads)} gradient trees and {len(residuals)} "
                         "residuals")
    mean: Dict[str, torch.Tensor] = {}
    new_res: List[Dict[str, torch.Tensor]] = [{} for _ in grads]
    for name in grads[0]:
        total = None
        for s, (g_s, r_s) in enumerate(zip(grads, residuals)):
            g = g_s[name].float() + r_s[name]
            q, scale = quantize_int8(g)
            deq = dequantize_int8(q, scale)
            new_res[s][name] = g - deq
            total = deq if total is None else total + deq.to(total.device)
        mean[name] = total / torch.tensor(float(len(grads)),
                                          device=total.device)
    return mean, new_res


def init_residual(params) -> Dict[str, torch.Tensor]:
    """Zero float32 residuals for a parameter tree (a dict or a module)."""
    named = (dict(params.named_parameters())
             if hasattr(params, "named_parameters") else dict(params))
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in named.items()}
