"""Shared model substrate: parameter definitions and their initialisation,
norms, RoPE.

The JAX package's `repro.models.common`.  A block is a `ParamModule`: an
`nn.Module` whose parameters are named as the JAX package's leaves and are
made from a table of `ParamDef`s by an `Init`, which says the device, the
dtype and the seeded `torch.Generator` they are drawn from.  Each
`ParamDef` carries the JAX package's logical sharding axes, leaf for
leaf; `spec_tree` turns them into `repro_torch.sharding` specs under the
active mesh (which slice of a leaf each shard holds: a spec places data,
it never changes a value), and `abstract_params` gives meta tensors, the
JAX package's `ShapeDtypeStruct`s, for the dry run.

    init = Init(torch.bfloat16, torch.device("cuda"),
                torch.Generator("cuda").manual_seed(0))
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import sharding as SH


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axes, same rank as shape
    init: str = "normal"              # normal | zeros | ones
    dtype: Optional[torch.dtype] = None   # None: the model's dtype
    scale: Optional[float] = None     # override stddev

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"axes {self.axes} for shape {self.shape}")


def stddev(d: ParamDef) -> float:
    if d.scale is not None:
        return d.scale
    # fan-in on the last-but-one dim for matrices, d_model for embeddings
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    return 1.0 / math.sqrt(max(fan_in, 1))


@dataclasses.dataclass
class Init:
    """Where a model's tensors are made.  "normal" parameters are drawn in
    float32 from `generator` (on `device`) times their stddev, then cast;
    without a generator they are left uninitialised for a converter to
    fill.  On the meta device nothing is allocated (counting only)."""

    dtype: torch.dtype
    device: torch.device
    generator: Optional[torch.Generator] = None

    def tensor(self, d: ParamDef) -> torch.Tensor:
        dtype = d.dtype or self.dtype
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dtype, device=self.device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dtype, device=self.device)
        if self.generator is None or self.device.type == "meta":
            return torch.empty(d.shape, dtype=dtype, device=self.device)
        v = torch.randn(d.shape, generator=self.generator,
                        dtype=torch.float32, device=self.device)
        return v.mul_(stddev(d)).to(dtype)


def seeded_init(dtype: torch.dtype, device, seed: int) -> Init:
    """An `Init` drawing from a generator on `device` seeded with `seed`."""
    device = torch.device(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device).manual_seed(int(seed))
    return Init(dtype, device, gen)


class ParamModule(nn.Module):
    """A block whose parameters are the JAX package's leaves by name."""

    def __init__(self, defs: Dict[str, ParamDef], init: Init):
        super().__init__()
        for name, d in defs.items():
            register_param(self, name, d, init)


def register_param(module: nn.Module, name: str, d: ParamDef, init: Init
                   ) -> None:
    """Register parameter `name` of `module`, made from `d` by `init`, and
    keep `d` in the module's `param_defs`."""
    module.__dict__.setdefault("param_defs", {})[name] = d
    module.register_parameter(
        name, nn.Parameter(init.tensor(d), requires_grad=False))


def module_defs(module: nn.Module) -> Dict[str, ParamDef]:
    """The `ParamDef` of every parameter of `module`, by its name there
    (in `named_parameters` order); a parameter made without one raises
    `KeyError`."""
    defs = {}
    for prefix, m in module.named_modules():
        for n, d in getattr(m, "param_defs", {}).items():
            defs[f"{prefix}.{n}" if prefix else n] = d
    return {n: defs[n] for n, _ in module.named_parameters()}


def axes_tree(defs: Dict[str, ParamDef]) -> Dict[str, Tuple]:
    return {n: d.axes for n, d in defs.items()}


def spec_tree(defs: Dict[str, ParamDef]) -> Dict[str, SH.PartitionSpec]:
    """Each leaf's spec under the active rules, with the divisibility
    fallback of `sharding.logical_spec` (its shape given)."""
    return {n: SH.logical_spec(d.axes, d.shape) for n, d in defs.items()}


def abstract_params(defs: Dict[str, ParamDef], dtype: torch.dtype
                    ) -> Dict[str, torch.Tensor]:
    """Meta tensors of every leaf (the model's `dtype` where the def names
    none): the JAX package's `ShapeDtypeStruct`s; nothing is allocated."""
    return {n: torch.empty(d.shape, dtype=d.dtype or dtype, device="meta")
            for n, d in defs.items()}


def zeros_tree(defs: Any, dtype: torch.dtype, device) -> Any:
    """Materialise a (nested dict / list) tree of cache `ParamDef`s as
    zeros; leaves that are not `ParamDef`s (a cache's position) pass."""
    if isinstance(defs, ParamDef):
        return torch.zeros(defs.shape, dtype=defs.dtype or dtype,
                           device=device)
    if isinstance(defs, dict):
        return {k: zeros_tree(v, dtype, device) for k, v in defs.items()}
    if isinstance(defs, list):
        return [zeros_tree(v, dtype, device) for v in defs]
    return defs


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA lowers it for a 16-bit `x`: x * (1 / (1 +
    exp(-x))), each op rounded to x's dtype.  PyTorch's fused silu rounds
    once and in bf16 lands an ulp away from XLA's in ~40% of the elements.
    In float32 and wider the fused kernel stays: one launch in place of
    five, an ulp from XLA's at most, inside every float32 bound."""
    if x.dtype.itemsize >= 4:
        return F.silu(x)
    return x * (1.0 / (1.0 + torch.exp(-x)))


def _in_dtype(v: float, dtype: torch.dtype) -> float:
    """`v` rounded to `dtype`, as a JAX constant takes its operand's."""
    return torch.tensor(v, dtype=dtype).item()


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` in XLA's op order for a 16-bit
    `x`, each op rounded to x's dtype and its constants too (PyTorch's
    fused tanh gelu parts from XLA's in ~37% of bf16 elements); the fused
    kernel in float32 and wider, as for `silu`."""
    if x.dtype.itemsize >= 4:
        return F.gelu(x, approximate="tanh")
    inner = _in_dtype(0.7978845608028654, x.dtype) * (
        x + _in_dtype(0.044715, x.dtype) * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """Statistics in f32, application in the input dtype, `(1 + w)` with a
    zero-initialised `w`."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + w.to(x.dtype))


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    centered = xf - mu
    var = torch.mean(centered * centered, dim=-1, keepdim=True)
    y = centered * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (NeoX half-rotation convention)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _powf():
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.powf.restype = ctypes.c_float
    libm.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    return libm.powf


def powf(base: float, expo: float) -> np.float32:
    """`base ** expo` in float32 by the C library's `powf`: the words XLA's
    float32 `pow` gives on the CPU."""
    return np.float32(_powf()(float(np.float32(base)),
                              float(np.float32(expo))))


@functools.lru_cache(maxsize=None)
def _rope_freqs(theta: float, half: int, device: torch.device
                ) -> torch.Tensor:
    """theta ** (-i/half) for i < half in float32, by the C library's
    `powf`: XLA's float32 `pow` on the CPU gives the same words, where a
    float64 power rounded to float32 parts from it near a midpoint (at
    theta 5e4, half 64, i 9).  Made once a (theta, half, device)."""
    powf = _powf()
    expo = -np.arange(half, dtype=np.float32) / np.float32(half)
    out = np.array([powf(theta, float(e)) for e in expo], np.float32)
    return torch.tensor(out, device=device)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for integer positions: each (..., head_dim/2) f32."""
    freqs = _rope_freqs(float(theta), head_dim // 2, positions.device)
    ang = positions.float()[..., None] * freqs        # (..., half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (B, S, hd/2) or (S, hd/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    xf1, xf2 = x1.float(), x2.float()
    o1 = xf1 * cos - xf2 * sin
    o2 = xf2 * cos + xf1 * sin
    return torch.cat([o1, o2], dim=-1).to(x.dtype)


def sinusoidal_pos(seq: int, dim: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (S, D) f32."""
    pos = np.arange(seq)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    emb = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.as_tensor(emb.astype(np.float32), device=device)
