"""AdamW with optional 8-bit (blockwise-quantized) moment states; the JAX
package's `repro.optim.adamw`, written out op for op.

The JAX update is a pure function over parameter trees; here `update`
changes the parameters and the moments in place (under `torch.no_grad()`)
and returns the new `AdamState` (its step advanced, its moment tensors the
same objects, changed) and the metrics.  Its arithmetic is the JAX
package's, not `torch.optim.AdamW`'s: one global-norm clip, weight decay
inside the step (`p - lr * (u + wd * p)`), the bias corrections
`1 - b ** step` in float32 by the C library's `powf` (the words XLA's
float32 `pow` gives), and in 8-bit mode `v` kept as `sqrt(v)` and every
leaf's step clipped to +-10.  Every divisor is a tensor on the leaf's
device: PyTorch's CUDA division by a host scalar multiplies by its
reciprocal, which rounds differently.

8-bit mode stores m and sqrt(v) as int8 with one float32 absmax scale a
block of `block` (128) elements along the last axis, for every leaf whose
last axis is a multiple of the block; the other leaves keep float32.

The update runs a leaf at a time and a large leaf in chunks of rows
(`CHUNK_ELEMS` elements): every op is elementwise or local to a block of
the last axis, and the norm sums each row before it sums the rows, so
chunking changes no value, and the float32 temporaries stay one chunk's,
not the whole leaf's (minitron-8b's 256000x4096 head would need 3.9 GiB
each).  `update` drops each gradient from the dict it is given as
soon as its leaf is updated.

The port holds one tensor a layer where the JAX package stacks layers:
blocks along the last axis are the same, but the global norm sums the
squares a leaf at a time, so the per-layer grouping sums them in another
order and the clip factor may part from JAX's by an ulp.

    opt = init(model.named_parameters(), AdamWConfig(state_bits=8))
    opt, metrics = update(params, grads, opt, cfg)   # params changed
"""

from __future__ import annotations

import dataclasses
from typing import (Dict, Iterable, Mapping, NamedTuple, Optional, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch.models.common import powf

# elements of a chunk of rows: the float32 temporaries of a chunk are
# 64 MiB each
CHUNK_ELEMS = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_bits: int = 32          # 32 or 8
    block: int = 128              # 8-bit quantization block


@dataclasses.dataclass
class QTensor:
    """Blockwise-quantized int8 tensor: `q` (int8, the tensor's shape) and
    `scale` (float32, the shape with its last axis cut to the blocks);
    `shape` and `npad` are static, as in the JAX package."""
    q: torch.Tensor
    scale: torch.Tensor
    shape: Tuple[int, ...] = ()
    npad: int = 0

    # the JAX pytree's children (`shape`, `npad` are its static data)
    tree_fields = ("q", "scale")


class AdamState(NamedTuple):
    step: int                              # a Python int: no device read
    m: Dict[str, Union[torch.Tensor, QTensor]]
    v: Dict[str, Union[torch.Tensor, QTensor]]


def quantizable(shape: Tuple[int, ...], block: int) -> bool:
    """Blockwise along the LAST axis keeps the tensor's own shape."""
    return len(shape) >= 1 and shape[-1] % block == 0 and shape[-1] >= block


def _rows(t: torch.Tensor) -> torch.Tensor:
    """`t` as (rows, last axis): a view, which an in-place update of the
    rows writes through (raises where `t` has no such view)."""
    return t.view(-1, t.shape[-1]) if t.dim() else t.view(1, 1)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt.  PyTorch's CPU float32 sqrt is not
    (its vector path parts from IEEE sqrt by an ulp in ~0.7% of the
    elements), so the CPU goes through float64, whose sqrt rounded to
    float32 is exact; the card's sqrtf is IEEE."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _quantize_rows(x: torch.Tensor, block: int, d127: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (R, C) float32 -> (q (R, C) int8, scale (R, C // block))."""
    r, c = x.shape
    blocks = x.reshape(r, c // block, block)
    scale = torch.amax(torch.abs(blocks), dim=-1, keepdim=True) / d127
    q = torch.round(blocks / torch.clamp_min(scale, 1e-12)).to(torch.int8)
    return q.reshape(r, c), scale[..., 0]


def _dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    r, c = q.shape
    blocks = q.float().reshape(r, scale.shape[-1], c // scale.shape[-1])
    return (blocks * scale[..., None]).reshape(r, c)


def _quantize(x: torch.Tensor, block: int) -> QTensor:
    d127 = torch.tensor(127.0, device=x.device)
    q, scale = _quantize_rows(_rows(x.float().contiguous()), block, d127)
    shape = tuple(x.shape)
    return QTensor(q.reshape(shape), scale.reshape(shape[:-1] + (-1,)),
                   shape, 0)


def _dequantize(t: QTensor) -> torch.Tensor:
    return _dequantize_rows(_rows(t.q), _rows(t.scale)).reshape(t.shape)


def _named(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, Mapping):
        return dict(params)
    if hasattr(params, "named_parameters"):
        return dict(params.named_parameters())
    return dict(params)


def init(params: Union[Mapping[str, torch.Tensor],
                       Iterable[Tuple[str, torch.Tensor]]],
         cfg: AdamWConfig) -> AdamState:
    """Zero moments for every leaf of `params` (a dict, `named_parameters()`
    or a module), on each leaf's device."""
    def zeros_like(p):
        if cfg.state_bits == 8 and quantizable(tuple(p.shape), cfg.block):
            shape = tuple(p.shape)
            return QTensor(
                torch.zeros(shape, dtype=torch.int8, device=p.device),
                torch.zeros(shape[:-1] + (shape[-1] // cfg.block,),
                            dtype=torch.float32, device=p.device), shape, 0)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    named = _named(params)
    return AdamState(step=0, m={k: zeros_like(p) for k, p in named.items()},
                     v={k: zeros_like(p) for k, p in named.items()})


def _sum_squares(g: torch.Tensor, scale: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """sum((g.float() / scale) ** 2), no division without `scale`: each
    row's sum, in chunks of rows past CHUNK_ELEMS, then the sum of the
    rows' sums, so the chunk changes no value."""
    rows = _rows(g.contiguous())
    step = max(1, CHUNK_ELEMS // max(rows.shape[1], 1))
    per_row = []
    for r0 in range(0, rows.shape[0], step):
        gf = rows[r0:r0 + step].float()
        if scale is not None:
            gf = gf / scale
        per_row.append(torch.sum(gf * gf, dim=1))
    return torch.sum(torch.cat(per_row))


def global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's `_sum_squares`, in the order of
    `grads`, on the first leaf's device: JAX's `_global_norm` (up to the
    order of its sums, above) wherever that float32 sum is finite.

    Where it overflows while every element is finite (a deviation by
    design, hazard H9: minitron-8b's gradient at its init as drawn), the
    norm is m * sqrt(sum((g / m) ** 2)) with m the largest |g| of every
    leaf, summed in the same order, so the clip factor is not 0.  A leaf
    that is itself inf or NaN keeps the plain value.  Deciding reads the
    norm on the host once a call (not on `meta`)."""
    leaves = list(grads.values())
    dev = leaves[0].device

    def norm_of(scale=None):
        return _sqrt(torch.sum(torch.stack(
            [_sum_squares(g, None if scale is None else scale.to(g.device))
             .to(dev) for g in leaves])))

    norm = norm_of()
    if dev.type == "meta" or bool(torch.isfinite(norm)):
        return norm
    m = torch.amax(torch.stack([torch.amax(torch.abs(g)).float().to(dev)
                                for g in leaves]))
    if not bool(torch.isfinite(m)):
        return norm
    return m * norm_of(m)


def _update_rows(p, g, m, v, k: Dict[str, torch.Tensor], cfg: AdamWConfig
                 ) -> None:
    """One chunk of rows of one leaf, in place.  m and v are float32 row
    chunks or (q, scale) row chunks of a QTensor."""
    g = g.float() * k["clip"]
    mf = _dequantize_rows(*m) if isinstance(m, tuple) else m
    if isinstance(v, tuple):
        vq = _dequantize_rows(*v)
        vf = vq * vq          # v is kept in the sqrt domain when quantized
    else:
        vf = v
    mf = cfg.b1 * mf + (1 - cfg.b1) * g
    vf = cfg.b2 * vf + (1 - cfg.b2) * g * g
    upd = (mf / k["bc1"]) / (_sqrt(vf / k["bc2"]) + cfg.eps)
    if cfg.state_bits == 8:
        # residual quantization noise can still inflate 1/sqrt(v); bound
        # the per-element update (bitsandbytes-style), every leaf
        upd = torch.clamp(upd, -10.0, 10.0)
    pf = p.float()
    pf = pf - cfg.lr * (upd + cfg.weight_decay * pf)
    p.copy_(pf)
    _store(m, mf, k, cfg)
    _store(v, _sqrt(vf) if isinstance(v, tuple) else vf, k, cfg)


def _store(state, value: torch.Tensor, k, cfg: AdamWConfig) -> None:
    """Write a float32 row chunk into its moment: as it is, or quantized
    into a (q, scale) row chunk."""
    if isinstance(state, tuple):
        q, scale = _quantize_rows(value, cfg.block, k["d127"])
        state[0].copy_(q)
        state[1].copy_(scale)
    else:
        state.copy_(value)


def _update_leaf(p, g, m, v, k, cfg: AdamWConfig) -> None:
    rows_p, rows_g = _rows(p), _rows(g.contiguous())

    def rows_of(s):
        if isinstance(s, QTensor):
            return (_rows(s.q), _rows(s.scale))
        return _rows(s)

    rm, rv = rows_of(m), rows_of(v)
    step = max(1, CHUNK_ELEMS // max(rows_p.shape[1], 1))

    def cut(s, r0):
        if isinstance(s, tuple):
            return (s[0][r0:r0 + step], s[1][r0:r0 + step])
        return s[r0:r0 + step]

    for r0 in range(0, rows_p.shape[0], step):
        _update_rows(rows_p[r0:r0 + step], rows_g[r0:r0 + step],
                     cut(rm, r0), cut(rv, r0), k, cfg)


def bias_corrections(step: int, cfg: AdamWConfig) -> Tuple[np.float32,
                                                           np.float32]:
    """(1 - b1 ** step, 1 - b2 ** step) in float32, as XLA computes them."""
    one = np.float32(1.0)
    return (one - powf(cfg.b1, float(step)), one - powf(cfg.b2, float(step)))


@torch.no_grad()
def update(params: Mapping[str, torch.Tensor],
           grads: Dict[str, torch.Tensor], state: AdamState,
           cfg: AdamWConfig, gnorm: Optional[torch.Tensor] = None
           ) -> Tuple[AdamState, Dict[str, torch.Tensor]]:
    """One AdamW step.  `params` (name -> tensor) and the moments of
    `state` change in place; `grads` (name -> tensor, the same names) is
    emptied as the leaves are updated.  `gnorm` is the global gradient
    norm where the caller has taken it (over the whole gradient, before
    it cut the leaves into slices); by default `global_norm` of `grads`.
    Returns (new state, {"grad_norm"})."""
    names = list(params)
    if set(grads) != set(names):
        raise KeyError(f"grads name {sorted(set(grads) ^ set(names))[:4]} "
                       "that params do not, or the other way round")
    if gnorm is None:
        gnorm = global_norm({n: grads[n] for n in names})
    dev = gnorm.device
    step = state.step + 1
    bc1, bc2 = bias_corrections(step, cfg)
    consts = {}

    def on(device):
        if device not in consts:
            c = torch.tensor([cfg.grad_clip, bc1, bc2, 127.0],
                             dtype=torch.float32, device=device)
            clip = torch.clamp_max(
                c[0] / torch.clamp_min(gnorm.to(device), 1e-9), 1.0)
            consts[device] = {"clip": clip, "bc1": c[1], "bc2": c[2],
                              "d127": c[3]}
        return consts[device]

    on(dev)
    for n in names:
        p = params[n]
        _update_leaf(p, grads.pop(n), state.m[n], state.v[n], on(p.device),
                     cfg)
    return AdamState(step, state.m, state.v), {"grad_norm": gnorm}


def state_axes(param_axes: Mapping[str, Tuple], cfg: AdamWConfig
               ) -> AdamState:
    """Logical axes of the optimizer state, the JAX package's: 32-bit
    moments mirror the parameters' axes; in 8-bit mode every moment is a
    `QTensor` whose `q` and `scale` take (None, None), so the moments stay
    whole."""
    if cfg.state_bits == 8:
        q_axes = QTensor(q=(None, None), scale=(None, None), shape=(), npad=0)
        return AdamState(step=(), m={n: q_axes for n in param_axes},
                         v={n: q_axes for n in param_axes})
    return AdamState(step=(), m=dict(param_axes), v=dict(param_axes))
