"""Mamba2 — State Space Duality (SSD) blocks, chunked (arXiv:2405.21060);
the JAX package's `repro.models.ssm`.

Prefill uses the chunked dual form: intra-chunk attention-like einsums and
a scan over chunk states, all in float32.  The JAX package runs that scan
as `lax.associative_scan`; here it is a loop over the chunks, which adds
in another order (held to a float32 bound, not bit for bit).  Decode
carries the (B, H, N, P) SSM state and the depthwise-conv tail: O(1) a
token.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import common as C


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128          # N
    headdim: int = 64           # P
    expand: int = 2
    n_groups: int = 1           # G
    conv_width: int = 4
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        assert self.d_inner % self.headdim == 0
        return self.d_inner // self.headdim

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    @property
    def in_proj_dim(self) -> int:
        # z, x_inner, B, C, dt
        return (2 * self.d_inner + 2 * self.n_groups * self.d_state
                + self.n_heads)


def ssm_defs(cfg: SSMConfig) -> Dict[str, C.ParamDef]:
    d, f32 = cfg.d_model, torch.float32
    return {
        "in_proj": C.ParamDef((d, cfg.in_proj_dim), ("embed", "mlp")),
        "conv_w": C.ParamDef((cfg.conv_width, cfg.conv_channels),
                             (None, "mlp"), scale=0.2),
        "conv_b": C.ParamDef((cfg.conv_channels,), ("mlp",), init="zeros"),
        "a_log": C.ParamDef((cfg.n_heads,), ("heads",), init="zeros",
                            dtype=f32),
        "dt_bias": C.ParamDef((cfg.n_heads,), ("heads",), init="zeros",
                              dtype=f32),
        "d_skip": C.ParamDef((cfg.n_heads,), ("heads",), init="ones",
                             dtype=f32),
        "norm_w": C.ParamDef((cfg.d_inner,), ("mlp",), init="zeros"),
        "out_proj": C.ParamDef((cfg.d_inner, d), ("mlp", "embed")),
    }


def cache_defs(cfg: SSMConfig, batch: int) -> Dict[str, C.ParamDef]:
    return {
        "state": C.ParamDef((batch, cfg.n_heads, cfg.d_state, cfg.headdim),
                            ("batch", "heads", None, None), init="zeros",
                            dtype=torch.float32),
        "conv": C.ParamDef((batch, cfg.conv_width - 1, cfg.conv_channels),
                           ("batch", None, "mlp"), init="zeros"),
    }


def split_proj(proj, cfg: SSMConfig):
    di, gn = cfg.d_inner, cfg.n_groups * cfg.d_state
    z = proj[..., :di]
    xbc = proj[..., di: di + di + 2 * gn]   # conv input: x_inner ‖ B ‖ C
    dt = proj[..., di + di + 2 * gn:]
    return z, xbc, dt


def split_xbc(xbc, cfg: SSMConfig):
    di, gn = cfg.d_inner, cfg.n_groups * cfg.d_state
    return xbc[..., :di], xbc[..., di: di + gn], xbc[..., di + gn:]


def causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor
                ) -> torch.Tensor:
    """Depthwise causal conv, width W: (B,S,C) -> (B,S,C)."""
    width = w.shape[0]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    s = xbc.shape[1]
    out = pad[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, width):
        out = out + pad[:, i: i + s, :] * w[i][None, None, :]
    return C.silu((out + bias[None, None, :]).float()).to(xbc.dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`: logaddexp(x, 0)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def ssd_chunked(x, dt, a, b, c, cfg: SSMConfig,
                init_state: Optional[torch.Tensor] = None):
    """SSD dual form.

    x: (B,S,H,P) f32; dt: (B,S,H) f32; a: (H,) f32 (negative);
    b, c: (B,S,G,N) f32.  Returns (y (B,S,H,P), final_state (B,H,N,P)).
    """
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    q = cfg.chunk
    if s % q:
        raise ValueError(f"seq {s} % chunk {q} != 0")
    nc = s // q
    hg = h // g

    bh = b.repeat_interleave(hg, dim=2)                 # (B,S,H,N)
    ch = c.repeat_interleave(hg, dim=2)
    xc = x.reshape(bsz, nc, q, h, p)
    dtc = dt.reshape(bsz, nc, q, h)
    bc = bh.reshape(bsz, nc, q, h, n)
    cc = ch.reshape(bsz, nc, q, h, n)

    da = dtc * a[None, None, None, :]                   # (B,Nc,Q,H) <= 0
    cs = torch.cumsum(da, dim=2)                        # within-chunk
    x_dt = xc * dtc[..., None]

    # intra-chunk (attention-like, lower-triangular decay kernel).  The
    # mask goes in before the exp: above the diagonal li > 0 grows with the
    # chunk (past 88 at chunk 256, where exp overflows), and the JAX
    # package's where(tri, exp(li), 0) then back-propagates 0 * inf = NaN.
    # exp(-inf) = 0, so the values are the same; the gradients are finite.
    li = cs[:, :, :, None, :] - cs[:, :, None, :, :]    # (B,Nc,Q,Q,H) i,j
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    l_mat = torch.exp(torch.where(
        tri[None, None, :, :, None], li,
        torch.full((), float("-inf"), dtype=li.dtype, device=x.device)))
    cb = torch.einsum("bcihn,bcjhn->bcijh", cc, bc)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", cb * l_mat, x_dt)

    # chunk states
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)     # (B,Nc,Q,H)
    states = torch.einsum("bcjhn,bcjhp->bchnp",
                          bc * decay_to_end[..., None], x_dt)
    lam = torch.exp(cs[:, :, -1, :])                    # (B,Nc,H)

    # inter-chunk recurrence: inclusive prefix over (Λ, S)
    lam_s, st_s = [lam[:, 0]], [states[:, 0]]
    for i in range(1, nc):
        lam_s.append(lam_s[-1] * lam[:, i])
        st_s.append(st_s[-1] * lam[:, i][..., None, None] + states[:, i])
    lam_s, st_s = torch.stack(lam_s, dim=1), torch.stack(st_s, dim=1)
    prev = torch.cat([torch.zeros_like(st_s[:, :1]), st_s[:, :-1]], dim=1)
    if init_state is not None:
        # incorporate an incoming state (prefill continuation)
        lam_prev = torch.cat([torch.ones_like(lam_s[:, :1]), lam_s[:, :-1]],
                             dim=1)
        prev = prev + init_state[:, None] * lam_prev[..., None, None]

    y_inter = torch.einsum("bcihn,bchnp->bcihp", cc, prev) \
        * torch.exp(cs)[..., None]
    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    final = st_s[:, -1]
    if init_state is not None:
        final = final + init_state * lam_s[:, -1][..., None, None]
    return y, final


class SSM(C.ParamModule):
    def __init__(self, cfg: SSMConfig, init: C.Init):
        super().__init__(ssm_defs(cfg), init)
        self.cfg = cfg

    def _gate_out(self, y, z, dtype):
        y = C.rmsnorm(y * C.silu(z.float()).to(dtype), self.norm_w)
        return C.dense(y, self.out_proj)

    def forward(self, x: torch.Tensor, return_cache: bool = False):
        """Full-sequence mamba2 block. x: (B,S,D).

        With return_cache=True also returns the decode cache (final SSM
        state and the conv tail): the block's prefill, which needs a
        chunk-multiple length."""
        cfg = self.cfg
        s_orig = x.shape[1]
        pad = (-s_orig) % cfg.chunk
        if pad:
            # trailing zeros never reach earlier outputs, but the final
            # state would decay further, so a cache needs aligned lengths
            if return_cache:
                raise ValueError(f"prefill length {s_orig} must be a "
                                 f"multiple of the chunk {cfg.chunk}")
            x = F.pad(x, (0, 0, 0, pad))
        proj = C.dense(x, self.in_proj)
        z, xbc, dt = split_proj(proj, cfg)
        conv_tail = xbc[:, -(cfg.conv_width - 1):, :]
        xbc = causal_conv(xbc, self.conv_w, self.conv_b)
        xi, b, c = split_xbc(xbc, cfg)

        bsz, s, _ = x.shape
        h, pd, g, n = cfg.n_heads, cfg.headdim, cfg.n_groups, cfg.d_state
        xi = xi.reshape(bsz, s, h, pd).float()
        b = b.reshape(bsz, s, g, n).float()
        c = c.reshape(bsz, s, g, n).float()
        dtv = softplus(dt.float() + self.dt_bias[None, None, :])
        a = -torch.exp(self.a_log)

        y, state = ssd_chunked(xi, dtv, a, b, c, cfg)
        y = y + xi * self.d_skip[None, None, :, None]
        y = y.reshape(bsz, s, cfg.d_inner).to(x.dtype)
        out = self._gate_out(y, z, x.dtype)
        if pad:
            out = out[:, :s_orig]
        if return_cache:
            return out, {"state": state, "conv": conv_tail}
        return out

    def decode_step(self, x: torch.Tensor, cache):
        """One token. x: (B,1,D); cache: {state (B,H,N,P), conv (B,W-1,C)};
        returns a new cache."""
        cfg = self.cfg
        bsz = x.shape[0]
        proj = C.dense(x, self.in_proj)
        z, xbc, dt = split_proj(proj, cfg)

        window = torch.cat([cache["conv"], xbc], dim=1)      # (B,W,C)
        conv_out = torch.einsum("bwc,wc->bc", window.float(),
                                self.conv_w.float()) + self.conv_b.float()
        xbc_act = C.silu(conv_out)[:, None, :].to(x.dtype)
        conv_cache = window[:, 1:, :]

        xi, b, c = split_xbc(xbc_act, cfg)
        h, pd, g, n = cfg.n_heads, cfg.headdim, cfg.n_groups, cfg.d_state
        xi = xi.reshape(bsz, h, pd).float()
        b = b.reshape(bsz, g, n).float()
        c = c.reshape(bsz, g, n).float()
        hg = h // g
        bhh = b.repeat_interleave(hg, dim=1)   # (B,H,N)
        chh = c.repeat_interleave(hg, dim=1)

        dtv = softplus(dt[:, 0].float() + self.dt_bias[None, :])
        a = -torch.exp(self.a_log)
        da = torch.exp(dtv * a[None, :])       # (B,H)

        state = cache["state"] * da[..., None, None] + \
            torch.einsum("bhn,bhp->bhnp", bhh, xi * dtv[..., None])
        y = torch.einsum("bhn,bhnp->bhp", chh, state) + \
            xi * self.d_skip[None, :, None]
        y = y.reshape(bsz, 1, cfg.d_inner).to(x.dtype)
        out = self._gate_out(y, z, x.dtype)
        return out, {"state": state, "conv": conv_cache}
