"""Attention: GQA/MHA with RoPE, sliding windows, QKV bias, QK-norm,
cross-attention, and a decode KV cache; the JAX package's
`repro.models.attention`.

Scores and softmax are float32 einsums, as in the JAX package: no library
attention kernel stands in for them.  Caches are written in place: a
prefill or decode step returns the cache it was given, updated.  A decode
position past the cache is refused (`ValueError`), where JAX's
`dynamic_update_slice` would clamp it onto the last slot.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.models import common as C

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False       # qwen1.5
    qk_norm: bool = False        # gemma3
    rope_theta: Optional[float] = 10_000.0   # None = no rope (whisper)
    causal: bool = True
    window: Optional[int] = None  # sliding-window size (gemma3 locals)
    softmax_scale: Optional[float] = None

    @property
    def scale(self) -> float:
        return self.softmax_scale or self.head_dim ** -0.5


def attn_defs(cfg: AttnConfig) -> Dict[str, C.ParamDef]:
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        "wq": C.ParamDef((d, h, hd), ("embed", "heads", None)),
        "wk": C.ParamDef((d, kh, hd), ("embed", "kv_heads", None)),
        "wv": C.ParamDef((d, kh, hd), ("embed", "kv_heads", None)),
        "wo": C.ParamDef((h, hd, d), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = C.ParamDef((h, hd), ("heads", None), init="zeros")
        defs["bk"] = C.ParamDef((kh, hd), ("kv_heads", None),
                               init="zeros")
        defs["bv"] = C.ParamDef((kh, hd), ("kv_heads", None),
                               init="zeros")
    if cfg.qk_norm:
        defs["q_norm"] = C.ParamDef((hd,), (None,), init="zeros")
        defs["k_norm"] = C.ParamDef((hd,), (None,), init="zeros")
    return defs


def mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, cfg: AttnConfig,
              k_valid: Optional[torch.Tensor] = None,
              window: Optional[int] = None) -> torch.Tensor:
    """(..., Sq, Sk) additive f32 mask from positions; `window` overrides
    the static cfg.window."""
    d = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if cfg.causal:
        ok &= d >= 0
    if window is not None:
        ok &= d < window
    elif cfg.window is not None:
        ok &= d < cfg.window
    if k_valid is not None:
        ok &= k_valid[..., None, :]
    bias = torch.zeros(ok.shape, dtype=torch.float32, device=d.device)
    return bias.masked_fill_(~ok, NEG_INF)


def expand_kv(k: torch.Tensor, v: torch.Tensor, n_heads: int):
    """Repeat KV heads up to the query-head count (`jnp.repeat` on the
    head axis)."""
    g = n_heads // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    return k, v


def sdpa(q, k, v, bias, cfg: AttnConfig) -> torch.Tensor:
    """q: (B,Sq,H,hd)  k/v: (B,Sk,KH,hd)  bias: broadcastable (B,1,Sq,Sk)."""
    k, v = expand_kv(k, v, q.shape[2])
    scores = torch.einsum("bshd,bthd->bhst", q, k).float()
    scores = scores * cfg.scale + bias
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _rope(q, k, cfg: AttnConfig, positions, rope_cs=None):
    if rope_cs is not None:
        return C.apply_rope(q, *rope_cs), C.apply_rope(k, *rope_cs)
    if cfg.rope_theta is not None:
        cos, sin = C.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        return C.apply_rope(q, cos, sin), C.apply_rope(k, cos, sin)
    return q, k


# ---------------------------------------------------------------------------
# Flash-style chunked attention (prefill): online softmax over KV blocks,
# so the (Sq, Sk) score matrix never exists whole.  Taken by inference from
# FLASH_MIN_SEQ query positions on.
# ---------------------------------------------------------------------------

FLASH_MIN_SEQ = 8192
FLASH_CHUNK = 1024


def flash_sdpa(q, k, v, cfg: AttnConfig, q_pos, k_pos, window=None):
    """q: (B,Sq,H,hd); k/v: (B,Sk,H,hd) (already head-expanded).
    q_pos: (B,Sq); k_pos: (Sk,). Returns (B,Sq,H,hd)."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    chunk = FLASH_CHUNK
    n_chunks = -(-sk // chunk)
    pad = n_chunks * chunk - sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=-(10 ** 9))
    qf = q.float() * cfg.scale
    m = torch.full((b, h, sq), float("-inf"), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, h, hd), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        k_i = k[:, c * chunk:(c + 1) * chunk]
        v_i = v[:, c * chunk:(c + 1) * chunk]
        p_i = k_pos[c * chunk:(c + 1) * chunk]
        s = torch.einsum("bshd,bthd->bhst", qf, k_i.float())
        d = q_pos[:, None, :, None] - p_i[None, None, None, :]
        ok = torch.ones(d.shape, dtype=torch.bool, device=q.device)
        if cfg.causal:
            ok &= d >= 0
        if window is not None:
            ok &= d < window
        elif cfg.window is not None:
            ok &= d < cfg.window
        ok &= (p_i >= 0)[None, None, None, :]
        s = s.masked_fill(~ok, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhst,bthd->bshd", p.to(v_i.dtype), v_i)
        acc = acc * alpha.transpose(1, 2)[..., None] + pv.float()
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def sdpa_infer(q, k, v, cfg: AttnConfig, q_pos, k_pos, window=None):
    """Inference SDPA: the flash path for long sequences, einsum
    otherwise."""
    k, v = expand_kv(k, v, q.shape[2])
    if q.shape[1] >= FLASH_MIN_SEQ:
        return flash_sdpa(q, k, v, cfg, q_pos, k_pos, window=window)
    bias = mask_bias(q_pos, k_pos[None, :], cfg, window=window)[:, None]
    return sdpa(q, k, v, bias, cfg)


def _check_pos(pos: int, slots: int) -> None:
    if not 0 <= pos < slots:
        raise ValueError(f"decode position {pos} is outside the cache's "
                         f"{slots} slots")


# ---------------------------------------------------------------------------
# Caches (zeros from `C.zeros_tree`)
# ---------------------------------------------------------------------------


def cache_defs(cfg: AttnConfig, batch: int, max_len: int
               ) -> Dict[str, C.ParamDef]:
    """K/V of `max_len` positions; as a ring of `window` slots, slot i holds
    position p ≡ i (mod W), so at decode position `pos` the live positions
    are (pos-W, pos], recovered in closed form; as cross K/V, `enc_seq`."""
    kh, hd = cfg.n_kv_heads, cfg.head_dim
    axes = ("batch", "act_seq", "kv_heads", None)
    return {"k": C.ParamDef((batch, max_len, kh, hd), axes, init="zeros"),
            "v": C.ParamDef((batch, max_len, kh, hd), axes, init="zeros")}


class Attention(C.ParamModule):
    """Self-attention with its `AttnConfig` (window and RoPE base are the
    layer's own: gemma3's locals and globals are two configs)."""

    def __init__(self, cfg: AttnConfig, init: C.Init):
        super().__init__(attn_defs(cfg), init)
        self.cfg = cfg

    def project_qkv(self, x):
        cfg = self.cfg
        q = torch.einsum("bsd,dhk->bshk", x, self.wq)
        k = torch.einsum("bsd,dhk->bshk", x, self.wk)
        v = torch.einsum("bsd,dhk->bshk", x, self.wv)
        if cfg.qkv_bias:
            q = q + self.bq.to(q.dtype)
            k = k + self.bk.to(k.dtype)
            v = v + self.bv.to(v.dtype)
        if cfg.qk_norm:
            q = C.rmsnorm(q, self.q_norm)
            k = C.rmsnorm(k, self.k_norm)
        return q, k, v

    def out(self, o):
        return torch.einsum("bshk,hkd->bsd", o, self.wo)

    def forward(self, x, positions=None, rope_cs=None, window=None):
        """Full-sequence (prefill-free) self-attention."""
        b, s, _ = x.shape
        q, k, v = self.project_qkv(x)
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        q, k = _rope(q, k, self.cfg, positions, rope_cs)
        bias = mask_bias(positions, positions, self.cfg,
                         window=window)[:, None]
        return self.out(sdpa(q, k, v, bias, self.cfg))

    def prefill(self, x, cache: Dict[str, torch.Tensor]):
        """Attention over the prompt; fills the cache at [0, S)."""
        b, s, _ = x.shape
        if s > cache["k"].shape[1]:
            raise ValueError(f"a prompt of {s} positions does not fit the "
                             f"cache's {cache['k'].shape[1]} slots")
        q, k, v = self.project_qkv(x)
        positions = torch.arange(s, device=x.device)[None, :]
        q, k = _rope(q, k, self.cfg, positions)
        out = sdpa_infer(q, k, v, self.cfg, positions,
                         torch.arange(s, device=x.device))
        cache["k"][:, :s] = k.to(cache["k"].dtype)
        cache["v"][:, :s] = v.to(cache["v"].dtype)
        return self.out(out), cache

    def decode_step(self, x, cache: Dict[str, torch.Tensor], pos: int):
        """One-token decode. x: (B,1,D); pos: a Python int."""
        b = x.shape[0]
        ck, cv = cache["k"], cache["v"]
        s_max = ck.shape[1]
        _check_pos(pos, s_max)
        q, k, v = self.project_qkv(x)
        positions = torch.full((b, 1), pos, dtype=torch.int64,
                               device=x.device)
        q, k = _rope(q, k, self.cfg, positions)
        ck[:, pos:pos + 1] = k.to(ck.dtype)
        cv[:, pos:pos + 1] = v.to(cv.dtype)
        k_pos = torch.arange(s_max, device=x.device)[None, :]
        k_valid = k_pos[0] <= pos
        bias = mask_bias(positions, k_pos.expand(b, s_max), self.cfg,
                         k_valid=k_valid[None, :])[:, None]
        return self.out(sdpa(q, ck, cv, bias, self.cfg)), cache

    # ---- ring-buffer cache for sliding-window layers (gemma3 locals) ----

    def ring_prefill(self, x, cache, window: int, rope_cs=None):
        """Windowed attention over the prompt; keeps the last `window` KVs.
        Requires window | S so ring slots line up with positions."""
        b, s, _ = x.shape
        if s % window:
            raise ValueError(f"ring prefill needs window|S ({window},{s})")
        q, k, v = self.project_qkv(x)
        positions = torch.arange(s, device=x.device)[None, :]
        q, k = _rope(q, k, self.cfg, positions, rope_cs)
        bias = mask_bias(positions, positions, self.cfg,
                         window=window)[:, None]
        out = sdpa(q, k, v, bias, self.cfg)
        cache["k"].copy_(k[:, -window:])
        cache["v"].copy_(v[:, -window:])
        return self.out(out), cache

    def ring_decode_step(self, x, cache, pos: int, window: int,
                         rope_cs=None):
        """One-token decode against a ring cache. x: (B,1,D)."""
        b = x.shape[0]
        q, k, v = self.project_qkv(x)
        positions = torch.full((b, 1), pos, dtype=torch.int64,
                               device=x.device)
        q, k = _rope(q, k, self.cfg, positions, rope_cs)
        slot = pos % window
        ck, cv = cache["k"], cache["v"]
        ck[:, slot:slot + 1] = k.to(ck.dtype)
        cv[:, slot:slot + 1] = v.to(cv.dtype)
        # position held by ring slot i:  pos - ((pos - i) mod W)
        i = torch.arange(window, device=x.device)[None, :]
        k_pos = pos - torch.remainder(pos - i, window)
        k_valid = k_pos[0] >= 0
        bias = mask_bias(positions, k_pos.expand(b, window), self.cfg,
                         k_valid=k_valid[None, :], window=window)[:, None]
        return self.out(sdpa(q, ck, cv, bias, self.cfg)), cache


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder)
# ---------------------------------------------------------------------------


def cross_config(cfg: AttnConfig) -> AttnConfig:
    return dataclasses.replace(cfg, qkv_bias=False, qk_norm=False)


class CrossAttention(C.ParamModule):
    def __init__(self, cfg: AttnConfig, init: C.Init):
        cfg = cross_config(cfg)
        super().__init__(attn_defs(cfg), init)
        self.cfg = cfg

    def _attend(self, x, k, v):
        q = torch.einsum("bsd,dhk->bshk", x, self.wq)
        bias = torch.zeros((x.shape[0], 1, x.shape[1], k.shape[1]),
                           dtype=torch.float32, device=x.device)
        out = sdpa(q, k.to(q.dtype), v.to(q.dtype), bias, self.cfg)
        return torch.einsum("bshk,hkd->bsd", out, self.wo)

    def forward(self, x, kv_src):
        """x attends over kv_src (encoder states); no mask, no rope."""
        kv = self.fill(kv_src)
        return self._attend(x, kv["k"], kv["v"])

    def fill(self, kv_src) -> Dict[str, torch.Tensor]:
        """Project encoder states to cross K/V once (at prefill)."""
        k = torch.einsum("btd,dhk->bthk", kv_src, self.wk)
        v = torch.einsum("btd,dhk->bthk", kv_src, self.wv)
        return {"k": k, "v": v}

    def decode(self, x, cache) -> torch.Tensor:
        """Cross-attention against cached encoder K/V."""
        return self._attend(x, cache["k"], cache["v"])
