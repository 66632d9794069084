"""The port's model blocks against the JAX package's, in float32, from
numpy inputs and weights made from a seed: norms, RoPE, the sinusoid, both
MLPs, attention (full, prefill, decode, the ring, cross, the flash path),
MoE routing and dispatch (with drops), MLA, and the SSD scan and decode.
tests/test_torch_lm_blocks_bf16.py runs them again in bf16.

Bound: |Δ| <= REL * max(1, max|JAX|) with REL = 2e-6 (about 16 float32
ulps of the largest value): the two packages sum in different orders and
call different exp/cos/sin, which part by an ulp or a few per block.  The
SSD scan adds its chunks in a loop where JAX runs `associative_scan`, so
it is held to SSD_REL = 1e-5.  Parameters that the models initialise to
zero (biases, norm weights) are drawn non-zero here so they count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import common as JC
from repro.models import mla as JMLA
from repro.models import mlp as JM
from repro.models import moe as JMOE
from repro.models import ssm as JS
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import mla as TMLA
from repro_torch.models import mlp as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import ssm as TS

REL = 2e-6
SSD_REL = 1e-5
INIT = TC.Init(torch.float32, torch.device("cpu"))


def close(got, want, rel=REL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= rel, f"|Δ|/max(1,max|JAX|) = {err:.3e} > {rel}"


def draw(defs, seed):
    """numpy weights for a JAX defs table: N(0, stddev) for every leaf."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, d in defs.items():
        if isinstance(d, dict):
            out[k] = draw(d, seed + 1)
            continue
        sd = JC._stddev(d) if d.init == "normal" else 0.1
        base = 1.0 if d.init == "ones" else 0.0
        out[k] = (base + rng.normal(size=d.shape) * sd).astype(np.float32)
    return out


def load(module, weights):
    for k, v in weights.items():
        if isinstance(v, dict):
            load(getattr(module, k), v)
        else:
            getattr(module, k).data = torch.from_numpy(v.copy())
    return module


def jx(tree):
    return jax.tree.map(jnp.asarray, tree)


def x_of(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


T = torch.from_numpy


# ---------------------------------------------------------------------------
# norms, rope, sinusoid, MLPs
# ---------------------------------------------------------------------------


def test_rmsnorm_and_layernorm():
    x, w, b = x_of((2, 5, 64)), x_of((64,), 1, 0.1), x_of((64,), 2, 0.1)
    close(TC.rmsnorm(T(x), T(w)), JC.rmsnorm(jnp.asarray(x), jnp.asarray(w)))
    close(TC.layernorm(T(x), T(w), T(b)),
          JC.layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


@pytest.mark.parametrize("theta,head_dim", [(1e4, 32), (1e6, 128),
                                            (5e4, 128), (5e6, 128)])
def test_rope_tables_and_rotation(theta, head_dim):
    """Frequencies word for word (XLA's float32 pow); cos/sin and
    the rotation within REL out to position 8191."""
    pos = np.arange(0, 8192, 3, dtype=np.int32)[None]
    jc, js = JC.rope_tables(jnp.asarray(pos), head_dim, theta)
    tc, ts = TC.rope_tables(T(pos), head_dim, theta)
    half = head_dim // 2
    want_f = np.asarray(theta ** (-jnp.arange(0, half, dtype=jnp.float32)
                                  / half))
    assert np.array_equal(
        TC._rope_freqs(theta, half, torch.device("cpu")).numpy(), want_f)
    close(tc, jc)
    close(ts, js)
    x = x_of((1, pos.shape[1], 2, head_dim))
    close(TC.apply_rope(T(x), tc, ts), JC.apply_rope(jnp.asarray(x), jc, js))
    close(TC.apply_rope(T(x), tc[0], ts[0]),
          JC.apply_rope(jnp.asarray(x), jc[0], js[0]))


def test_sinusoidal_pos():
    assert np.array_equal(TC.sinusoidal_pos(64, 128).numpy(),
                          np.asarray(JC.sinusoidal_pos(64, 128)))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_mlp(act):
    w = draw(JM.gated_defs(64, 96), 3)
    x = x_of((2, 7, 64))
    got = load(TM.GatedMLP(64, 96, INIT), w)(T(x), act)
    close(got, JM.gated_forward(jx(w), jnp.asarray(x), act))


def test_plain_mlp():
    w = draw(JM.plain_defs(64, 96), 4)
    x = x_of((2, 7, 64))
    close(load(TM.PlainMLP(64, 96, INIT), w)(T(x)),
          JM.plain_forward(jx(w), jnp.asarray(x)))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN = {
    "gqa": dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16),
    "bias": dict(d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                 qkv_bias=True),
    "qknorm": dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                   qk_norm=True, rope_theta=1e6),
    "window": dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                   window=5),
    "norope": dict(d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                   rope_theta=None),
}


def attn_pair(kind, seed=5):
    jcfg = JA.AttnConfig(**ATTN[kind])
    tcfg = TA.AttnConfig(**ATTN[kind])
    w = draw(JA.attn_defs(jcfg), seed)
    return jcfg, jx(w), load(TA.Attention(tcfg, INIT), w)


@pytest.mark.parametrize("kind", sorted(ATTN))
def test_attention_forward(kind):
    jcfg, jw, mod = attn_pair(kind)
    x = x_of((2, 12, 64))
    close(mod(T(x)), JA.forward(jw, jnp.asarray(x), jcfg))


@pytest.mark.parametrize("kind", ["gqa", "bias", "qknorm"])
def test_attention_prefill_then_decode(kind):
    """prefill over 10 positions, then two decode steps into a 16-slot
    cache: outputs and the cache."""
    jcfg, jw, mod = attn_pair(kind)
    x = x_of((2, 12, 64))
    defs = JA.cache_defs(jcfg, 2, 16)
    jcache = jax.tree.map(lambda d: jnp.zeros(d.shape, jnp.float32), defs,
                          is_leaf=JC.is_def)
    tcache = TC.zeros_tree(TA.cache_defs(mod.cfg, 2, 16), torch.float32,
                           "cpu")
    jo, jcache = JA.prefill(jw, jnp.asarray(x[:, :10]), jcfg, jcache)
    to, tcache = mod.prefill(T(x[:, :10]), tcache)
    close(to, jo)
    for pos in (10, 11):
        xi = x[:, pos:pos + 1]
        jo, jcache = JA.decode_step(jw, jnp.asarray(xi), jcfg, jcache,
                                    jnp.int32(pos))
        to, tcache = mod.decode_step(T(xi), tcache, pos)
        close(to, jo)
    close(tcache["k"], jcache["k"])
    close(tcache["v"], jcache["v"])


def test_decode_past_the_cache_is_refused():
    """JAX's dynamic_update_slice clamps pos >= max_len onto the last
    slot; the port refuses it."""
    _, _, mod = attn_pair("gqa")
    cache = TC.zeros_tree(TA.cache_defs(mod.cfg, 1, 4), torch.float32, "cpu")
    with pytest.raises(ValueError, match="outside the cache"):
        mod.decode_step(torch.zeros(1, 1, 64), cache, 4)


def test_ring_prefill_then_decode():
    """The sliding-window ring: window 4 over 8 prompt positions, then 6
    decode steps, wrapping the ring."""
    jcfg, jw, mod = attn_pair("window")
    w, x = 4, x_of((2, 14, 64))
    jcache = {k: jnp.zeros((2, w, 2, 16), jnp.float32) for k in "kv"}
    tcache = {k: torch.zeros(2, w, 2, 16) for k in "kv"}
    jo, jcache = JA.ring_prefill(jw, jnp.asarray(x[:, :8]), jcfg, jcache, w)
    to, tcache = mod.ring_prefill(T(x[:, :8]), tcache, w)
    close(to, jo)
    for pos in range(8, 14):
        xi = x[:, pos:pos + 1]
        jo, jcache = JA.ring_decode_step(jw, jnp.asarray(xi), jcfg, jcache,
                                         jnp.int32(pos), w)
        to, tcache = mod.ring_decode_step(T(xi), tcache, pos, w)
        close(to, jo)
    close(tcache["k"], jcache["k"])
    with pytest.raises(ValueError, match="window"):
        mod.ring_prefill(T(x[:, :6]), tcache, w)


def test_cross_attention():
    jcfg = JA.AttnConfig(**ATTN["norope"])
    w = draw(JA.cross_defs(jcfg), 6)
    mod = load(TA.CrossAttention(TA.AttnConfig(**ATTN["norope"]), INIT), w)
    x, enc = x_of((2, 5, 64)), x_of((2, 9, 64), 1)
    close(mod(T(x), T(enc)), JA.cross_forward(jx(w), jnp.asarray(x),
                                              jnp.asarray(enc), jcfg))
    jkv = JA.cross_fill(jx(w), jnp.asarray(enc), jcfg)
    tkv = mod.fill(T(enc))
    close(tkv["k"], jkv["k"])
    close(mod.decode(T(x[:, :1]), tkv),
          JA.cross_decode(jx(w), jnp.asarray(x[:, :1]), jcfg, jkv))


@pytest.mark.parametrize("seq", [20, 32])
def test_flash_path(monkeypatch, seq):
    """The chunked online-softmax prefill, taken from 16 positions on in
    chunks of 8 in both packages (20 pads the last chunk)."""
    for mod in (JA, TA):
        monkeypatch.setattr(mod, "FLASH_MIN_SEQ", 16)
        monkeypatch.setattr(mod, "FLASH_CHUNK", 8)
    jcfg, jw, mod = attn_pair("gqa")
    x = x_of((2, seq, 64))
    jcache = {k: jnp.zeros((2, 32, 2, 16), jnp.float32) for k in "kv"}
    tcache = {k: torch.zeros(2, 32, 2, 16) for k in "kv"}
    jo, _ = JA.prefill(jw, jnp.asarray(x), jcfg, jcache)
    to, _ = mod.prefill(T(x), tcache)
    close(to, jo)
    # and the flash form equals the einsum form within the bound
    close(to, JA.forward(jw, jnp.asarray(x), jcfg))


# ---------------------------------------------------------------------------
# MoE and MLA
# ---------------------------------------------------------------------------


def moe_pair(capacity_factor, seed=7):
    kw = dict(d_model=64, n_experts=4, top_k=2, expert_ff=32, n_shared=1,
              shared_ff=32, capacity_factor=capacity_factor)
    jcfg, tcfg = JMOE.MoEConfig(**kw), TMOE.MoEConfig(**kw)
    w = draw(JMOE.moe_defs(jcfg), seed)
    return jcfg, jx(w), load(TMOE.MoE(tcfg, INIT), w)


def test_moe_route():
    jcfg, jw, mod = moe_pair(1.25)
    x = x_of((2, 16, 64))
    jwt, jidx, jaux = JMOE.route(jw["router"], jnp.asarray(x), jcfg)
    twt, tidx, taux = mod.route(T(x))
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    close(twt, jwt)
    close(taux, jaux)


def test_moe_route_ties_take_the_lower_expert():
    """Equal router columns give equal probabilities: both packages pick
    the lower expert first (`lax.top_k`; a stable descending sort)."""
    jcfg, jw, mod = moe_pair(1.25)
    r = np.array(jw["router"])
    r[:, 3] = r[:, 1]
    r[:, 2] = r[:, 0]
    mod.router.data = T(r.copy())
    x = x_of((2, 16, 64))
    _, jidx, _ = JMOE.route(jnp.asarray(r), jnp.asarray(x), jcfg)
    _, tidx, _ = mod.route(T(x))
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    assert set(np.unique(tidx[..., 0].numpy())) <= {0, 1}


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5, 8.0])
def test_moe_forward(capacity_factor):
    """Capacity 0.5 drops choices (counted here); 8.0 drops none."""
    jcfg, jw, mod = moe_pair(capacity_factor)
    x = x_of((2, 16, 64))
    jo, jaux = JMOE.forward(jw, jnp.asarray(x), jcfg)
    to, taux = mod(T(x))
    close(to, jo)
    close(taux, jaux)
    _, idx, _ = mod.route(T(x))
    per_expert = torch.nn.functional.one_hot(idx, 4).sum(dim=(1, 2))
    cap = TMOE.capacity(16, mod.cfg)
    dropped = int(torch.clamp_min(per_expert - cap, 0).sum())
    assert (dropped > 0) == (capacity_factor == 0.5), (dropped, cap)


MLA_KW = dict(d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
              qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)


def test_mla_forward_prefill_decode():
    jcfg, tcfg = JMLA.MLAConfig(**MLA_KW), TMLA.MLAConfig(**MLA_KW)
    w = draw(JMLA.mla_defs(jcfg), 8)
    jw, mod = jx(w), load(TMLA.MLA(tcfg, INIT), w)
    x = x_of((2, 12, 64))
    close(mod(T(x)), JMLA.forward(jw, jnp.asarray(x), jcfg))
    jcache = jax.tree.map(lambda d: jnp.zeros(d.shape, jnp.float32),
                          JMLA.cache_defs(jcfg, 2, 16), is_leaf=JC.is_def)
    tcache = TC.zeros_tree(TMLA.cache_defs(tcfg, 2, 16), torch.float32,
                           "cpu")
    jo, jcache = JMLA.prefill(jw, jnp.asarray(x[:, :10]), jcfg, jcache)
    to, tcache = mod.prefill(T(x[:, :10]), tcache)
    close(to, jo)
    for pos in (10, 11):
        xi = x[:, pos:pos + 1]
        jo, jcache = JMLA.decode_step(jw, jnp.asarray(xi), jcfg, jcache,
                                      jnp.int32(pos))
        to, tcache = mod.decode_step(T(xi), tcache, pos)
        close(to, jo)
    close(tcache["c_kv"], jcache["c_kv"])
    close(tcache["k_rope"], jcache["k_rope"])


# ---------------------------------------------------------------------------
# SSM
# ---------------------------------------------------------------------------

SSM_KW = dict(d_model=64, d_state=16, headdim=16, chunk=8)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked(with_state):
    """Four chunks of 8, with and without an incoming state."""
    jcfg, tcfg = JS.SSMConfig(**SSM_KW), TS.SSMConfig(**SSM_KW)
    rng = np.random.default_rng(9)
    b, s, h, p, n = 2, 32, tcfg.n_heads, 16, 16
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = (0.05 + 0.1 * rng.random((b, s, h))).astype(np.float32)
    a = -(0.5 + rng.random(h)).astype(np.float32)
    bb = rng.normal(size=(b, s, 1, n)).astype(np.float32)
    cc = rng.normal(size=(b, s, 1, n)).astype(np.float32)
    st = rng.normal(size=(b, h, n, p)).astype(np.float32) if with_state \
        else None
    jy, jf = JS._ssd_chunked(*map(jnp.asarray, (x, dt, a, bb, cc)), jcfg,
                             init_state=None if st is None
                             else jnp.asarray(st))
    ty, tf = TS.ssd_chunked(*map(T, (x, dt, a, bb, cc)), tcfg,
                            init_state=None if st is None else T(st))
    close(ty, jy, SSD_REL)
    close(tf, jf, SSD_REL)


def test_ssm_forward_and_decode():
    """The block's prefill (forward with its cache) over 16 positions, then
    three recurrent decode steps; and forward over an unaligned length."""
    jcfg, tcfg = JS.SSMConfig(**SSM_KW), TS.SSMConfig(**SSM_KW)
    w = draw(JS.ssm_defs(jcfg), 10)
    w["a_log"] = (np.random.default_rng(11).random(tcfg.n_heads) - 0.5
                  ).astype(np.float32)
    jw, mod = jx(w), load(TS.SSM(tcfg, INIT), w)
    x = x_of((2, 19, 64), 12, 0.5)
    close(mod(T(x)), JS.forward(jw, jnp.asarray(x), jcfg), SSD_REL)
    jo, jc = JS.forward(jw, jnp.asarray(x[:, :16]), jcfg, return_cache=True)
    to, tc = mod(T(x[:, :16]), return_cache=True)
    close(to, jo, SSD_REL)
    close(tc["state"], jc["state"], SSD_REL)
    close(tc["conv"], jc["conv"])
    for pos in (16, 17, 18):
        xi = x[:, pos:pos + 1]
        jo, jc = JS.decode_step(jw, jnp.asarray(xi), jcfg, jc)
        to, tc = mod.decode_step(T(xi), tc)
        close(to, jo, SSD_REL)
    close(tc["state"], jc["state"], SSD_REL)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        mod(T(x), return_cache=True)
