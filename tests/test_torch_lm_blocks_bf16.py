"""The port's model blocks against the JAX package's in bf16, from the
same bf16 weights and inputs: the norms, both MLPs, attention (full,
prefill, decode and the cache, the ring, cross, the flash path), MoE
routing and dispatch (with drops), MLA, and the SSD scan and decode.  The
shapes, weights and inputs are tests/test_torch_lm_blocks.py's.

Bounds:
- every output: |Δ| <= BF16_REL * max|JAX| with BF16_REL = 2**-6, two
  bf16 ulps of the largest value.
- every bf16 output: at most BITWISE_SHARE = 1% of the elements differ
  from JAX at all; both libraries round these the same way, and measured,
  at most 0.08% differ.  That includes the MLPs and MoE: the port's silu
  and tanh gelu are XLA's op sequence rounded op by op
  (`models.common.silu`, `gelu_tanh`); PyTorch's fused kernels round
  once and part from XLA's by an ulp in about 40% of the elements.  A
  cast that rounds where JAX keeps float32, or the reverse, moves far
  more: attention's scores kept in float32 where JAX rounds its score
  einsum to bf16 change 22-29% of its outputs, the softmax taken over
  bf16 scores 43% (head width 24), norm statistics in bf16 33-57%, the
  router's logits in bf16 16% of its weights, the SSM's dt in bf16 17% of
  its outputs.
- float32 outputs (the SSM state, MoE's aux loss): F32_REL = 1e-5 of
  max(1, max|JAX|), the float32 block tests' SSD bound.
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
from test_torch_lm_blocks import ATTN, MLA_KW, SSM_KW, T, draw, x_of

BF16_REL = 2.0 ** -6
BITWISE_SHARE = 0.01
F32_REL = 1e-5
# the float32 tests' attention shapes and one whose score scale is not a
# power of two, so scores rounded to bf16 after scaling would show
BF16_ATTN = {**ATTN, "hd24": dict(d_model=64, n_heads=4, n_kv_heads=2,
                                  head_dim=24)}
INIT_BF16 = TC.Init(torch.bfloat16, torch.device("cpu"))


def bf16_weights(defs, w, module):
    """The float32 draws `w` rounded once to each leaf's dtype (bf16, or
    float32 where JAX's def says so): a JAX tree, and loaded into
    `module`, whose parameters have the same dtypes."""
    out = {}
    for k, v in w.items():
        if isinstance(v, dict):
            out[k] = bf16_weights(defs[k], v, getattr(module, k))
            continue
        out[k] = jnp.asarray(v).astype(defs[k].dtype)
        p = getattr(module, k)
        assert p.dtype == (torch.float32 if defs[k].dtype == jnp.float32
                           else torch.bfloat16), k
        p.data = torch.from_numpy(v.copy()).to(p.dtype)
    return out


def xb(shape, seed=0, scale=1.0):
    x = x_of(shape, seed, scale)
    return jnp.asarray(x).astype(jnp.bfloat16), T(x).to(torch.bfloat16)


def bf16_norms():
    (jxx, tx), w, b = xb((2, 5, 64)), x_of((64,), 1, 0.1), x_of((64,), 2, 0.1)
    jw, jb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (w, b))
    tw, tb = (T(a).to(torch.bfloat16) for a in (w, b))
    return [("rmsnorm", TC.rmsnorm(tx, tw), JC.rmsnorm(jxx, jw)),
            ("layernorm", TC.layernorm(tx, tw, tb),
             JC.layernorm(jxx, jw, jb))]


def bf16_mlps():
    out = []
    for act in ("silu", "gelu"):
        defs = JM.gated_defs(64, 96)
        mod = TM.GatedMLP(64, 96, INIT_BF16)
        jw = bf16_weights(defs, draw(defs, 3), mod)
        jxx, tx = xb((2, 7, 64))
        out.append((f"gated {act}", mod(tx, act),
                    JM.gated_forward(jw, jxx, act)))
    defs = JM.plain_defs(64, 96)
    mod = TM.PlainMLP(64, 96, INIT_BF16)
    jw = bf16_weights(defs, draw(defs, 4), mod)
    jxx, tx = xb((2, 7, 64))
    out.append(("plain", mod(tx), JM.plain_forward(jw, jxx)))
    return out


def bf16_attn(kind):
    jcfg = JA.AttnConfig(**BF16_ATTN[kind])
    tcfg = TA.AttnConfig(**BF16_ATTN[kind])
    mod = TA.Attention(tcfg, INIT_BF16)
    return jcfg, bf16_weights(JA.attn_defs(jcfg), draw(JA.attn_defs(jcfg),
                                                       5), mod), mod


def bf16_attention():
    out = []
    for kind in sorted(BF16_ATTN):
        jcfg, jw, mod = bf16_attn(kind)
        jxx, tx = xb((2, 12, 64))
        out.append((f"forward {kind}", mod(tx), JA.forward(jw, jxx, jcfg)))
    for kind in ("gqa", "bias", "qknorm", "hd24"):
        jcfg, jw, mod = bf16_attn(kind)
        jxx, tx = xb((2, 12, 64))
        jc = jax.tree.map(lambda d: jnp.zeros(d.shape, jnp.bfloat16),
                          JA.cache_defs(jcfg, 2, 16), is_leaf=JC.is_def)
        tc = TC.zeros_tree(TA.cache_defs(mod.cfg, 2, 16), torch.bfloat16,
                           "cpu")
        jo, jc = JA.prefill(jw, jxx[:, :10], jcfg, jc)
        to, tc = mod.prefill(tx[:, :10], tc)
        out.append((f"prefill {kind}", to, jo))
        for pos in (10, 11):
            jo, jc = JA.decode_step(jw, jxx[:, pos:pos + 1], jcfg, jc,
                                    jnp.int32(pos))
            to, tc = mod.decode_step(tx[:, pos:pos + 1], tc, pos)
            out.append((f"decode {kind} @{pos}", to, jo))
        out += [(f"cache {kind} {k}", tc[k], jc[k]) for k in "kv"]
    return out


def bf16_ring_and_cross():
    jcfg, jw, mod = bf16_attn("window")
    w, (jxx, tx) = 4, xb((2, 14, 64))
    jc = {k: jnp.zeros((2, w, 2, 16), jnp.bfloat16) for k in "kv"}
    tc = {k: torch.zeros(2, w, 2, 16, dtype=torch.bfloat16) for k in "kv"}
    jo, jc = JA.ring_prefill(jw, jxx[:, :8], jcfg, jc, w)
    to, tc = mod.ring_prefill(tx[:, :8], tc, w)
    out = [("ring prefill", to, jo)]
    for pos in range(8, 14):
        jo, jc = JA.ring_decode_step(jw, jxx[:, pos:pos + 1], jcfg, jc,
                                     jnp.int32(pos), w)
        to, tc = mod.ring_decode_step(tx[:, pos:pos + 1], tc, pos, w)
        out.append((f"ring decode @{pos}", to, jo))
    jcfg = JA.AttnConfig(**ATTN["norope"])
    mod = TA.CrossAttention(TA.AttnConfig(**ATTN["norope"]), INIT_BF16)
    jw = bf16_weights(JA.cross_defs(jcfg), draw(JA.cross_defs(jcfg), 6), mod)
    (jxx, tx), (je, te) = xb((2, 5, 64)), xb((2, 9, 64), 1)
    jkv, tkv = JA.cross_fill(jw, je, jcfg), mod.fill(te)
    return out + [
        ("cross forward", mod(tx, te), JA.cross_forward(jw, jxx, je, jcfg)),
        ("cross K", tkv["k"], jkv["k"]),
        ("cross decode", mod.decode(tx[:, :1], tkv),
         JA.cross_decode(jw, jxx[:, :1], jcfg, jkv))]


def bf16_flash(monkeypatch):
    for m in (JA, TA):
        monkeypatch.setattr(m, "FLASH_MIN_SEQ", 16)
        monkeypatch.setattr(m, "FLASH_CHUNK", 8)
    jcfg, jw, mod = bf16_attn("gqa")
    jxx, tx = xb((2, 20, 64))
    jc = {k: jnp.zeros((2, 32, 2, 16), jnp.bfloat16) for k in "kv"}
    tc = {k: torch.zeros(2, 32, 2, 16, dtype=torch.bfloat16) for k in "kv"}
    jo, _ = JA.prefill(jw, jxx, jcfg, jc)
    to, _ = mod.prefill(tx, tc)
    return [("flash prefill", to, jo)]


def bf16_moe():
    out = []
    for cf in (1.25, 0.5):
        kw = dict(d_model=64, n_experts=4, top_k=2, expert_ff=32, n_shared=1,
                  shared_ff=32, capacity_factor=cf)
        jcfg = JMOE.MoEConfig(**kw)
        mod = TMOE.MoE(TMOE.MoEConfig(**kw), INIT_BF16)
        defs = JMOE.moe_defs(jcfg)
        jw = bf16_weights(defs, draw(defs, 7), mod)
        jxx, tx = xb((2, 16, 64))
        jwt, jidx, _ = JMOE.route(jw["router"], jxx, jcfg)
        twt, tidx, _ = mod.route(tx)
        assert np.array_equal(tidx.numpy(), np.asarray(jidx)), cf
        jo, jaux = JMOE.forward(jw, jxx, jcfg)
        to, taux = mod(tx)
        out += [(f"route weights {cf}", twt, jwt),
                (f"moe forward {cf}", to, jo), (f"aux {cf}", taux, jaux)]
    return out


def bf16_mla():
    jcfg, tcfg = JMLA.MLAConfig(**MLA_KW), TMLA.MLAConfig(**MLA_KW)
    mod = TMLA.MLA(tcfg, INIT_BF16)
    jw = bf16_weights(JMLA.mla_defs(jcfg), draw(JMLA.mla_defs(jcfg), 8), mod)
    jxx, tx = xb((2, 12, 64))
    out = [("forward", mod(tx), JMLA.forward(jw, jxx, jcfg))]
    jc = jax.tree.map(lambda d: jnp.zeros(d.shape, jnp.bfloat16),
                      JMLA.cache_defs(jcfg, 2, 16), is_leaf=JC.is_def)
    tc = TC.zeros_tree(TMLA.cache_defs(tcfg, 2, 16), torch.bfloat16, "cpu")
    jo, jc = JMLA.prefill(jw, jxx[:, :10], jcfg, jc)
    to, tc = mod.prefill(tx[:, :10], tc)
    out.append(("prefill", to, jo))
    for pos in (10, 11):
        jo, jc = JMLA.decode_step(jw, jxx[:, pos:pos + 1], jcfg, jc,
                                  jnp.int32(pos))
        to, tc = mod.decode_step(tx[:, pos:pos + 1], tc, pos)
        out.append((f"decode @{pos}", to, jo))
    return out + [(f"cache {k}", tc[k], jc[k]) for k in ("c_kv", "k_rope")]


def bf16_ssm():
    jcfg, tcfg = JS.SSMConfig(**SSM_KW), TS.SSMConfig(**SSM_KW)
    defs, mod = JS.ssm_defs(jcfg), TS.SSM(tcfg, INIT_BF16)
    w = draw(defs, 10)
    w["a_log"] = (np.random.default_rng(11).random(tcfg.n_heads) - 0.5
                  ).astype(np.float32)
    jw = bf16_weights(defs, w, mod)
    jxx, tx = xb((2, 19, 64), 12, 0.5)
    out = [("forward", mod(tx), JS.forward(jw, jxx, jcfg))]
    jo, jc = JS.forward(jw, jxx[:, :16], jcfg, return_cache=True)
    to, tc = mod(tx[:, :16], return_cache=True)
    assert tc["state"].dtype == torch.float32
    out += [("prefill", to, jo), ("state", tc["state"], jc["state"]),
            ("conv", tc["conv"], jc["conv"])]
    for pos in (16, 17, 18):
        jo, jc = JS.decode_step(jw, jxx[:, pos:pos + 1], jcfg, jc)
        to, tc = mod.decode_step(tx[:, pos:pos + 1], tc)
        out.append((f"decode @{pos}", to, jo))
    return out + [("state after decode", tc["state"], jc["state"])]


BF16_BLOCKS = {"norms": bf16_norms, "mlps": bf16_mlps,
               "attention": bf16_attention, "ring_cross": bf16_ring_and_cross,
               "flash": bf16_flash, "moe": bf16_moe, "mla": bf16_mla,
               "ssm": bf16_ssm}


@pytest.mark.parametrize("block", sorted(BF16_BLOCKS))
def test_block_bf16_matches_jax(block, monkeypatch):
    """Each block in bf16 from the same bf16 weights and inputs: within
    BF16_REL * max|JAX| of the JAX package, and equal to it in all but
    BITWISE_SHARE of the elements (MoE's expert choices equal)."""
    fn = BF16_BLOCKS[block]
    pairs = fn(monkeypatch) if block == "flash" else fn()
    for name, got, want in pairs:
        assert got.dtype == (torch.bfloat16 if want.dtype == jnp.bfloat16
                             else torch.float32), (name, got.dtype)
        g = got.detach().float().numpy()
        w = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        err = np.abs(g - w).max()
        if got.dtype == torch.float32:       # the SSM state, MoE's aux loss
            assert err <= F32_REL * max(1.0, np.abs(w).max()), (name, err)
            continue
        assert err <= BF16_REL * np.abs(w).max(), (
            f"{name}: |Δ| {err:.4g} against max|JAX| {np.abs(w).max():.4g}")
        share = float((g != w).mean())
        assert share <= BITWISE_SHARE, f"{name}: {share:.2%} differ"
