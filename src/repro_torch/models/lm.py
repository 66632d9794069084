"""Model assembly: every assigned architecture as one `LM` module with
`forward`, `prefill` and `decode_step`, driven by one ModelConfig; the JAX
package's `repro.models.lm`.

Families:
  dense  — llama-style decoder (minitron, yi, qwen[+bias], gemma3[5:1 pattern])
  moe    — GQA or MLA attention + GShard MoE (moonshot, deepseek-v3)
  audio  — whisper backbone: encoder (stubbed conv frontend) + cross-attn dec
  vlm    — pixtral backbone: patch-embedding prefix + mistral-nemo decoder
  ssm    — mamba2 SSD stack
  hybrid — zamba2: mamba2 stack + shared attention block every k layers

Where the JAX package scans stacked layers, the port keeps a `ModuleList`
of layers, each made on the device from the seeded generator, so the
largest float32 draw is one layer's leaf.  Parameter names follow the JAX
tree with the layer index spelled out (`layers.3.attn.wq`,
`groups.1.locals.0.mlp.w_up`, `groups.1.global.attn.wo`), which is how
`repro_torch.models.convert` carries JAX weights across.  One plan, made
with the model, lists the decoder layers in the order they run with the
cache slots each uses; forward, prefill and decode each loop over it.

A cache is a tree of dicts and per-layer lists mirroring the JAX cache
(`cache_defs`), whose "pos" is a Python int: decoding never reads a
position back from the device.  Attention caches are written in place.

    model = init_params(cfg, max_seq=512, device="cuda", seed=0)
    cache = new_cache(cfg, batch=8, max_len=512, device="cuda")
    logits, cache = model.prefill(tokens, cache)
    logits, cache = model.decode_step(next_tokens, cache)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as ATT
from repro_torch.models import common as C
from repro_torch.models import mla as MLA
from repro_torch.models import mlp as MLP
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

# a path into a cache tree: keys and list indices, e.g. ("groups", 1, "global")
Path = Tuple[Any, ...]


# ---------------------------------------------------------------------------
# Sub-config builders
# ---------------------------------------------------------------------------


def attn_cfg(cfg: ModelConfig, *, window: Optional[int] = None,
             theta: Optional[float] = None, causal: bool = True
             ) -> ATT.AttnConfig:
    return ATT.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads_, n_kv_heads=cfg.n_kv_heads_,
        head_dim=cfg.head_dim_, qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
        rope_theta=theta if theta is not None else cfg.rope_theta,
        causal=causal, window=window)


def local_attn_cfg(cfg: ModelConfig) -> ATT.AttnConfig:
    """gemma3's sliding-window layers."""
    return attn_cfg(cfg, window=cfg.window_size, theta=cfg.rope_theta_local)


def audio_attn_cfg(cfg: ModelConfig, causal: bool = True) -> ATT.AttnConfig:
    """whisper's attention: no RoPE (positions are added to the input)."""
    return dataclasses.replace(attn_cfg(cfg, causal=causal), rope_theta=None)


def mla_cfg(cfg: ModelConfig) -> MLA.MLAConfig:
    return MLA.MLAConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads_, q_lora_rank=cfg.q_lora_rank,
        kv_lora_rank=cfg.kv_lora_rank, qk_nope_dim=cfg.qk_nope_dim,
        qk_rope_dim=cfg.qk_rope_dim, v_head_dim=cfg.v_head_dim,
        rope_theta=cfg.rope_theta)


def moe_cfg(cfg: ModelConfig) -> MOE.MoEConfig:
    return MOE.MoEConfig(
        d_model=cfg.d_model, n_experts=cfg.n_experts, top_k=cfg.top_k,
        expert_ff=cfg.expert_ff, n_shared=cfg.n_shared_experts,
        shared_ff=cfg.expert_ff, capacity_factor=cfg.capacity_factor)


def ssm_cfg(cfg: ModelConfig) -> SSM.SSMConfig:
    return SSM.SSMConfig(d_model=cfg.d_model, d_state=cfg.d_state,
                         headdim=cfg.ssm_headdim, chunk=cfg.ssm_chunk)


def gemma_groups(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_groups, locals_per_group, n_tail_locals) for the 5:1 pattern."""
    ge = cfg.global_every
    n_groups = cfg.n_layers // ge
    tail = cfg.n_layers - n_groups * ge
    assert tail < ge, "tail must be all-local"
    return n_groups, ge - 1, tail


def zamba_groups(cfg: ModelConfig) -> int:
    assert cfg.n_layers % cfg.attn_every == 0
    return cfg.n_layers // cfg.attn_every


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


class Norm(C.ParamModule):
    def __init__(self, d: int, cfg: ModelConfig, init: C.Init):
        if cfg.norm == "rms":
            defs = {"w": C.ParamDef((d,), (None,), init="zeros")}
        else:
            defs = {"w": C.ParamDef((d,), (None,), init="ones"),
                    "b": C.ParamDef((d,), (None,), init="zeros")}
        super().__init__(defs, init)
        self.kind = cfg.norm

    def forward(self, x):
        if self.kind == "rms":
            return C.rmsnorm(x, self.w)
        return C.layernorm(x, self.w, self.b)


class DecoderLayer(nn.Module):
    """norm1 → attention (GQA, or MLA where the config says) → norm2 →
    gated MLP or MoE, each a residual branch: the dense, vlm and moe
    families' layers and zamba2's shared block."""

    def __init__(self, cfg: ModelConfig, init: C.Init, *,
                 acfg: Optional[ATT.AttnConfig] = None,
                 d_ff: Optional[int] = None, moe: bool = False):
        super().__init__()
        self.act = cfg.act
        self.is_moe = moe
        # a sliding-window layer keeps a ring as wide as its cache
        self.ring = acfg is not None and acfg.window is not None
        self.attn = (MLA.MLA(mla_cfg(cfg), init) if cfg.use_mla
                     else ATT.Attention(acfg or attn_cfg(cfg), init))
        if moe:
            self.moe = MOE.MoE(moe_cfg(cfg), init)
        else:
            self.mlp = MLP.GatedMLP(cfg.d_model, d_ff or cfg.d_ff, init)
        self.norm1 = Norm(cfg.d_model, cfg, init)
        self.norm2 = Norm(cfg.d_model, cfg, init)

    def ffn(self, x) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        h = self.norm2(x)
        if self.is_moe:
            out, aux = self.moe(h)
            return x + out, aux
        return x + self.mlp(h, self.act), None

    def forward(self, x):
        return self.ffn(x + self.attn(self.norm1(x)))

    def prefill(self, x, cache):
        hn = self.norm1(x)
        if self.ring:
            o, cache = self.attn.ring_prefill(hn, cache, cache["k"].shape[1])
        else:
            o, cache = self.attn.prefill(hn, cache)
        return self.ffn(x + o)[0], cache

    def decode_step(self, x, cache, *, pos: int):
        hn = self.norm1(x)
        if self.ring:
            o, cache = self.attn.ring_decode_step(hn, cache, pos,
                                                  cache["k"].shape[1])
        else:
            o, cache = self.attn.decode_step(hn, cache, pos)
        return self.ffn(x + o)[0], cache


class GemmaGroup(nn.Module):
    """`global_every - 1` sliding-window layers, then one global layer."""

    def __init__(self, cfg: ModelConfig, n_locals: int, init: C.Init):
        super().__init__()
        self.locals = nn.ModuleList(
            DecoderLayer(cfg, init, acfg=local_attn_cfg(cfg))
            for _ in range(n_locals))
        self.add_module("global", DecoderLayer(cfg, init))

    @property
    def glob(self) -> DecoderLayer:
        return self._modules["global"]


class EncoderLayer(nn.Module):
    """whisper encoder: bidirectional attention and a plain GELU MLP."""

    def __init__(self, cfg: ModelConfig, init: C.Init):
        super().__init__()
        self.attn = ATT.Attention(audio_attn_cfg(cfg, causal=False), init)
        self.mlp = MLP.PlainMLP(cfg.d_model, cfg.d_ff, init)
        self.norm1 = Norm(cfg.d_model, cfg, init)
        self.norm2 = Norm(cfg.d_model, cfg, init)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class AudioDecoderLayer(nn.Module):
    """whisper decoder: causal self-attention, cross-attention over the
    encoder states, a plain GELU MLP."""

    def __init__(self, cfg: ModelConfig, init: C.Init):
        super().__init__()
        acfg = audio_attn_cfg(cfg)
        self.self_attn = ATT.Attention(acfg, init)
        self.cross_attn = ATT.CrossAttention(acfg, init)
        self.mlp = MLP.PlainMLP(cfg.d_model, cfg.d_ff, init)
        self.norm1 = Norm(cfg.d_model, cfg, init)
        self.norm2 = Norm(cfg.d_model, cfg, init)
        self.norm3 = Norm(cfg.d_model, cfg, init)

    def forward(self, x, *, enc):
        x = x + self.self_attn(self.norm1(x))
        x = x + self.cross_attn(self.norm2(x), enc)
        return x + self.mlp(self.norm3(x)), None

    def prefill(self, x, cache, cross_cache, *, enc):
        """Fills the self-attention cache and, once, the cross K/V."""
        o, cache = self.self_attn.prefill(self.norm1(x), cache)
        x = x + o
        kv = self.cross_attn.fill(enc)
        x = x + self.cross_attn.decode(self.norm2(x), kv)
        for k in ("k", "v"):
            cross_cache[k].copy_(kv[k])
        return x + self.mlp(self.norm3(x)), cache

    def decode_step(self, x, cache, cross_cache, *, pos: int):
        o, cache = self.self_attn.decode_step(self.norm1(x), cache, pos)
        x = x + o
        x = x + self.cross_attn.decode(self.norm2(x), cross_cache)
        return x + self.mlp(self.norm3(x)), cache


class SSMLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, init: C.Init):
        super().__init__()
        self.ssm = SSM.SSM(ssm_cfg(cfg), init)
        self.norm1 = Norm(cfg.d_model, cfg, init)

    def forward(self, x):
        return x + self.ssm(self.norm1(x)), None

    def prefill(self, x, cache):
        """Returns a new cache (the scan's final state and conv tail)."""
        o, cache = self.ssm(self.norm1(x), return_cache=True)
        return x + o, cache

    def decode_step(self, x, cache, *, pos: int):
        o, cache = self.ssm.decode_step(self.norm1(x), cache)
        return x + o, cache


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


class LM(nn.Module):
    """One architecture.  `init` says where its parameters are made (see
    `common.Init`); `max_seq` sizes whisper's learned decoder positions."""

    def __init__(self, cfg: ModelConfig, init: C.Init, max_seq: int = 4096):
        super().__init__()
        self.cfg = cfg
        d, v = cfg.d_model, cfg.vocab_

        def param(name, shape, axes, **kw):
            C.register_param(self, name, C.ParamDef(shape, axes, **kw), init)

        # 1/sqrt(d) keeps tied-head logits unit-scale; tied inputs are
        # re-scaled by sqrt(d) in embed_tokens() (gemma convention)
        param("embed", (v, d), ("vocab", "embed"), scale=d ** -0.5)
        self.final_norm = Norm(d, cfg, init)
        if not cfg.tie_embeddings:
            param("lm_head", (d, v), ("embed", "vocab"))

        fam = cfg.family
        if fam in ("dense", "vlm"):
            if cfg.global_every > 1:
                ng, nl, tail = gemma_groups(cfg)
                self.groups = nn.ModuleList(GemmaGroup(cfg, nl, init)
                                            for _ in range(ng))
                if tail:
                    self.tail = nn.ModuleList(
                        DecoderLayer(cfg, init, acfg=local_attn_cfg(cfg))
                        for _ in range(tail))
            else:
                self.layers = nn.ModuleList(DecoderLayer(cfg, init)
                                            for _ in range(cfg.n_layers))
        elif fam == "moe":
            nd = cfg.n_dense_layers
            if nd:
                self.dense_layers = nn.ModuleList(
                    DecoderLayer(cfg, init, d_ff=cfg.moe_ff_dense or cfg.d_ff)
                    for _ in range(nd))
            self.layers = nn.ModuleList(DecoderLayer(cfg, init, moe=True)
                                        for _ in range(cfg.n_layers - nd))
        elif fam == "audio":
            self.enc_layers = nn.ModuleList(EncoderLayer(cfg, init)
                                            for _ in range(cfg.enc_layers))
            self.enc_norm = Norm(d, cfg, init)
            self.dec_layers = nn.ModuleList(AudioDecoderLayer(cfg, init)
                                            for _ in range(cfg.n_layers))
            param("dec_pos", (max_seq, d), (None, "embed"), scale=0.01)
        elif fam in ("ssm", "hybrid"):
            self.layers = nn.ModuleList(SSMLayer(cfg, init)
                                        for _ in range(cfg.n_layers))
            if fam == "hybrid":
                zamba_groups(cfg)
                self.shared = DecoderLayer(cfg, init)
        else:
            raise ValueError(fam)
        self.plan = self._layer_plan()

    def _layer_plan(self) -> List[Tuple[nn.Module, Tuple[Path, ...]]]:
        """Every decoder layer in the order it runs, with the paths in the
        cache tree of the caches it reads and writes (whisper's layers
        also their cross K/V; zamba2's shared block appears once a group
        with that group's KV cache)."""
        fam = self.cfg.family
        plan = []
        if fam in ("dense", "vlm") and self.cfg.global_every > 1:
            for g, group in enumerate(self.groups):
                plan += [(lp, (("groups", g, "locals", j),))
                         for j, lp in enumerate(group.locals)]
                plan.append((group.glob, (("groups", g, "global"),)))
            plan += [(lp, (("tail", i),))
                     for i, lp in enumerate(getattr(self, "tail", ()))]
        elif fam == "audio":
            plan = [(lp, (("layers", i), ("cross", i)))
                    for i, lp in enumerate(self.dec_layers)]
        elif fam == "hybrid":
            ge = self.cfg.attn_every
            for g in range(zamba_groups(self.cfg)):
                plan += [(self.layers[i], (("layers", i),))
                         for i in range(g * ge, (g + 1) * ge)]
                plan.append((self.shared, (("shared_kv", g),)))
        else:
            plan = [(lp, (("dense_layers", i),)) for i, lp in
                    enumerate(getattr(self, "dense_layers", ()))]
            plan += [(lp, (("layers", i),))
                     for i, lp in enumerate(self.layers)]
        return plan

    # ---- pieces shared by forward, prefill and decode ---------------------

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed[tokens]
        if self.cfg.tie_embeddings:
            # sqrt(d) rounded to the activation dtype first, as the JAX
            # package multiplies; rounded on the host, so no copy to the
            # device (which would wait for the stream) a step
            scale = torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype)
            x = x * scale.item()
        return x

    def head(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x)
        w = self.embed.t() if self.cfg.tie_embeddings else self.lm_head
        return torch.matmul(x, w)

    def encode(self, frames: torch.Tensor, remat: bool = False
               ) -> torch.Tensor:
        """whisper's encoder over the (B, enc_seq, D) stub frames."""
        cfg = self.cfg
        enc = frames.to(device=self.embed.device, dtype=cfg.torch_dtype)
        enc = enc + C.sinusoidal_pos(enc.shape[1], cfg.d_model,
                                     device=enc.device).to(enc.dtype)
        for lp in self.enc_layers:
            enc = _run(lp, remat, enc)
        return self.enc_norm(enc)

    def _inputs(self, tokens, patches=None, start: int = 0):
        """The residual stream's input: token embeddings, after pixtral's
        patch prefix, plus whisper's learned positions from `start`."""
        x = self.embed_tokens(tokens)
        if self.cfg.family == "vlm" and patches is not None:
            x = torch.cat([patches.to(device=x.device, dtype=x.dtype), x],
                          dim=1)
        if self.cfg.family == "audio":
            x = x + self.dec_pos[start:start + x.shape[1]][None].to(x.dtype)
        return x

    def _context(self, frames, remat: bool = False
                 ) -> Dict[str, torch.Tensor]:
        """What every layer of a pass reads besides the stream: whisper's
        encoder states."""
        return ({"enc": self.encode(frames, remat)}
                if self.cfg.family == "audio" else {})

    # ---- the three passes ---------------------------------------------------

    def forward(self, batch: Dict[str, torch.Tensor], remat: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (logits (B,S,V), aux_loss scalar).  With `remat`, each
        entry of the plan (and each of whisper's encoder layers) runs
        under activation checkpointing: its activations are recomputed in
        the backward pass instead of kept, as the JAX package wraps each
        scanned body in `jax.checkpoint`; no value changes."""
        tokens = batch["tokens"]
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        kw = self._context(batch.get("frames"), remat)
        x = self._inputs(tokens, batch.get("patches"))
        for layer, _ in self.plan:
            x, a = _run(layer, remat, x, **kw)
            if a is not None:
                aux = aux + a
        return self.head(x), aux

    def prefill(self, tokens: torch.Tensor, cache: Dict,
                frames: Optional[torch.Tensor] = None,
                patches: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict]:
        """Fills the cache over the prompt.  Returns (last-position logits
        (B,V), cache)."""
        kw = self._context(frames)
        x = self._inputs(tokens, patches)
        for layer, paths in self.plan:
            x, new = layer.prefill(x, *(_at(cache, p) for p in paths), **kw)
            _put(cache, paths[0], new)
        cache["pos"] = x.shape[1]
        return self.head(x[:, -1:, :])[:, 0], cache

    def position_slots(self, cache: Dict) -> Optional[int]:
        """How many positions the cache (and whisper's learned positions)
        hold; None where nothing is indexed by position (mamba2)."""
        for layer, paths in self.plan:
            if isinstance(layer, SSMLayer) or getattr(layer, "ring", False):
                continue
            slots = next(iter(_at(cache, paths[0]).values())).shape[1]
            if self.cfg.family == "audio":
                slots = min(slots, self.dec_pos.shape[0])
            return slots
        return None

    def decode_step(self, tokens: torch.Tensor, cache: Dict
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens: (B, 1). Returns (logits (B, V), cache); refuses a
        position past the cache (`ValueError`) before any write."""
        pos = cache["pos"]
        slots = self.position_slots(cache)
        if slots is not None and not 0 <= pos < slots:
            raise ValueError(f"decode position {pos} is outside the cache's "
                             f"{slots} slots")
        x = self._inputs(tokens, start=pos)
        for layer, paths in self.plan:
            x, new = layer.decode_step(x, *(_at(cache, p) for p in paths),
                                       pos=pos)
            _put(cache, paths[0], new)
        cache["pos"] = pos + 1
        return self.head(x)[:, 0], cache


def _run(layer: nn.Module, remat: bool, *args, **kw):
    """`layer(*args, **kw)`, under activation checkpointing with `remat`
    while autograd records."""
    if remat and torch.is_grad_enabled():
        return checkpoint(layer, *args, use_reentrant=False, **kw)
    return layer(*args, **kw)


def _at(tree, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree, path: Path, value) -> None:
    _at(tree, path[:-1])[path[-1]] = value


# ---------------------------------------------------------------------------
# Construction and caches
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, max_seq: int = 4096, *, device,
                seed: int = 0) -> LM:
    """A model with random weights on `device`, drawn from a generator
    there seeded with `seed` (the JAX package's `init_params(model_defs)`;
    its draws are its own).  On the meta device nothing is allocated."""
    return LM(cfg, C.seeded_init(cfg.torch_dtype, device, seed), max_seq)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def model_defs(cfg: ModelConfig, max_seq: int = 4096
               ) -> Dict[str, C.ParamDef]:
    """Every parameter's `ParamDef` by its port name (the JAX package's
    `model_defs`, one entry a layer where it stacks): the model is made
    on the meta device, so nothing is allocated."""
    return C.module_defs(LM(cfg, C.Init(cfg.torch_dtype,
                                        torch.device("meta")), max_seq))


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, Any]:
    """The decode cache's shapes as a tree of `ParamDef`s: per-layer lists
    where the JAX package stacks, and "pos" (a Python int)."""
    fam = cfg.family

    def each(n, make):
        return [make() for _ in range(n)]

    if fam in ("dense", "vlm"):
        if cfg.global_every > 1:
            ng, nl, tail = gemma_groups(cfg)
            a_local, a_glob = local_attn_cfg(cfg), attn_cfg(cfg)
            w = min(cfg.window_size, max_len)
            d = {"groups": each(ng, lambda: {
                "locals": each(nl, lambda: ATT.cache_defs(
                    a_local, batch, w)),
                "global": ATT.cache_defs(a_glob, batch, max_len)}),
                "pos": 0}
            if tail:
                d["tail"] = each(tail, lambda: ATT.cache_defs(
                    a_local, batch, w))
            return d
        return {"layers": each(cfg.n_layers, lambda: ATT.cache_defs(
            attn_cfg(cfg), batch, max_len)), "pos": 0}
    if fam == "moe":
        def sub():
            if cfg.use_mla:
                return MLA.cache_defs(mla_cfg(cfg), batch, max_len)
            return ATT.cache_defs(attn_cfg(cfg), batch, max_len)
        d = {"layers": each(cfg.n_layers - cfg.n_dense_layers, sub),
             "pos": 0}
        if cfg.n_dense_layers:
            d["dense_layers"] = each(cfg.n_dense_layers, sub)
        return d
    if fam == "audio":
        acfg = audio_attn_cfg(cfg)
        return {
            "layers": each(cfg.n_layers, lambda: ATT.cache_defs(
                acfg, batch, max_len)),
            "cross": each(cfg.n_layers, lambda: ATT.cache_defs(
                acfg, batch, cfg.enc_seq)),
            "pos": 0,
        }
    if fam in ("ssm", "hybrid"):
        d = {"layers": each(cfg.n_layers, lambda: SSM.cache_defs(
            ssm_cfg(cfg), batch)), "pos": 0}
        if fam == "hybrid":
            d["shared_kv"] = each(zamba_groups(cfg), lambda: ATT.cache_defs(
                attn_cfg(cfg), batch, max_len))
        return d
    raise ValueError(fam)


def new_cache(cfg: ModelConfig, batch: int, max_len: int, *, device
              ) -> Dict[str, Any]:
    """An empty decode cache on `device` in the model's dtype (the SSM
    state in float32)."""
    return C.zeros_tree(cache_defs(cfg, batch, max_len), cfg.torch_dtype,
                        torch.device(device))
