"""The LM serving path of the port against the JAX package: the shared
harness of tests/test_torch_lm_*.py, and the checks that need no model run
(parameter counts, the cache facts of tests/test_decode.py).

Each family's file runs its architectures at `reduced()` size once per
module (`run_arch`): JAX's `init_params` draws the weights, the converter
carries them into the port, and both packages run `forward` over S+2
tokens, `prefill` over S and two `decode_step`s, in float32 and in bf16,
and in bf16 from well-conditioned weights once more at one or two layers
and once at full reduced depth (below).

Bounds, each stated where it is checked:
- float32, port against JAX: |Δ| <= F32_REL * max(1, max|JAX|) for the
  logits and every cache leaf.  Two float32 programs that sum in different
  orders part by ~1e-7 a block (tests/test_torch_lm_blocks.py); through
  the reduced models' residual streams this grew to 9e-5 * max|logit|
  (moonshot's forward, measured), so F32_REL = 5e-4.
- bf16, the port's own prefill and decode against its own forward: within
  tests/test_decode.py's TOL, the check that file makes of the JAX package.
- bf16, port against JAX (`check_bf16_matches_jax`): each logit within TOL
  plus one bf16 ulp of JAX's logit.  The ulp is there because XLA's bf16 silu
  and gelu round an ulp away from PyTorch's in about a third of their
  elements (tests/test_torch_lm_blocks_bf16.py, which holds each block's
  casts); through a layer or two that leaves up to two ulps of a logit
  between the packages.  The models are cut to one or two layers (`shallow`),
  keeping gemma3's group and tail and zamba2's shared block, and their query
  and key projections are redrawn at 1/sqrt(fan-in) (`well_conditioned`).
  JAX's init draws them at 1/sqrt(n_heads), so at reduced size the attention
  scores have a standard deviation near 32 and each softmax is near an
  argmax, whose winner an ulp of a bf16 score flips: there JAX's own bf16
  logits lie far from its float32 logits after one layer, and the two
  packages' bf16 logits part as far.
- bf16 accuracy at reduced depth on JAX's own weights
  (`check_bf16_accuracy`): the port's bf16 logits lie no farther from
  JAX's float32 logits than twice JAX's bf16 logits do at their farthest
  for that model, plus TOL.
- bf16 at full reduced depth from well-conditioned weights, port against
  JAX's bf16 (`check_bf16_deep_matches_jax`, the "bf16_deep" run): over
  forward, prefill and both decode steps together, the root mean square
  of the port's distance from JAX's bf16 logits is at most DEEP_REL = 1.0
  times that of JAX's own bf16 logits from its float32 logits (the
  "float32" run's weights, well-conditioned alike): the port lies no
  farther from JAX's bf16 program than that program lies from float32.
  Measured (CPU): 0.31 (pixtral), 0.37-0.47 (mamba2, minitron, qwen1.5,
  yi), 0.56-0.67 (moonshot, gemma3, zamba2), 0.93 (deepseek-v3), 0.95
  (whisper).  Every block is bit-equal to JAX's in all but 0.08% of its
  elements (tests/test_torch_lm_blocks_bf16.py), but inside one jitted
  program XLA may widen a bf16 result that feeds a float32 op without
  rounding it (jitted, a layer norm over a bf16 residual sum equals the
  norm of the unrounded sum in every element, and the norm of the
  rounded sum in 70%), where the port rounds every op; from such a site
  on the two programs' roundings part, so at depth the ratio is not near
  0.  A fault moves it past 1: norm statistics taken in bf16 give 1.06-1.14
  (gemma3, deepseek-v3, moonshot), the softmax over bf16 scores 1.04
  (whisper); an unrelated bf16 program of the same noise would sit near
  sqrt(2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY, get_config, reduced
from repro.models import common as JC
from repro.models import lm as JLM
from repro_torch import configs as TCONF
from repro_torch.models import common as TC
from repro_torch.models import convert as CV
from repro_torch.models import lm as TLM
from repro_torch.train import parity
from test_decode import TOL

B, S = 2, 32
F32_REL = 5e-4
DEEP_REL = 1.0
OUTS = ("forward", "prefill", "decode1", "decode2")
DTYPES = ("float32", "bfloat16")


def configs(arch: str, dtype: str):
    """The JAX and port configs of `arch` at reduced size in `dtype` (MoE
    without drops, as tests/test_decode.py runs it)."""
    out = []
    for get, red in ((get_config, reduced),
                     (TCONF.get_config, TCONF.reduced)):
        cfg = dataclasses.replace(red(get(arch)), dtype=dtype)
        if cfg.family == "moe":
            cfg = dataclasses.replace(cfg, capacity_factor=8.0)
        out.append(cfg)
    return out


def to_np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


def jax_params(cfg, max_seq: int, dtype: str):
    params = JC.init_params(JLM.model_defs(cfg, max_seq=max_seq),
                            jax.random.key(0))
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return params


def f32_cache_defs(defs):
    """JAX cache defs with bf16 leaves widened to float32: the port's cache
    of a float32 config."""
    return jax.tree.map(
        lambda d: dataclasses.replace(d, dtype=jnp.float32)
        if d.dtype == jnp.bfloat16 else d, defs, is_leaf=JC.is_def)


def inputs(cfg, seed: int = 1):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S + 2)).astype(np.int32)}
    if cfg.family == "audio":
        out["frames"] = (rng.normal(size=(B, cfg.enc_seq, cfg.d_model))
                         * 0.1).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = (rng.normal(size=(B, cfg.n_patches, cfg.d_model))
                          * 0.1).astype(np.float32)
    return out


def _jax_run(cfg, dtype, data, transform=None):
    P = cfg.n_patches if cfg.family == "vlm" else 0
    max_len = S + 8 + P
    params = jax_params(cfg, max_len, dtype)
    if transform is not None:
        params = transform(params)
    toks = jnp.asarray(data["tokens"])
    kw = {k: jnp.asarray(v) for k, v in data.items() if k != "tokens"}
    fwd = jax.jit(lambda p, b: JLM.forward(p, cfg, b))
    pre = jax.jit(lambda p, t, c, kw: JLM.prefill(p, cfg, t, c, **kw))
    dec = jax.jit(lambda p, t, c: JLM.decode_step(p, cfg, t, c))
    defs = JLM.cache_defs(cfg, B, max_len)
    if dtype == "float32":
        defs = f32_cache_defs(defs)
    cache = JC.init_params(defs, jax.random.key(2))
    logits, _ = fwd(params, {"tokens": toks, **kw})
    lp, cache = pre(params, toks[:, :S], cache, kw)
    ld1, cache = dec(params, toks[:, S:S + 1], cache)
    ld2, cache = dec(params, toks[:, S + 1:S + 2], cache)
    return params, {"forward": to_np(logits), "prefill": to_np(lp),
                    "decode1": to_np(ld1), "decode2": to_np(ld2),
                    "cache": jax.tree.map(to_np, cache)}


def _port_run(tcfg, jparams, data):
    P = tcfg.n_patches if tcfg.family == "vlm" else 0
    model = CV.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    toks = torch.from_numpy(data["tokens"]).long()
    kw = {k: torch.from_numpy(v) for k, v in data.items() if k != "tokens"}
    with torch.inference_mode():
        logits, _ = model({"tokens": toks, **kw})
        cache = TLM.new_cache(tcfg, B, S + 8 + P, device="cpu")
        lp, cache = model.prefill(toks[:, :S], cache, **kw)
        ld1, cache = model.decode_step(toks[:, S:S + 1], cache)
        ld2, cache = model.decode_step(toks[:, S + 1:S + 2], cache)
    return {"forward": to_np(logits), "prefill": to_np(lp),
            "decode1": to_np(ld1), "decode2": to_np(ld2),
            "cache": CV.cache_to_numpy(cache)}


def shallow(cfg):
    """`cfg` cut to one or two decoder layers, each kind of layer and cache
    kept: gemma3 one group (a local and the global) and a local tail,
    moe its dense layer and one MoE layer, zamba2 two SSM layers each
    followed by the shared block, whisper one encoder layer."""
    if cfg.global_every > 1:
        kw = dict(n_layers=3, global_every=2)
    elif cfg.family == "moe":
        kw = dict(n_layers=cfg.n_dense_layers + 1)
    elif cfg.family == "hybrid":
        kw = dict(n_layers=2, attn_every=1)
    elif cfg.family == "audio":
        kw = dict(n_layers=1, enc_layers=1)
    else:
        kw = dict(n_layers=1)
    return dataclasses.replace(cfg, **kw)


def well_conditioned(params):
    """JAX's parameters with every query and key projection (`wq`, `wk`,
    and MLA's `w_uq`, `w_uk`: input width, heads, head width last) redrawn
    from its own values at 1/sqrt(input width) in place of JAX's
    1/sqrt(heads)."""
    def scale(path, a):
        f = parity.qk_factor(path[-1].key, a.shape)
        if f is None:
            return a
        return (a.astype(jnp.float32) * f).astype(a.dtype)
    return jax.tree_util.tree_map_with_path(scale, params)


def run_arch(arch: str):
    """Both packages on `arch`, in float32 and bf16, from the same weights
    and inputs; in bf16 shallow and well-conditioned ("bf16_shallow");
    and in bf16 at full reduced depth, well-conditioned, beside JAX's
    float32 run from well-conditioned float32 weights ("bf16_deep", whose
    "jax_f32" holds that run): {run: {"jax": outputs, "port": outputs,
    "cfg": config}}."""
    out = {}
    for dtype in DTYPES:
        cfg, tcfg = configs(arch, dtype)
        data = inputs(cfg)
        jparams, jout = _jax_run(cfg, dtype, data)
        out[dtype] = {"jax": jout, "port": _port_run(tcfg, jparams, data),
                      "cfg": cfg}
    cfg, tcfg = (shallow(c) for c in configs(arch, "bfloat16"))
    data = inputs(cfg)
    jparams, jout = _jax_run(cfg, "bfloat16", data, well_conditioned)
    out["bf16_shallow"] = {"jax": jout, "cfg": cfg,
                           "port": _port_run(tcfg, jparams, data)}
    cfg, tcfg = configs(arch, "bfloat16")
    data = inputs(cfg)
    jparams, jout = _jax_run(cfg, "bfloat16", data, well_conditioned)
    _, jf32 = _jax_run(configs(arch, "float32")[0], "float32", data,
                       well_conditioned)
    out["bf16_deep"] = {"jax": jout, "jax_f32": jf32, "cfg": cfg,
                        "port": _port_run(tcfg, jparams, data)}
    return out


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


# ---------------------------------------------------------------------------
# The checks each family's file runs on its fixture
# ---------------------------------------------------------------------------


def check_logits_f32(run, which):
    r = run["float32"]
    err = rel_err(r["port"][which], r["jax"][which])
    assert err <= F32_REL, f"{which}: |Δ|/max(1,max|JAX|) = {err:.3e}"


def check_cache_f32(run):
    r = run["float32"]
    jc, pc = r["jax"]["cache"], r["port"]["cache"]
    assert jax.tree.structure(jc) == jax.tree.structure(pc)
    for path, want in jax.tree_util.tree_leaves_with_path(jc):
        got = pc
        for k in path:
            got = got[k.key]
        assert np.shape(got) == np.shape(want), path
        if np.ndim(want) == 0:
            assert int(got) == int(want), path       # "pos"
            continue
        err = rel_err(got, want)
        assert err <= F32_REL, f"cache {jax.tree_util.keystr(path)}: {err:.3e}"


def bf16_ulp(v):
    """The spacing of bf16 numbers at |v| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def check_bf16_matches_jax(run, which):
    """At one or two layers from well-conditioned weights, in bf16: every
    logit within TOL plus one bf16 ulp of JAX's logit of JAX's."""
    r = run["bf16_shallow"]
    tol = TOL[r["cfg"].family]
    got = r["port"][which].astype(np.float64)
    want = r["jax"][which].astype(np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want)
    bound = tol + bf16_ulp(want)
    worst = np.unravel_index(np.argmax(err - bound), err.shape)
    assert (err <= bound).all(), (
        f"{which}: |Δ| {err[worst]:.4f} at logit {want[worst]:.4f} "
        f"(bound {bound[worst]:.4f}); max|Δ| {err.max():.4f}")


def check_bf16_deep_matches_jax(run):
    """At full reduced depth from well-conditioned weights, in bf16: the
    port's logits (forward, prefill, both decode steps) within DEEP_REL
    times JAX's own bf16-to-float32 gap of JAX's bf16 logits, in root
    mean square over the four outputs together."""
    r = run["bf16_deep"]
    port = noise = 0.0
    for which in OUTS:
        got = r["port"][which].astype(np.float64)
        want = r["jax"][which].astype(np.float64)
        ref = r["jax_f32"][which].astype(np.float64)
        assert got.shape == want.shape == ref.shape, which
        assert np.isfinite(got).all(), which
        port += float(np.sum((got - want) ** 2))
        noise += float(np.sum((want - ref) ** 2))
    ratio = np.sqrt(port / noise)
    assert ratio <= DEEP_REL, (
        f"{r['cfg'].name}: the port is {ratio:.3f} x JAX's bf16 gap from "
        f"JAX's bf16 logits (bound {DEEP_REL})")


def check_bf16_accuracy(run):
    """The port's bf16 logits lie no farther from JAX's float32 logits
    than twice JAX's own bf16 logits do at their farthest (over forward,
    prefill and both decode steps: the model's bf16 noise), plus TOL."""
    ref = run["float32"]["jax"]
    r = run["bfloat16"]
    tol = TOL[r["cfg"].family]
    noise = max(np.abs(r["jax"][w] - ref[w]).max() for w in OUTS)
    for which in OUTS:
        port_err = np.abs(r["port"][which] - ref[which]).max()
        assert port_err <= 2 * noise + tol, (
            f"{which}: port bf16 {port_err:.3f} from the float32 logits, "
            f"JAX bf16 at most {noise:.3f}")


def check_self_consistency(run, dtype):
    """tests/test_decode.py's check, on the port: prefill and two decode
    steps reproduce the port's own forward at those positions."""
    r = run[dtype]
    cfg = r["cfg"]
    P = cfg.n_patches if cfg.family == "vlm" else 0
    full = r["port"]["forward"]
    tol = TOL[cfg.family] if dtype == "bfloat16" else F32_REL * max(
        1.0, float(np.abs(full).max()))
    err_p = np.abs(r["port"]["prefill"] - full[:, P + S - 1]).max()
    assert err_p <= tol, f"prefill mismatch {err_p}"
    for i, which in enumerate(("decode1", "decode2")):
        err = np.abs(r["port"][which] - full[:, P + S + i]).max()
        assert err <= max(tol, 1e-6) * 4 + tol, f"{which} mismatch {err}"


def check_param_count(arch):
    cfg, tcfg = configs(arch, "float32")
    want = JC.param_count(JLM.model_defs(cfg))
    model = TLM.init_params(tcfg, device="meta")
    assert TLM.param_count(model) == want


# ---------------------------------------------------------------------------
# Checks that need no model run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_full_size_param_count_on_meta(arch):
    """Every full configuration's parameter count equals the JAX package's
    `param_count(model_defs(cfg))`, counted on the meta device (nothing is
    allocated)."""
    want = JC.param_count(JLM.model_defs(get_config(arch)))
    model = TLM.init_params(TCONF.get_config(arch), device="meta")
    assert all(p.device.type == "meta" for p in model.parameters())
    assert TLM.param_count(model) == want


def test_gemma_ring_cache_bounded():
    """gemma3's local layers keep a window-sized ring whatever max_len."""
    cfg = TCONF.reduced(TCONF.get_config("gemma3-27b"))
    cdefs = TLM.cache_defs(cfg, batch=1, max_len=4096)
    assert cdefs["groups"][0]["locals"][0]["k"].shape[1] == cfg.window_size
    assert cdefs["groups"][0]["global"]["k"].shape[1] == 4096


def test_mla_cache_is_compressed():
    cfg = TCONF.reduced(TCONF.get_config("deepseek-v3-671b"))
    cdefs = TLM.cache_defs(cfg, batch=1, max_len=1024)
    for stack in ("layers", "dense_layers"):
        layer = cdefs[stack][0]
        assert set(layer) == {"c_kv", "k_rope"}      # latents only
        assert layer["c_kv"].shape[-1] == cfg.kv_lora_rank


def test_ssm_cache_is_constant_size():
    cfg = TCONF.reduced(TCONF.get_config("mamba2-1.3b"))
    c1 = TLM.cache_defs(cfg, batch=1, max_len=64)
    c2 = TLM.cache_defs(cfg, batch=1, max_len=65536)
    assert c1["layers"][0]["state"].shape == c2["layers"][0]["state"].shape
    assert c1["layers"][0]["conv"].shape == c2["layers"][0]["conv"].shape


def test_configs_equal_the_jax_package():
    """The port's copy of every configuration, full and reduced."""
    for name, cfg in REGISTRY.items():
        tcfg = TCONF.get_config(name)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
        assert (dataclasses.asdict(TCONF.reduced(tcfg))
                == dataclasses.asdict(reduced(cfg)))
        assert tcfg.param_count() == cfg.param_count()
        assert tcfg.torch_dtype == torch.bfloat16


class _ScaleInit(TC.Init):
    """Makes each parameter as its init's scale broadcast to its shape (no
    memory): the stddev a "normal" parameter is drawn with, else the
    constant (0 or 1) it starts at."""

    def tensor(self, d):
        v = {"zeros": 0.0, "ones": 1.0}.get(d.init)
        v = TC.stddev(d) if v is None else v
        return torch.tensor(v, dtype=torch.float64).expand(d.shape)


def _jax_leaf(tree, name):
    """The JAX leaf of a port parameter name and the index of its slice
    (`groups.1.locals.0.mlp.w_up` -> groups/locals/mlp/w_up, [1, 0])."""
    parts = name.split(".")
    for k in (x for x in parts if not x.isdigit()):
        tree = tree[k]
    return tree, tuple(int(x) for x in parts if x.isdigit())


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_init_scale_matches_jax(arch):
    """Every parameter of every configuration, full and reduced, starts as
    the JAX package's leaf does: drawn at JAX's `_stddev` of that (stacked)
    leaf, or at its constant.  At full width the dense model's scores are
    near an argmax because of this rule (q and k at 1/sqrt(n_heads)), so
    the port's weights are as chaotic as JAX's, and no more."""
    for cfg, tcfg in ((get_config(arch), TCONF.get_config(arch)),
                      (reduced(get_config(arch)),
                       TCONF.reduced(TCONF.get_config(arch)))):
        defs = JLM.model_defs(cfg)
        model = TLM.LM(tcfg, _ScaleInit(torch.float64, torch.device("cpu")))
        for name, p in model.named_parameters():
            d, _ = _jax_leaf(defs, name)
            want = {"zeros": 0.0, "ones": 1.0}.get(d.init)
            want = JC._stddev(d) if want is None else want
            got = float(p[(0,) * p.dim()])
            assert got == pytest.approx(want, rel=1e-12), (cfg.name, name)


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_init_draws_match_jax(arch):
    """At reduced size the port's seeded draws and JAX's `init_params`
    agree leaf by leaf: the same constants, and root-mean-squares within
    5/sqrt(n) of each other (two independent estimates of one scale over
    n values each part by about 1/sqrt(n))."""
    cfg, tcfg = configs(arch, "float32")
    max_len = S + 8 + (cfg.n_patches if cfg.family == "vlm" else 0)
    jparams = jax.tree.map(np.asarray, jax_params(cfg, max_len, "float32"))
    model = TLM.init_params(tcfg, max_seq=max_len, device="cpu", seed=0)
    for name, p in model.named_parameters():
        leaf, idx = _jax_leaf(jparams, name)
        want = np.asarray(leaf[idx], np.float64)
        got = p.detach().double().numpy()
        if np.all(want == want.flat[0]):
            assert np.all(got == want.flat[0]), name
            continue
        rms_w, rms_g = (float(np.sqrt(np.mean(a * a))) for a in (want, got))
        assert abs(rms_g / rms_w - 1) <= 5 / np.sqrt(want.size), (
            f"{name}: rms {rms_g:.4g} against JAX's {rms_w:.4g}")
