"""The train step of the port against the JAX package: the shared harness
of tests/test_torch_train_step_*.py, and the loss's own checks.

`run_step(arch)` runs, once per module, JAX's `value_and_grad` of
`make_loss_fn` (jitted, remat on) and its AdamW update (eager: XLA's CPU
jit contracts multiply-adds into FMAs, hazard H1) at `reduced()` size in
float32 from JAX's weights, and the port's `value_and_grad` with remat on
and off and its `update` from the same weights, converted.

Bounds, each stated where it is checked:
- loss, ce, aux: within LOSS_REL of JAX's, relative (two float32 programs
  that sum in other orders);
- every gradient leaf, sliced onto the port's layout: within
  GRAD_REL * max|g| of that JAX leaf slice;
- the global gradient norm: within LOSS_REL relative;
- the port with remat equals the port without it, bit for bit (loss and
  every gradient);
- the updated parameters, element by element and leaf by leaf: within 2
  float32 ulps of JAX's, plus lr times the gap of the two gradients'
  first Adam step directions g c / (|g c| + eps) (c the clip factor),
  plus 1e-6 lr of rounding (`repro_torch.train.parity.update_excess`,
  which chip_smoke.py phase 14 (a) holds the card to).  Where the two
  gradients agree the bound is 2 ulps + 1e-6 lr, so a leaf left unchanged
  or moved wrong fails it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lm_common as H
from repro.models import lm as JLM
from repro.optim import adamw as JOPT
from repro.train import step as JTS
from repro_torch.models import convert as CV
from repro_torch.optim import adamw as TOPT
from repro_torch.train import parity as PAR
from repro_torch.train import step as TTS

B, S = 2, 32
LOSS_REL = 1e-5
# torch's CPU threads a test process uses: the suite runs several
# processes at once, and each one's default of a thread a core made the
# small ops of these tests wait on each other (a 1 s training loop took
# 85 s beside five busy processes)
THREADS = 2
GRAD_REL = 1e-4
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """THREADS torch threads for the module's tests, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


def batch(cfg, seed: int = 3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "audio":
        out["frames"] = (rng.normal(size=(B, cfg.enc_seq, cfg.d_model))
                         * 0.1).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = (rng.normal(size=(B, cfg.n_patches, cfg.d_model))
                          * 0.1).astype(np.float32)
    return out


def port_batch(data):
    return {k: torch.from_numpy(v).long() if k in ("tokens", "labels")
            else torch.from_numpy(v) for k, v in data.items()}


def _jax_side(cfg, params, data, opt_cfg):
    loss_fn = JTS.make_loss_fn(cfg, remat=True)
    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    jb = {k: jnp.asarray(v) for k, v in data.items()}
    (loss, extras), grads = vg(params, jb)
    opt = JOPT.init(params, opt_cfg)
    new_params, opt, om = JOPT.update(params, grads, opt, opt_cfg)
    return {"loss": float(loss), "ce": float(extras["ce"]),
            "aux": float(extras["aux"]), "grad_norm": float(om["grad_norm"]),
            "grads": jax.tree.map(np.asarray, grads),
            "params": jax.tree.map(lambda a: np.asarray(a, np.float32),
                                   new_params)}


def _port_side(tcfg, params, data, opt_cfg):
    out = {}
    for remat in (True, False):
        model = CV.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray,
                                                           params),
                                        device="cpu")
        loss_fn = TTS.make_loss_fn(tcfg, remat=remat)
        loss, extras, grads = TTS.value_and_grad(loss_fn, model,
                                                 port_batch(data))
        res = {"loss": float(loss), "ce": float(extras["ce"]),
               "aux": float(extras["aux"]),
               "grads": {k: g.clone() for k, g in grads.items()}}
        if remat:
            named = dict(model.named_parameters())
            state = TOPT.init(named, opt_cfg)
            _, om = TOPT.update(named, grads, state, opt_cfg)
            res["grad_norm"] = float(om["grad_norm"])
            res["params"] = {k: p.detach().float().numpy()
                             for k, p in named.items()}
        out["remat" if remat else "plain"] = res
    return out


def run_step(arch: str):
    """JAX and the port on one train step of `arch` at reduced size in
    float32 from JAX's weights made well-conditioned:
    {"jax": ..., "remat": ..., "plain": ..., "cfg": ...}."""
    cfg, tcfg = H.configs(arch, "float32")
    data = batch(cfg)
    params = H.well_conditioned(H.jax_params(cfg, S, "float32"))
    out = {"jax": _jax_side(cfg, params, data, JOPT.AdamWConfig(lr=LR)),
           **_port_side(tcfg, params, data, TOPT.AdamWConfig(lr=LR)),
           "cfg": cfg}
    return out


def run_bf16_shallow(arch: str):
    """The loss of both packages in bf16 at one or two layers (`H.shallow`)
    from well-conditioned JAX weights: (port loss, JAX loss, family)."""
    cfg, tcfg = (H.shallow(c) for c in H.configs(arch, "bfloat16"))
    data = batch(cfg)
    params = H.well_conditioned(H.jax_params(cfg, S, "bfloat16"))
    jloss, _ = jax.jit(JTS.make_loss_fn(cfg, remat=True))(
        params, {k: jnp.asarray(v) for k, v in data.items()})
    model = CV.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    with torch.no_grad():
        tloss, _ = TTS.make_loss_fn(tcfg, remat=True)(model,
                                                      port_batch(data))
    return float(tloss), float(jloss), cfg.family


def check_bf16_loss(got: float, want: float, family: str):
    """Within tests/test_decode.py's TOL plus one bf16 ulp of the loss."""
    bound = H.TOL[family] + float(H.bf16_ulp(np.asarray([want]))[0])
    assert abs(got - want) <= bound, (got, want, bound)


def rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def check_losses(run, remat: str):
    j, p = run["jax"], run[remat]
    for k in ("loss", "ce"):
        assert rel(p[k], j[k]) <= LOSS_REL, (k, p[k], j[k])
    # aux is 0 outside the MoE family; there it is a mean over routing
    assert abs(p["aux"] - j["aux"]) <= LOSS_REL * max(abs(j["aux"]), 1.0), \
        (p["aux"], j["aux"])


def check_grads(run, remat: str):
    j, p = run["jax"], run[remat]
    want = CV.unstack_named(j["grads"], list(p["grads"]))
    worst = []
    for name, g in p["grads"].items():
        w = want[name].numpy()
        scale = float(np.abs(w).max())
        err = float(np.abs(g.numpy() - w).max())
        worst.append((err / max(scale, 1e-30), name))
        assert err <= GRAD_REL * scale, (name, err, scale)
    return max(worst)


def check_grad_norm(run):
    assert rel(run["remat"]["grad_norm"], run["jax"]["grad_norm"]) \
        <= LOSS_REL, (run["remat"]["grad_norm"], run["jax"]["grad_norm"])


def check_remat_bit_equal(run):
    a, b = run["remat"], run["plain"]
    assert (a["loss"], a["aux"]) == (b["loss"], b["aux"])
    differ = {n: float((g - b["grads"][n]).abs().max())
              for n, g in a["grads"].items()
              if not torch.equal(g, b["grads"][n])}
    assert not differ, differ


def check_update(run):
    """The updated parameters against JAX's: see the module docstring."""
    j, p = run["jax"], run["remat"]
    want = CV.unstack_named(j["params"], list(p["params"]))
    grads = CV.unstack_named(j["grads"], list(p["params"]))
    over = {}
    for name, got in p["params"].items():
        ex = PAR.update_excess(got, want[name].numpy(), p["grads"][name],
                               p["grad_norm"], grads[name], j["grad_norm"],
                               LR)
        if ex > 0:
            over[name] = ex
    assert not over, over


# ---------------------------------------------------------------------------


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :3] = JTS.IGNORE
    want = float(JTS.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(TTS.cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(labels)))
    assert rel(got, want) <= 1e-6, (got, want)


def test_cross_entropy_all_ignored_is_zero():
    logits = torch.zeros(1, 4, 8)
    labels = torch.full((1, 4), TTS.IGNORE)
    assert float(TTS.cross_entropy(logits, labels)) == 0.0


def test_vlm_loss_masks_the_patch_prefix():
    """pixtral's loss counts no patch position: with the prefix's logits
    made arbitrary, the loss does not move."""
    cfg = H.configs("pixtral-12b", "float32")[1]
    from repro_torch.models import lm as TLM
    model = TLM.init_params(cfg, max_seq=S, device="cpu", seed=0)
    data = port_batch(batch(cfg))
    loss_fn = TTS.make_loss_fn(cfg, remat=False)
    base, _ = loss_fn(model, data)
    data2 = dict(data, patches=data["patches"] * 5.0)
    moved, _ = loss_fn(model, data2)
    assert float(base) != float(moved)   # the prefix feeds the text ...
    logits, _ = model(data)
    p = cfg.n_patches
    assert logits.shape[1] == p + S
    labels = torch.cat([torch.full((B, p), TTS.IGNORE), data["labels"]], 1)
    ce = TTS.cross_entropy(logits, labels)
    ce_text = TTS.cross_entropy(logits[:, p:], data["labels"])
    assert float(ce) == pytest.approx(float(ce_text), rel=1e-6)


def test_eval_step_is_the_loss_and_changes_nothing():
    """`make_eval_step` gives the loss function's loss, ce and aux (JAX's
    `make_eval_step`, with remat off) and leaves the model untouched."""
    cfg = H.configs("moonshot-v1-16b-a3b", "float32")[1]
    from repro_torch.models import lm as TLM
    model = TLM.init_params(cfg, max_seq=S, device="cpu", seed=0)
    before = {k: p.clone() for k, p in model.named_parameters()}
    data = port_batch(batch(cfg))
    got = TTS.make_eval_step(cfg)(model, data)
    loss, extras = TTS.make_loss_fn(cfg, remat=False)(model, data)
    assert sorted(got) == ["aux", "ce", "loss"]
    assert float(got["loss"]) == float(loss)
    assert float(got["aux"]) == float(extras["aux"]) > 0
    assert not got["loss"].requires_grad
    assert all(torch.equal(p, before[k]) for k, p in model.named_parameters())
