"""Holding one train step against another: one reduced float32 step with
remat on the card against the same step on the CPU (`hold_step`), and
the pieces the CPU tests share with it.

- `qk_factor` / `well_conditioned`: every query and key projection (`wq`,
  `wk`, MLA's `w_uq`, `w_uk`: input width, heads, head width last)
  redrawn from its own values at 1/sqrt(input width) in place of the
  init's 1/sqrt(heads).  At the init's scale each attention softmax of a
  reduced model is near an argmax, where float32 rounding grows: the JAX
  package's own float32 gradients lie up to 1.4e-3 of max|g| from their
  float64 values there, while both packages widened to float64 agree to
  2e-12 (tests/test_torch_train_f64.py).
- `first_step_direction` / `update_excess`: two first AdamW steps from
  the same parameters part by at most 2 ulps, plus lr times the gap of
  their step directions g c / (|g c| + eps) (c the clip factor), plus
  1e-6 lr of rounding.  The bound is tight wherever the two gradients
  agree, and a leaf left unchanged, or moved wrong, breaks it.

    res = hold_step("minitron-8b", torch.device("cuda"))
    assert res["loss_rel"] <= 1e-5 and res["remat_equal"]

The caller turns TF32 off: this module changes no global setting.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import configs as TCONF
from repro_torch.models import lm as TLM
from repro_torch.optim import adamw as OPT
from repro_torch.train import step as TS

QK_NAMES = ("wq", "wk", "w_uq", "w_uk")
# `hold_step`'s step: learning rate, batch and sequence length; AdamW's
# eps (its default)
LR = 1e-3
BATCH, SEQ = 2, 32
EPS = 1e-8


def qk_factor(name: str, shape: Tuple[int, ...]) -> Optional[float]:
    """The redraw factor sqrt(heads / input width) of the query or key
    projection `name` (its last component) of `shape`, else None."""
    if name not in QK_NAMES:
        return None
    return math.sqrt(shape[-2] / shape[-3])


def well_conditioned(model: torch.nn.Module) -> None:
    """Every query and key projection of `model` at 1/sqrt(input width),
    in place."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            f = qk_factor(name.rsplit(".", 1)[-1], tuple(p.shape))
            if f is not None:
                p.mul_(f)


def first_step_direction(g, gnorm: float) -> np.ndarray:
    """AdamW's first step over lr, before weight decay, in float64:
    g c / (|g c| + eps), the clip factor c = min(1, 1 / |g|) (grad_clip 1)."""
    g = g.detach().double().cpu().numpy() if isinstance(g, torch.Tensor) \
        else np.asarray(g, np.float64)
    gc = g * min(1.0, 1.0 / max(gnorm, 1e-9))
    return gc / (np.abs(gc) + EPS)


def update_excess(a, b, ga, na: float, gb, nb: float, lr: float
                  ) -> float:
    """How far parameters `a` and `b` after one first AdamW step (from the
    same parameters, gradients `ga` / `gb` of global norms `na` / `nb`)
    part beyond 2 ulps + lr |direction gap| + 1e-6 lr; <= 0 is within."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    gap = np.abs(first_step_direction(ga, na)
                 - first_step_direction(gb, nb))
    bound = (2 * np.spacing(np.abs(a).astype(np.float32)) + lr * gap
             + 1e-6 * lr)
    return float((np.abs(a - b) - bound).max())


def reduced_f32(arch: str):
    """`arch` at reduced size in float32 (MoE without drops)."""
    cfg = dataclasses.replace(TCONF.reduced(TCONF.get_config(arch)),
                              dtype="float32")
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    return cfg


def train_batch(cfg, device) -> Dict[str, torch.Tensor]:
    """A seeded batch of BATCH x SEQ tokens and their labels (and
    whisper's frames, pixtral's patches) on `device`."""
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (BATCH, SEQ + 1))
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "audio":
        out["frames"] = (rng.normal(size=(BATCH, cfg.enc_seq, cfg.d_model))
                         * 0.1).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = (rng.normal(size=(BATCH, cfg.n_patches,
                                           cfg.d_model)) * 0.1
                          ).astype(np.float32)
    return {k: torch.as_tensor(v, dtype=torch.long if k in ("tokens",
                                                             "labels")
                               else None, device=device)
            for k, v in out.items()}


def hold_step(arch: str, device) -> dict:
    """One train step of `arch` (reduced, float32, well-conditioned, seed
    0, lr LR, BATCH x SEQ tokens) with remat on `device` and on the CPU,
    and without remat on `device`.  Returns the loss's relative gap
    ("loss_rel"), the aux gap and its scale max(1, |aux|) ("aux_gap",
    "aux_scale"), each gradient leaf's gap over its max|g| ("grad_rel"),
    whether remat changed no value on `device` ("remat_equal"), and each
    updated leaf's `update_excess` ("update_excess")."""
    cfg = reduced_f32(arch)
    cpu = TLM.init_params(cfg, max_seq=SEQ, device="cpu", seed=0)
    well_conditioned(cpu)
    card = copy.deepcopy(cpu).to(device)
    plain = copy.deepcopy(card)
    opt_cfg = OPT.AdamWConfig(lr=LR)
    res = {}
    for name, model, where, remat in (("cpu", cpu, "cpu", True),
                                      ("card", card, device, True),
                                      ("plain", plain, device, False)):
        data = train_batch(cfg, where)
        loss, extras, grads = TS.value_and_grad(
            TS.make_loss_fn(cfg, remat=remat), model, data)
        res[name] = {"loss": float(loss), "aux": float(extras["aux"]),
                     "grads": {k: g.detach().clone()
                               for k, g in grads.items()}}
        if name != "plain":
            named = dict(model.named_parameters())
            _, om = OPT.update(named, grads, OPT.init(named, opt_cfg),
                               opt_cfg)
            res[name]["gnorm"] = float(om["grad_norm"])
    c, k, p = res["cpu"], res["card"], res["plain"]
    grad_rel = {}
    for n, g in c["grads"].items():
        err = float((k["grads"][n].cpu() - g).abs().max())
        grad_rel[n] = err / max(float(g.abs().max()), 1e-30)
    excess = {}
    for (n, pc), (_, pk) in zip(cpu.named_parameters(),
                                card.named_parameters()):
        excess[n] = update_excess(pc.detach().numpy(),
                                  pk.detach().cpu().numpy(),
                                  k["grads"][n], k["gnorm"],
                                  c["grads"][n], c["gnorm"], LR)
    return {"loss_rel": abs(k["loss"] - c["loss"]) / abs(c["loss"]),
            "loss": (k["loss"], c["loss"]), "aux": (k["aux"], c["aux"]),
            "aux_gap": abs(k["aux"] - c["aux"]),
            "aux_scale": max(1.0, abs(c["aux"])),
            "grad_rel": grad_rel,
            "remat_equal": k["loss"] == p["loss"] and all(
                torch.equal(g, p["grads"][n])
                for n, g in k["grads"].items()),
            "update_excess": excess}
