"""The train step: CE loss, remat'd layers, AdamW, the MoE aux loss; the JAX
package's `repro.train.step`.

The JAX step is a pure function `(params, opt_state, batch) -> (params,
opt_state, metrics)`.  Here the model is an `nn.Module` and the step
changes its parameters in place:

    step = make_train_step(cfg, AdamWConfig())
    opt_state, metrics = step(model, opt_state, batch)

Gradients come from autograd (`torch.autograd.grad`, every parameter's,
zeros where one is unused); the update is `repro_torch.optim.adamw.update`
under `torch.no_grad()`.  The metrics are 0-d tensors on the device:
"loss" (= ce + 0.01 aux), "ce", "aux" and "grad_norm".  The step runs
eagerly.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.optim import adamw as OPT

IGNORE = -1  # label value that is masked out of the loss (vlm patch prefix)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean CE over valid positions. logits (B,S,V); labels (B,S) int."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, torch.clamp_min(labels, 0)[..., None]
                      .long())[..., 0]
    mask = (labels != IGNORE).float()
    nll = (lse - ll) * mask
    return torch.sum(nll) / torch.clamp_min(torch.sum(mask), 1.0)


def make_loss_fn(cfg: ModelConfig, remat: bool = True,
                 aux_weight: float = 0.01) -> Callable:
    """loss_fn(model, batch) -> (loss, {"ce", "aux"})."""
    def loss_fn(model, batch):
        logits, aux = model(batch, remat=remat)
        labels = batch["labels"]
        if cfg.family == "vlm":
            # patch prefix positions carry no next-token target
            pad = torch.full((labels.shape[0], cfg.n_patches), IGNORE,
                             dtype=labels.dtype, device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
        ce = cross_entropy(logits, labels)
        return ce + aux_weight * aux, {"ce": ce, "aux": aux}
    return loss_fn


def value_and_grad(loss_fn: Callable, model: torch.nn.Module,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                              Dict[str, torch.Tensor]]:
    """(loss, extras, grads by parameter name) of `loss_fn(model, batch)`:
    the gradient of every parameter, zeros for one the loss does not
    reach, in its parameter's dtype."""
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    with torch.enable_grad():
        loss, extras = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
    out = {}
    for (n, p), g in zip(named.items(), grads):
        out[n] = torch.zeros_like(p) if g is None else g
    return loss.detach(), {k: v.detach() for k, v in extras.items()}, out


def make_train_step(cfg: ModelConfig,
                    opt_cfg: Optional[OPT.AdamWConfig] = None,
                    remat: bool = True) -> Callable:
    """step(model, opt_state, batch) -> (opt_state, metrics); the model's
    parameters are updated in place."""
    opt_cfg = opt_cfg or OPT.AdamWConfig()
    loss_fn = make_loss_fn(cfg, remat=remat)

    def train_step(model, opt_state, batch):
        loss, extras, grads = value_and_grad(loss_fn, model, batch)
        params = dict(model.named_parameters())
        opt_state, om = OPT.update(params, grads, opt_state, opt_cfg)
        return opt_state, {"loss": loss, **extras, **om}

    return train_step


def make_eval_step(cfg: ModelConfig) -> Callable:
    loss_fn = make_loss_fn(cfg, remat=False)

    @torch.no_grad()
    def eval_step(model, batch):
        loss, extras = loss_fn(model, batch)
        return {"loss": loss, **extras}

    return eval_step
