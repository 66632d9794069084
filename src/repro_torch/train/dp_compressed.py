"""Data-parallel training step with int8 gradient compression; the JAX
package's `repro.train.dp_compressed`, over the port's single-controller
`repro_torch.launch.mesh.Mesh`.

One process drives every shard of the mesh's data axes (the mesh decision
of the port: one controller, no `torch.distributed`).  Each shard takes
its contiguous slice of the batch, computes its loss and gradients on its
own device with its own replica of the model, quantizes them to int8 with
its carried residual (`repro_torch.optim.compress`), and the dequantized
gradients are averaged in shard order on the first shard's device, where
AdamW updates the first replica; the others are then copied from it, so
the parameters stay replicated.  Shards on one device share one module
(a mesh of logical shards of one card, or of the CPU).

The residuals are one tree a shard.  The JAX step declares its residual
replicated in `shard_map`'s out_specs while each device computes its own,
so it carries one device's residual forward; here each shard keeps its
own, as error feedback defines it.

    step = make_compressed_dp_step(cfg, mesh, AdamWConfig())
    residual = init_residual(model, mesh)
    opt, residual, metrics = step(model, opt, residual, batch)
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.optim import adamw as OPT
from repro_torch.optim import compress as GC
from repro_torch.train import step as TS


def init_residual(model, mesh, dp_axes: Tuple[str, ...] = ("data",)
                  ) -> List[Dict[str, torch.Tensor]]:
    """One zero residual tree a shard of `dp_axes`
    (`compress.init_residual`), on its device."""
    zeros = GC.init_residual(model)
    return [{k: r.to(dev, copy=True) for k, r in zeros.items()}
            for dev in mesh.shard_devices(dp_axes)]


def make_compressed_dp_step(cfg: ModelConfig, mesh,
                            opt_cfg: Optional[OPT.AdamWConfig] = None,
                            dp_axes: Tuple[str, ...] = ("data",),
                            remat: bool = False) -> Callable:
    """Returns step(model, opt_state, residual, batch) -> (opt_state,
    residual, metrics): `model` lives on the mesh's first device and is
    updated in place; `batch` is a dict of tensors whose leading axis
    splits evenly over the shards."""
    opt_cfg = opt_cfg or OPT.AdamWConfig()
    loss_fn = TS.make_loss_fn(cfg, remat=remat)
    devices = mesh.shard_devices(dp_axes)
    replicas: Dict[torch.device, torch.nn.Module] = {}

    def replica(model, dev):
        if dev == devices[0]:
            return model
        if dev not in replicas:
            replicas[dev] = copy.deepcopy(model).to(dev)
        return replicas[dev]

    def step(model, opt_state, residual, batch):
        n = len(devices)
        rows = next(iter(batch.values())).shape[0]
        if rows % n:
            raise ValueError(f"a batch of {rows} does not split over {n} "
                             "shards")
        per = rows // n
        losses, grads = [], []
        for s, dev in enumerate(devices):
            part = {k: v[s * per:(s + 1) * per].to(dev)
                    for k, v in batch.items()}
            loss, _, g = TS.value_and_grad(loss_fn, replica(model, dev),
                                           part)
            losses.append(loss)
            grads.append(g)
        mean, residual = GC.compress_psum(grads, residual)
        del grads
        params = dict(model.named_parameters())
        opt_state, om = OPT.update(params, mean, opt_state, opt_cfg)
        with torch.no_grad():
            for dev, rep in replicas.items():
                for (_, p), (_, q) in zip(model.named_parameters(),
                                          rep.named_parameters()):
                    q.copy_(p.to(dev))
        loss = losses[0]
        for x in losses[1:]:
            loss = loss + x.to(loss.device)
        loss = loss / torch.tensor(float(n), device=loss.device)
        return opt_state, residual, {"loss": loss, **om}

    return step
