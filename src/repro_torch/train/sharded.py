"""The training state of `train(mesh=)`: batch shards, and parameters and
moments held as slices under the logical-axis rules.

On the port's single-controller mesh (`repro_torch.sharding` says what a
rule means there), one step of `ShardedTrain` is:

  1. the parameters are gathered from their slices onto the mesh's first
     device (and copied to each other device that runs a batch shard);
  2. the batch splits over the shards of the "batch" rule's axes; each
     shard runs forward and backward on its slice, on its device (shards
     on one device share one module), and the gradients are averaged in
     shard order on the first device (the replica machinery of
     `train.dp_compressed`, without the int8);
  3. the global gradient norm is taken once, over the whole gradient;
  4. the whole parameters are released, and each gradient leaf is cut
     into the slices of its parameter's spec (`models.common.spec_tree`
     under the FSDP rules);
  5. AdamW updates slice by slice, each on its shard's device, with that
     norm.  32-bit moments are sliced as their parameters
     (`optim.adamw.state_axes`); 8-bit moments stay whole, as the JAX
     package's `state_axes` says, so a leaf with whole moments is updated
     whole on the first device and cut into its slices again.

Every op of the update is elementwise (or local to a block of the last
axis, which no spec here cuts: quantized leaves stay whole), so a slice's
update is the whole leaf's, element for element; with one batch shard a
step equals `train()`'s bit for bit.  With several, the gradients and the
loss are shard means averaged (the MoE load-balance loss is each shard's,
averaged), which parts from the one-device step by float32 rounding.

A checkpoint holds whole arrays (`state_tree` gathers the slices to the
host), so it restores under any mesh, or none: the elastic restart.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Tuple

import torch

from repro_torch import sharding as SH
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as C
from repro_torch.models import convert as CV
from repro_torch.optim import adamw as OPT
from repro_torch.train import step as TS


def batch_devices(mesh) -> List[torch.device]:
    """The device of each batch shard: the shards over the active
    "batch" rule's mesh axes (one shard where the rule names none)."""
    axes = SH.current_rules().get("batch")
    if not axes:
        return [mesh.first_device]
    return mesh.shard_devices(SH.entry_axes(axes))


def _unique(slices: List[torch.Tensor]) -> List[Tuple[int, torch.Tensor]]:
    """(position, tensor) of each distinct tensor of a shard list."""
    seen, out = set(), []
    for pos, t in enumerate(slices):
        if id(t) not in seen:
            seen.add(id(t))
            out.append((pos, t))
    return out


class ShardedTrain:
    """Takes over `model` (its parameters become slices) and the full
    `opt_state` (its 32-bit moments become slices); build it under
    `sharding.use_mesh(mesh)`."""

    def __init__(self, model, opt_state: OPT.AdamState, mesh,
                 model_cfg: ModelConfig, opt_cfg: OPT.AdamWConfig):
        self.model, self.mesh, self.opt_cfg = model, mesh, opt_cfg
        # remat on, as `train()`'s step (`make_train_step`'s default)
        self.loss_fn = TS.make_loss_fn(model_cfg, remat=True)
        self.devices = batch_devices(mesh)
        defs = C.module_defs(model)
        specs = C.spec_tree(defs)
        self.shardings = {n: SH.NamedSharding(mesh, specs[n]) for n in defs}
        self.shapes = {n: tuple(d.shape) for n, d in defs.items()}
        self.whole_moments = opt_cfg.state_bits == 8
        self.step_count = opt_state.step
        named = dict(model.named_parameters())
        self.params = {n: self.shardings[n].shard(p.detach())
                       for n, p in named.items()}
        self.m, self.v = opt_state.m, opt_state.v
        if not self.whole_moments:
            for tree in (self.m, self.v):
                for n in named:
                    tree[n] = self.shardings[n].shard(tree[n])
        self.replicas: Dict[torch.device, torch.nn.Module] = {}
        self.release()

    # ---- whole parameters ---------------------------------------------

    def release(self) -> None:
        """Drop the whole parameters (the slices hold the state)."""
        for p in self.model.parameters():
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        for rep in self.replicas.values():
            for p in rep.parameters():
                p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    def materialize(self) -> None:
        """Gather every parameter from its slices onto the model's device,
        and copy it to each other batch shard's replica."""
        for n, p in self.model.named_parameters():
            p.data = self.shardings[n].gather(self.params[n], self.shapes[n],
                                              p.device)
        for dev in self.devices:
            if dev == self.mesh.first_device:
                continue
            if dev not in self.replicas:
                self.replicas[dev] = copy.deepcopy(self.model).to(dev)
            rep = dict(self.replicas[dev].named_parameters())
            for n, p in self.model.named_parameters():
                rep[n].data = p.detach().to(dev)

    # ---- one step ------------------------------------------------------

    def _grads(self, batch: Dict[str, torch.Tensor]):
        n = len(self.devices)
        rows = next(iter(batch.values())).shape[0]
        if rows % n:
            raise ValueError(f"a batch of {rows} does not split over {n} "
                             "batch shards")
        per = rows // n
        first = self.mesh.first_device
        losses, grads = [], None
        for s, dev in enumerate(self.devices):
            part = {k: v[s * per:(s + 1) * per].to(dev)
                    for k, v in batch.items()}
            module = self.model if dev == first else self.replicas[dev]
            loss, extras, g = TS.value_and_grad(self.loss_fn, module, part)
            losses.append({"loss": loss, **extras})
            if n == 1:
                grads = g
            elif grads is None:
                grads = {k: t.float() for k, t in g.items()}
            else:
                for k, t in g.items():
                    grads[k] += t.to(first, torch.float32)
            del g
        if n == 1:
            return losses[0], grads
        scale = torch.tensor(float(n), device=first)
        dtypes = {k: p.dtype for k, p in self.model.named_parameters()}
        grads = {k: (t / scale).to(dtypes[k]) for k, t in grads.items()}
        mean = {k: sum((m[k].to(first, torch.float32) for m in losses[1:]),
                       losses[0][k].float()) / scale for k in losses[0]}
        return mean, grads

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One training step on a batch held on the first device; returns
        the metrics of `train.step` (loss, ce and aux: shard means)."""
        self.materialize()
        metrics, grads = self._grads(batch)
        names = list(self.params)
        gnorm = OPT.global_norm({k: grads[k] for k in names})
        self.release()
        with torch.no_grad():
            self._update(grads, names, gnorm)
        return {**metrics, "grad_norm": gnorm}

    def _update(self, grads, names, gnorm) -> None:
        first = self.mesh.first_device
        p_u, g_u, m_u, v_u = {}, {}, {}, {}
        whole: Dict[str, torch.Tensor] = {}
        for n in names:
            sh, g = self.shardings[n], grads.pop(n)
            if self.whole_moments:
                p = sh.gather(self.params[n], self.shapes[n], first)
                whole[n] = p
                p_u[n], g_u[n], m_u[n], v_u[n] = p, g, self.m[n], self.v[n]
                continue
            g_sl = sh.shard(g)
            del g
            for pos, p in _unique(self.params[n]):
                key = f"{n}@{pos}"
                p_u[key], g_u[key] = p, g_sl[pos]
                m_u[key], v_u[key] = self.m[n][pos], self.v[n][pos]
        OPT.update(p_u, g_u, OPT.AdamState(self.step_count, m_u, v_u),
                   self.opt_cfg, gnorm=gnorm)
        self.step_count += 1
        for n, p in whole.items():
            for pos, part in _unique(self.params[n]):
                part.copy_(p[self.shardings[n].block(pos, self.shapes[n])])

    # ---- checkpoints and the end of a run ------------------------------

    def _whole_moments(self, tree, device) -> Dict[str, object]:
        if self.whole_moments:
            host = lambda t: t.detach().to(device)
            return {n: OPT.QTensor(host(x.q), host(x.scale), x.shape, x.npad)
                    if isinstance(x, OPT.QTensor) else host(x)
                    for n, x in tree.items()}
        return {n: self.shardings[n].gather(s, self.shapes[n], device)
                for n, s in tree.items()}

    def state_tree(self) -> Dict[str, object]:
        """The training state in the JAX package's checkpoint layout (as
        `train.loop.state_tree` gives it), gathered into host memory."""
        cpu = torch.device("cpu")
        params = {n: self.shardings[n].gather(s, self.shapes[n], cpu)
                  for n, s in self.params.items()}
        as_pair = lambda t: CV.map_tree(
            t, lambda x: (x.q, x.scale) if isinstance(x, OPT.QTensor) else x)
        same = lambda t: t
        return {"params": CV.stack_named(params, same),
                "opt": OPT.AdamState(
                    torch.tensor(self.step_count, dtype=torch.int32),
                    as_pair(CV.stack_moments(self._whole_moments(self.m, cpu),
                                             same)),
                    as_pair(CV.stack_moments(self._whole_moments(self.v, cpu),
                                             same)))}

    def finish(self) -> OPT.AdamState:
        """Whole parameters back in the model and the whole AdamState on
        the first device, each leaf's slices dropped as it is gathered."""
        self.materialize()
        first = self.mesh.first_device
        m, v = {}, {}
        for out, tree in ((m, self.m), (v, self.v)):
            for n in list(tree):
                out.update(self._whole_moments({n: tree.pop(n)}, first))
        self.params = {}
        self.replicas.clear()
        return OPT.AdamState(self.step_count, m, v)
