"""Logical-axis sharding on the port's single-controller mesh; the JAX
package's `repro.sharding`.

One rule table maps every tensor's logical axes onto the mesh axes
(`repro_torch.launch.mesh`):

    single-pod shape: (16, 16)    axes ("data", "model")
    multi-pod shape : (2, 16, 16) axes ("pod", "data", "model")

    batch    -> (pod,) data      (DP; batch dim of activations)
    embed    -> data if fsdp else None   (FSDP / ZeRO-3 on the d_model dim)
    vocab, heads, kv_heads, mlp, expert -> model
    seq/layers/state/... -> None

What a rule means on one controller.  Under GSPMD a rule tells the
compiler where a tensor lives, and the compiler inserts the collectives.
The port has no such compiler: one process drives every shard of a
`Mesh`.  Here a rule says which slice of a tensor each shard holds, and
never changes a value:

  * `NamedSharding(mesh, spec).shard(t)` cuts the slices and puts each on
    its shard's device; `gather` joins them again;
  * `constrain(x, ...)` returns `x` unchanged: a GSPMD constraint only
    places data, and on one controller there is no compiler to take the
    hint.  The port's model code calls it nowhere;
  * `train(mesh=)` holds parameters and 32-bit moments as slices between
    steps and updates them slice by slice; `launch.dryrun` sizes each
    shard's bytes by `shard_shape`.

`torch.distributed` and DTensor stay out: NCCL refuses two ranks on one
card, and a logical mesh of one card (or of the CPU) is how the sharded
paths run there.  The JAX module's `shard_map` has no counterpart: its
bodies are the per-shard loops of the modules that need one
(`models.moe_a2a`, `train.dp_compressed`, the island ring).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class PartitionSpec(tuple):
    """One entry a tensor dimension: None (whole), a mesh axis name, or a
    tuple of names (the dimension split over their product, the first
    name outermost).  A one-name tuple is kept as the name, as JAX's
    `PartitionSpec` keeps it."""

    def __new__(cls, *parts):
        def norm(p):
            if isinstance(p, (tuple, list)):
                return p[0] if len(p) == 1 else tuple(p)
            return p
        return super().__new__(cls, tuple(norm(p) for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class NamedSharding:
    """`spec` over `mesh`: which slice of a tensor each mesh position
    holds.  Positions are taken in row-major order of the mesh's
    coordinates (`mesh.devices.flat`)."""

    def __init__(self, mesh, spec: Sequence):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)
        used: List[str] = []
        for entry in self.spec:
            for a in entry_axes(entry):
                if a not in mesh.axis_names:
                    raise ValueError(f"spec {self.spec}: no mesh axis {a!r} "
                                     f"(axes: {mesh.axis_names})")
                if a in used:
                    raise ValueError(f"spec {self.spec} names axis {a!r} "
                                     "twice")
                used.append(a)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.shape}, {self.spec})"

    def _entries(self, ndim: int):
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} for a {ndim}-D tensor")
        return tuple(self.spec) + (None,) * (ndim - len(self.spec))

    def _splits(self, ndim: int) -> List[int]:
        shape = self.mesh.shape
        return [int(np.prod([shape[a] for a in entry_axes(e)]))
                for e in self._entries(ndim)]

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one shard's slice; a dimension its axes do not
        divide raises `ValueError`."""
        out = []
        for dim, n in zip(shape, self._splits(len(shape))):
            if dim % n:
                raise ValueError(f"dimension {dim} of {tuple(shape)} does "
                                 f"not split over {n} shards ({self.spec})")
            out.append(dim // n)
        return tuple(out)

    def block(self, position: int, shape: Sequence[int]) -> Tuple[slice, ...]:
        """The index of the slice mesh position `position` (row-major)
        holds of a tensor of `shape`."""
        coords = dict(zip(self.mesh.axis_names,
                          np.unravel_index(position, self.mesh.devices.shape)))
        sizes = self.shard_shape(shape)
        index = []
        for e, size in zip(self._entries(len(shape)), sizes):
            k = 0
            for a in entry_axes(e):
                k = k * self.mesh.shape[a] + int(coords[a])
            index.append(slice(k * size, (k + 1) * size))
        return tuple(index)

    def shard(self, t: torch.Tensor) -> List[torch.Tensor]:
        """The slice each mesh position holds, each a new contiguous tensor
        on its position's device.  Positions that hold the same slice on
        the same device share one tensor (a replicated axis of a logical
        mesh costs no copy)."""
        made: Dict[Tuple, torch.Tensor] = {}
        out = []
        for pos, dev in enumerate(self.mesh.devices.flat):
            index = self.block(pos, t.shape)
            key = (str(dev), tuple((s.start, s.stop) for s in index))
            if key not in made:
                part = t[index]
                made[key] = torch.empty(part.shape, dtype=part.dtype,
                                        device=dev).copy_(part)
            out.append(made[key])
        return out

    def gather(self, slices: Sequence[torch.Tensor], shape: Sequence[int],
               device=None) -> torch.Tensor:
        """The whole tensor of `shape` from one slice a mesh position (as
        `shard` gives them), on `device` (default the mesh's first)."""
        device = torch.device(device or self.mesh.first_device)
        first = slices[0]
        out = torch.empty(tuple(shape), dtype=first.dtype, device=device)
        seen = set()
        for pos, part in enumerate(slices):
            index = self.block(pos, shape)
            key = tuple((s.start, s.stop) for s in index)
            if key not in seen:
                seen.add(key)
                out[index].copy_(part)
        return out


def make_rules(mesh, fsdp: bool = True) -> dict:
    if mesh is None:
        return {}
    axes = set(mesh.axis_names)
    batch = tuple(a for a in ("pod", "data") if a in axes)
    rules = {
        "batch": batch if batch else None,
        "vocab": "model" if "model" in axes else None,
        "heads": "model" if "model" in axes else None,
        "kv_heads": "model" if "model" in axes else None,
        "mlp": "model" if "model" in axes else None,
        "expert": "model" if "model" in axes else None,
        # expert banks over data x model jointly
        "expert_full": (("data", "model") if ("data" in axes and
                                              "model" in axes)
                        else ("model" if "model" in axes else None)),
        "embed": ("data" if (fsdp and "data" in axes) else None),
        # the activation feature dim: parameters only are FSDP-sharded
        "act_embed": None,
        # sequence parallelism of the residual stream's token dim
        "act_seq": "model" if "model" in axes else None,
        # 8-bit optimizer-state blocks, over every axis
        "qblocks": batch + ("model",) if "model" in axes else batch or None,
    }
    return rules


class _Ctx(threading.local):
    mesh = None
    rules: dict = {}


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh, fsdp: bool = True, rules: Optional[dict] = None):
    """Activate a mesh and its logical rules in this thread."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    _CTX.rules = rules if rules is not None else make_rules(mesh, fsdp)
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh():
    return _CTX.mesh


def current_rules() -> dict:
    return _CTX.rules


def _axis_size(mesh, r) -> int:
    if r is None:
        return 1
    if isinstance(r, (tuple, list)):
        n = 1
        for a in r:
            n *= mesh.shape[a]
        return n
    return mesh.shape[r]


def logical_spec(logical_axes: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None) -> PartitionSpec:
    """Logical axis names -> a PartitionSpec under the current rules.

    With `shape`, a mapping whose mesh-axis size does not divide the
    dimension is dropped (that dimension stays whole), e.g. 8 KV heads on
    a 16-way model axis.  A mesh axis appears once a spec: the first
    logical axis that maps to it wins.
    """
    rules = _CTX.rules
    mesh = _CTX.mesh
    parts = []
    used = set()
    for i, ax in enumerate(logical_axes):
        r = rules.get(ax) if ax else None
        if r is not None and shape is not None and mesh is not None:
            if shape[i] % _axis_size(mesh, r) != 0:
                r = None
        if r is not None:
            names = r if isinstance(r, (tuple, list)) else (r,)
            if any(n in used for n in names):
                r = None
            else:
                used.update(names)
        parts.append(r)
    return PartitionSpec(*parts)


def named_sharding(logical_axes: Sequence[Optional[str]],
                   shape: Optional[Sequence[int]] = None
                   ) -> Optional[NamedSharding]:
    if _CTX.mesh is None:
        return None
    return NamedSharding(_CTX.mesh, logical_spec(logical_axes, shape))


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """`x` unchanged: a GSPMD constraint only places data (see above)."""
    return x


def _is_axes(t) -> bool:
    return (isinstance(t, tuple) and not hasattr(t, "_fields")
            and all(a is None or isinstance(a, str) for a in t))


def map_axes(fn, tree):
    """`fn` over every logical-axes tuple of `tree`: dicts, lists,
    NamedTuples, and objects whose class names its `tree_fields` (an
    8-bit moment's `q` and `scale`)."""
    if _is_axes(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_axes(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_axes(fn, v) for v in tree]
    if hasattr(tree, "_fields"):
        return type(tree)(*(map_axes(fn, v) for v in tree))
    fields = getattr(type(tree), "tree_fields", None)
    if fields:
        return dataclasses.replace(
            tree, **{f: map_axes(fn, getattr(tree, f)) for f in fields})
    raise TypeError(f"not a tree of logical axes: {type(tree).__name__}")


def spec_tree(axes_tree):
    """A tree of logical-axes tuples -> PartitionSpecs."""
    return map_axes(lambda axes: logical_spec(axes), axes_tree)


def sharding_tree(axes_tree):
    """A tree of logical-axes tuples -> NamedShardings (None without a
    mesh)."""
    mesh = _CTX.mesh
    if mesh is None:
        return map_axes(lambda _: None, axes_tree)
    return map_axes(lambda axes: NamedSharding(mesh, logical_spec(axes)),
                    axes_tree)


def pad_to_multiple(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult
