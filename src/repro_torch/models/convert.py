"""JAX parameter and cache trees in and out of the port's LM.

The JAX package stacks every layer of a stack along a leading axis
(`stack_tree`: `layers`, `dense_layers`, `enc_layers`, `dec_layers`, gemma's
`groups/locals` and `groups/global`, `tail`); the port keeps one module a
layer.  A port parameter `groups.1.locals.0.mlp.w_up` is therefore the JAX
leaf `groups/locals/mlp/w_up` at index [1, 0].

    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    cache = cache_from_numpy(cfg, jax_cache_as_numpy, device="cpu")
    tree = cache_to_numpy(cache)       # the JAX layout, stacked again
    tree = lm_params_to_numpy(model)   # the JAX parameter tree, stacked
    opt = opt_state_to_numpy(state)    # AdamW's state in the JAX layout
    state = opt_state_from_numpy(opt, model)

`stack_named` / `unstack_named` carry any tree of per-parameter tensors
(parameters, gradients, moments) between the two layouts; a training
checkpoint holds the stacked layout (`repro_torch.train.loop`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as C
from repro_torch.models import lm as LM
from repro_torch.optim import adamw as OPT


def _tensor(a, device) -> torch.Tensor:
    """A numpy array (ml_dtypes' bfloat16 included) as a torch tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                             .astype(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


def _flatten(tree: Dict[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def lm_params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any], *,
                         device) -> LM.LM:
    """The JAX parameter tree (leaves as numpy arrays) -> the port's LM on
    `device`, each leaf cast to its port parameter's dtype (the config's;
    float32 where both packages keep float32).  Every port parameter must
    find a leaf slice of its shape, and every leaf a port parameter."""
    max_seq = tree["dec_pos"].shape[0] if "dec_pos" in tree else 4096
    model = LM.LM(cfg, C.Init(cfg.torch_dtype, torch.device(device)),
                  max_seq)
    leaves = {path: np.asarray(a) for path, a in _flatten(tree)}
    used = {path: 0 for path in leaves}
    for name, p in model.named_parameters():
        parts = name.split(".")
        path = tuple(x for x in parts if not x.isdigit())
        idx = tuple(int(x) for x in parts if x.isdigit())
        if path not in leaves:
            raise KeyError(f"port parameter {name}: no JAX leaf "
                           f"{'/'.join(path)}")
        a = leaves[path][idx]
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX slice {a.shape} against the "
                             f"port's {tuple(p.shape)}")
        p.data = _tensor(a, device).to(p.dtype)
        used[path] += 1
    for path, a in leaves.items():
        if used[path] == 0:
            raise KeyError(f"JAX leaf {'/'.join(path)} has no port parameter")
    n_jax = sum(a.size for a in leaves.values())
    if n_jax != LM.param_count(model):
        raise ValueError(f"the JAX tree holds {n_jax} parameters, the port "
                         f"{LM.param_count(model)}")
    return model


def _unstack(jax_node, port_defs, device):
    if isinstance(port_defs, list):
        return [_unstack(_index(jax_node, i), d, device)
                for i, d in enumerate(port_defs)]
    if isinstance(port_defs, dict):
        return {k: _unstack(jax_node[k], d, device)
                for k, d in port_defs.items()}
    if isinstance(port_defs, C.ParamDef):
        t = _tensor(jax_node, device)
        if tuple(t.shape) != tuple(port_defs.shape):
            raise ValueError(f"cache leaf {tuple(t.shape)} against the "
                             f"port's {port_defs.shape}")
        return t
    return int(np.asarray(jax_node))        # "pos"


def _index(node, i):
    if isinstance(node, dict):
        return {k: _index(v, i) for k, v in node.items()}
    return np.asarray(node)[i]


def cache_from_numpy(cfg: ModelConfig, tree: Dict[str, Any], *, device
                     ) -> Dict[str, Any]:
    """A JAX decode cache (leaves as numpy arrays) -> the port's cache, its
    stacked leaves unstacked into the port's per-layer lists."""
    defs = LM.cache_defs(cfg, *_batch_and_len(cfg, tree))
    return _unstack(tree, defs, torch.device(device))


def _batch_and_len(cfg: ModelConfig, tree):
    """(batch, max_len) of a JAX cache tree, read off its leaves."""
    if cfg.family == "ssm":
        return np.asarray(tree["layers"]["state"]).shape[1], 1
    if cfg.family == "hybrid":
        leaf = tree["shared_kv"]["k"]
    elif "groups" in tree:
        leaf = tree["groups"]["global"]["k"]
    else:
        layer = tree["layers"]
        leaf = layer["c_kv"] if "c_kv" in layer else layer["k"]
    shape = np.asarray(leaf).shape
    return shape[1], shape[2]


def _stack(items):
    if isinstance(items[0], dict):
        return {k: _stack([it[k] for it in items]) for k in items[0]}
    return np.stack(items)


def cache_to_numpy(cache: Any) -> Any:
    """The port's cache -> the JAX layout: per-layer lists stacked along a
    leading axis, tensors as numpy arrays (bfloat16 widened to float32),
    "pos" as int32."""
    if isinstance(cache, list):
        return _stack([cache_to_numpy(c) for c in cache])
    if isinstance(cache, dict):
        return {k: cache_to_numpy(v) for k, v in cache.items()}
    if isinstance(cache, torch.Tensor):
        return _to_numpy(cache)
    return np.int32(cache)


# ---------------------------------------------------------------------------
# Parameter-shaped trees: the port's names <-> the JAX stacked layout
# ---------------------------------------------------------------------------


def _split_name(name: str) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """`groups.1.locals.0.mlp.w_up` -> (("groups", "locals", "mlp",
    "w_up"), (1, 0)): the JAX leaf's path and the index into its stack."""
    parts = name.split(".")
    return (tuple(x for x in parts if not x.isdigit()),
            tuple(int(x) for x in parts if x.isdigit()))


def _put_path(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _get_path(tree, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def stack_named(named: Mapping[str, torch.Tensor],
                to: Callable = lambda t: t) -> Dict[str, Any]:
    """Per-parameter tensors by port name -> the JAX tree, each stack's
    layers stacked along leading axes (torch tensors, through `to` first:
    `to=lambda t: t.cpu()` stacks on the host)."""
    groups: Dict[Tuple[str, ...], Dict[Tuple[int, ...], torch.Tensor]] = {}
    for name, t in named.items():
        path, idx = _split_name(name)
        groups.setdefault(path, {})[idx] = to(t)
    tree: Dict[str, Any] = {}
    for path, items in groups.items():
        if list(items) == [()]:
            _put_path(tree, path, items[()])
            continue
        grid = tuple(max(i[d] for i in items) + 1
                     for d in range(len(next(iter(items)))))
        if len(items) != int(np.prod(grid)):
            raise ValueError(f"{'/'.join(path)}: layers {sorted(items)} do "
                             f"not fill a {grid} stack")
        flat = [items[i] for i in np.ndindex(*grid)]
        _put_path(tree, path, torch.stack(flat).reshape(
            grid + tuple(flat[0].shape)))
    return tree


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else _tensor(a, "cpu")


def unstack_named(tree: Dict[str, Any], names) -> Dict[str, torch.Tensor]:
    """The inverse of `stack_named`: the slice of the JAX tree's leaf for
    each port name in `names` (numpy or tensor leaves), contiguous."""
    out = {}
    for name in names:
        path, idx = _split_name(name)
        out[name] = _as_tensor(_get_path(tree, path))[idx].contiguous()
    return out


def lm_params_to_numpy(model: LM.LM) -> Dict[str, Any]:
    """The port's LM -> the JAX parameter tree (the inverse of
    `lm_params_from_numpy`): stacked layers, numpy leaves, bfloat16
    widened to float32 (exact, and narrowed back exactly on the way in)."""
    stacked = stack_named(dict(model.named_parameters()),
                          to=lambda t: t.detach().cpu())
    return map_tree(stacked, _to_numpy)


def map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def stack_moments(moments: Mapping[str, Any], to: Callable) -> Dict[str, Any]:
    """AdamW moments by port name -> the JAX layout: float32 leaves
    stacked; a QTensor's `q` and `scale` stacked apart into one
    `OPT.QTensor` whose `shape` is the stacked shape."""
    plain = {n: to(m) for n, m in moments.items()
             if not isinstance(m, OPT.QTensor)}
    tree = stack_named(plain)
    qs = {n: m for n, m in moments.items() if isinstance(m, OPT.QTensor)}
    q_tree = stack_named({n: to(m.q) for n, m in qs.items()})
    s_tree = stack_named({n: to(m.scale) for n, m in qs.items()})
    for n in qs:
        path, _ = _split_name(n)
        q, scale = _get_path(q_tree, path), _get_path(s_tree, path)
        _put_path(tree, path, OPT.QTensor(q, scale, tuple(q.shape), 0))
    return tree


def opt_state_to_numpy(state: OPT.AdamState) -> OPT.AdamState:
    """The port's AdamW state -> the JAX layout with numpy leaves: `step`
    an int32, `m` and `v` trees of the parameter tree's shape whose leaves
    are float32 arrays or `OPT.QTensor`s of numpy `q` and `scale`."""
    to = lambda t: t.detach().cpu()
    conv = lambda tree: map_tree(
        tree, lambda x: OPT.QTensor(x.q.numpy(), x.scale.numpy(), x.shape,
                                    x.npad)
        if isinstance(x, OPT.QTensor) else x.numpy())
    return OPT.AdamState(np.int32(state.step),
                         conv(stack_moments(state.m, to)),
                         conv(stack_moments(state.v, to)))


def opt_state_from_numpy(state: OPT.AdamState, model: LM.LM
                         ) -> OPT.AdamState:
    """The JAX layout (numpy or tensor leaves; a quantized leaf anything
    with `q` and `scale`, the JAX package's QTensor included) -> the
    port's AdamW state for `model`'s parameters, on each parameter's
    device."""
    named = dict(model.named_parameters())

    def one(tree):
        out = {}
        for n, p in named.items():
            path, idx = _split_name(n)
            leaf = _get_path(tree, path)
            dev = p.device
            if hasattr(leaf, "q"):
                q = _as_tensor(leaf.q)[idx].to(device=dev, dtype=torch.int8)
                s = _as_tensor(leaf.scale)[idx].to(device=dev,
                                                   dtype=torch.float32)
                out[n] = OPT.QTensor(q.contiguous(), s.contiguous(),
                                     tuple(q.shape), 0)
            else:
                out[n] = _as_tensor(leaf)[idx].to(
                    device=dev, dtype=torch.float32).contiguous()
        return out

    return OPT.AdamState(int(np.asarray(state.step)), one(state.m),
                         one(state.v))
