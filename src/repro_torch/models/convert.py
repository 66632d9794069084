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
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as C
from repro_torch.models import lm as LM


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
