"""Checkpointing in the JAX package's on-disk format.

Layout (one directory per step):
    ckpt_dir/step_00000100/
        manifest.json        # step, flattened keys with shapes and logical
                             # dtypes, extra, per-shard CRC32 and bytes
        shard_0.npz          # the arrays, one entry per flattened key

The format is the one `repro.ckpt.checkpoint` writes and reads, so a
checkpoint of either package resumes in the other:

  * the flattened keys are the JAX package's: a NamedTuple field is
    ``.name`` (a `GAState` gives ``.x``, ``.sel_lfsr``, ``.cross_lfsr``,
    ``.mut_lfsr``, ``.k``), a dict entry its key, a sequence entry its
    index, joined by ``/`` (``__`` inside the npz);
  * bfloat16 leaves are stored as their raw uint16 words with logical
    dtype ``bfloat16``, as the JAX package stores ml_dtypes, and restore
    into torch tensors; int8 leaves (8-bit AdamW moments) as they are;
  * the port carries uint32 words as int32 bit patterns (hazard H2); a
    `GAState`'s four word arrays are written as ``np.uint32`` through
    `repro_torch.convert`, with logical dtype ``uint32`` in the manifest,
    and read back the same way; ``k`` stays ``int32``;
  * integrity: the manifest is written last and renamed into place, so a
    crash mid-write leaves no valid-looking step; each shard's CRC32 rides
    in the manifest, `validate_step` recomputes it, `latest_step` falls
    back past a corrupt newest step with a warning, and `restore` raises
    the typed `CheckpointCorrupt`.

Torch tensors are mutable where JAX arrays are not (hazard H6): `save` and
`AsyncCheckpointer.save` copy every leaf to host memory (after the
device's work on it is done) before they return, so a kernel or an
in-place op of the next chunk cannot change what is written.

`restore(ckpt_dir, step, tree_like)` places each leaf on the device of
`tree_like`'s leaf; `shardings=` places it elsewhere — on a given device,
or over a mesh (the elastic-restart path of the JAX package: the saved
run's mesh need not match the restoring one's, since a step always holds
whole arrays).

Fault injection: `save` consults `repro_torch.faults` (the ambient
``REPRO_GA_FAULTS`` injector, or one passed via ``faults=``) at the
``ckpt_corrupt`` site — when armed, it flips bytes in the just-written
shard AFTER its checksum was recorded, simulating bit-rot the validation
path must catch.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import warnings
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch import faults as FLT
from repro_torch.core.ga import GAState

_SEP = "/"
_WORD_FIELDS = ("x", "sel_lfsr", "cross_lfsr", "mut_lfsr")
_PLAIN_DTYPES = ("float64", "float32", "float16", "int64", "int32", "int16",
                 "int8", "uint64", "uint32", "uint16", "uint8", "bool")


class CheckpointCorrupt(RuntimeError):
    """A checkpoint step failed shard-checksum validation."""


def _flatten(tree, prefix: str = "", word: bool = False,
             is_leaf=lambda t: False) -> List[Tuple[str, Any, bool]]:
    """(key, leaf, is_word) in the JAX package's flattening order and key
    spelling; `is_word` marks a GAState's uint32 word arrays; `is_leaf`
    stops the walk at containers that are leaves (a placement tuple)."""
    join = (lambda k: f"{prefix}{_SEP}{k}") if prefix else (lambda k: k)
    if is_leaf(tree):
        return [(prefix, tree, word)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for name in tree._fields:
            out += _flatten(getattr(tree, name), join(f".{name}"),
                            isinstance(tree, GAState)
                            and name in _WORD_FIELDS, is_leaf)
        return out
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], join(str(k)), is_leaf=is_leaf)
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, join(str(i)), is_leaf=is_leaf)
        return out
    return [(prefix, tree, word)]


def _unflatten(tree_like, leaves: Dict[str, Any], prefix: str = ""):
    join = (lambda k: f"{prefix}{_SEP}{k}") if prefix else (lambda k: k)
    if isinstance(tree_like, tuple) and hasattr(tree_like, "_fields"):
        return type(tree_like)(*(
            _unflatten(getattr(tree_like, n), leaves, join(f".{n}"))
            for n in tree_like._fields))
    if isinstance(tree_like, dict):
        return {k: _unflatten(v, leaves, join(str(k)))
                for k, v in tree_like.items()}
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(_unflatten(v, leaves, join(str(i)))
                               for i, v in enumerate(tree_like))
    return leaves[prefix]


def _host(leaf, word: bool) -> Tuple[np.ndarray, str]:
    """A host copy of one leaf and its logical dtype: words as np.uint32,
    a bfloat16 tensor as its raw uint16 words (logical "bfloat16", as the
    JAX package stores ml_dtypes); never a view of a tensor that later
    work could change."""
    if isinstance(leaf, torch.Tensor):
        if word:
            if leaf.dtype != torch.int32:
                raise TypeError(f"GAState word arrays are int32 bit "
                                f"patterns, got {leaf.dtype}")
            return convert.words_to_numpy(leaf).copy(), "uint32"
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy(), \
                "bfloat16"
        arr = t.numpy().copy()
        return arr, str(arr.dtype)
    arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def host_snapshot(tree) -> List[Tuple[str, np.ndarray, str]]:
    """Every leaf of `tree` copied to host memory: (flattened key, stored
    array, logical dtype).  Waits for the device's pending work on the
    leaves first."""
    flat = _flatten(tree)
    for dev in {leaf.device for _k, leaf, _w in flat
                if isinstance(leaf, torch.Tensor)
                and leaf.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return [(k, *_host(leaf, w)) for k, leaf, w in flat]


def _crc32_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(block, crc)
    return crc


def _write(ckpt_dir: str, step: int, snapshot, extra, host_id: int,
           faults, fault_tag: str) -> str:
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays, meta = {}, {}
    for k, arr, logical_dtype in snapshot:
        if str(arr.dtype) not in _PLAIN_DTYPES:
            raise TypeError(f"checkpoint leaf {k!r} has dtype "
                            f"{logical_dtype}, which the format cannot hold")
        arrays[k.replace(_SEP, "__")] = arr
        meta[k] = {"shape": list(arr.shape), "dtype": logical_dtype}
    shard_name = f"shard_{host_id}.npz"
    shard_path = os.path.join(tmp, shard_name)
    np.savez(shard_path, **arrays)
    shards = {shard_name: {"crc32": _crc32_file(shard_path),
                           "bytes": os.path.getsize(shard_path)}}
    injector = FLT.resolve_faults(faults)
    if injector is not None:
        rule = injector.fires("ckpt_corrupt",
                              tag=f"{fault_tag}|{ckpt_dir}|step={step}")
        if rule is not None:   # bit-rot AFTER the checksum: readers must catch
            FLT.corrupt_file(shard_path, seed=rule.seed)
    manifest = {"step": step, "keys": meta, "extra": extra or {},
                "n_hosts": 1, "time": time.time(), "shards": shards}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


def save(ckpt_dir: str, step: int, tree, extra: Optional[Dict] = None,
         host_id: int = 0, *, faults=None, fault_tag: str = "") -> str:
    """Synchronous save. Returns the checkpoint path.

    Each shard's CRC32 + byte count land in the manifest so readers can
    validate before trusting the step.  `faults`/`fault_tag` hook the
    ``ckpt_corrupt`` injection site (see `repro_torch.faults`): when a rule
    fires, the shard is corrupted AFTER its checksum was recorded."""
    return _write(ckpt_dir, step, host_snapshot(tree), extra, host_id,
                  faults, fault_tag)


class AsyncCheckpointer:
    """Overlap checkpoint serialization with compute.  `save` returns once
    the host snapshot is taken; the file writing runs on a thread, and
    `wait` joins it and raises what it raised."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_path: Optional[str] = None

    def save(self, ckpt_dir: str, step: int, tree, extra=None):
        self.wait()
        snapshot = host_snapshot(tree)   # before the next chunk mutates it

        def work():
            try:
                self.last_path = _write(ckpt_dir, step, snapshot, extra, 0,
                                        None, "")
            except Exception as e:   # handed to wait(), which re-raises
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def validate_step(ckpt_dir: str, step: int) -> Optional[str]:
    """None when the step's shards match their manifest checksums, else a
    human-readable reason.  Manifests written before checksums existed
    (no "shards" key) validate trivially — they can't be checked."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return f"unreadable manifest: {e}"
    for shard_name, meta in (manifest.get("shards") or {}).items():
        shard_path = os.path.join(path, shard_name)
        if not os.path.exists(shard_path):
            return f"missing shard {shard_name}"
        if os.path.getsize(shard_path) != int(meta["bytes"]):
            return (f"shard {shard_name} is {os.path.getsize(shard_path)} "
                    f"bytes, manifest says {meta['bytes']}")
        crc = _crc32_file(shard_path)
        if crc != int(meta["crc32"]):
            return (f"shard {shard_name} checksum {crc:#010x} != manifest "
                    f"{int(meta['crc32']):#010x}")
    return None


def latest_step(ckpt_dir: str, validate: bool = True) -> Optional[int]:
    """Newest step whose manifest exists — and, with `validate` (the
    default), whose shards pass checksum validation: a corrupt newest step
    falls back to the previous valid one with a warning."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp") and \
                os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append(int(d.split("_")[1]))
    for step in sorted(steps, reverse=True):
        if not validate:
            return step
        reason = validate_step(ckpt_dir, step)
        if reason is None:
            return step
        warnings.warn(
            f"checkpoint step {step} in {ckpt_dir} failed validation "
            f"({reason}); falling back to the previous step", stacklevel=2)
    return None


def _is_placement(p) -> bool:
    """A `(Mesh, axis[, mesh_axes])` placement (a leaf of `shardings`)."""
    return (isinstance(p, tuple) and not hasattr(p, "_fields")
            and len(p) in (2, 3) and hasattr(p[0], "shard_devices"))


def _placed_device(arr: np.ndarray, place, key: str, like_device):
    """The device a leaf of shape `arr.shape` lands on under `place`: None
    keeps `like_device`; a device is taken as it is; `(mesh, axis[,
    mesh_axes])` needs `axis` to split evenly over the mesh's shards over
    `mesh_axes` (default all axes) and lands on the mesh's first device,
    where a sharded run keeps its state between segments (the run splits
    it onto the shards itself)."""
    if place is None:
        return like_device
    if not _is_placement(place):
        return torch.device(place)
    mesh, axis = place[0], int(place[1])
    axes = tuple(place[2]) if len(place) > 2 and place[2] else \
        tuple(mesh.axis_names)
    shards = mesh.shards(axes)
    if arr.ndim <= axis or arr.shape[axis] % shards:
        raise ValueError(
            f"checkpoint key {key!r} of shape {arr.shape} cannot shard its "
            f"axis {axis} evenly over the {shards} shard(s) of mesh axes "
            f"{axes}")
    return mesh.first_device


def _leaf_like(arr: np.ndarray, like, word: bool, device=None,
               logical: Optional[str] = None):
    """The stored array as a leaf of `like`'s kind and dtype, on `device`
    (default `like`'s); `logical` "bfloat16" reads raw uint16 words."""
    if isinstance(like, torch.Tensor):
        device = like.device if device is None else torch.device(device)
        if word:
            t = convert.words_from_numpy(arr, device=device)
        elif logical == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
                .view(torch.bfloat16).to(device=device, dtype=like.dtype)
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=device, dtype=like.dtype)
        if t.device != device:
            raise RuntimeError(f"restored leaf landed on {t.device}, "
                               f"not {device}")
        return t
    want = getattr(like, "dtype", arr.dtype)
    return arr if arr.dtype == want else arr.astype(want)


def restore(ckpt_dir: str, step: int, tree_like, shardings=None,
            validate: bool = True) -> Tuple[Any, Dict]:
    """Restore into the structure of `tree_like`, each leaf in the dtype of
    `tree_like`'s leaf and on its device — or where `shardings` (a tree
    matching `tree_like`) places it: a leaf `None` keeps `tree_like`'s
    device, a `torch.device` moves there, a `(Mesh, axis[, mesh_axes])`
    places the leaf's `axis` over that mesh (see `_placed_device`).  This
    is the elastic-restart path: the saving run's mesh need not match.
    With `validate` (default), shard checksums are re-checked first and a
    mismatch raises `CheckpointCorrupt` instead of an opaque npz error."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if validate:
        reason = validate_step(ckpt_dir, step)
        if reason is not None:
            raise CheckpointCorrupt(
                f"checkpoint step {step} in {ckpt_dir} is corrupt: {reason}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    keymeta = manifest["keys"]
    place = ({k: p for k, p, _ in _flatten(shardings,
                                           is_leaf=_is_placement)}
             if shardings is not None else {})
    out = {}
    with np.load(os.path.join(path, "shard_0.npz")) as data:
        for k, like, word in _flatten(tree_like):
            arr = data[k.replace(_SEP, "__")]
            logical = keymeta.get(k, {}).get("dtype", str(arr.dtype))
            raw_bf16 = logical == "bfloat16" and arr.dtype == np.uint16
            if logical != str(arr.dtype) and not raw_bf16:
                arr = arr.astype(logical)
            if raw_bf16 and not isinstance(like, torch.Tensor):
                raise TypeError(f"checkpoint key {k!r} holds bfloat16, "
                                "which restores into a torch tensor only")
            if word and arr.dtype != np.uint32:
                raise TypeError(f"checkpoint key {k!r} holds {arr.dtype}, "
                                "not the uint32 words of a GAState")
            device = _placed_device(arr, place.get(k), k,
                                    getattr(like, "device", None))
            out[k] = _leaf_like(arr, like, word, device,
                                "bfloat16" if raw_bf16 else None)
    return _unflatten(tree_like, out), manifest.get("extra", {})
