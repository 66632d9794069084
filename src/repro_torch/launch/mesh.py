"""Device meshes: the island ring's, the LM's logical-axis meshes and
the dry run's.

A `Mesh` is an array of torch devices with named axes, shaped like the
JAX package's `jax.sharding.Mesh`: `devices` (a numpy object array of
`torch.device`), `axis_names`, `shape` (axis name -> size), `size`.  The
island axis of a GA state shards over some of its axes
(`GASpec.mesh_axes`, default all), one contiguous block of islands a
shard, shards in row-major order of their logical coordinates over those
axes (`shard_devices`).

The mesh is single-controller: one process drives every shard, launching
each shard's kernels on that shard's device and moving the boundary
elites between shards (`repro_torch.core.islands.ring_shift_sharded`).  A
device may stand at several positions: a mesh of logical shards on one
card (or on the CPU) runs every sharded code path there, as the JAX
package's tests run theirs on XLA's fake host devices.

    parse_mesh("auto")            # every device of the kind, 1-D ("islands",)
    parse_mesh("4")               # the first 4, 1-D
    parse_mesh("2x4")             # (data=2, model=4); "2x2x4" adds "pod"
    Mesh([torch.device("cpu")] * 8, ("islands",))   # 8 logical shards

`parse_mesh` and `make_island_mesh` count real devices
(`torch.cuda.device_count()`, or 1 for the CPU) and refuse a mesh larger
than that, as the JAX package refuses one larger than `jax.devices()`.

`make_production_mesh` keeps the JAX package's shapes: (16, 16) as
("data", "model"), and (2, 16, 16) with a leading "pod" axis.  It takes
the devices it is given (logical shards, or `torch.device("meta")`
positions: the dry run's placeholders, the counterpart of JAX's 512 fake
host devices) or every real card, and refuses fewer than it needs.  The
hardware constants below are one NVIDIA H100's datasheet figures, which
the dry run's roofline divides by.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

_MESH_AXIS_NAMES = {1: ("islands",), 2: ("data", "model"),
                    3: ("pod", "data", "model")}


class Mesh:
    """Torch devices laid out on named axes."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        flat = [torch.device(d) for d in arr.flat]
        self.devices = np.empty(arr.shape, dtype=object)
        for i, d in enumerate(flat):
            self.devices.flat[i] = d
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-D device array")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names repeat: {self.axis_names}")
        if self.devices.size == 0:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in flat}
        if not kinds <= {"cpu", "cuda", "meta"} or len(kinds) != 1:
            raise ValueError(f"a mesh holds CUDA devices, the CPU or meta "
                             f"positions, one kind, got {sorted(kinds)}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first_device(self) -> torch.device:
        """Where the engine keeps a sharded run's state between segments."""
        return self.devices.flat[0]

    def device_at(self, **coords: int) -> torch.device:
        """The device at the given axis coordinates, the other axes at 0."""
        index = tuple(int(coords.get(a, 0)) for a in self.axis_names)
        return self.devices[index]

    def shards(self, axes: Sequence[str]) -> int:
        """How many shards the island axis makes over `axes`."""
        return int(np.prod([self.shape[a] for a in axes]))

    def shard_devices(self, axes: Sequence[str]) -> List[torch.device]:
        """The device of each shard over `axes`, in row-major order of the
        logical coordinates along `axes` (in the order given), the other
        axes at coordinate 0 — the order of the JAX package's
        `ring_shift_sharded`."""
        axes = tuple(axes)
        missing = [a for a in axes if a not in self.axis_names]
        if missing:
            raise ValueError(f"mesh_axes {missing} not in the mesh "
                             f"(axes: {self.axis_names})")
        order = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(self.devices.ndim) if i not in order]
        arr = np.transpose(self.devices, order + rest)
        arr = arr[(Ellipsis,) + (0,) * len(rest)] if rest else arr
        return list(arr.flat)

    def __repr__(self) -> str:
        devs = [str(d) for d in self.devices.flat]
        return f"Mesh({self.shape}, devices={devs})"


def device_count(kind: str = "cuda") -> int:
    """Real devices of `kind` on this host: CUDA cards, or 1 for the CPU."""
    kind = torch.device(kind).type
    if kind == "cpu":
        return 1
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _devices(n: Optional[int], kind: str) -> List[torch.device]:
    kind = torch.device(kind).type
    have = device_count(kind)
    n = have if n is None else int(n)
    if n > have or n < 1:
        raise ValueError(f"asked for {n} devices, have {have}")
    if kind == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(n)]


def local_devices(kind: str = "cuda") -> List[torch.device]:
    """Every real device of `kind` on this host (the CPU is one)."""
    return _devices(None, kind) if device_count(kind) else []


def make_island_mesh(n_devices: Optional[int] = None, *,
                     device: str = "cuda") -> Mesh:
    """A 1-D ("islands",) mesh over the first `n_devices` devices of the
    kind of `device` (default all)."""
    return Mesh(_devices(n_devices, device), ("islands",))


def make_host_mesh(*, device: str = "cuda") -> Mesh:
    """Every device of the kind of `device` as a 1 x N (data, model) mesh."""
    devs = _devices(None, device)
    return Mesh(np.asarray(devs, dtype=object).reshape(1, len(devs)),
                ("data", "model"))


def parse_mesh(spec: str, *, device: str = "cuda") -> Mesh:
    """CLI mesh syntax -> Mesh over devices of the kind of `device`.

    "auto"/"host"  every device as a 1-D ("islands",) mesh
    "4"            the first 4 devices, 1-D ("islands",)
    "2x4"          (data=2, model=4);  "2x2x4" adds a leading "pod" axis
    """
    s = spec.strip().lower()
    if s in ("auto", "host"):
        return make_island_mesh(device=device)
    dims = tuple(int(d) for d in s.split("x"))
    if len(dims) == 1:
        return make_island_mesh(dims[0], device=device)
    if len(dims) not in _MESH_AXIS_NAMES:
        raise ValueError(f"mesh spec {spec!r}: want N, NxM or NxMxK")
    devs = _devices(int(np.prod(dims)), device)
    return Mesh(np.asarray(devs, dtype=object).reshape(dims),
                _MESH_AXIS_NAMES[len(dims)])


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """The JAX package's production shapes: (data=16, model=16), or with
    `multi_pod` (pod=2, data=16, model=16), over the first 256 or 512 of
    `devices` (default every card).  Fewer devices raise `ValueError`, as
    `jax.make_mesh` refuses."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = int(np.prod(shape))
    devices = list(local_devices() if devices is None else devices)
    if len(devices) < need:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {need} "
                         f"devices, have {len(devices)}")
    return Mesh(np.asarray(devices[:need], dtype=object).reshape(shape),
                axes)


def logical_mesh(device, shape: Sequence[int]) -> Mesh:
    """`prod(shape)` logical shards of one `device`, with `parse_mesh`'s
    axis names: (n,) is ("islands",), (d, m) ("data", "model"), and a
    3-D shape adds "pod"."""
    shape = tuple(int(n) for n in shape)
    devs = np.empty(int(np.prod(shape)), dtype=object)
    devs[:] = [torch.device(device)] * devs.size
    return Mesh(devs.reshape(shape), _MESH_AXIS_NAMES[len(shape)])


# One NVIDIA H100 80GB HBM3 (SXM5, 700.00 W), NVIDIA's datasheet: the
# roofline of `repro_torch.roofline.analyze_cell` divides by these.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12                # B/s
NVLINK_BW = 450e9               # B/s, NVLink 4, one direction


MESH_HELP = ("shard the island axis over devices: 'auto' (all), '4', "
             "'2x4', ... (repro_torch.launch.mesh.parse_mesh; devices of "
             "--device's kind)")


def mesh_from_args(args, ap) -> Optional[Mesh]:
    """The mesh a CLI's `--mesh` names, over devices of the kind of its
    `--device` (the card by default), printed as the JAX launchers print
    it; None without `--mesh`.  A mesh the host cannot give is refused
    through the parser's `ap.error` (exit 2)."""
    if not args.mesh:
        return None
    try:
        mesh = parse_mesh(args.mesh, device=args.device or "cuda")
    except ValueError as e:
        ap.error(f"--mesh {args.mesh}: {e}")
    print(f"mesh: {mesh.shape} ({mesh.devices.size} device(s))")
    return mesh
