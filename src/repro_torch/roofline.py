"""The dry run's roofline and the GA planner's measured roofline rows; the
JAX package's `repro.roofline`.

The JAX module parses a lowered cell's optimized HLO.  The port has no
HLO: it runs the cell's own program on meta tensors (nothing is
allocated, no kernel runs) and counts what that program does
(`count_ops`):

  * FLOPs under `torch.utils.flop_counter.FlopCounterMode`: matrix
    products, convolutions and attention, forward and backward, and the
    forward again where remat recomputes it; elementwise work is not
    counted, as the JAX module counts only `dot`s;
  * HBM bytes as every aten op's operand and result bytes (views move
    none).  This is the unfused count, an upper bound: PyTorch's eager
    program runs op by op, and a fused kernel would keep its
    intermediates on chip;
  * the peak of the live bytes of tensors the run made (views aside), a
    lower bound on the working memory;
  * collective bytes are not counted from the run: they are the bytes the
    port's own mesh design moves a step, computed from the layout by the
    dry run (`launch.dryrun`): the parameter gather, the gradient
    average, the gradient scatter.  They are not GSPMD's collectives.

Terms (a device, seconds), against one NVIDIA H100's datasheet
(`launch.mesh`):
  compute    = flops / PEAK_FLOPS_BF16
  memory     = hbm_bytes / HBM_BW
  collective = coll_bytes / NVLINK_BW

`ga_measured_points` needs no counting: the measured points of an
autotune `CostTable`.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

# ops that alias their input without the `is_view` flag
_ALIASES = {"_unsafe_view", "_reshape_alias", "lift_fresh", "alias"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _ByteCounter(TorchDispatchMode):
    """Operand and result bytes of every aten op, and the peak live bytes
    of the tensors the ops made."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if func.is_view or name in _ALIASES or name.startswith("empty"):
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        seen = {id(t) for t in ins}
        self.bytes += sum(_nbytes(t) for t in ins)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and id(t) not in seen:
                n = _nbytes(t)
                self.bytes += n
                self.live += n
                weakref.finalize(t, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


def count_ops(fn, *args, **kwargs) -> Dict[str, float]:
    """Run `fn(*args, **kwargs)` (on meta tensors) and count its FLOPs,
    HBM bytes and peak live bytes (see the module docstring)."""
    bc = _ByteCounter()
    with FlopCounterMode(display=False) as fc, bc:
        fn(*args, **kwargs)
    return {"flops": float(fc.get_total_flops()),
            "hbm_bytes": float(bc.bytes), "peak_bytes": float(bc.peak)}


@dataclasses.dataclass
class CellReport:
    """The JAX module's report, over what the port's program does.
    `n_devices` is the mesh's size; `compute_devices` of them run the
    forward and backward (the batch shards; 1 where the port runs the
    cell on one device, and then the per-device terms are the whole
    cell's).  `xla_flops_reported` is None: there is no XLA."""
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_dev: float
    hbm_bytes_per_dev: float
    coll_bytes_per_dev: float
    coll_breakdown: Dict[str, float]
    t_compute: float
    t_memory: float
    t_collective: float
    model_flops_total: float
    xla_flops_reported: Optional[float]
    memory_analysis: Dict[str, float]
    compute_devices: int = 1
    placement: str = ""

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """Useful FLOPs over the FLOPs the devices that compute count."""
        total = self.flops_per_dev * self.compute_devices
        return self.model_flops_total / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOP throughput at the bound, as a fraction of the
        peak of the `n_devices` the cell holds."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        if t <= 0:
            return 0.0
        from repro_torch.launch.mesh import PEAK_FLOPS_BF16
        ach = self.model_flops_total / (self.n_devices * t)
        return ach / PEAK_FLOPS_BF16

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["dominant"] = self.dominant
        d["useful_flops_ratio"] = self.useful_flops_ratio
        d["roofline_fraction"] = self.roofline_fraction
        return d


def analyze_cell(arch: str, shape: str, mesh_name: str, n_devices: int,
                 counted: Dict[str, float], coll: Dict[str, float],
                 mem: Dict[str, float], model_flops_total: float,
                 compute_devices: int = 1, placement: str = ""
                 ) -> CellReport:
    """A `CellReport` from `count_ops`' counts of one device's program,
    the layout's collective bytes of that device by kind, and its memory
    sizes."""
    from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16
    flops, hbm = counted["flops"], counted["hbm_bytes"]
    coll_bytes = float(sum(coll.values()))
    return CellReport(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        flops_per_dev=flops, hbm_bytes_per_dev=hbm,
        coll_bytes_per_dev=coll_bytes, coll_breakdown=dict(coll),
        t_compute=flops / PEAK_FLOPS_BF16,
        t_memory=hbm / HBM_BW,
        t_collective=coll_bytes / NVLINK_BW,
        model_flops_total=model_flops_total,
        xla_flops_reported=None,
        memory_analysis=mem,
        compute_devices=compute_devices, placement=placement)


def ga_measured_points(table) -> List[Dict]:
    """Flatten a `repro_torch.autotune.CostTable` into report rows: one
    row per (plan point, gens_per_launch) with `frac_of_best`, the
    fraction of the best throughput any epoch mode demonstrated for the
    same spec family (1.0 marks the winner the measured planner picks)."""
    rows = list(table.entries())

    # family = everything identifying the spec except the competing
    # mode/executor and the launch fold
    def fam(r):
        return (r["stage"], r["migration"], r["n"], r["i_local"], r["c"],
                r["shards"], r["E"])
    best: Dict[Tuple, float] = {}
    for r in rows:
        best[fam(r)] = max(best.get(fam(r), 0.0), r["gens_per_s"])
    return [{**r, "frac_of_best":
             r["gens_per_s"] / best[fam(r)] if best[fam(r)] else 0.0}
            for r in rows]
