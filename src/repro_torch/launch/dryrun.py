"""Dry run: every (arch x shape x mesh) cell on a meta mesh of 256 or 512
placeholder positions, counted with no allocation and no kernel; the JAX
package's `repro.launch.dryrun`.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minitron-8b --shape train_4k --mesh pod1
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all    # one subprocess a cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --ga     # the GA mega-cell

Where the JAX module lowers and compiles each cell for 512 fake host
devices and parses the HLO, this one runs the port's own program for the
cell on meta tensors under `repro_torch.roofline.count_ops` (FLOPs,
unfused HBM bytes, peak live bytes) and computes the bytes its mesh
design moves from the layout:

  * a train cell is `train(mesh=)`'s step (`train.sharded`) on the
    production mesh's shape: the first position runs forward and backward
    on its batch shard's rows (remat on) and updates its slices (32-bit
    moments) or, with 8-bit moments, which stay whole, every leaf whole.
    Its collectives are the parameter gather onto it, the copies to the
    other batch shards, the gradient average and the gradient scatter
    (and, with 8-bit moments, each leaf's gather and re-scatter round the
    whole update);
  * a prefill or decode cell runs on one device, as the port's serving
    path takes no mesh: the report says so, and its terms are the whole
    cell's.

Records land in dryrun_results_torch/<arch>__<shape>__<mesh>.json with
the JAX module's keys; `t_lower_s` is the time to build the cell and
`t_compile_s` the time its counting run took (there is no compiler).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import roofline as RL
from repro_torch import sharding as SH
from repro_torch.configs import REGISTRY, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import shapes as SHAPES
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import common as C
from repro_torch.models import lm as LM
from repro_torch.optim import adamw as OPT
from repro_torch.train import step as TS

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "dryrun_results_torch")

MESHES = {"pod1": dict(multi_pod=False), "pod2": dict(multi_pod=True)}
META = torch.device("meta")


def meta_mesh(mesh_name: str):
    """The production mesh of `mesh_name` over meta positions."""
    return make_production_mesh(**MESHES[mesh_name], devices=[META] * 512)


def _moment(shape, opt_cfg: OPT.AdamWConfig):
    shape = tuple(shape)
    if opt_cfg.state_bits == 8 and OPT.quantizable(shape, opt_cfg.block):
        scale = shape[:-1] + (shape[-1] // opt_cfg.block,)
        return OPT.QTensor(torch.empty(shape, dtype=torch.int8, device=META),
                           torch.empty(scale, dtype=torch.float32,
                                       device=META), shape, 0)
    return torch.empty(shape, dtype=torch.float32, device=META)


def abstract_opt_state(defs: Dict[str, C.ParamDef],
                       opt_cfg: OPT.AdamWConfig) -> OPT.AdamState:
    """Meta tensors of the optimizer state, whole leaves."""
    return OPT.AdamState(
        step=0, m={n: _moment(d.shape, opt_cfg) for n, d in defs.items()},
        v={n: _moment(d.shape, opt_cfg) for n, d in defs.items()})


def model_flops_total(cfg: ModelConfig, shape: SHAPES.ShapeSpec) -> float:
    """Useful-FLOP convention: 6·N_active·D train, 2·N_active·D forward."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def _bytes(t) -> int:
    if isinstance(t, OPT.QTensor):
        return _bytes(t.q) + _bytes(t.scale)
    return t.numel() * t.element_size()


@dataclasses.dataclass
class Cell:
    """One device's program for a cell (`fn(*args, **kw)` on meta
    tensors), the bytes the mesh design moves to and from that device a
    step by kind, its memory sizes, and how many devices compute."""
    fn: Callable
    args: tuple
    kw: dict
    coll: Dict[str, float]
    mem: Dict[str, float]
    compute_devices: int
    placement: str


def _meta_part(spec: SHAPES.InputSpec, rows: int) -> torch.Tensor:
    return torch.empty((rows,) + spec.shape[1:], dtype=spec.dtype,
                       device=META)


def build_cell(cfg: ModelConfig, shape: SHAPES.ShapeSpec,
               opt_bits: Optional[int] = None) -> Cell:
    """The cell's program for its busiest device, under the active mesh."""
    model = LM.LM(cfg, C.Init(cfg.torch_dtype, META), shape.seq_len)
    inputs = SHAPES.input_specs(cfg, shape)
    mesh = SH.current_mesh()
    if shape.kind == "train":
        return _train_cell(cfg, shape, model, inputs, mesh, opt_bits)

    b = shape.global_batch
    max_seq = shape.seq_len + (cfg.n_patches if cfg.family == "vlm" else 0)
    cache = LM.new_cache(cfg, b, max_seq, device=META)
    args = {k: v.tensor for k, v in inputs.items()}
    if shape.kind == "prefill":
        fn, call = model.prefill, (args.pop("tokens"), cache)
        kw = args
    else:
        # one token at the last position of the window
        cache["pos"] = max_seq - 1
        fn, call, kw = model.decode_step, (args["tokens"], cache), {}
    state = sum(p.numel() * p.element_size() for p in model.parameters())
    cache_b = sum(_bytes(t) for t in _leaves(cache))
    return Cell(torch.no_grad()(fn), call, kw, {},
                {"argument_size_in_bytes": float(state + cache_b),
                 "output_size_in_bytes": 0.0,
                 "temp_size_in_bytes": 0.0,
                 "generated_code_size_in_bytes": 0.0},
                1, "one device: the port's serving path takes no mesh")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _train_cell(cfg, shape, model, inputs, mesh, opt_bits) -> Cell:
    bits = opt_bits or (8 if cfg.name.startswith("deepseek") else 32)
    opt_cfg = OPT.AdamWConfig(state_bits=bits)
    defs = C.module_defs(model)
    whole = bits == 8 or mesh is None
    shards, slice_shapes = 1, {n: tuple(d.shape) for n, d in defs.items()}
    if mesh is not None:
        axes = SH.current_rules().get("batch")
        shards = mesh.shards(SH.entry_axes(axes)) if axes else 1
        specs = C.spec_tree(defs)
        slice_shapes = {n: SH.NamedSharding(mesh, specs[n])
                        .shard_shape(d.shape) for n, d in defs.items()}
    rows = shape.global_batch // shards
    part = {k: _meta_part(v, rows) for k, v in inputs.items()}
    dtype = {n: d.dtype or cfg.torch_dtype for n, d in defs.items()}
    upd_shapes = ({n: tuple(d.shape) for n, d in defs.items()} if whole
                  else slice_shapes)
    p_u = {n: torch.empty(s, dtype=dtype[n], device=META)
           for n, s in upd_shapes.items()}
    state = abstract_opt_state(
        {n: dataclasses.replace(d, shape=upd_shapes[n])
         for n, d in defs.items()}, opt_cfg)
    loss_fn = TS.make_loss_fn(cfg, remat=True)

    def step():
        _, _, grads = TS.value_and_grad(loss_fn, model, part)
        gnorm = OPT.global_norm(grads)
        g_u = {n: torch.empty(s, dtype=dtype[n], device=META)
               for n, s in upd_shapes.items()}
        del grads
        OPT.update(p_u, g_u, state, opt_cfg, gnorm=gnorm)

    size = lambda n, s: int(np.prod(s)) * torch.empty(
        (), dtype=dtype[n]).element_size()
    p_whole = sum(size(n, d.shape) for n, d in defs.items())
    p_slice = sum(size(n, s) for n, s in slice_shapes.items())
    g_f32 = 4 * sum(int(np.prod(d.shape)) for d in defs.values())
    batch = sum(_bytes(v.tensor) for v in inputs.values())
    coll: Dict[str, float] = {}
    if mesh is not None:
        coll["param_gather"] = float(p_whole - p_slice)
        coll["replica_copy"] = float((shards - 1) * p_whole)
        coll["batch_split"] = float(batch - batch // shards)
        coll["grad_average"] = float((shards - 1) * g_f32)
        if whole:
            coll["update_gather"] = coll["update_scatter"] = \
                float(p_whole - p_slice)
        else:
            coll["grad_scatter"] = float(p_whole - p_slice)
    moments = sum(_bytes(x) for x in state.m.values()) + \
        sum(_bytes(x) for x in state.v.values())
    mem = {"argument_size_in_bytes": float(p_slice + moments
                                           + batch // shards),
           "output_size_in_bytes": 0.0,
           # the gathered working copy; the counted peak is added later
           "temp_size_in_bytes": float(p_whole if mesh is not None else 0),
           "generated_code_size_in_bytes": 0.0}
    placement = (f"{shards} batch shard(s) of {mesh.size} positions; "
                 f"{'whole' if whole else 'sliced'} {bits}-bit moments"
                 if mesh is not None else "one device")
    return Cell(step, (), {}, coll, mem, shards, placement)


def run_cell(arch: str, shape_name: str, mesh_name: str,
             out_dir: str = RESULTS_DIR, verbose: bool = True) -> Dict:
    cfg = get_config(arch)
    shape = SHAPES.SHAPES[shape_name]
    ok, why = SHAPES.cell_supported(cfg, shape)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "skipped", "reason": why}
        _save(rec, out_dir)
        return rec

    mesh = meta_mesh(mesh_name)
    t0 = time.time()
    with SH.use_mesh(mesh, fsdp=True):
        cell = build_cell(cfg, shape)
        t_build = time.time() - t0
        counted = RL.count_ops(cell.fn, *cell.args, **cell.kw)
        t_count = time.time() - t0 - t_build
    mem = dict(cell.mem)
    mem["temp_size_in_bytes"] += counted["peak_bytes"]
    n_dev = mesh.size if shape.kind == "train" else 1
    report = RL.analyze_cell(arch, shape_name, mesh_name, n_dev, counted,
                             cell.coll, mem, model_flops_total(cfg, shape),
                             cell.compute_devices, cell.placement)
    rec = {"status": "ok", "t_lower_s": t_build, "t_compile_s": t_count,
           **report.to_dict()}
    _save(rec, out_dir)
    if verbose:
        print(f"[{arch} × {shape_name} × {mesh_name}] OK "
              f"(build {t_build:.1f}s, count {t_count:.1f}s; "
              f"{cell.placement})")
        print(f"  memory/device: args "
              f"{mem['argument_size_in_bytes']/2**30:.2f} GiB, "
              f"temp {mem['temp_size_in_bytes']/2**30:.2f} GiB")
        print(f"  terms: compute {report.t_compute*1e3:.2f} ms | "
              f"memory {report.t_memory*1e3:.2f} ms | "
              f"collective {report.t_collective*1e3:.2f} ms "
              f"-> {report.dominant}-bound, "
              f"roofline {report.roofline_fraction*100:.1f}%")
    return rec


def _save(rec: Dict, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1)


# ---------------------------------------------------------------------------
# GA mega-cell: the paper's engine at production scale
# ---------------------------------------------------------------------------


def run_ga_cell(mesh_name: str, out_dir: str = RESULTS_DIR,
                islands_per_device: int = 8, n: int = 256) -> Dict:
    """The island ring over every position of the mesh: the per-shard GA
    state bytes (read and written once an epoch step), the formula's
    FLOPs and the ring's elite exchange, against one card's constants.
    It launches no kernel: meta tensors cannot run one."""
    from repro_torch import ga as engine_api

    mesh = meta_mesh(mesh_name)
    n_dev = mesh.size
    spec = engine_api.GASpec(
        problem="F3", n=n, bits_per_var=14, n_vars=2, mode="arith",
        mutation_rate=0.02, seed=1, migrate_every=16,
        n_islands=islands_per_device * n_dev)
    cfg = spec.ga_config()
    t0 = time.time()
    words = cfg.n * cfg.v + 2 * cfg.n + cfg.v * cfg.n // 2 + cfg.v * cfg.n
    state = islands_per_device * (4 * words + 4)
    total_flops = model_flops_total_ga(cfg, spec)
    counted = {"flops": total_flops / n_dev, "hbm_bytes": 2.0 * state}
    # one elite chromosome a shard boundary and migration interval
    coll = {"ring_elites": float(4 * cfg.v)}
    mem = {"argument_size_in_bytes": float(state),
           "output_size_in_bytes": float(state),
           "temp_size_in_bytes": 0.0, "generated_code_size_in_bytes": 0.0}
    islands = spec.n_islands
    report = RL.analyze_cell("ga-islands", f"I{islands}_N{n}", mesh_name,
                             n_dev, counted, coll, mem, total_flops, n_dev,
                             "every position holds "
                             f"{islands_per_device} islands")
    t_count = time.time() - t0
    t_dom = max(report.t_compute, report.t_memory, report.t_collective)
    gens_per_s = spec.migrate_every / t_dom if t_dom > 0 else 0
    rec = {"status": "ok", "t_lower_s": 0.0, "t_compile_s": t_count,
           "generations_per_s_bound": gens_per_s,
           "total_chromosomes": islands * n,
           **report.to_dict()}
    rec["arch"], rec["shape"] = "ga-islands", f"I{islands}_N{n}"
    _save(rec, out_dir)
    print(f"[GA × {mesh_name}] {islands} islands × N={n} "
          f"({islands*n/1e6:.1f}M chromosomes): state "
          f"{state/2**10:.1f} KiB a shard, "
          f"bound {gens_per_s/1e3:.0f}k gens/s/epoch-step, "
          f"dominant={report.dominant}")
    return rec


def model_flops_total_ga(cfg, spec) -> float:
    """Useful FLOPs per sharded epoch step: fitness evals dominate."""
    per_gen = spec.n_islands * cfg.n * 20.0     # ~20 flops per fitness eval
    return per_gen * spec.migrate_every


# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=[None, "pod1", "pod2"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--ga", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    if args.ga:
        for mesh_name in ([args.mesh] if args.mesh else ["pod1", "pod2"]):
            run_ga_cell(mesh_name, args.out)
        return

    if args.all:
        # one subprocess a cell: isolates each cell's failures
        cells = []
        for arch in sorted(REGISTRY):
            for shape in SHAPES.SHAPES:
                for mesh_name in MESHES:
                    out = os.path.join(
                        args.out, f"{arch}__{shape}__{mesh_name}.json")
                    if os.path.exists(out) and not args.force:
                        continue
                    cells.append((arch, shape, mesh_name))
        print(f"{len(cells)} cells to run")
        failures = []
        for arch, shape, mesh_name in cells:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh_name,
                   "--out", args.out]
            r = subprocess.run(cmd, capture_output=True, text=True)
            tail = r.stdout.strip().splitlines()[-3:]
            print(f"== {arch} × {shape} × {mesh_name}: rc={r.returncode}")
            for line in tail:
                print("   " + line)
            if r.returncode != 0:
                failures.append((arch, shape, mesh_name,
                                 r.stderr.strip().splitlines()[-5:]))
        if failures:
            print(f"\n{len(failures)} FAILURES:")
            for f_ in failures:
                print(f_)
            sys.exit(1)
        return

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all / --ga)")
    meshes = [args.mesh] if args.mesh else list(MESHES)
    for mesh_name in meshes:
        try:
            run_cell(args.arch, args.shape, mesh_name, args.out)
        except Exception:
            traceback.print_exc()
            sys.exit(1)


if __name__ == "__main__":
    main()
