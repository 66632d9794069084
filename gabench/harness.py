"""One run of one cell: set-up, the measured window, the check, the
result line.

    run_cell(root, manifest, workload, seed, seconds, trace, device=...)

The cell's configuration file gives the spec and the backend, its
traffic file the kind of load (`loadgen`).  Whatever depends on the
configuration's shape comes from two modules that the configuration file
names by their paths from the root, so a new deployment comes as new
files: its plain reference (`"reference"`, `reference/plain.py` where
absent: the shape, the state's leaves, the evaluations a generation, the
trajectory's sampling, and the replay the check compares against) and
its yardstick (`"work"`, `work.py` where absent: the least time of a run
of generations, the launch unit, the form the metric readers key on, and
the kernel names the trace must hold).  Set-up builds the system, warms
one job or takes the stream's first chunk (which holds the initial
state) at the cell's own shapes, and allocates the buffers the check
keeps its samples in; the window then offers load for `seconds` and
closes when the first job or chunk to end past that ends, so every unit
counted completed inside it.  With `trace` the run also records spans
and profiles one slice of the window, and reports the per-layer metrics
(`metrics/<name>.py`) in place of the end-to-end ones.

The check's buffers are allocated before the peak counter starts and
stay allocated until it is read, so the system's own peak is the
counter's less their bytes.  After the window, that peak is read, the
system's state freed, and the kept jobs or chunks are replayed by the
configuration's reference on the same device and compared word for word
(`check`).  A stream is checked from its start (the
reference's own initial state, through the first chunk) and, at each
sampled window chunk, from the state the program handed that chunk: the
reference follows the program chunk by chunk there, as replaying every
chunk of the window would take longer than the window.
"""

from __future__ import annotations

import contextlib
import importlib.util
import statistics
import sys
import time
import traceback
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from gabench import check as CHK
from gabench import loadgen as LG
from gabench import trace as TR
from gabench.systems import SYSTEMS

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# what a configuration file names where it names no module of its own
REFERENCE = "gabench/reference/plain.py"
WORK = "gabench/work.py"


def _load(path: Path, name: str):
    """A module of the benchmark's, loaded from its file under `name` (in
    `sys.modules`, where a dataclass looks its module up)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reference_of(root: Path, config: dict):
    """The configuration's plain reference module."""
    rel = config.get("reference", REFERENCE)
    return _load(root / rel, "gabench_reference_" + Path(rel).stem)


def work_of(root: Path, config: dict):
    """The configuration's yardstick module."""
    rel = config.get("work", WORK)
    return _load(root / rel, "gabench_work_" + Path(rel).stem)


class Cell(NamedTuple):
    """What one run of a cell holds fixed."""

    config: dict
    traffic: dict
    ref: object         # the reference module
    work: object        # the yardstick module
    shape: object       # `ref.shape_of(config)`
    replicas: int


class Slot:
    """Device buffers for one kept job or chunk: its output state (and,
    for a chunk, the state it was handed), and its host results."""

    def __init__(self, cell: Cell, device, inputs: bool):
        shapes = cell.ref.leaf_shapes(cell.shape, cell.replicas)

        def leaves():
            return tuple(torch.empty(s, dtype=torch.int32, device=device)
                         for s in shapes)
        self.outs = leaves()
        self.ins = leaves() if inputs else None
        self.out = None
        self.seed = None

    def take(self, bufs, state) -> None:
        for buf, leaf in zip(bufs, state):
            buf.copy_(leaf)


class Tap:
    """Wraps a system's chunk step: copies the input and output state of
    the chunk it is armed for into a slot."""

    def __init__(self, spans: TR.Spans):
        self.spans = spans
        self.armed = None

    def __call__(self, step):
        def segment(state, gens):
            slot, self.armed = self.armed, None
            if slot is not None and slot.ins is not None:
                slot.take(slot.ins, state)
            with self.spans.span("segment"):
                result = step(state, gens)
            if slot is not None:
                slot.take(slot.outs, result.state)
            return result
        return segment


@contextlib.contextmanager
def check_buffers(rec, cuda: bool):
    """Allocate the check's buffers inside: their bytes go to `rec.held`
    and the peak counter restarts after them."""
    before = torch.cuda.memory_allocated() if cuda else 0
    yield
    if cuda:
        rec.held = torch.cuda.memory_allocated() - before
        torch.cuda.reset_peak_memory_stats()


def forbidden_loaded(modules) -> list:
    """Top-level names among `modules` (e.g. `sys.modules`) that are the
    JAX stack or the JAX package, each compared whole."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def _now() -> float:
    return time.perf_counter()


def _metric_readers(root: Path, manifest: dict, workload: str, trace: bool):
    """The metrics this cell reports, as (entry, reader or None)."""
    if not trace:
        return [(m, None) for m in manifest["end_to_end"]
                if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m, _ in _metric_readers(root, manifest, workload,
                                                   False)}
    out = []
    for m in manifest["per_layer"]:
        if workload not in m.get("workloads", [workload]):
            continue
        if "workloads" not in m and m["moves"] not in moved:
            continue
        mod = _load(root / "gabench" / "metrics" / f"{m['name']}.py",
                    "gabench_metric_" + m["name"].replace(".", "_"))
        out.append((m, mod.read))
    return out


class Record:
    """What a run measured, for the metric readers."""

    def __init__(self):
        self.attempted = 0
        self.failed = 0
        self.gens = 0
        self.evals = 0
        self.latencies = []
        self.window_s = 0.0
        self.setup_s = 0.0
        self.spans = None
        self.slice = None
        self.form = None        # the yardstick's form: "block", "global"...
        self.unit = 1           # generations a replica's state stays on chip
        self.traj_unit = 1      # generations a trajectory sample covers
        self.device = None
        self.held = 0           # device bytes of the check's buffers
        self.error = None


def _fail(rec: Record, what: str) -> None:
    rec.failed += 1
    if rec.error is None:
        rec.error = f"{what}:\n{traceback.format_exc()}"


def _due(times: list, t: float) -> bool:
    """Whether a sample time has come by window offset t (and drop the
    ones that have)."""
    due = bool(times) and t >= times[0]
    while times and t >= times[0]:
        times.pop(0)
    return due


def _open_slice(rec, system, t: float, seconds: float, cuda: bool) -> None:
    """Start the traced slice before the first unit past a third of the
    window: the spans stop counting, the profiler starts up once outside
    the slice, then the slice's profile begins."""
    sl = rec.slice
    if sl is not None and sl.prof is None and t >= seconds / 3:
        rec.spans.counting = False
        TR.warm_profiler(cuda, rec.device)
        sl.start(cuda, system.launches())


def _count_slice(rec, system, cell, gens, cuda) -> None:
    """Count a finished unit into the open slice; close the slice once it
    has lasted `trace_slice_s`."""
    sl = rec.slice
    if sl is None or not sl.active:
        return
    sl.gens += gens
    sl.units += 1
    sl.least_ms += cell.work.generations_bound(cell.shape, cell.replicas,
                                               gens, rec.unit)["bound_ms"]
    if _now() - sl.t0 >= cell.traffic["trace_slice_s"]:
        sl.stop(cuda, system.launches())


def run_jobs(system, cell, seed, seconds, rec, device, cuda, t0):
    ref, replicas, shape = cell.ref, cell.replicas, cell.shape
    evals = replicas * ref.evals_per_generation(shape)
    base = LG.seed_base(seed)
    times = LG.sample_times(seed, seconds, cell.traffic["sample"])
    with check_buffers(rec, cuda):
        slots = [Slot(cell, device, False) for _ in times]
    # set-up: one job of the cell's shapes, seeded apart from the window's
    system.job(LG.job_seed(base, -1, replicas))
    if cuda:
        torch.cuda.synchronize()
    kept, j = [], 0
    start = _now()
    rec.setup_s = start - t0
    while True:
        t = _now() - start
        if t >= seconds:
            break
        keep = _due(times, t)
        _open_slice(rec, system, t, seconds, cuda)
        s = LG.job_seed(base, j, replicas)
        j += 1
        rec.attempted += 1
        ta = _now()
        try:
            out = system.job(s, rec.spans if rec.spans.traced else None)
        except Exception:
            _fail(rec, f"job seed {s}")
            continue
        rec.latencies.append(_now() - ta)
        rec.gens += out.gens
        rec.evals += evals * out.gens
        if keep:
            slot = slots[len(kept)]
            slot.take(slot.outs, out.state)
            slot.out, slot.seed = out._replace(state=slot.outs), s
            kept.append(slot)
        _count_slice(rec, system, cell, out.gens, cuda)
    rec.window_s = _now() - start

    def checks(device):
        for slot in kept:
            st = ref.init(shape, [slot.seed + r for r in range(replicas)],
                          device)
            run = ref.run(shape, st, slot.out.gens, rec.traj_unit)
            yield CHK.differences(run, slot.out)
    return checks, len(kept)


def run_stream(system, cell, seed, seconds, rec, device, cuda, t0):
    ref, replicas, shape = cell.ref, cell.replicas, cell.shape
    evals = replicas * ref.evals_per_generation(shape)
    chunk = cell.config["chunk_generations"]
    base = LG.seed_base(seed)
    times = LG.sample_times(seed, seconds, cell.traffic["sample"])
    with check_buffers(rec, cuda):
        first = Slot(cell, device, False)
        slots = [Slot(cell, device, True) for _ in times]
    tap = Tap(rec.spans)
    chunks = system.stream(base, chunk, cell.traffic["run_generations"],
                           tap)
    # set-up: the first chunk, which builds the initial state
    tap.armed = first
    out = next(chunks)
    first.out = out._replace(state=first.outs)
    if cuda:
        torch.cuda.synchronize()
    kept = []
    start = _now()
    rec.setup_s = start - t0
    while True:
        t = _now() - start
        if t >= seconds:
            break
        keep = _due(times, t)
        if keep:
            tap.armed = slots[len(kept)]
        _open_slice(rec, system, t, seconds, cuda)
        rec.attempted += 1
        try:
            with rec.spans.span("chunk"):
                out = next(chunks)
        except Exception:
            _fail(rec, "chunk")
            break
        rec.gens += out.gens
        rec.evals += evals * out.gens
        if keep:
            slot = slots[len(kept)]
            slot.out = out._replace(state=slot.outs)
            kept.append(slot)
        _count_slice(rec, system, cell, out.gens, cuda)
    rec.window_s = _now() - start
    chunks.close()

    def checks(device):
        st = ref.init(shape, [base + r for r in range(replicas)], device)
        yield CHK.differences(
            ref.run(shape, st, first.out.gens, rec.traj_unit), first.out)
        for slot in kept:
            run = ref.run(shape, ref.State(*slot.ins), slot.out.gens,
                          rec.traj_unit)
            yield CHK.differences(run, slot.out)
    return checks, 1 + len(kept)


RUNNERS = {"jobs": run_jobs, "stream": run_stream}


def card_line() -> str:
    """The card's name and power limit, from nvidia-smi where it runs."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


def run_cell(root: Path, manifest: dict, workload: str, seed: int,
             seconds: float, trace: bool, *, device: str, t0: float,
             system: str = "repro_torch", err=sys.stderr) -> dict:
    """Run one cell once; returns the result object (its keys in order,
    the check last).  Raises on a name that does not resolve."""
    _, config, traffic = LG.load_cell(root, manifest, workload)
    readers = _metric_readers(root, manifest, workload, trace)
    cuda = torch.device(device).type == "cuda"
    ref, work = reference_of(root, config), work_of(root, config)
    shape = ref.shape_of(config)
    replicas = config["spec"]["n_repeats"]
    cell = Cell(config, traffic, ref, work, shape, replicas)
    rec = Record()
    rec.unit = work.launch_unit(shape, config["spec"])
    rec.traj_unit = ref.traj_unit(config)
    rec.form = work.form(shape)
    rec.spans = TR.Spans(trace, cuda)
    rec.slice = TR.Slice() if trace else None
    rec.device = device
    sut = SYSTEMS[system](config, device, ref)
    checks, checked = RUNNERS[traffic["kind"]](
        sut, cell, seed, seconds, rec, device, cuda, t0)
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - rec.held if cuda else 0
    if rec.slice is not None and rec.slice.active:
        rec.slice.stop(cuda, sut.launches())
    del sut
    if trace:
        rec.slice.trace = (rec.slice.reduce() if rec.slice.prof is not None
                           else None)
        if cuda and not ga_kernels_seen(rec, work.KERNELS):
            raise RuntimeError("the profiler recorded no device time for "
                               "the GA's kernels in the traced slice")
    if cuda:
        torch.cuda.empty_cache()

    diffs = list(checks(device))
    correct, numbers = CHK.verdict(diffs, checked, traffic["least_checked"],
                                   rec.failed)

    if rec.error:
        print(rec.error, file=err)
    lat = sorted(rec.latencies)
    info = (f"{workload}: {traffic['kind']}, {rec.attempted} attempted, "
            f"{rec.failed} failed, {rec.gens} generations, window "
            f"{rec.window_s:.4f} s, set-up {rec.setup_s:.4f} s, peak "
            f"{peak} bytes (the check's {rec.held} bytes left out)")
    if lat:
        info += (f"; job latency median {statistics.median(lat) * 1e3:.4f}"
                 f" ms, p95 {float(np.percentile(lat, 95)) * 1e3:.4f} ms "
                 f"over {len(lat)} jobs")
    if trace and rec.slice.done:
        info += (f"; traced slice {rec.slice.units} units, "
                 f"{rec.slice.gens} generations, {rec.slice.host_s:.4f} s "
                 "on the host clock")
    print(info, file=err)
    gb = work.generations_bound(shape, replicas, rec.unit, rec.unit)
    print(f"least time a generation ({rec.form} form, unit {rec.unit}): "
          f"{gb['bound_ms'] / rec.unit:.6f} ms by {gb['bound_by']} at "
          f"{work.HBM_BYTES_PER_S:.3e} B/s and {work.OPS_PER_S:.3e} op/s; op "
          f"classes {gb['class_bound_ms'] / rec.unit:.6f} ms by "
          f"{gb['class_bound_by']} (information only); card: "
          f"{card_line() if cuda else 'none'}", file=err)

    metrics = {}
    if not trace:
        # by the name before its first dot: `evals_per_s.global` is the
        # rate, bounded for the cells it lists
        values = {
            "evals_per_s": (rec.evals / rec.window_s
                            if rec.window_s > 0 else None),
            "setup_s": rec.setup_s,
        }
        for m, _ in readers:
            v = values.get(m["name"].split(".")[0])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m, read in readers:
            v = read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": rec.attempted,
              "failed": rec.failed, "metrics": metrics, "device": dev_info}
    if trace:
        red = rec.slice.trace or {}
        dev_info["busy_s"] = red.get("busy_s", 0.0)
        dev_info["window_s"] = red.get("window_s", 0.0)
        result["breakdown"] = {"device_ops": red.get("device_ops", []),
                               "idle_gaps": red.get("idle_gaps", [])}
    result["check"] = numbers
    for name, n in numbers.items():
        print(f"check {name} = {n['value']} (limit {n['rule']} "
              f"{n['limit']})", file=err)
    return result


def ga_kernels_seen(rec: Record, kernels) -> bool:
    """Whether the traced slice holds device time of one of `kernels`
    (the yardstick's names for the GA's kernels)."""
    red = rec.slice.trace if rec.slice is not None else None
    return bool(red) and any(k in name for name in red["names"]
                             for k in kernels)
