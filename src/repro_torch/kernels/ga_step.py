"""The fused GA kernels of the island ring — CUDA kernels and plain twins.

  K1 `ga_generation_kernel`      `gens` generations of each island (replica)
                                 of a stack [R, N, V]: the one-block form
                                 where it fits, else the global form (three
                                 kernels a generation: `ga_ffm_kernel` or
                                 the program's PyTorch stage,
                                 `ga_best_kernel`, `ga_operators_kernel`);
  K2 `ga_epoch_kernel`           resident epochs of replica groups
                                 [G, I, N, V]: `intervals` migration
                                 intervals with the ring migration inside the
                                 kernel (`migrate=False`: no ring, the
                                 resident-free mode; `boundary=True`: the
                                 intra-shard part only);
  K3 `ga_streamed_epoch_kernel`  by default one interval of every island
                                 of [G, I, N, V], returning the pre-splice
                                 elites and worst slots for a splice
                                 outside; with `splice=True`, `intervals`
                                 intervals with the ring inside one
                                 cooperative launch (K2's contract, past
                                 the cluster limit).

On a CUDA tensor each wrapper launches its kernel in ``csrc/ga_step.cu``
(built on first use by `repro_torch.kernels.build`) and counts the launch
in ``LAUNCHES`` (K2's boundary form and K3's one-interval form, which only
a mesh's engine path runs, also in ``FORM_LAUNCHES``); on a CPU tensor it
runs its plain version, the same function in plain PyTorch built from the
port's `core.ga` operators, the program's `stage` and `core.islands`'
migration rule set.  There is no
fallback between the two: a call the kernel cannot take raises, on either
device, so the CPU path accepts exactly what the card does.

Contracts (the JAX package's kernels, on int32 words):

  K1  x int32[R, N, V], sel int32[R, 2, N], cross int32[R, V, N/2],
      mut int32[R, V, N] -> (x', sel', cross', mut', y f32[R, N]) where y is
      the fitness of the last pre-update population; `track_best` appends
      (best_y f32[R], best_x int32[R, V]), the best over all `gens`
      generations with strict improvement and the first-occurrence rule.
  K2  the same banks with leading axes [G, I] -> (state', y f32[G, I, N],
      best_y f32[K, G, I], best_x int32[K, G, I, V]); y is the final
      interval's migration fitness (pre-splice); best_* hold the best of
      each of the K intervals (the TPU kernel returns their fold over the
      launch: folding at the interval keeps the island ring's per-replica
      best the same under every plan, see `IslandRingTopology.segment`);
      `boundary` appends (send_elite int32[G, V], worst0 int32[G]).
  K3  one interval: (state', y f32[G, I, N], best_y f32[G, I], best_x
      int32[G, I, V]), plus (elite_x int32[G, I, V], worst_idx int32[G, I])
      with `migrate`; with `splice=True`, K2's outputs for `intervals`
      intervals (the state after the last splice).

K1's one-block form, K2 and K3 hold one island per thread block with its
state in shared memory (the mutation rows past P, never drawn, stay in
global memory, and so do the rows below P where they do not fit; see the
note at the top of the CUDA source), so (N, V) must fit `SMEM_LIMIT`, and
their FFM stage is CUDA's own, for the built-in problems; at c <= 16 K2
holds the population as 16-bit words (`population_bits`), half the
population's bytes, so more of its blocks share an SM, and there (without
problem data, 32 <= N <= 512) may run one thread an individual rather than
one a pair (`pair_threads`), twice the warps a block; K2's ring makes
the islands of a group one thread-block cluster, at most `MAX_CLUSTER`;
K3's ring needs every block of a launch co-resident (`streamed_capacity`).
K1's global form keeps the state in global memory and takes any fitness
(a blackbox or registered one through its PyTorch stage, as the reference
evaluates it), so K1 runs every spec the JAX package's fused kernel runs.
`hopper_reason` says why a spec cannot run fused at all, `block_reason`
why the one-block form cannot take it, and the epoch planner
(`epoch_mode_candidates`) which launch shapes an island-ring spec can take
on this card.

A problem with data (rastrigin_sr: a shift and a rotation) runs in builds
of its own, each kernel's data pointer from `FitnessProgram.device_data`,
the data in the block's shared memory (`data_words`, counted by every
block-size function given the program), ga_ffm in its rows form; a V
past what those builds hold in registers (`SR_MAX_VARS`) is refused by
`data_reason`, so K1 runs its global form with the PyTorch stage.
"""

from __future__ import annotations

import functools
import inspect
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np

import torch

from repro_torch.core import fitness as F
from repro_torch.core import ga as G
from repro_torch.core import islands as ISL
from repro_torch.core.ga import GAConfig, ONEHOT_MAX_N

# launches of each kernel made by its wrapper (plain-version calls excluded)
# (K1's global form apart: "ga_generation:global" counts `ga_operators`,
# one a generation, beside "ga_ffm" and "ga_best")
LAUNCHES: Dict[str, int] = {"ga_generation": 0, "ga_epoch": 0,
                            "ga_streamed_epoch": 0,
                            "ga_generation:global": 0, "ga_ffm": 0,
                            "ga_best": 0}
# of those, the launches of the two forms only a mesh runs: K2's boundary
# form and K3's one interval without the ring inside
FORM_LAUNCHES: Dict[str, int] = {"ga_epoch:boundary": 0,
                                 "ga_streamed_epoch:one-interval": 0}

SMEM_LIMIT = 232448            # bytes of shared memory a Hopper block can use
# the kernel's own copy of that limit (kSmemLimit), which decides where the
# mutation rows below P live, whatever limit a caller checks against
_LAYOUT_LIMIT = SMEM_LIMIT
MAX_CLUSTER = 8                # portable thread-block cluster size (K2 ring)
MAX_THREADS = 512              # threads of an island block (kMaxThreads)

# the built-in problems the kernel's FFM stage implements, by kernel id
PROBLEM_IDS = {"F1": 0, "F2": 1, "F3": 2, "sphere": 3, "rastrigin": 4,
               "rosenbrock": 5, "ackley": 6, "rastrigin_sr": 7}
# rastrigin_sr's builds hold an individual's V shifted values in registers:
# at most this many variables (kSRMaxVars)
SR_MAX_VARS = 32


def reset_launches() -> None:
    for counts in (LAUNCHES, FORM_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _block_bytes(n: int, v: int, p: int, extra: int, bits: int = 32,
                 data: int = 0) -> int:
    """Bytes of a block with `extra` words beyond K1's layout, population
    words of `bits` bits and `data` words of problem data; the mutation
    rows below P count only where they fit (else they stay in global
    memory)."""
    base = (n * v * bits // 4
            + 4 * (4 * n + v * (n // 2) + 3 * v + 2 + 2 * 64 + extra + data))
    rows = base + 4 * v * min(p, n)
    return rows if rows <= _LAYOUT_LIMIT else base


def data_words(program: Optional[F.FitnessProgram]) -> int:
    """Words of the program's data a kernel block holds in shared memory
    (`data_words` in the CUDA source): rastrigin_sr's M rows at a stride of
    V rounded up to 4, then o, the pad words zero; 0 for a problem without
    data (or no program)."""
    if program is None or program.data is None:
        return 0
    v = program.n_vars
    return ((v + 3) & ~3) * (v + 1)


def smem_bytes(n: int, v: int, p: int, data: int = 0) -> int:
    """Shared memory one block takes for a replica of shape (N, V) that
    mutates its first P rows: the population and the fitness vector, each
    double buffered, the selection and crossover banks, the mutation bank's
    rows below P where they fit beside the rest (the rows at and past P are
    never drawn and stay in global memory, as do the rows below P that do
    not fit), the decode constants, the best individual, the reduction
    scratch and `data` words of problem data (`data_words`; the layout in
    ``csrc/ga_step.cu``)."""
    return _block_bytes(n, v, p, 0, data=data)


def epoch_smem_bytes(n: int, v: int, p: int, bits: int = 32,
                     data: int = 0) -> int:
    """Shared memory one K2 or K3 block takes for an island of shape (N, V)
    with P mutated rows: K1's layout plus the elite row a ring neighbour
    reads and one slot, with population words of `bits` bits (K3 and K1
    hold 32; K2 holds `population_bits(c)`, so its block is
    `resident_block_bytes`) and `data` words of problem data."""
    return _block_bytes(n, v, p, v + 1, bits, data)


def population_bits(c: int) -> int:
    """Bits of a population word in K2's shared memory for c bits a
    variable: 16 where c <= 16, else 32.  Every word the port makes at
    c <= 16 is below 2^16 (initial states keep a word's top c bits,
    crossover and the XOR mutation keep a word below 2^c, a splice copies a
    row), so K2 then holds its two population buffers in half the bytes,
    bit for bit the same generations; K1 and K3 always hold 32."""
    return 16 if c <= 16 else 32


def resident_block_bytes(cfg: GAConfig,
                         program: Optional[F.FitnessProgram] = None) -> int:
    """Shared memory one K2 block takes at `cfg`'s shape and layout
    (`population_bits(cfg.c)`), with `program`'s data."""
    return epoch_smem_bytes(cfg.n, cfg.v, cfg.p, population_bits(cfg.c),
                            data_words(program))


# why a LUT config cannot take the kernels: their FFM stage is arith only
ARITH_REASON = ("the CUDA kernel requires mode='arith' — LUT gathers stay "
                "on the plain path ('reference')")


def problem_id(program: F.FitnessProgram) -> Optional[int]:
    """Kernel id of the program's fitness, or None when the kernel has no
    FFM stage for it (a blackbox, or a problem registered by the user —
    also under a built-in name)."""
    pid = PROBLEM_IDS.get(program.name)
    builtin = F.BUILTIN.get(program.name)
    if pid is None or builtin is None or program.fn is not builtin.fn:
        return None
    return pid


def data_reason(program: F.FitnessProgram) -> Optional[str]:
    """None when the kernels' FFM stage can hold the program's data, else
    why: rastrigin_sr's builds keep an individual's V shifted values in
    registers, at most `SR_MAX_VARS` (K1's global form then runs the
    program's PyTorch stage)."""
    if program.data is not None and program.n_vars > SR_MAX_VARS:
        return (f"{program.name}:{program.n_vars}: the kernels' FFM stage "
                "holds an individual's shifted values in registers, at most "
                f"{SR_MAX_VARS} variables; K1's global form runs its "
                "PyTorch stage")
    return None


def _data_ptr(program: F.FitnessProgram, device):
    """The device pointer of the program's data on `device`, or None."""
    data = program.device_data(device)
    return None if data is None else data.data_ptr()


def _tensor_bytes(value) -> int:
    """Bytes of the tensors and arrays in `value`, looking one level into
    tuples, lists and dicts."""
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    if isinstance(value, np.ndarray):
        return int(value.nbytes)
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (tuple, list)):
        return sum(_tensor_bytes(v) for v in value
                   if isinstance(v, (torch.Tensor, np.ndarray)))
    return 0


def ffm_const_bytes(program: F.FitnessProgram) -> int:
    """Bytes of array constants the program's FFM stage takes, counted as
    the JAX package counts its traced stage's constants: the decode's lo
    and span (4 bytes a variable each) and the tensors and arrays the
    fitness function closes over (`inspect.getclosurevars`: its nonlocals
    and the globals it names, one level into tuples, lists and dicts).
    The problem's data (`FitnessProgram.data`) counts too.  Counted once a
    program."""
    cached = program.__dict__.get("_const_bytes")
    if cached is None:
        fn = getattr(program.fn, "__func__", program.fn)
        cached = 8 * program.n_vars + program.data_bytes
        if inspect.isfunction(fn):
            seen = inspect.getclosurevars(fn)
            cached += sum(_tensor_bytes(v) for v in
                          (*seen.nonlocals.values(), *seen.globals.values()))
        program.__dict__["_const_bytes"] = cached
    return cached


def ffm_const_limit() -> int:
    """The FFM-constant gate (bytes), the JAX package's:
    REPRO_FFM_CONST_LIMIT overrides the default 2 MiB."""
    return int(os.environ.get("REPRO_FFM_CONST_LIMIT", str(2 << 20)))


def hopper_reason(cfg: GAConfig, program: F.FitnessProgram) -> Optional[str]:
    """None if K1 can run this (config, program) on the card in one of its
    forms, else why: exactly what the JAX package's fused kernel refuses
    past its mode and pipeline checks.

    The tournament indices are the top `idx_bits` of the LFSR draw, so N
    must be a power of two on any lane; a pinned onehot lane keeps the JAX
    package's N cap so a spec validates the same way in both packages; a
    fitness that closes over more than `ffm_const_limit()` bytes of arrays
    (a dataset) is refused with the JAX package's words, so `auto` routes
    it to 'reference' in both packages."""
    if cfg.n & (cfg.n - 1):
        return (f"N={cfg.n}: the fused kernel path draws tournament indices "
                "from the top idx_bits LFSR bits and requires a power-of-two "
                "N (the reference backend accepts any even N)")
    if cfg.sel_lane == "onehot" and cfg.n > ONEHOT_MAX_N:
        return (f"N={cfg.n} > {ONEHOT_MAX_N} on the 'onehot' selection "
                "lane, the JAX package's cap for its (N, N) one-hot "
                "tournament matrices; switch to the dynamic-indexing lane "
                "with sel_lane='gather'")
    const_bytes, limit = ffm_const_bytes(program), ffm_const_limit()
    if const_bytes > limit:
        return (f"FFM stage captures {const_bytes} bytes of array "
                f"constants (> the {limit}-byte VMEM gate): hoisted "
                "consts replicate into VMEM per grid step — run "
                "'reference' (REPRO_FFM_CONST_LIMIT overrides)")
    return None


def block_reason(cfg: GAConfig, program: F.FitnessProgram) -> Optional[str]:
    """None if the one-block form of K1 (and, for the FFM stage, K2 and K3)
    takes this (config, program), else why: the fitness needs an FFM stage
    in CUDA (a built-in problem) that holds its data (`data_reason`), and
    the replica's state and the problem's data must fit a block's shared
    memory (the mutation rows below P only where they fit).  K1's global
    form takes what this refuses; K2 and K3 do not."""
    if problem_id(program) is None:
        return (f"no Hopper FFM stage for this fitness ({program.name!r}): "
                "the one-block kernels implement the built-in problems "
                f"{sorted(PROBLEM_IDS)}; K1's global form runs a blackbox "
                "or user-registered fitness through its PyTorch stage")
    reason = data_reason(program)
    if reason is not None:
        return reason
    need = smem_bytes(cfg.n, cfg.v, cfg.p, data_words(program))
    if need > SMEM_LIMIT:
        return (f"N={cfg.n}, V={cfg.v}, P={cfg.p} needs {need} bytes of "
                f"shared memory per replica, past the {SMEM_LIMIT}-byte "
                "limit of one Hopper thread block (the one-block kernels "
                "keep a replica's state in shared memory); K1's global "
                "form keeps it in global memory")
    return None


def check_kernel_lane(cfg: GAConfig, program: F.FitnessProgram,
                      one_block: bool = True) -> None:
    """The kernels' validity gate: raises `hopper_reason`'s reason and,
    for the one-block kernels (K2, K3), `block_reason`'s."""
    reason = hopper_reason(cfg, program)
    if reason is None and one_block:
        reason = block_reason(cfg, program)
    if reason is not None:
        raise ValueError(reason)


def _check_device(name: str, x) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {x.device}")


def _check_shapes(x, sel, cross, mut, cfg: GAConfig, lead: str = "R"
                  ) -> None:
    """The banks of a stack whose leading axes are named by `lead` ("R":
    [R, ...], "GI": [G, I, ...]): int32 words on one device."""
    k = len(lead)
    if x.dim() != k + 2 or tuple(x.shape[k:]) != (cfg.n, cfg.v):
        raise ValueError(f"x must be [{', '.join(lead)}, {cfg.n}, {cfg.v}], "
                         f"got {tuple(x.shape)}")
    r = tuple(x.shape[:k])
    want = {"sel": (sel, r + (2, cfg.n)),
            "cross": (cross, r + (cfg.v, cfg.n // 2)),
            "mut": (mut, r + (cfg.v, cfg.n))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{list(t.shape)}")
    for name, t in (("x", x), ("sel", sel), ("cross", cross), ("mut", mut)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must hold int32 words, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def ga_generation_plain(x, sel, cross, mut, *, cfg: GAConfig,
                        program: F.FitnessProgram, gens: int = 1,
                        track_best: bool = False) -> Tuple[torch.Tensor, ...]:
    """The kernel's function in plain PyTorch, on any device: `gens`
    generations of `core.ga.generation` with the program's stage, and the
    running best folded as the reference scan folds it.  Takes what the
    wrapper validated (see `ga_generation_kernel`)."""
    state = G.GAState(x, sel, cross, mut,
                      torch.zeros(x.shape[:1], dtype=torch.int32,
                                  device=x.device))
    by = torch.full(x.shape[:1], math.inf if cfg.minimize else -math.inf,
                    dtype=torch.float32, device=x.device)
    bx = torch.zeros((x.shape[0], cfg.v), dtype=torch.int32, device=x.device)
    for _ in range(gens):
        nxt, y = G.generation(state, cfg, program.stage)
        if track_best:
            gb, gx = G.gen_best(state.x, y, cfg.minimize)
            by, bx = G.fold_best(by, bx, gb, gx, cfg.minimize)
        state = nxt
    out = (state.x, state.sel_lfsr, state.cross_lfsr, state.mut_lfsr, y)
    return out + ((by, bx) if track_best else ())


def kernel_library():
    """The built ``ga_step`` library with its C signatures declared, built
    and bound once per process (`build.library`)."""
    from repro_torch.kernels import build
    return build.library("ga_step", _declare)


def _declare(lib) -> None:
    import ctypes
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ga_step_launch.argtypes = [p] * 14 + [i] * 12 + [p]
    lib.ga_step_launch.restype = i
    lib.ga_epoch_launch.argtypes = [p] * 16 + [i] * 17 + [p]
    lib.ga_epoch_launch.restype = i
    lib.ga_streamed_launch.argtypes = [p] * 17 + [i] * 17 + [p]
    lib.ga_streamed_launch.restype = i
    lib.ga_streamed_capacity.argtypes = [i] * 5 + [ctypes.POINTER(i)]
    lib.ga_streamed_capacity.restype = i
    lib.ga_epoch_max_active_clusters.argtypes = [i] * 8 + [ctypes.POINTER(i)]
    lib.ga_epoch_max_active_clusters.restype = i
    lib.ga_step_kernel_attrs.argtypes = [i] * 8 + [ctypes.POINTER(i)] * 3
    lib.ga_step_kernel_attrs.restype = i
    lib.ga_step_threads.argtypes = [i, i]
    lib.ga_step_threads.restype = i
    lib.ga_step_smem_bytes.argtypes = [i, i, i]
    lib.ga_epoch_smem_bytes.argtypes = [i, i, i, i]
    lib.ga_block_smem_bytes.argtypes = [i] * 6
    for fn in (lib.ga_step_smem_bytes, lib.ga_epoch_smem_bytes,
               lib.ga_block_smem_bytes):
        fn.restype = ctypes.c_size_t
    for fn in (lib.ga_step_smem_limit, lib.ga_step_max_cluster):
        fn.argtypes = []
        fn.restype = i
    lib.ga_step_error_string.argtypes = [i]
    lib.ga_step_error_string.restype = ctypes.c_char_p
    lib.ga_ffm_launch.argtypes = [p] * 4 + [i] * 8 + [p]
    lib.ga_ffm_launch.restype = i
    lib.ga_ffm_data_launch.argtypes = [p] * 5 + [i] * 5 + [p]
    lib.ga_ffm_data_launch.restype = i
    lib.ga_operators_launch.argtypes = [p] * 9 + [i] * 11 + [p]
    lib.ga_operators_launch.restype = i
    lib.ga_best_launch.argtypes = [p] * 6 + [i] * 6 + [p]
    lib.ga_best_launch.restype = i
    lib.ga_global_kernel_attrs.argtypes = [i] + [ctypes.POINTER(i)] * 2
    lib.ga_global_kernel_attrs.restype = i


def ga_generation_kernel(x, sel, cross, mut, *, cfg: GAConfig,
                         program: F.FitnessProgram, gens: int = 1,
                         track_best: bool = False
                         ) -> Tuple[torch.Tensor, ...]:
    """Run `gens` fused generations over a stack of replicas (see the
    module docstring for the contract).  What K1 cannot take in any form
    (`hopper_reason`) is rejected on every device; then CPU tensors take
    the plain version, and CUDA tensors launch the one-block form where
    `block_reason` is None, else the global form (`gens` times: the FFM
    stage, `ga_best_kernel` with `track_best`, `ga_operators_kernel`)."""
    _check_device("ga_generation_kernel", x)
    check_kernel_lane(cfg, program, one_block=False)
    _check_shapes(x, sel, cross, mut, cfg)
    if gens < 1:
        raise ValueError(f"gens must be >= 1, got {gens}")
    if x.device.type == "cpu":
        return ga_generation_plain(x, sel, cross, mut, cfg=cfg,
                                   program=program, gens=gens,
                                   track_best=track_best)
    if block_reason(cfg, program) is not None:
        return _global_generations(x, sel, cross, mut, cfg, program, gens,
                                   track_best)
    x, sel, cross, mut = (t.contiguous() for t in (x, sel, cross, mut))
    r, n, v = x.shape
    dev = x.device
    lo, span = program.device_consts(dev)
    outs = [torch.empty_like(t) for t in (x, sel, cross, mut)]
    y = torch.empty((r, n), dtype=torch.float32, device=dev)
    by = torch.empty((r,), dtype=torch.float32, device=dev)
    bx = torch.empty((r, v), dtype=torch.int32, device=dev)
    lib = kernel_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ga_step_launch(
            x.data_ptr(), sel.data_ptr(), cross.data_ptr(), mut.data_ptr(),
            *(t.data_ptr() for t in outs), y.data_ptr(), by.data_ptr(),
            bx.data_ptr(), lo.data_ptr(), span.data_ptr(),
            _data_ptr(program, dev),
            r, n, v, cfg.c, cfg.idx_bits, cfg.cut_bits, min(cfg.p, n),
            cfg.steps_per_draw, int(cfg.minimize), problem_id(program), gens,
            int(track_best), stream)
    _check_launch(err, "ga_step")
    LAUNCHES["ga_generation"] += 1
    return tuple(outs) + (y,) + ((by, bx) if track_best else ())


def _global_generations(x, sel, cross, mut, cfg, program, gens, track_best):
    """K1's global form on card tensors: a generation is the FFM stage
    (`ga_ffm_kernel` for a built-in problem whose data it holds, else the
    program's PyTorch stage, which the reference executor calls), the best
    fold and the operators, each a launch.  Returns K1's contract."""
    builtin = problem_id(program) is not None and data_reason(program) is None
    r = x.shape[0]
    by = torch.full((r,), math.inf if cfg.minimize else -math.inf,
                    dtype=torch.float32, device=x.device)
    bx = torch.zeros((r, cfg.v), dtype=torch.int32, device=x.device)
    for _ in range(gens):
        y = (ga_ffm_kernel(x, cfg=cfg, program=program) if builtin
             else program.stage(x))
        if track_best:
            by, bx = ga_best_kernel(x, y, by, bx, minimize=cfg.minimize)
        x, sel, cross, mut = ga_operators_kernel(x, y, sel, cross, mut,
                                                 cfg=cfg)
    return (x, sel, cross, mut, y) + ((by, bx) if track_best else ())


def _check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {err} "
            f"({kernel_library().ga_step_error_string(err).decode()})")


# ---------------------------------------------------------------------------
# K1's global form: one generation as three kernels over global memory
# ---------------------------------------------------------------------------


def _check_tensor(name: str, t, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {list(shape)}, got "
                         f"{list(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")


def ga_ffm_plain(x, *, cfg: GAConfig, program: F.FitnessProgram):
    """`ga_ffm`'s function in plain PyTorch: the program's stage."""
    return program.stage(x)


def ga_ffm_kernel(x, *, cfg: GAConfig, program: F.FitnessProgram
                  ) -> torch.Tensor:
    """y f32[R, N]: the FFM stage of a built-in problem over x
    int32[R, N, V], a block a tile of `ffm_tiling(N, V, R)` rows of x seen
    as [R * N, V] (`ga_ffm` in the CUDA source); a CPU tensor takes
    `ga_ffm_plain`."""
    _check_device("ga_ffm_kernel", x)
    if problem_id(program) is None:
        raise ValueError(f"no Hopper FFM stage for this fitness "
                         f"({program.name!r}): ga_ffm implements the "
                         f"built-in problems {sorted(PROBLEM_IDS)}")
    reason = data_reason(program)
    if reason is not None:
        raise ValueError(reason)
    _check_tensor("x", x, x.shape[:1] + (cfg.n, cfg.v), torch.int32,
                  x.device)
    if x.device.type == "cpu":
        return ga_ffm_plain(x, cfg=cfg, program=program)
    x = x.contiguous()
    r, n, v = x.shape
    lo, span = program.device_consts(x.device)
    y = torch.empty((r, n), dtype=torch.float32, device=x.device)
    spread = ffm_spreads(n, v, r, data_words(program))
    lib = kernel_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if program.data is not None:
            # the rows form's build for the problem: a row a thread in
            # tiles of FFM_THREADS rows, the data first in the block
            err = lib.ga_ffm_data_launch(
                x.data_ptr(), y.data_ptr(), lo.data_ptr(), span.data_ptr(),
                _data_ptr(program, x.device), r, n, v, cfg.c,
                problem_id(program), stream)
        else:
            tile, chunk = ffm_tiling(n, v, r, spread)
            err = lib.ga_ffm_launch(x.data_ptr(), y.data_ptr(),
                                    lo.data_ptr(), span.data_ptr(), r, n, v,
                                    cfg.c, problem_id(program), tile, chunk,
                                    int(spread), stream)
    _check_launch(err, "ga_ffm")
    LAUNCHES["ga_ffm"] += 1
    return y


# K1's global form cuts its work into blocks as the CUDA launchers check:
# ga_ffm a tile of rows by a chunk of variables, ga_operators a tile of
# pairs by a chunk of variables, each within a shared-memory budget, and
# ga_best a replica into a cluster of slices
FFM_THREADS = 256              # threads of a ga_ffm block (kGlobalThreads)
FFM_ROWS_TILE = 1024           # most rows of a rows-form tile (4 a thread)
FFM_CHUNK = 64                 # most variables of a spread-form chunk
FFM_SMEM_LIMIT = 49152         # bytes of a ga_ffm block (kFfmSmemLimit)
FFM_ITEMS = 512                # (row, variable) items a tile is cut down to
FFM_SPREAD_V = 4               # below this V always the rows form
OPS_TILE_PAIRS = 256           # most pairs a ga_operators tile holds
OPS_CHUNK = 64                 # most variables a ga_operators chunk holds
OPS_SMEM_LIMIT = 27648         # bytes of a tile, 8 an SM (kOpsSmemLimit)
OPS_ITEMS = 512                # (pair, variable) items a tile is cut down to
OPS_GRID = 512                 # blocks a launch should have to fill the card
BEST_SLICE = 4096              # values a ga_best block folds before B grows


def ffm_spreads(n: int, v: int, replicas: int, data: int = 0) -> bool:
    """Whether ga_ffm takes its spread form over R * N rows of V variables
    (a thread a term, then a thread a row folding them) rather than its
    rows form (a thread whole rows): never below `FFM_SPREAD_V` (F1-F3, V
    = 2, have no per-variable sum), never for a problem with `data` words
    (rastrigin_sr: each of its V terms needs every variable, so its terms
    are no per-variable sum either), and from there unless the rows form's
    256-row tiles alone fill `OPS_GRID` blocks and fit the budget.  Where
    they do, the rows form was the faster on the card, and where R * N is
    small the spread form keeps the card busy (`PERF.md` §5)."""
    if v < FFM_SPREAD_V or data:
        return False
    return not (replicas * n >= FFM_THREADS * OPS_GRID
                and ffm_tile_bytes(FFM_THREADS, v, False) <= FFM_SMEM_LIMIT)


def ffm_tile_bytes(tile: int, chunk: int, spread: bool) -> int:
    """Shared memory of a ga_ffm block (`ffm_tile_bytes`): `tile` rows at
    the odd stride `ffm_stride` (in the spread form one word past the chunk
    for rosenbrock's halo), the chunk's lo and span, and in the spread form
    a tile of terms."""
    stride = (chunk + 1) | 1 if spread else chunk | 1
    return 4 * ((2 if spread else 1) * tile * stride + 2 * (chunk + 1))


def ffm_tiling(n: int, v: int, replicas: int,
               spread: Optional[bool] = None) -> Tuple[int, int]:
    """(tile, chunk) of ga_ffm over the R * N rows of `replicas` replicas of
    (N, V), in the form `ffm_spreads` picks (or `spread`).  Rows form: chunk =
    V, a tile of 256, 512 or 1024 rows (1, 2 or 4 a thread), the most that
    fit `FFM_SMEM_LIMIT`, halved while the grid has fewer than `OPS_GRID`
    blocks.  Spread form: a chunk of at most `FFM_CHUNK` variables (the last
    one ragged), a tile a power of two up to 256 rows (a folding thread a
    row) that fits the budget, then halved while the grid has fewer than
    `OPS_GRID` blocks and a tile more than `FFM_ITEMS` items.  The last tile
    of the rows may be ragged."""
    if spread is None:
        spread = ffm_spreads(n, v, replicas)
    rows = replicas * n
    if not spread:
        tile = FFM_ROWS_TILE
        while (tile > FFM_THREADS
               and (ffm_tile_bytes(tile, v, False) > FFM_SMEM_LIMIT
                    or -(-rows // tile) < OPS_GRID)):
            tile //= 2
        return tile, v
    chunk = min(v, FFM_CHUNK)
    tile = FFM_THREADS
    while tile > 1 and ffm_tile_bytes(tile, chunk, True) > FFM_SMEM_LIMIT:
        tile //= 2
    while (tile > 1 and tile * chunk > FFM_ITEMS
           and -(-rows // tile) < OPS_GRID):
        tile //= 2
    return tile, chunk


def operators_tile_bytes(tile: int, chunk: int) -> int:
    """Shared memory of a ga_operators tile (`ops_tile_words`): 2 x tile
    rows of `chunk` words at the odd stride chunk | 1, and 2 x tile
    winners."""
    return 4 * (2 * tile * (chunk | 1) + 2 * tile)


def operators_tiling(n: int, v: int, replicas: int) -> Tuple[int, int]:
    """(tile, chunk) of ga_operators over `replicas` replicas of (N, V): a
    chunk of at most `OPS_CHUNK` variables (the last one ragged), and a
    tile of pairs, a power of two dividing N/2 (N is one): the most, up to
    `OPS_TILE_PAIRS`, that fit `OPS_SMEM_LIMIT`, then halved while the
    grid has fewer than `OPS_GRID` blocks and a tile more than `OPS_ITEMS`
    (pair, variable) items: a few large tiles leave SMs idle, many small
    ones each pay a block's fixed cost (the trade measured on the card,
    `PERF.md` §5)."""
    chunk = min(v, OPS_CHUNK)
    tile = min(OPS_TILE_PAIRS, n // 2)
    while tile > 1 and operators_tile_bytes(tile, chunk) > OPS_SMEM_LIMIT:
        tile //= 2
    chunks = -(-v // chunk)
    while (tile > 1 and tile * chunk > OPS_ITEMS
           and replicas * (n // 2 // tile) * chunks < OPS_GRID):
        tile //= 2
    return tile, chunk


def best_split(n: int) -> Tuple[int, int]:
    """(blocks, slice) of ga_best at N: a cluster of ceil(N / BEST_SLICE)
    blocks, 1 to MAX_CLUSTER, block k folding values [k * slice, (k + 1) *
    slice) of its replica's row; slice is a multiple of 4 (16-byte loads)
    and every block has some."""
    blocks = min(MAX_CLUSTER, max(1, -(-n // BEST_SLICE)))
    slice_ = -(-n // blocks)
    return blocks, slice_ + (-slice_ % 4)


def _aligned8(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy where its data does not start on 8 bytes (the kernel
    reads the banks as 8-byte words)."""
    return t if t.data_ptr() % 8 == 0 else t.clone()


def ga_best_plain(x, y, best_y, best_x, *, minimize: bool):
    """`ga_best`'s function in plain PyTorch: `core.ga.gen_best`, then
    `fold_best`, as the reference scan folds a generation."""
    gb, gx = G.gen_best(x, y, minimize)
    return G.fold_best(best_y, best_x, gb, gx, minimize)


def ga_best_kernel(x, y, best_y, best_x, *, minimize: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The running best (best_y f32[R], best_x int32[R, V]) folded with the
    best of x int32[R, N, V] scored by y f32[R, N]: the first occurrence of
    the best value, kept on strict improvement, nothing taken where y holds
    a NaN (`ga_best` in the CUDA source, a cluster of `best_split(N)`
    blocks a replica); a CPU tensor takes `ga_best_plain`."""
    _check_device("ga_best_kernel", x)
    if x.dim() != 3 or x.dtype != torch.int32:
        raise ValueError(f"x must be int32 [R, N, V], got {x.dtype} "
                         f"{tuple(x.shape)}")
    r, n, v = x.shape
    _check_tensor("y", y, (r, n), torch.float32, x.device)
    _check_tensor("best_y", best_y, (r,), torch.float32, x.device)
    _check_tensor("best_x", best_x, (r, v), torch.int32, x.device)
    if x.device.type == "cpu":
        return ga_best_plain(x, y, best_y, best_x, minimize=minimize)
    x, y, best_y, best_x = (t.contiguous() for t in (x, y, best_y, best_x))
    by = torch.empty_like(best_y)
    bx = torch.empty_like(best_x)
    blocks, slice_ = best_split(n)
    lib = kernel_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ga_best_launch(x.data_ptr(), y.data_ptr(),
                                 best_y.data_ptr(), best_x.data_ptr(),
                                 by.data_ptr(), bx.data_ptr(), r, n, v,
                                 int(minimize), blocks, slice_, stream)
    _check_launch(err, "ga_best")
    LAUNCHES["ga_best"] += 1
    return by, bx


def ga_operators_plain(x, y, sel, cross, mut, *, cfg: GAConfig):
    """`ga_operators`' function in plain PyTorch:
    `core.ga.generation_with_y`, the reference's SM, CM and MM."""
    k = torch.zeros(x.shape[:1], dtype=torch.int32, device=x.device)
    st = G.generation_with_y(G.GAState(x, sel, cross, mut, k), y, cfg)
    return st.x, st.sel_lfsr, st.cross_lfsr, st.mut_lfsr


def ga_operators_kernel(x, y, sel, cross, mut, *, cfg: GAConfig
                        ) -> Tuple[torch.Tensor, ...]:
    """(x', sel', cross', mut'): the tournaments, crossover and mutation of
    one generation over a stack [R, ...] scored by y f32[R, N], a block a
    tile of `operators_tiling(N, V, R)` (`ga_operators` in the CUDA
    source); a CPU tensor takes `ga_operators_plain`.  N must be a power
    of two (the tournament indices are the top idx_bits of a draw)."""
    _check_device("ga_operators_kernel", x)
    if cfg.n & (cfg.n - 1):
        raise ValueError(f"N={cfg.n}: ga_operators draws tournament indices "
                         "from the top idx_bits LFSR bits and requires a "
                         "power-of-two N")
    _check_shapes(x, sel, cross, mut, cfg)
    _check_tensor("y", y, x.shape[:2], torch.float32, x.device)
    if x.device.type == "cpu":
        return ga_operators_plain(x, y, sel, cross, mut, cfg=cfg)
    x, y, sel, cross, mut = (t.contiguous() for t in (x, y, sel, cross, mut))
    sel, mut = _aligned8(sel), _aligned8(mut)
    r, n, v = x.shape
    outs = [torch.empty_like(t) for t in (x, sel, cross, mut)]
    tile, chunk = operators_tiling(n, v, r)
    lib = kernel_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ga_operators_launch(
            x.data_ptr(), y.data_ptr(), sel.data_ptr(), cross.data_ptr(),
            mut.data_ptr(), *(t.data_ptr() for t in outs), r, n, v, cfg.c,
            cfg.idx_bits, cfg.cut_bits, min(cfg.p, n), cfg.steps_per_draw,
            int(cfg.minimize), tile, chunk, stream)
    _check_launch(err, "ga_operators")
    LAUNCHES["ga_generation:global"] += 1
    return tuple(outs)


# ga_ffm: its spread form's rastrigin build; ga_ffm:rows<K>: the rows form,
# K rows a thread; ga_ffm:<problem>: the spread form's other builds, and
# rastrigin_sr's rows-form build
GLOBAL_KERNEL_IDS = {"ga_ffm": 0, "ga_operators": 1, "ga_best": 2,
                     "ga_ffm:rows1": 3, "ga_ffm:rows2": 4, "ga_ffm:rows4": 5,
                     "ga_ffm:sphere": 6, "ga_ffm:rosenbrock": 7,
                     "ga_ffm:ackley": 8, "ga_ffm:rastrigin_sr": 9}


def global_kernel_attrs(name: str) -> Dict[str, int]:
    """Registers and local (spill and stack) bytes a thread of the global
    form's kernel `name` (cudaFuncGetAttributes); needs a card."""
    import ctypes
    lib = kernel_library()
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    _check_launch(lib.ga_global_kernel_attrs(
        GLOBAL_KERNEL_IDS[name], ctypes.byref(regs), ctypes.byref(local)),
        f"{name} attributes")
    return {"registers": regs.value, "local_bytes": local.value}


# ---------------------------------------------------------------------------
# The Hopper epoch planner (tier 1: feasibility on this card)
# ---------------------------------------------------------------------------


def epoch_smem_reason(cfg: GAConfig, bits: int = 32,
                      program: Optional[F.FitnessProgram] = None
                      ) -> Optional[str]:
    """None when one island fits a K2/K3 block's shared memory at
    population layout `bits` (K2's: `population_bits(cfg.c)`) with
    `program`'s data, else why."""
    need = epoch_smem_bytes(cfg.n, cfg.v, cfg.p, bits, data_words(program))
    if need > SMEM_LIMIT:
        return (f"N={cfg.n}, V={cfg.v}, P={cfg.p} needs {need} bytes of "
                "shared memory per island block of the epoch kernels, past "
                f"the {SMEM_LIMIT}-byte limit of one Hopper thread block")
    return None


def resident_smem_bytes(cfg: GAConfig, i_local: int,
                        program: Optional[F.FitnessProgram] = None) -> int:
    """Shared memory of one replica's resident epoch: `i_local` K2 blocks
    of `resident_block_bytes`, one cluster (the quantity a planning budget
    weighs, as the JAX package weighs `resident_vmem_bytes`)."""
    return i_local * resident_block_bytes(cfg, program)


def resident_fit_reason(cfg: GAConfig, i_local: int, *, ring: bool = True,
                        budget: Optional[int] = None,
                        program: Optional[F.FitnessProgram] = None
                        ) -> Optional[str]:
    """None when a resident epoch of `i_local` islands runs on Hopper, else
    the limit that refuses it.  One K2 block holds one island, so the block
    must fit a block's shared memory; the ring makes a group's islands one
    thread-block cluster, so with `ring` it also needs i_local <=
    MAX_CLUSTER.  The resident-free mode has no ring and no cluster.  A
    planning `budget` (`EngineOptions.smem_budget`) also refuses a
    replica whose blocks take more than it (`resident_smem_bytes`)."""
    if ring and i_local > MAX_CLUSTER:
        return (f"resident epoch makes the {i_local} islands of a replica "
                "one thread-block cluster for its ring, past the portable "
                f"cluster size of {MAX_CLUSTER} on Hopper")
    reason = epoch_smem_reason(cfg, population_bits(cfg.c), program)
    if reason is None and budget is not None:
        need = resident_smem_bytes(cfg, i_local, program)
        if need > budget:
            reason = (f"resident epoch needs {need} B of shared memory for "
                      f"{i_local} island(s) at N={cfg.n} (> smem_budget "
                      f"{budget} B)")
    return reason


def _build_id(program: Optional[F.FitnessProgram]) -> int:
    """The problem id that picks a kernel's build: rastrigin_sr's for a
    program with data, else a runtime-problem build's (every other
    built-in problem shares those)."""
    if program is not None and program.data is not None:
        return PROBLEM_IDS[program.name]
    return PROBLEM_IDS["F1"]


@functools.lru_cache(maxsize=None)
def _capacity(n: int, v: int, p: int, steps: int, device_index: int,
              problem: int) -> int:
    import ctypes
    lib = kernel_library()
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _check_launch(lib.ga_streamed_capacity(n, v, p, steps, problem,
                                               ctypes.byref(out)),
                      "ga_streamed_epoch occupancy")
    return out.value


def streamed_capacity(cfg: GAConfig, device,
                      program: Optional[F.FitnessProgram] = None) -> int:
    """How many K3 blocks at (N, V, P) in `program`'s build the card
    `device` holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
    times the SMs): the most a cooperative K3 launch may have; needs a
    card."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return _capacity(cfg.n, cfg.v, min(cfg.p, cfg.n), cfg.steps_per_draw,
                     index, _build_id(program))


def streamed_waves(groups: int, islands: int, tile: int,
                   capacity: int) -> int:
    """Launches (waves of whole groups) a ring-inside K3 launch of
    `groups` x `islands / tile` blocks takes on a card that holds
    `capacity` at once; 0 when one group alone does not fit."""
    per_wave = capacity // (islands // tile)
    return -(-groups // per_wave) if per_wave else 0


def tile_for_capacity(groups: int, islands: int, capacity: int) -> int:
    """The least divisor T of `islands` whose groups x islands / T blocks
    the card holds at once; else `islands` (the fewest blocks, whole groups
    in waves)."""
    for t in range(1, islands + 1):
        if islands % t == 0 and groups * (islands // t) <= capacity:
            return t
    return islands


def streamed_tile_islands(cfg: GAConfig, groups: int = 1, islands: int = 1,
                          device=None, budget: Optional[int] = None,
                          program: Optional[F.FitnessProgram] = None
                          ) -> Optional[int]:
    """The streamed lane's island tile for `groups` replica groups of
    `islands` islands: None when one island does not fit a K3 block (or
    the planning `budget`); on a CPU device (no device given counts as the
    CPU) 1, since the plain version ignores the tile; on a card
    `tile_for_capacity` at its `streamed_capacity`.  A K3 block walks its
    tile's islands in turn, so unlike the JAX package's double-buffered
    tile the budget does not bound T.  `program`'s data counts in the
    block."""
    if epoch_smem_reason(cfg, 32, program) is not None:
        return None
    if (budget is not None
            and epoch_smem_bytes(cfg.n, cfg.v, cfg.p, 32,
                                 data_words(program)) > budget):
        return None
    if device is None or torch.device(device).type != "cuda":
        return 1
    return tile_for_capacity(groups, islands,
                             streamed_capacity(cfg, device, program))


def streamed_tile_reason(cfg: GAConfig, groups: int, islands: int,
                         tile: int, device=None,
                         program: Optional[F.FitnessProgram] = None
                         ) -> Optional[str]:
    """None when a pinned streamed tile runs, else why not: it must divide
    the island count, and on a card its blocks must co-reside in no more
    waves than the planner's tile needs."""
    if tile < 1 or islands % tile:
        return (f"stream_tile_islands={tile} is not a feasible tile: it "
                f"must divide the island count {islands}")
    if device is None or torch.device(device).type != "cuda":
        return None
    cap = streamed_capacity(cfg, device, program)
    best = tile_for_capacity(groups, islands, cap)
    waves = streamed_waves(groups, islands, tile, cap)
    if waves == 0 or waves > streamed_waves(groups, islands, best, cap):
        return (f"stream_tile_islands={tile} cannot co-reside: "
                f"{groups} x {islands // tile} blocks of the cooperative "
                f"ring launch, and the card holds {cap} at once; tile "
                f"{best} fits")
    return None


def epoch_mode_candidates(cfg: GAConfig, i_local: int, *, executor: str,
                          migration: str, gens_per_epoch: int,
                          migrate_every: int, groups: int = 1,
                          device=None, sharded: bool = False,
                          budget: Optional[int] = None,
                          program: Optional[F.FitnessProgram] = None
                          ) -> list:
    """The launch shapes an island-ring spec can run on Hopper, ordered so
    candidates[0] is the heuristic choice.  The structure and the order are
    the JAX package's `epoch_mode_candidates` (they decide
    `gens_per_launch`, and so the trajectory's sample count); only the
    feasibility test is this card's (`resident_fit_reason`,
    `streamed_tile_islands` for `groups` replica groups on `device`).
    `i_local` is the islands of one shard; `sharded` (a mesh) turns the
    resident mode into resident-sharded, one interval a launch with the
    boundary elite crossing shards between launches, and offers no
    resident-free.  A planning `budget` in bytes (`EngineOptions.
    smem_budget`) refuses the resident shapes whose blocks exceed it and
    offers the streamed mode where one K3 block fits it, as the JAX
    package's VMEM budget does; None leaves every list as the card's own
    limits give it.  Given the executor's `program`, an island the one-block
    kernels cannot take (`block_reason`: no FFM stage in CUDA, or past a
    block's shared memory) plans gridded only, K1's global form a launch,
    with that reason as the fallback.

    Each candidate is a plan dict: {"mode", "lane", "epochs_per_launch",
    "gens_per_launch"} (+ "fallback", the limit that refused the resident
    shape, + "tile_islands" for the streamed mode)."""
    g_gridded = (min(gens_per_epoch, migrate_every) if executor == "fused"
                 else migrate_every)
    gridded = {"mode": "gridded", "lane": cfg.sel_lane,
               "epochs_per_launch": 1, "gens_per_launch": g_gridded}
    if executor != "fused":
        return [gridded]
    reason = block_reason(cfg, program) if program is not None else None
    if reason is not None:
        return [dict(gridded, fallback=reason)]
    k = max(1, gens_per_epoch // migrate_every)
    if migration == "ring" and gens_per_epoch >= migrate_every:
        reason = resident_fit_reason(cfg, i_local, budget=budget,
                                     program=program)
        if reason is not None:
            tile = streamed_tile_islands(cfg, groups, i_local, device,
                                         budget, program)
            if tile is None:
                return [dict(gridded, fallback=reason)]
            return [{"mode": "streamed", "lane": cfg.sel_lane,
                     "epochs_per_launch": k,
                     "gens_per_launch": k * migrate_every,
                     "tile_islands": tile, "fallback": reason},
                    dict(gridded, fallback=reason)]
        if sharded:
            return [{"mode": "resident-sharded", "lane": cfg.sel_lane,
                     "epochs_per_launch": 1,
                     "gens_per_launch": migrate_every}, gridded]
        return [{"mode": "resident", "lane": cfg.sel_lane,
                 "epochs_per_launch": k,
                 "gens_per_launch": k * migrate_every}, gridded]
    if (migration == "none" and gens_per_epoch > migrate_every
            and not sharded):
        # no ring: gridded stays the heuristic; resident-free (or, past the
        # block, a streamed tile) is offered for plan_override to pick
        reason = resident_fit_reason(cfg, i_local, ring=False,
                                     budget=budget, program=program)
        if reason is not None:
            tile = streamed_tile_islands(cfg, groups, i_local, device,
                                         budget, program)
            out = [dict(gridded, fallback=reason)]
            if tile is not None:
                out.append({"mode": "streamed", "lane": cfg.sel_lane,
                            "epochs_per_launch": k,
                            "gens_per_launch": k * migrate_every,
                            "tile_islands": tile, "fallback": reason})
            return out
        return [gridded,
                {"mode": "resident-free", "lane": cfg.sel_lane,
                 "epochs_per_launch": k, "gens_per_launch": gens_per_epoch}]
    return [gridded]


def max_active_clusters(cfg: GAConfig, i_local: int,
                        program: Optional[F.FitnessProgram] = None,
                        lanes: int = 1) -> int:
    """How many K2 clusters of `i_local` islands at (N, V), K2's layout
    (`population_bits(cfg.c)`), `program`'s build (its data in the block)
    and `lanes` threads a pair (`pair_threads`) the card holds at once
    (cudaOccupancyMaxActiveClusters); needs a card."""
    import ctypes
    lib = kernel_library()
    out = ctypes.c_int(0)
    _check_launch(lib.ga_epoch_max_active_clusters(
        cfg.n, cfg.v, min(cfg.p, cfg.n), cfg.steps_per_draw, i_local,
        population_bits(cfg.c), _build_id(program), lanes,
        ctypes.byref(out)), "ga_epoch occupancy")
    return out.value


def clusters_at_once(cfg: GAConfig, i_local: int, device,
                     program: Optional[F.FitnessProgram] = None,
                     lanes: int = 1) -> Optional[int]:
    """`max_active_clusters` on a card `device`; None elsewhere (the plain
    version has no clusters)."""
    if device is None or torch.device(device).type != "cuda":
        return None
    with torch.cuda.device(torch.device(device)):
        return max_active_clusters(cfg, i_local, program, lanes)


def two_lanes_fit(cfg: GAConfig,
                  program: Optional[F.FitnessProgram] = None) -> bool:
    """Whether K2 has a two-lane build for `cfg` and `program`: its 16-bit
    layout (`population_bits`) without problem data, and a block of one
    thread an individual that every lane fills and `MAX_THREADS` holds,
    32 <= N <= 512 (N a multiple of 32)."""
    return (population_bits(cfg.c) == 16 and data_words(program) == 0
            and 32 <= cfg.n <= MAX_THREADS and cfg.n % 32 == 0)


def pair_threads(cfg: GAConfig, islands: int, device,
                 program: Optional[F.FitnessProgram] = None) -> int:
    """Threads a pair K2 runs with: 2 (one thread an individual, twice
    the warps a block of pairs has) where `two_lanes_fit` and the card
    `device` holds at least as many clusters of `islands` islands (at most
    `MAX_CLUSTER`: the resident-free mode has no cluster, and this
    stands for how many of its blocks co-reside) of the two-lane block at
    once as of the pair block (`clusters_at_once`), else 1.  Off a card
    there is no occupancy to weigh and `two_lanes_fit` decides (the plain
    version runs either way)."""
    if not two_lanes_fit(cfg, program):
        return 1
    k = min(islands, MAX_CLUSTER)
    pair = clusters_at_once(cfg, k, device, program, 1)
    two = clusters_at_once(cfg, k, device, program, 2)
    return 2 if pair is None or two >= pair else 1


KERNEL_IDS = {"ga_generation": 0, "ga_epoch": 1, "ga_streamed_epoch": 2}


def kernel_attrs(name: str, cfg: GAConfig,
                 program: Optional[F.FitnessProgram] = None,
                 lanes: Optional[int] = None) -> Dict[str, int]:
    """Kernel `name` as built for `cfg`'s clocks a draw (3 has its own
    build), its population layout (K2: `population_bits(cfg.c)`; K1, K3:
    32), `program`'s problem (rastrigin_sr's builds hold its data; every
    other problem shares one build) and its threads a pair (K2: `lanes`,
    by default `pair_threads` at clusters of `MAX_CLUSTER`; K1, K3: 1), at
    `cfg`'s block shape: registers and local (spill and stack) bytes a
    thread (cudaFuncGetAttributes), the blocks an SM holds
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the threads a block,
    the threads a pair, the layout's bits and the bytes a block; needs a
    card."""
    import ctypes
    lib = kernel_library()
    bits = population_bits(cfg.c) if name == "ga_epoch" else 32
    if name != "ga_epoch":
        lanes = 1
    elif lanes is None:
        lanes = pair_threads(cfg, MAX_CLUSTER,
                             torch.device("cuda", torch.cuda.current_device()),
                             program)
    p = min(cfg.p, cfg.n)
    regs, local, blocks = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    _check_launch(lib.ga_step_kernel_attrs(
        KERNEL_IDS[name], cfg.n, cfg.v, p, cfg.steps_per_draw, bits,
        _build_id(program), lanes, ctypes.byref(regs), ctypes.byref(local),
        ctypes.byref(blocks)),
        f"{name} attributes")
    data = data_words(program)
    smem = (smem_bytes(cfg.n, cfg.v, p, data) if name == "ga_generation"
            else epoch_smem_bytes(cfg.n, cfg.v, p, bits, data))
    return {"registers": regs.value, "local_bytes": local.value,
            "blocks_per_sm": blocks.value,
            "threads": lib.ga_step_threads(cfg.n, lanes),
            "pair_threads": lanes, "population_bits": bits,
            "smem_bytes": smem}


# ---------------------------------------------------------------------------
# K2: resident epochs
# ---------------------------------------------------------------------------


def ga_epoch_plain(x, sel, cross, mut, *, cfg: GAConfig,
                   program: F.FitnessProgram, migrate_every: int,
                   intervals: int = 1, boundary: bool = False,
                   migrate: bool = True) -> Tuple[torch.Tensor, ...]:
    """K2's function in plain PyTorch, on any device: per interval,
    `migrate_every` generations of every island with the interval's best
    folded per generation, the migration fitness of the final populations
    (`program.stage`), then `islands.ring_migrate_stack` — or nothing
    (`migrate=False`), or the partial ring of `boundary` (islands 1..I-1
    take elites 0..I-2; island I-1's elite and island 0's worst slot are
    returned instead).  Takes what the wrapper validated."""
    mini = cfg.minimize
    lead = x.shape[:2]
    state = G.GAState(x, sel, cross, mut,
                      torch.zeros(lead, dtype=torch.int32, device=x.device))
    bys, bxs, extra = [], [], ()
    for _ in range(intervals):
        by = torch.full(lead, math.inf if mini else -math.inf,
                        dtype=torch.float32, device=x.device)
        bx = torch.zeros(lead + (cfg.v,), dtype=torch.int32, device=x.device)
        for _ in range(migrate_every):
            nxt, y = G.generation(state, cfg, program.stage)
            gb, gx = G.gen_best(state.x, y, mini)
            by, bx = G.fold_best(by, bx, gb, gx, mini)
            state = nxt
        bys.append(by)
        bxs.append(bx)
        ymig = program.stage(state.x)
        if boundary:
            elite_x, _ = ISL.elites_stack(state.x, ymig, minimize=mini)
            widx = ISL.worst_slot(ymig, minimize=mini)
            not_first = (torch.arange(lead[1], device=x.device) >= 1)
            xs = ISL.splice_at(state.x, widx, torch.roll(elite_x, 1, dims=-2),
                               island_mask=not_first.unsqueeze(-1))
            state = state._replace(x=xs)
            extra = (elite_x[:, -1], widx[:, 0].to(torch.int32))
        elif migrate:
            xs, _, _ = ISL.ring_migrate_stack(state.x, ymig, minimize=mini)
            state = state._replace(x=xs)
    return (state.x, state.sel_lfsr, state.cross_lfsr, state.mut_lfsr, ymig,
            torch.stack(bys), torch.stack(bxs)) + extra


def _check_epoch(name, x, sel, cross, mut, cfg, program, migrate_every,
                 intervals, bits) -> None:
    _check_device(name, x)
    check_kernel_lane(cfg, program)
    _check_shapes(x, sel, cross, mut, cfg, lead="GI")
    if migrate_every < 1 or intervals < 1:
        raise ValueError(f"migrate_every and intervals must be >= 1, got "
                         f"{migrate_every} and {intervals}")
    reason = epoch_smem_reason(cfg, bits, program)
    if reason is not None:
        raise ValueError(reason)


def ga_epoch_kernel(x, sel, cross, mut, *, cfg: GAConfig,
                    program: F.FitnessProgram, migrate_every: int,
                    intervals: int = 1, boundary: bool = False,
                    migrate: bool = True, lanes: Optional[int] = None
                    ) -> Tuple[torch.Tensor, ...]:
    """Resident epochs over replica-stacked island groups (see the module
    docstring for the contract).  `migrate=False` is the resident-free mode
    (no ring, no cluster); `boundary=True` needs the ring and one interval.
    With the ring, the I islands of a group form one thread-block cluster,
    so I <= MAX_CLUSTER.  At c <= 16 the kernel holds the population as
    16-bit words (`population_bits`), which takes x's words below 2^16, as
    every producer in the port makes them.  `lanes`, the threads a pair (1,
    or 2 where `two_lanes_fit`), picks the build, by default by
    `pair_threads` (a plan passes its own); the outputs are the same bit
    for bit."""
    bits = population_bits(cfg.c)
    _check_epoch("ga_epoch_kernel", x, sel, cross, mut, cfg, program,
                 migrate_every, intervals, bits)
    if boundary and (not migrate or intervals != 1):
        raise ValueError("boundary epochs exchange elites between launches: "
                         "they need migrate=True and one interval")
    g_grid, i_islands = x.shape[:2]
    if migrate and i_islands > MAX_CLUSTER:
        raise ValueError(
            f"the ring of {i_islands} islands would be one thread-block "
            f"cluster past the portable size of {MAX_CLUSTER}; run the "
            "streamed or gridded plan")
    if lanes not in (None, 1, 2) or (
            lanes == 2 and not two_lanes_fit(cfg, program)):
        raise ValueError(
            f"lanes={lanes}: K2 runs 1 thread a pair, or 2 only in its "
            "16-bit build without problem data at 32 <= N <= "
            f"{MAX_THREADS}")
    if x.device.type == "cpu":
        return ga_epoch_plain(x, sel, cross, mut, cfg=cfg, program=program,
                              migrate_every=migrate_every,
                              intervals=intervals, boundary=boundary,
                              migrate=migrate)
    x, sel, cross, mut = (t.contiguous() for t in (x, sel, cross, mut))
    n, v = cfg.n, cfg.v
    dev = x.device
    if lanes is None:
        lanes = pair_threads(cfg, i_islands, dev, program)
    lo, span = program.device_consts(dev)
    outs = [torch.empty_like(t) for t in (x, sel, cross, mut)]
    y = torch.empty((g_grid, i_islands, n), dtype=torch.float32, device=dev)
    by = torch.empty((intervals, g_grid, i_islands), dtype=torch.float32,
                     device=dev)
    bx = torch.empty((intervals, g_grid, i_islands, v), dtype=torch.int32,
                     device=dev)
    send = torch.empty((g_grid, v), dtype=torch.int32, device=dev)
    w0 = torch.empty((g_grid,), dtype=torch.int32, device=dev)
    lib = kernel_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ga_epoch_launch(
            x.data_ptr(), sel.data_ptr(), cross.data_ptr(), mut.data_ptr(),
            *(t.data_ptr() for t in outs), y.data_ptr(), by.data_ptr(),
            bx.data_ptr(), send.data_ptr(), w0.data_ptr(), lo.data_ptr(),
            span.data_ptr(), _data_ptr(program, dev), g_grid, i_islands, n,
            v, cfg.c, cfg.idx_bits,
            cfg.cut_bits, min(cfg.p, n), cfg.steps_per_draw,
            int(cfg.minimize),
            problem_id(program), migrate_every, intervals, int(migrate),
            int(boundary), bits, lanes, stream)
    _check_launch(err, "ga_epoch")
    LAUNCHES["ga_epoch"] += 1
    if boundary:
        FORM_LAUNCHES["ga_epoch:boundary"] += 1
    return tuple(outs) + (y, by, bx) + ((send, w0) if boundary else ())


# ---------------------------------------------------------------------------
# K3: streamed epochs
# ---------------------------------------------------------------------------


def _streamed_pass(x, sel, cross, mut, *, cfg, program, migrate_every,
                   migrate):
    """One interval of every island (K2's function without a ring) and,
    with `migrate`, the pre-splice elites and worst slots."""
    out = ga_epoch_plain(x, sel, cross, mut, cfg=cfg, program=program,
                         migrate_every=migrate_every, migrate=False)
    out = out[:5] + (out[5][0], out[6][0])       # the one interval's best
    if not migrate:
        return out
    x2, ymig = out[0], out[4]
    elite_x, _ = ISL.elites_stack(x2, ymig, minimize=cfg.minimize)
    widx = ISL.worst_slot(ymig, minimize=cfg.minimize).to(torch.int32)
    return out + (elite_x, widx)


def ga_streamed_epoch_plain(x, sel, cross, mut, *, cfg: GAConfig,
                            program: F.FitnessProgram, migrate_every: int,
                            tile_islands: int = 1, migrate: bool = True,
                            intervals: int = 1, splice: bool = False
                            ) -> Tuple[torch.Tensor, ...]:
    """K3's function in plain PyTorch, on any device.  Without `splice`: one
    interval of every island and, with `migrate`, the pre-splice elites and
    worst slots of the migration rule set.  With `splice`: `intervals` such
    passes, each followed (with `migrate`) by the splice of the elites,
    shifted by one island, into the worst slots; returns K2's outputs.  The
    tile is a launch shape only and changes nothing here."""
    run = dict(cfg=cfg, program=program, migrate_every=migrate_every,
               migrate=migrate)
    if not splice:
        return _streamed_pass(x, sel, cross, mut, **run)
    bys, bxs = [], []
    for _ in range(intervals):
        out = _streamed_pass(x, sel, cross, mut, **run)
        x, sel, cross, mut, ymig, by, bx = out[:7]
        if migrate:
            elite, widx = out[7:]
            x = ISL.splice_at(x, widx, torch.roll(elite, 1, dims=-2))
        bys.append(by)
        bxs.append(bx)
    return (x, sel, cross, mut, ymig, torch.stack(bys), torch.stack(bxs))


def ga_streamed_epoch_kernel(x, sel, cross, mut, *, cfg: GAConfig,
                             program: F.FitnessProgram, migrate_every: int,
                             tile_islands: int = 1, migrate: bool = True,
                             intervals: int = 1, splice: bool = False
                             ) -> Tuple[torch.Tensor, ...]:
    """Streamed epochs of [G, I, ...] stacks, one block walking
    `tile_islands` islands (see the module docstring for the contract).
    Without `splice` (the TPU kernel's form) one interval, and the caller
    splices the returned elites, shifted by one island, into the worst
    slots.  With `splice`, `intervals` intervals and the ring inside the
    kernel: a cooperative launch whose blocks must co-reside, whole groups
    in waves the card holds (`streamed_waves`); a group whose blocks do not
    fit raises."""
    _check_epoch("ga_streamed_epoch_kernel", x, sel, cross, mut, cfg,
                 program, migrate_every, intervals, 32)
    g_grid, i_islands = x.shape[:2]
    if tile_islands < 1 or i_islands % tile_islands:
        raise ValueError(f"tile_islands={tile_islands} must divide the "
                         f"island count {i_islands}")
    if not splice and intervals != 1:
        raise ValueError("without splice=True a streamed launch runs one "
                         f"interval, got intervals={intervals}")
    if x.device.type == "cpu":
        return ga_streamed_epoch_plain(x, sel, cross, mut, cfg=cfg,
                                       program=program,
                                       migrate_every=migrate_every,
                                       tile_islands=tile_islands,
                                       migrate=migrate, intervals=intervals,
                                       splice=splice)
    ring = migrate and splice
    waves = 1
    if ring:
        cap = streamed_capacity(cfg, x.device, program)
        waves = streamed_waves(g_grid, i_islands, tile_islands, cap)
        if waves == 0:
            raise ValueError(
                f"a group's {i_islands // tile_islands} blocks at "
                f"tile_islands={tile_islands} cannot co-reside: the card "
                f"holds {cap} K3 blocks at once")
    x, sel, cross, mut = (t.contiguous() for t in (x, sel, cross, mut))
    n, v = cfg.n, cfg.v
    dev = x.device
    lo, span = program.device_consts(dev)
    outs = [torch.empty_like(t) for t in (x, sel, cross, mut)]
    y = torch.empty((g_grid, i_islands, n), dtype=torch.float32, device=dev)
    lead = (intervals, g_grid, i_islands)
    by = torch.empty(lead, dtype=torch.float32, device=dev)
    bx = torch.empty(lead + (v,), dtype=torch.int32, device=dev)
    ex = torch.empty(((2,) if splice else ()) + (g_grid, i_islands, v),
                     dtype=torch.int32, device=dev)
    wi = torch.empty((g_grid, i_islands), dtype=torch.int32, device=dev)
    # the group barriers' counters, zero at launch
    arrived = (torch.zeros((g_grid,), dtype=torch.int32, device=dev)
               if ring else None)
    lib = kernel_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ga_streamed_launch(
            x.data_ptr(), sel.data_ptr(), cross.data_ptr(), mut.data_ptr(),
            *(t.data_ptr() for t in outs), y.data_ptr(), by.data_ptr(),
            bx.data_ptr(), ex.data_ptr(), wi.data_ptr(),
            arrived.data_ptr() if ring else None,
            lo.data_ptr(), span.data_ptr(), _data_ptr(program, dev), g_grid,
            i_islands, tile_islands,
            n, v, cfg.c, cfg.idx_bits, cfg.cut_bits, min(cfg.p, n),
            cfg.steps_per_draw, int(cfg.minimize), problem_id(program),
            migrate_every, intervals, int(migrate), int(splice),
            -(-g_grid // waves), stream)
    _check_launch(err, "ga_streamed_epoch")
    LAUNCHES["ga_streamed_epoch"] += waves
    if not splice:
        FORM_LAUNCHES["ga_streamed_epoch:one-interval"] += waves
    if splice:
        return tuple(outs) + (y, by, bx)
    return tuple(outs) + (y, by[0], bx[0]) + ((ex, wi) if migrate else ())
