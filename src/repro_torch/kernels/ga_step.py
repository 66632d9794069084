"""K1: fused GA generations per replica — the CUDA kernel and its plain twin.

`ga_generation_kernel` is the wrapper the fused executor calls.  On a CUDA
tensor it launches ``csrc/ga_step.cu`` (built on first use by
`repro_torch.kernels.build`) and counts the launch in ``LAUNCHES``; on a CPU
tensor it runs `ga_generation_plain`, the same function in plain PyTorch
built from the port's `core.ga` operators and the program's `stage`.  There
is no fallback between the two: a call the kernel cannot take raises, on
either device, so the CPU path accepts exactly what the card does.

Contract (the JAX package's `ga_generation_kernel`, on int32 words):
x int32[R, N, V], sel int32[R, 2, N], cross int32[R, V, N/2],
mut int32[R, V, N] -> (x', sel', cross', mut', y f32[R, N]) where y is the
fitness of the last pre-update population; `track_best` appends
(best_y f32[R], best_x int32[R, V]), the best over all `gens` generations
with strict improvement and the first-occurrence tie rule.

The kernel holds one replica per thread block with its whole state in
shared memory (see the note at the top of the CUDA source), so (N, V) must
fit `SMEM_LIMIT`; `hopper_reason` says why a shape or a fitness cannot run.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import fitness as F
from repro_torch.core import ga as G
from repro_torch.core.ga import GAConfig, ONEHOT_MAX_N

# launches of each kernel made by its wrapper (plain-version calls excluded)
LAUNCHES: Dict[str, int] = {"ga_generation": 0}

SMEM_LIMIT = 232448            # bytes of shared memory a Hopper block can use

# the built-in problems the kernel's FFM stage implements, by kernel id
PROBLEM_IDS = {"F1": 0, "F2": 1, "F3": 2, "sphere": 3, "rastrigin": 4,
               "rosenbrock": 5, "ackley": 6}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def smem_bytes(n: int, v: int) -> int:
    """Shared memory one block takes for a replica of shape (N, V): the
    population and offspring, the fitness vector, the three LFSR banks, the
    decode constants, the best individual and the reduction scratch (the
    layout in ``csrc/ga_step.cu``)."""
    return 4 * (2 * n * v + n + 2 * n + v * (n // 2) + v * n + 3 * v + 2
                + 64)


def problem_id(program: F.FitnessProgram) -> Optional[int]:
    """Kernel id of the program's fitness, or None when the kernel has no
    FFM stage for it (a blackbox, or a problem registered by the user —
    also under a built-in name)."""
    pid = PROBLEM_IDS.get(program.name)
    builtin = F.BUILTIN.get(program.name)
    if pid is None or builtin is None or program.fn is not builtin.fn:
        return None
    return pid


def hopper_reason(cfg: GAConfig, program: F.FitnessProgram) -> Optional[str]:
    """None if the CUDA kernel can run this (config, program), else why.

    The tournament indices are the top `idx_bits` of the LFSR draw, so N
    must be a power of two on any lane; a pinned onehot lane keeps the JAX
    package's N cap so a spec validates the same way in both packages; the
    fitness needs an FFM stage in the kernel; the replica's state must fit
    a block's shared memory."""
    if cfg.n & (cfg.n - 1):
        return (f"N={cfg.n}: the fused kernel path draws tournament indices "
                "from the top idx_bits LFSR bits and requires a power-of-two "
                "N (the reference backend accepts any even N)")
    if cfg.sel_lane == "onehot" and cfg.n > ONEHOT_MAX_N:
        return (f"N={cfg.n} > {ONEHOT_MAX_N} on the 'onehot' selection "
                "lane, the JAX package's cap for its (N, N) one-hot "
                "tournament matrices; switch to the dynamic-indexing lane "
                "with sel_lane='gather'")
    if problem_id(program) is None:
        return (f"no Hopper FFM stage for this fitness ({program.name!r}): "
                "the CUDA kernel implements the built-in problems "
                f"{sorted(PROBLEM_IDS)}; blackbox and user-registered "
                "fitness run on 'reference'")
    need = smem_bytes(cfg.n, cfg.v)
    if need > SMEM_LIMIT:
        return (f"N={cfg.n}, V={cfg.v} needs {need} bytes of shared memory "
                f"per replica, past the {SMEM_LIMIT}-byte limit of one "
                "Hopper thread block (the kernel keeps a replica's whole "
                "state in shared memory); use a smaller N or V, or "
                "'reference'")
    return None


def check_kernel_lane(cfg: GAConfig, program: F.FitnessProgram) -> None:
    """The kernel's validity gate: raises `hopper_reason`'s reason."""
    reason = hopper_reason(cfg, program)
    if reason is not None:
        raise ValueError(reason)


def _check_shapes(x, sel, cross, mut, cfg: GAConfig) -> None:
    if x.dim() != 3 or tuple(x.shape[1:]) != (cfg.n, cfg.v):
        raise ValueError(f"x must be [R, {cfg.n}, {cfg.v}], got "
                         f"{tuple(x.shape)}")
    r = x.shape[0]
    want = {"sel": (sel, (r, 2, cfg.n)),
            "cross": (cross, (r, cfg.v, cfg.n // 2)),
            "mut": (mut, (r, cfg.v, cfg.n))}
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


@functools.lru_cache(maxsize=None)
def kernel_library():
    """The built ``ga_step`` library with its C signatures declared."""
    import ctypes

    from repro_torch.kernels import build
    lib = build.load("ga_step")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ga_step_launch.argtypes = [p] * 13 + [i] * 12 + [p]
    lib.ga_step_launch.restype = i
    lib.ga_step_smem_bytes.argtypes = [i, i]
    lib.ga_step_smem_bytes.restype = ctypes.c_size_t
    lib.ga_step_smem_limit.argtypes = []
    lib.ga_step_smem_limit.restype = i
    lib.ga_step_error_string.argtypes = [i]
    lib.ga_step_error_string.restype = ctypes.c_char_p
    return lib


def ga_generation_kernel(x, sel, cross, mut, *, cfg: GAConfig,
                         program: F.FitnessProgram, gens: int = 1,
                         track_best: bool = False
                         ) -> Tuple[torch.Tensor, ...]:
    """Run `gens` fused generations over a stack of replicas (see the
    module docstring for the contract).  What the kernel cannot take is
    rejected on every device; then CPU tensors take the plain version and
    CUDA tensors launch the kernel."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ga_generation_kernel takes CPU or CUDA tensors, "
                         f"got {x.device}")
    check_kernel_lane(cfg, program)
    _check_shapes(x, sel, cross, mut, cfg)
    if gens < 1:
        raise ValueError(f"gens must be >= 1, got {gens}")
    if x.device.type == "cpu":
        return ga_generation_plain(x, sel, cross, mut, cfg=cfg,
                                   program=program, gens=gens,
                                   track_best=track_best)
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
            r, n, v, cfg.c, cfg.idx_bits, cfg.cut_bits, cfg.p,
            cfg.steps_per_draw, int(cfg.minimize), problem_id(program), gens,
            int(track_best), stream)
    if err != 0:
        raise RuntimeError(
            f"ga_step kernel launch failed: CUDA error {err} "
            f"({lib.ga_step_error_string(err).decode()})")
    LAUNCHES["ga_generation"] += 1
    return tuple(outs) + (y,) + ((by, bx) if track_best else ())
