"""The work a generation needs, counted from the shapes alone.

These counts are the benchmark's yardstick for a generation's least time
on one H100: bytes at the published HBM rate, operations at the published
float32 rate outside the tensor cores.  They depend on the algorithm's
shapes (replicas R, population N, variables V, bits c, mutated rows P,
clocks a draw, problem, generations) and on nothing a kernel chooses, so
a later change that fuses, splits or removes a kernel leaves them as they
are.  The per-kernel counts (`island_ops`, `k1_bound`, `global_bounds`)
are the ones the port's smoke script states its kernel bounds with,
frozen here so that the yardstick cannot move with the program.

A configuration file names its yardstick (`"work"`, this file where
absent).  The harness asks it for `generations_bound`, `launch_unit`,
`form` and `KERNELS`, and prints its `HBM_BYTES_PER_S` and `OPS_PER_S`
beside the least time; this one knows K1 over one population a replica.
"""

from __future__ import annotations

import numpy as np

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, and the
# float32 rate outside the tensor cores, against which every integer and
# float operation is counted (a generous rate, so a low bound).
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# Per-SM rates by op class (CUDA C++ Programming Guide, compute capability
# 9.0), results a cycle an SM: 32-bit integer shifts, logic, min and
# select; float32 add, multiply and compare; conversions and MUFU; and the
# issue limit of four schedulers at one warp instruction a cycle.
CLASS_PER_CLK = {"int32": 64, "fp32": 128, "slow": 16}
ISSUE_PER_CLK = 128
SMS = 132
MAX_SM_CLOCK_HZ = 1980e6

# shared memory one Hopper thread block can use
SMEM_LIMIT = 232448


def ffm_ops(problem: str, v: int):
    """(float32, slow) operations of one fitness evaluation beyond the
    decode; cos, exp, sqrt and a division count as one slow op each."""
    return {"F1": (5, 0), "F2": (4, 0), "F3": (4, 1),
            "sphere": (2 * v - 1, 0), "rastrigin": (6 * v - 1, v),
            "rosenbrock": (8 * (v - 1) - 1, 0),
            "ackley": (4 * v + 5, v + 5)}[problem]


# One precise libdevice call, as (int32, fp32, slow) instructions of its
# fast path in sm_90a SASS built with -fmad=false.
SASS_COS = (8, 15, 2)
SASS_EXP = (1, 6, 1)
SASS_SQRT = (3, 4, 1)
SASS_DIV = (2, 5, 1)


def ffm_sass_ops(problem: str, v: int) -> np.ndarray:
    """(int32, fp32, slow) instructions of one evaluation beyond the
    decode, each cos, exp, sqrt and division counted as its SASS."""
    f32, slow = ffm_ops(problem, v)
    calls = {"F3": (SASS_SQRT,), "rastrigin": (SASS_COS,) * v,
             "ackley": (SASS_COS,) * v + (SASS_DIV, SASS_DIV, SASS_SQRT,
                                          SASS_EXP, SASS_EXP)
             }.get(problem, ())
    ops = np.array([0.0, f32, slow - len(calls)])
    for c in calls:
        ops += c
    return ops


def advance_ops(t: int) -> int:
    """int32 instructions of one LFSR word's advance by t clocks in the
    word-parallel form, up to 22 clocks a pass."""
    ops = 0
    while t > 0:
        k = min(t, 22)
        ops += 13 + 2 * (k > 4) + 2 * (k > 10)
        t -= k
    return ops


# a mutation word past P advanced through the table of each nibble's
# advance: 8 indices (7 shifts, 8 masks) and the XOR of 8 words (4 LOP3)
NIBBLE_OPS = 19


def island_ops(shape, gens: int, evals: int, migrations: int) -> np.ndarray:
    """int32, float32 and slow operations of one replica's launch of
    `gens` generations with `evals` evaluations and `migrations` scans:
    the draws of the selection and crossover banks and of the mutation
    rows below P, tournaments, crossover, mutation, evaluations (decode,
    objective, a compare for the best fold), and the mutation rows past P
    advanced once through the nibble table, built once a launch."""
    n, v, steps = shape.n, shape.v, shape.steps_per_draw
    half, p = n // 2, min(shape.p, n)
    f32, slow = ffm_ops(shape.problem, v)
    words = 2 * n + v * half + v * p
    i32 = (gens * (words * advance_ops(steps) + 3 * n + half * v * 5
                   + p * v * 2)
           + evals * n * v + migrations * 2 * v
           + v * (n - p) * NIBBLE_OPS + 128 * advance_ops(steps * gens))
    fp = gens * n + evals * n * (2 * v + f32 + 1) + migrations * 2 * n
    sl = evals * n * (v + slow)
    return np.array([i32, fp, sl], dtype=np.float64)


def bound(nbytes: float, ops, clock_hz: float = MAX_SM_CLOCK_HZ) -> dict:
    """The least time two ways: the larger of the bytes over HBM and all
    operations over the float32 rate (`bound_ms`, the yardstick); and the
    larger of the bytes and the op classes over their per-SM rates
    (`class_bound_ms`, information only)."""
    ops = np.asarray(ops, dtype=np.float64)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, float(ops.sum()) / OPS_PER_S
    cyc = {k: float(o) / r for (k, r), o in zip(CLASS_PER_CLK.items(), ops)}
    cyc["issue"] = float(ops.sum()) / ISSUE_PER_CLK
    by = max(cyc, key=cyc.get)
    t_cls = cyc[by] / SMS / clock_hz
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "class_bound_ms": max(t_bytes, t_cls) * 1e3,
            "class_bound_by": "bytes" if t_bytes >= t_cls else by,
            "bytes": float(nbytes),
            "ops": dict(zip(("int32", "fp32", "slow"), ops.tolist()))}


def state_bytes(shape, replicas: int) -> int:
    """One read and one write of the replicas' state, their y and best,
    and the decode constants (a K1 launch's bytes)."""
    n, v = shape.n, shape.v
    return replicas * (2 * 4 * shape.state_words + 4 * n + 4 + 4 * v) + 8 * v


def k1_bound(shape, replicas: int, gens: int,
             clock_hz: float = MAX_SM_CLOCK_HZ) -> dict:
    """Least time of one launch of K1's one-block form of `gens`
    generations."""
    return bound(state_bytes(shape, replicas),
                 replicas * island_ops(shape, gens, gens, 0), clock_hz)


def global_bounds(shape, replicas: int,
                  clock_hz: float = MAX_SM_CLOCK_HZ) -> dict:
    """Least time of one launch of each kernel of K1's global form."""
    n, v, steps = shape.n, shape.v, shape.steps_per_draw
    half, p = n // 2, min(shape.p, n)
    drawn = 2 * n + v * half + v * n
    ffm = ffm_sass_ops(shape.problem, v)
    return {
        "ga_operators": bound(
            replicas * (2 * 4 * shape.state_words + 4 * n),
            replicas * np.array([drawn * advance_ops(steps) + 3 * n
                                 + 5 * half * v + 2 * p * v, n, 0.0]),
            clock_hz),
        "ga_ffm": bound(
            replicas * (4 * n * v + 4 * n) + 8 * v,
            replicas * n * (np.array([v, 2 * v, v], dtype=np.float64)
                            + ffm), clock_hz),
        "ga_best": bound(
            replicas * (4 * n + 2 * 4 * (1 + v) + 4 * v),
            replicas * np.array([n, 2 * n, 0.0], dtype=np.float64),
            clock_hz),
    }


def one_block_bytes(shape) -> int:
    """Shared memory one replica takes when a block holds it: population
    and fitness double buffered, the selection and crossover banks, the
    mutation rows below P where they fit, decode constants, best and
    scratch."""
    n, v = shape.n, shape.v
    base = 4 * (2 * n * v + 4 * n + v * (n // 2) + 3 * v + 2 + 2 * 64)
    rows = base + 4 * v * min(shape.p, n)
    return rows if rows <= SMEM_LIMIT else base


# the GA's kernels, as the profiler's names for them contain them
KERNELS = ("ga_generation", "ga_ffm", "ga_operators", "ga_best",
           "ga_epoch", "ga_streamed_epoch")


def form(shape) -> str:
    """K1's form for these shapes: "block" where a block's shared memory
    holds a replica, else "global"."""
    return "block" if one_block_bytes(shape) <= SMEM_LIMIT else "global"


def launch_unit(shape, spec: dict) -> int:
    """Generations a replica's state may stay on chip between one read and
    one write of it: the spec's `gens_per_epoch` where a block's shared
    memory holds the replica, else 1 (the state goes through HBM every
    generation)."""
    return spec["gens_per_epoch"] if form(shape) == "block" else 1


def generations_bound(shape, replicas: int, gens: int, unit: int,
                      clock_hz: float = MAX_SM_CLOCK_HZ) -> dict:
    """Least time of `gens` generations of `replicas` replicas in launch
    units of `unit` generations.  Bytes: the state read once and written
    once a unit, and the best (value and chromosome) likewise; y lives
    only inside a generation and is not counted.  Operations: a unit's
    as `island_ops` counts them, with each evaluation's objective counted
    as its SASS (`ffm_sass_ops`)."""
    full, rem = divmod(gens, unit)
    v = shape.v
    nbytes = (full + (rem > 0)) * replicas * (2 * 4 * shape.state_words
                                              + 2 * 4 * (1 + v))
    f32, slow = ffm_ops(shape.problem, v)
    per_eval = ffm_sass_ops(shape.problem, v) - np.array([0.0, f32, slow])
    ops = full * island_ops(shape, unit, unit, 0) + gens * shape.n * per_eval
    if rem:
        ops = ops + island_ops(shape, rem, rem, 0)
    ops = replicas * ops
    return bound(nbytes, ops, clock_hz)
