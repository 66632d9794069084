"""The LFSR-32 kernels of ``csrc/lfsr_advance.cu``, each beside its plain
twin: K4 and the initial state's seed words.

`lfsr_advance_kernel(state, steps)` (K4) advances every lane of an int32
word tensor (uint32 bit patterns, any shape) by `steps` clocks of the
paper's polynomial.  No engine path calls it: like the JAX package's
`lfsr_advance_kernel`, it is a standalone bulk kernel.

`seed_state_kernel(n, v, c, seeds, device=)` builds a stack of initial
GA states, one a seed (`core.ga.init_states`' leaves).  It has no Pallas
counterpart: the JAX package derives the seed words with NumPy on the
host, and `seed_state_plain` is that derivation.  On a card the kernel is
the port's form of the same function, one launch for the whole stack, and
gives the same words.

On a CUDA device each wrapper launches its kernel and counts the launch in
``LAUNCHES``; on the CPU it runs the plain twin.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import lfsr

# launches made by the wrappers (plain-version calls excluded)
LAUNCHES: Dict[str, int] = {"lfsr_advance": 0, "seed_state": 0}


def lfsr_advance_plain(state: torch.Tensor, steps: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device."""
    return lfsr.steps(state, steps)


def kernel_library():
    """The built ``lfsr_advance`` library with its C signatures declared,
    built and bound once per process (`build.library`)."""
    from repro_torch.kernels import build
    return build.library("lfsr_advance", _declare)


def _declare(lib) -> None:
    import ctypes
    p = ctypes.c_void_p
    lib.lfsr_advance_launch.argtypes = [p, p, ctypes.c_longlong,
                                        ctypes.c_int, p]
    lib.lfsr_advance_launch.restype = ctypes.c_int
    lib.lfsr_advance_attrs.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    lib.lfsr_advance_attrs.restype = ctypes.c_int
    lib.seed_state_launch.argtypes = [p, ctypes.c_int, ctypes.c_longlong,
                                      ctypes.c_longlong, ctypes.c_int,
                                      p, p, p, p, p, p]
    lib.seed_state_launch.restype = ctypes.c_int
    lib.lfsr_advance_error_string.argtypes = [ctypes.c_int]
    lib.lfsr_advance_error_string.restype = ctypes.c_char_p


def kernel_attrs() -> Dict[str, int]:
    """The kernel as compiled: registers and local (spill and stack) bytes
    a thread, and the blocks of 256 threads an SM holds; needs a card."""
    import ctypes
    lib = kernel_library()
    regs, local, blocks = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    err = lib.lfsr_advance_attrs(ctypes.byref(regs), ctypes.byref(local),
                                 ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"lfsr_advance attributes: CUDA error {err} "
                           f"({lib.lfsr_advance_error_string(err).decode()})")
    return {"registers": regs.value, "local_bytes": local.value,
            "blocks_per_sm": blocks.value, "threads": 256}


def lfsr_advance_kernel(state: torch.Tensor, steps: int) -> torch.Tensor:
    """Advance every lane of `state` (int32 words, any shape) `steps`
    clocks.  CPU tensors take the plain version, CUDA tensors launch the
    kernel; anything else raises."""
    if state.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lfsr_advance_kernel takes CPU or CUDA tensors, "
                         f"got {state.device}")
    if state.dtype != torch.int32:
        raise TypeError(f"state must hold int32 words, got {state.dtype}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if state.device.type == "cpu":
        return lfsr_advance_plain(state, steps)
    src = state.contiguous()
    out = torch.empty_like(src)
    if src.numel() == 0:
        return out
    lib = kernel_library()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = lib.lfsr_advance_launch(src.data_ptr(), out.data_ptr(),
                                      src.numel(), steps, stream)
    if err != 0:
        raise RuntimeError(
            f"lfsr_advance kernel launch failed: CUDA error {err} "
            f"({lib.lfsr_advance_error_string(err).decode()})")
    LAUNCHES["lfsr_advance"] += 1
    return out


def state_words(n: int, v: int) -> int:
    """Seed words a replica's initial state takes: sel 2N, cross V*N/2, mut
    V*N, and the V*N that become the population."""
    return 2 * n + v * (n // 2) + 2 * v * n


def seed_state_plain(n: int, v: int, c: int, seeds: Sequence[int],
                     device) -> Tuple[torch.Tensor, ...]:
    """The kernel's function, as the JAX package computes it: each seed's
    splitmix words hashed on the host (`lfsr.np_seeds`), copied to
    `device`, cut into the banks, and the population's bank clocked 8 times
    there and truncated to `c` bits.  Returns (x, sel, cross, mut, k)."""
    words = np.stack([lfsr.np_seeds(sd, state_words(n, v)) for sd in seeds])
    s = torch.from_numpy(words.view(np.int32)).to(device)
    r = len(seeds)
    sel = s[:, : 2 * n].reshape(r, 2, n)
    cross = s[:, 2 * n: 2 * n + v * (n // 2)].reshape(r, v, n // 2)
    mut = s[:, 2 * n + v * (n // 2): 2 * n + v * (n // 2) + v * n]
    init_bank = s[:, -v * n:].reshape(r, n, v)
    # a few warmup clocks, then MSB-truncate to c bits per gene
    x = lfsr.truncate(lfsr.steps(init_bank, 8), c)
    return (x, sel.contiguous(), cross.contiguous(),
            mut.reshape(r, v, n).contiguous(),
            torch.zeros((r,), dtype=torch.int32, device=device))


def seed_state_kernel(n: int, v: int, c: int, seeds: Sequence[int], *,
                      device) -> Tuple[torch.Tensor, ...]:
    """Initial states of N = `n`, V = `v`, c = `c` (1..32) bits a gene, one
    a seed, stacked: (x [R, N, V], sel [R, 2, N], cross [R, V, N/2], mut
    [R, V, N], k [R]), int32 words.  On the CPU the plain twin; on a CUDA
    device one launch, its R seeds copied from pinned memory without a
    wait; anything else raises."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"seed_state_kernel runs on the CPU or a CUDA "
                         f"device, got {device}")
    if n < 2 or n % 2 or v < 1:
        raise ValueError(f"need an even N >= 2 and V >= 1, got N={n}, V={v}")
    if not 1 <= c <= 32:
        raise ValueError(f"bits per gene must be in [1, 32], got {c}")
    if not seeds:
        raise ValueError("seed_state_kernel needs at least one seed")
    if device.type == "cpu":
        return seed_state_plain(n, v, c, seeds, device)
    r = len(seeds)
    out = [torch.empty(shape, dtype=torch.int32, device=device)
           for shape in ((r, n, v), (r, 2, n), (r, v, n // 2), (r, v, n),
                         (r,))]
    lib = kernel_library()
    with torch.cuda.device(device):
        bases = torch.tensor([int(sd) & 0xFFFFFFFF for sd in seeds],
                             dtype=torch.int64, pin_memory=True)
        bases = bases.to(device, non_blocking=True)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.seed_state_launch(bases.data_ptr(), r, n, v, c,
                                    *(t.data_ptr() for t in out), stream)
    if err != 0:
        raise RuntimeError(
            f"seed_state kernel launch failed: CUDA error {err} "
            f"({lib.lfsr_advance_error_string(err).decode()})")
    LAUNCHES["seed_state"] += 1
    return tuple(out)
