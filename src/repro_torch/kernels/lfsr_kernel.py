"""K4: bulk LFSR-32 advance — the CUDA kernel and its plain twin.

`lfsr_advance_kernel(state, steps)` advances every lane of an int32 word
tensor (uint32 bit patterns, any shape) by `steps` clocks of the paper's
polynomial.  On a CUDA tensor it launches ``csrc/lfsr_advance.cu`` and
counts the launch in ``LAUNCHES``; on a CPU tensor it runs
`lfsr_advance_plain` (`core.lfsr.steps`).  No engine path calls it: like
the JAX package's `lfsr_advance_kernel`, it is a standalone bulk kernel.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import lfsr

# launches made by the wrapper (plain-version calls excluded)
LAUNCHES: Dict[str, int] = {"lfsr_advance": 0}


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
