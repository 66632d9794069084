"""Vectorized 32-bit Fibonacci LFSR — the paper's pseudo-random source.

The paper (Sec. 3, Fig. 1) uses independent 32-bit LFSRs based on the
polynomial  r^32 + r^22 + r^2 + 1  ([25] Goresky & Klapper), one per hardware
module, each seeded differently.  Hardware shifts one bit per clock and the
whole 32-bit register is the "draw"; draws are truncated to their most
significant bits when a narrower random value is needed.

Word layout.  PyTorch has no uint32 arithmetic (shifts, compares and min
raise on ``torch.uint32``), so every register word is carried as an
``int32`` tensor holding the uint32 BIT PATTERN.  Arithmetic widens to
``int64`` masked to 32 bits (`u32`), where ``>>`` is a logical shift, and
narrows back with `i32`.  Conversion to ``np.uint32`` happens only at the
boundary (`repro_torch.convert`).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

# Polynomial r^32 + r^22 + r^2 + 1  -> taps at exponents {32, 22, 2, 1}.
# With the register holding bits s_31..s_0 (s_31 oldest), the feedback bit is
#   fb = s[31] ^ s[21] ^ s[1] ^ s[0]
# and the register shifts left, inserting fb at bit 0.
TAPS = (31, 21, 1, 0)

_M32 = 0xFFFFFFFF


def u32(w: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values as int64 in [0, 2^32)."""
    return w.to(torch.int64) & _M32


def i32(w: torch.Tensor) -> torch.Tensor:
    """int64 values (any range) -> the int32 tensor of their low 32 bits."""
    w = w & _M32
    return (w - ((w >> 31) << 32)).to(torch.int32)


def _step64(s: torch.Tensor) -> torch.Tensor:
    fb = ((s >> 31) ^ (s >> 21) ^ (s >> 1) ^ s) & 1
    return ((s << 1) & _M32) | fb


def step(state: torch.Tensor) -> torch.Tensor:
    """Advance every LFSR lane one clock. state: int32[...] bit patterns."""
    return i32(_step64(u32(state)))


def steps(state: torch.Tensor, n: int) -> torch.Tensor:
    """Advance n clocks."""
    s = u32(state)
    for _ in range(n):
        s = _step64(s)
    return i32(s)


def draw(state: torch.Tensor, steps_per_draw: int = 3
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance and return (new_state, 32-bit draws).

    Default ``steps_per_draw=3``: the paper's SyncM strobes a new generation
    every 3 clocks, so each module's LFSR has shifted 3 bits between draws.
    """
    state = steps(state, steps_per_draw)
    return state, state


def truncate(r: torch.Tensor, bits: int) -> torch.Tensor:
    """Keep the `bits` most significant bits (the paper's truncation)."""
    if bits <= 0:
        return torch.zeros_like(r)
    return i32(u32(r) >> (32 - bits))


def seeds(key_or_int, n: int, *, device) -> torch.Tensor:
    """n distinct non-zero 32-bit seeds (CCseed in the paper), as int32
    bit patterns on `device`."""
    return torch.from_numpy(np_seeds(key_or_int, n).view(np.int32)).to(device)


def np_seeds(key_or_int, n: int) -> np.ndarray:
    """`seeds` as np.uint32.

    Deterministic: derived with a splitmix-style integer hash so tests and
    hardware-style reproducibility do not depend on a framework RNG.
    """
    base = int(key_or_int) & 0xFFFFFFFF
    idx = np.arange(1, n + 1, dtype=np.uint64) + np.uint64(base) * np.uint64(0x9E3779B9)
    z = idx * np.uint64(0xBF58476D1CE4E5B9)
    z ^= z >> np.uint64(31)
    z = z * np.uint64(0x94D049BB133111EB)
    z ^= z >> np.uint64(27)
    out = (z & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return np.where(out == 0, np.uint32(0xDEADBEEF), out)  # LFSR must not be 0


# ---------------------------------------------------------------------------
# Leap-forward: advance t steps in O(1) work via GF(2) matrices.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def leap_feedback_masks(t: int) -> Tuple[int, ...]:
    """GF(2) masks for a t-step leap in shift+parity form (0 < t < 32).

    Advancing the register t clocks is linear over GF(2): the top 32-t bits
    are a plain left shift, and each of the t inserted feedback bits is the
    parity of the ORIGINAL register masked by a precomputed 32-bit mask:

        state_t  =  (s << t)  |  Σ_j  parity(s & M_j) << j

    (bit j of the result was the feedback computed at clock t-1-j).  The
    masks come from symbolically simulating `step` with each state bit
    represented as a mask over the original bits.
    """
    if not 0 < t < 32:
        raise ValueError(f"leap_feedback_masks needs 0 < t < 32, got {t}")
    bits = [1 << i for i in range(32)]   # bit i as a mask over the original s
    for _ in range(t):
        fb = 0
        for b in TAPS:
            fb ^= bits[b]
        bits = [fb] + bits[:-1]          # s' = (s << 1) | fb
    return tuple(bits[:t])


@functools.lru_cache(maxsize=None)
def _leap_matrix(t: int) -> Tuple[int, ...]:
    """Column representation of the t-step LFSR transition over GF(2).

    Returns 32 ints; column j is the new-state bitmask produced by old bit j.
    """
    # one-step: new_bit_i = old_bit_{i-1} for i>0 ; new_bit_0 = parity(taps)
    cols = []
    for j in range(32):
        col = 0
        if j + 1 < 32:
            col |= 1 << (j + 1)
        if j in TAPS:
            col |= 1
        cols.append(col)
    one = tuple(cols)

    def mul(a, b):  # c = a ∘ b  (apply b then a)
        out = []
        for j in range(32):
            v, acc = b[j], 0
            for i in range(32):
                if (v >> i) & 1:
                    acc ^= a[i]
            out.append(acc)
        return tuple(out)

    ident = tuple(1 << j for j in range(32))
    result, base = ident, one
    while t:
        if t & 1:
            result = mul(base, result)
        base = mul(base, base)
        t >>= 1
    return result


def leap(state: torch.Tensor, t: int) -> torch.Tensor:
    """Advance every lane t steps with 32 selects + XORs."""
    cols = _leap_matrix(int(t))
    s = u32(state)
    out = torch.zeros_like(s)
    for j in range(32):
        bit = (s >> j) & 1
        out = out ^ (bit * cols[j])
    return i32(out)


# ---------------------------------------------------------------------------
# NumPy reference (oracle for tests)
# ---------------------------------------------------------------------------


def np_step(state: np.ndarray) -> np.ndarray:
    s = state.astype(np.uint32)
    fb = ((s >> 31) ^ (s >> 21) ^ (s >> 1) ^ s) & np.uint32(1)
    return ((s << np.uint32(1)) | fb).astype(np.uint32)


def np_steps(state: np.ndarray, n: int) -> np.ndarray:
    for _ in range(n):
        state = np_step(state)
    return state
