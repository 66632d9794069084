"""State carried between the JAX package and the port, in both directions.

A GA has no weights: what one run hands another is its state — the
population and the three LFSR banks, all uint32 words, plus the generation
counter.  The port carries the words as int32 tensors holding the same bit
patterns (`repro_torch.core.lfsr`), so the conversion is a reinterpreting
view, never a change of value.

    st = convert.state_from_numpy(x, sel, cross, mut, k, device="cpu")
    x, sel, cross, mut, k = convert.state_to_numpy(st)
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.ga import GAState


def words_from_numpy(a, *, device) -> torch.Tensor:
    """uint32 (or int32) array -> int32 tensor of the same bit patterns."""
    a = np.ascontiguousarray(a)
    if a.dtype not in (np.uint32, np.int32):
        raise TypeError(f"expected uint32 or int32 words, got {a.dtype}")
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def words_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor of bit patterns -> np.uint32 array."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected an int32 word tensor, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def state_from_numpy(x, sel, cross, mut, k, *, device) -> GAState:
    """The JAX package's `GAState` leaves (numpy uint32 words, int32 k) ->
    the port's `GAState` on `device`.  Leading replica axes carry over."""
    return GAState(x=words_from_numpy(x, device=device),
                   sel_lfsr=words_from_numpy(sel, device=device),
                   cross_lfsr=words_from_numpy(cross, device=device),
                   mut_lfsr=words_from_numpy(mut, device=device),
                   k=torch.tensor(np.asarray(k, np.int32), device=device))


def state_to_numpy(state: GAState) -> Tuple[np.ndarray, ...]:
    """The port's `GAState` -> (x, sel, cross, mut) as np.uint32 and k as
    np.int32, the JAX package's leaf types."""
    return (words_to_numpy(state.x), words_to_numpy(state.sel_lfsr),
            words_to_numpy(state.cross_lfsr), words_to_numpy(state.mut_lfsr),
            np.asarray(state.k.detach().cpu().numpy(), np.int32))
