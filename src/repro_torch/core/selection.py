"""Selection-method variants (paper Sec. 2 surveys these; the hardware
implements tournament-of-2 — the others are drop-in SMs so the engine
covers the survey, all full-parallel).

Each returns (selected population W, new lfsr state); all consume the same
(2, N) LFSR bank as the tournament SM so the GAState layout is unchanged.
Like every operator of `repro_torch.core.ga` they take any leading replica
axes: x [..., N, V], y [..., N], sel_lfsr [..., 2, N].

Float order (hazard H5).  `roulette` and `rank` build a cdf from a float32
prefix sum and total.  The JAX package's jitted reference computes them
with XLA's CPU orders, which are neither sequential nor pairwise:

  * ``jnp.cumsum`` is a recursive blocked scan of base 16: a sequential
    scan within blocks of 16, the block totals scanned the same way, each
    block's offset added after (`blocked_cumsum`);
  * ``jnp.sum`` over a row of n > 32 elements is a reduce-window of
    k = ceil(n / 32) windows of exactly 32, the k * 32 - n padding zeros
    split floor(pad / 2) in front and the rest behind, each window summed
    sequentially, then a reduce of the k window sums in the same order,
    recursively (`blocked_sum`); n <= 32 is one sequential sum.  XLA
    starts each window from 0.0, and 0 + x is exact, so a window's sum is
    its elements' sequential sum.  The HLO dump shows the model
    (``XLA_FLAGS=--xla_dump_to=DIR``): at n = 66 the row sum is
    ``reduce-window(window size=1x32 stride=1x32 pad=0_0x15_15)``
    followed by a ``reduce`` over the 3 window sums.

Both are written here as plain float32 adds, so the cdf is the XLA one bit
for bit at every N tested (the tests pin N in {16, 64, 1024} and the odd sizes
66, 100, 130, 200 and 1000) and on the card alike.  `torch.cumsum` is not
used: on the CPU it accumulates float32 in double.  `rank`'s cdf holds
integers below 2^24 and is exact in any order.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import lfsr
from repro_torch.core.ga import GAConfig, _rows, _select

SCAN_BLOCK = 16      # XLA CPU's cumsum block
SUM_WINDOW = 32      # XLA CPU's widest sequential reduction window


def _seq_scan(a: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 scan along the last axis, left to right."""
    cols = [a[..., 0]]
    for j in range(1, a.shape[-1]):
        cols.append(cols[-1] + a[..., j])
    return torch.stack(cols, dim=-1)


def _seq_sum(a: torch.Tensor) -> torch.Tensor:
    acc = a[..., 0]
    for j in range(1, a.shape[-1]):
        acc = acc + a[..., j]
    return acc


def _blocks(a: torch.Tensor, width: int) -> torch.Tensor:
    """[..., n] -> [..., ceil(n / width), width], zero-padded at the end."""
    n = a.shape[-1]
    nb = -(-n // width)
    a = torch.nn.functional.pad(a, (0, nb * width - n))
    return a.reshape(a.shape[:-1] + (nb, width))


def blocked_cumsum(w: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum(w, axis=-1)`` in XLA's CPU order (see module doc)."""
    n = w.shape[-1]
    loc = _seq_scan(_blocks(w, SCAN_BLOCK))        # [..., nb, 16]
    if loc.shape[-2] > 1:
        tot = blocked_cumsum(loc[..., -1])          # [..., nb]
        loc = torch.cat([loc[..., :1, :],
                         loc[..., 1:, :] + tot[..., :-1, None]], dim=-2)
    return loc.reshape(loc.shape[:-2] + (-1,))[..., :n]


def blocked_sum(w: torch.Tensor) -> torch.Tensor:
    """``jnp.sum(w, axis=-1)`` in XLA's CPU order (see module doc)."""
    n = w.shape[-1]
    if n <= SUM_WINDOW:
        return _seq_sum(w)
    k = -(-n // SUM_WINDOW)
    pad = k * SUM_WINDOW - n
    w = torch.nn.functional.pad(w, (pad // 2, pad - pad // 2))
    return blocked_sum(_seq_sum(w.reshape(w.shape[:-1] + (k, SUM_WINDOW))))


def unit_draw(sel_lfsr: torch.Tensor, cfg: GAConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance the selection bank; u = bank row 0 / 2^32 as float32, the
    uint32 word converted by value (through int64, never as a signed
    int32)."""
    state, r = lfsr.draw(sel_lfsr, cfg.steps_per_draw)
    u = lfsr.u32(r[..., 0, :]).to(torch.float32) / 4294967296.0
    return state, u


def pick(cdf: torch.Tensor, u: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse-cdf pick: the left insertion point of u, clipped to [0, n)."""
    return torch.clamp(torch.searchsorted(cdf.contiguous(), u.contiguous()),
                       0, n - 1)


def tournament(x, y, sel_lfsr, cfg: GAConfig):
    """The paper's SM: N parallel 2-way tournaments (re-exported)."""
    return _select(x, y, sel_lfsr, cfg)


def tournament_k(x, y, sel_lfsr, cfg: GAConfig, k: int = 4):
    """k-way tournament: draw k indices per slot (k/2 draws per bank lane by
    re-stepping), pick the best (the first on a tie).  Stronger selection
    pressure than 2-way."""
    n = cfg.n
    state = sel_lfsr
    idx = []
    for _ in range(k):
        state, r = lfsr.draw(state, cfg.steps_per_draw)
        i = lfsr.truncate(r[..., 0, :] ^ r[..., 1, :],
                          cfg.idx_bits).to(torch.int64)
        if n & (n - 1):
            i = i % n
        idx.append(i)
    idx = torch.stack(idx, dim=-1)                       # [..., N, k]
    ys = torch.gather(y.to(torch.float32), -1,
                      idx.flatten(-2)).reshape(idx.shape)
    best = torch.argmin(ys, dim=-1) if cfg.minimize else \
        torch.argmax(ys, dim=-1)
    winner = torch.gather(idx, -1, best.unsqueeze(-1)).squeeze(-1)
    return _rows(x, winner), state


def roulette_cdf(y: torch.Tensor, cfg: GAConfig) -> torch.Tensor:
    """Fitness-proportional cdf: weights (max - y) when minimizing, (y -
    min) when maximizing, plus 1e-9 so flat fitness degrades to uniform."""
    yf = y.to(torch.float32)
    if cfg.minimize:
        w = torch.amax(yf, dim=-1, keepdim=True) - yf
    else:
        w = yf - torch.amin(yf, dim=-1, keepdim=True)
    w = w + torch.tensor(1e-9, dtype=torch.float32, device=w.device)
    return blocked_cumsum(w) / blocked_sum(w).unsqueeze(-1)


def roulette(x, y, sel_lfsr, cfg: GAConfig):
    """Fitness-proportional selection via inverse-CDF on LFSR draws."""
    cdf = roulette_cdf(y, cfg)
    state, u = unit_draw(sel_lfsr, cfg)
    return _rows(x, pick(cdf, u, cfg.n)), state


def _order(y: torch.Tensor, minimize: bool) -> torch.Tensor:
    """Stable ascending order of y (descending when maximizing), as
    ``jnp.argsort``."""
    yf = y.to(torch.float32)
    return torch.argsort(yf if minimize else -yf, dim=-1, stable=True)


def rank_cdf(y: torch.Tensor, cfg: GAConfig) -> torch.Tensor:
    """Linear-rank cdf: the best individual weighs N, the worst 1."""
    order = _order(y, cfg.minimize)
    weights = torch.arange(cfg.n, 0, -1, dtype=torch.float32,
                           device=y.device).expand(order.shape)
    ranks = torch.zeros(order.shape, dtype=torch.float32, device=y.device)
    ranks = ranks.scatter(-1, order, weights)
    return blocked_cumsum(ranks) / blocked_sum(ranks).unsqueeze(-1)


def rank(x, y, sel_lfsr, cfg: GAConfig):
    """Linear-rank selection: probability ∝ (N - rank)."""
    cdf = rank_cdf(y, cfg)
    state, u = unit_draw(sel_lfsr, cfg)
    return _rows(x, pick(cdf, u, cfg.n)), state


def with_elitism(select_fn, n_elite: int = 1):
    """Wrap any SM so the n_elite best individuals always survive into W
    (slots P..P+n_elite-1 when they fit below N, else 0..n_elite-1 — the
    latter are still mutated)."""

    def fn(x, y, sel_lfsr, cfg: GAConfig):
        w, state = select_fn(x, y, sel_lfsr, cfg)
        best = _order(y, cfg.minimize)[..., :n_elite]
        at = cfg.p if cfg.p + n_elite <= cfg.n else 0
        w = w.clone()
        w[..., at:at + n_elite, :] = _rows(x, best)
        return w, state

    return fn


SELECTORS = {"tournament": tournament, "tournament4": tournament_k,
             "roulette": roulette, "rank": rank}


def generation_with(selector, state, cfg: GAConfig, fit):
    """A GA generation using an alternative SM (same CM/MM as the paper)."""
    from repro_torch.core import ga as G
    y = fit(state.x)
    w, sel_lfsr = selector(state.x, y, state.sel_lfsr, cfg)
    z, cross_lfsr = G._crossover(w, state.cross_lfsr, cfg)
    x_new, mut_lfsr = G._mutate(z, state.mut_lfsr, cfg)
    return G.GAState(x_new, sel_lfsr, cross_lfsr, mut_lfsr, state.k + 1), y
