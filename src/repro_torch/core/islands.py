"""Island-model parallel GA: a stack of populations with ring migration, on
one device or split over the shards of a mesh.

The paper instantiates the full GA once per FPGA; its cited related work
(Guo et al., multi-FPGA parallel GAs) scales by running isolated
populations ("islands") that periodically exchange good individuals.  Here
the islands are a leading axis of the GA state ([I, N, V], or [R, I, N, V]
with replicas), and every `migrate_every` generations the best individual
of island i replaces the worst individual of island (i + 1) mod I.

The migration rule set below (`best_slot` .. `migrate_ring`) is THE rule
set: the `islands` backend runs it between generations, the plain versions
of the epoch kernels run it between intervals, and the CUDA epoch kernels
repeat it in shared memory.  Every function takes any leading axes in front
of the island axis.  First-occurrence best/worst is a min-reduction over a
masked iota, so a NaN fitness anywhere in an island matches no slot and its
splice is a no-op, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from repro_torch.core import ga as G
from repro_torch.core import lfsr


@dataclasses.dataclass(frozen=True)
class IslandConfig:
    ga: G.GAConfig
    n_islands: int               # island count I
    migrate_every: int = 16      # generations between migrations


def init_islands(cfg: IslandConfig, *, device) -> G.GAState:
    """Stack of I island states with decorrelated seeds (one population
    init per island, seeded `seed + 7919 * (i + 1)`)."""
    seeds = [cfg.ga.seed + 7919 * (i + 1) for i in range(cfg.n_islands)]
    return G.init_states(cfg.ga, seeds, device=device)


def init_islands_fast(cfg: IslandConfig, *, device) -> G.GAState:
    """Vectorized init: ONE splitmix seed stream of I * per words, cut into
    each island's banks and initial population (the JAX package's layout,
    bit for bit)."""
    i, n, v = cfg.n_islands, cfg.ga.n, cfg.ga.v
    per = 2 * n + v * (n // 2) + 2 * v * n
    s = lfsr.seeds(cfg.ga.seed, i * per, device=device).reshape(i, per)
    sel = s[:, : 2 * n].reshape(i, 2, n)
    cross = s[:, 2 * n: 2 * n + v * (n // 2)].reshape(i, v, n // 2)
    mut = s[:, 2 * n + v * (n // 2): 2 * n + v * (n // 2) + v * n]
    init_bank = s[:, -v * n:].reshape(i, n, v)
    x = lfsr.truncate(lfsr.steps(init_bank, 8), cfg.ga.c)
    return G.GAState(x=x, sel_lfsr=sel.contiguous(),
                     cross_lfsr=cross.contiguous(),
                     mut_lfsr=mut.reshape(i, v, n).contiguous(),
                     k=torch.zeros((i,), dtype=torch.int32, device=device))


# ---------------------------------------------------------------------------
# Migration rule set
# ---------------------------------------------------------------------------


def best_slot(y: torch.Tensor, *, minimize: bool) -> torch.Tensor:
    """First-occurrence best index per island: (..., N) -> int64 (...).
    Matches argmin/argmax for finite fitness; where an island holds a NaN
    the min/max is NaN, no slot matches and the result is the out-of-range
    sentinel N, which makes `take_slot`/`splice_at` no-ops."""
    yf = y.to(torch.float32)
    m = (torch.amin(yf, dim=-1, keepdim=True) if minimize
         else torch.amax(yf, dim=-1, keepdim=True))
    n = yf.shape[-1]
    iota = torch.arange(n, device=yf.device).expand(yf.shape)
    return torch.amin(torch.where(yf == m, iota, n), dim=-1)


def worst_slot(y: torch.Tensor, *, minimize: bool) -> torch.Tensor:
    """First-occurrence worst index per island (the slot migration fills)."""
    return best_slot(y, minimize=not minimize)


def _hit(slot: torch.Tensor, n: int) -> torch.Tensor:
    """bool (..., N): True at each island's slot (nowhere for slot N)."""
    return torch.arange(n, device=slot.device) == slot.unsqueeze(-1)


def take_slot(a: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """a[..., slot, :] per island for a (..., N, ...) stack whose leading
    axes are slot's: a masked sum, so the sentinel slot N gives zeros."""
    k = slot.dim()
    hit = _hit(slot, a.shape[k])
    hit = hit.reshape(hit.shape + (1,) * (a.dim() - k - 1))
    return torch.sum(torch.where(hit, a, torch.zeros_like(a)), dim=k,
                     dtype=a.dtype)


def splice_at(x: torch.Tensor, slot: torch.Tensor, rows: torch.Tensor,
              island_mask: torch.Tensor = None) -> torch.Tensor:
    """x (..., N, V) with x[..., slot, :] <- rows (..., V), a select.
    island_mask (bool, broadcastable to slot's shape + (1,)) disables the
    splice for masked-off islands — the boundary epoch leaves island 0 for
    the elite that crosses from outside."""
    hit = _hit(slot, x.shape[-2])
    if island_mask is not None:
        hit = hit & island_mask
    return torch.where(hit.unsqueeze(-1), rows.unsqueeze(-2), x)


def elites_stack(x: torch.Tensor, y: torch.Tensor, *, minimize: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-island elite of a raw stack: (elite_x (..., V), elite_y (...))."""
    slot = best_slot(y, minimize=minimize)
    return take_slot(x, slot), take_slot(y.to(torch.float32), slot)


def ring_migrate_stack(x: torch.Tensor, y: torch.Tensor, *, minimize: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One full ring migration over an island stack (..., I, N, V): elite
    extraction, shift by one island (island 0 takes island I-1's elite),
    worst-slot splice.  Returns (x', elite_x, elite_y)."""
    elite_x, elite_y = elites_stack(x, y, minimize=minimize)
    shifted = torch.roll(elite_x, 1, dims=-2)
    x2 = splice_at(x, worst_slot(y, minimize=minimize), shifted)
    return x2, elite_x, elite_y


def splice_elites(states: G.GAState, y: torch.Tensor, elites: torch.Tensor,
                  *, minimize: bool) -> G.GAState:
    """Replace each island's worst individual with the incoming elite.
    y: fitness of states.x (..., I, N)."""
    x = splice_at(states.x, worst_slot(y, minimize=minimize), elites)
    return states._replace(x=x)


def best_of(states: G.GAState, y: torch.Tensor, *, minimize: bool):
    """Per-island elite: (elite_x (..., I, V), elite_y (..., I))."""
    return elites_stack(states.x, y, minimize=minimize)


def migrate_ring(states: G.GAState, y: torch.Tensor, *, minimize: bool
                 ) -> Tuple[G.GAState, torch.Tensor, torch.Tensor]:
    """One ring migration over an island-stacked state: the best individual
    of island i replaces the worst of island (i + 1) mod I.  Returns
    (new_states, elite_x, elite_y)."""
    x2, elite_x, elite_y = ring_migrate_stack(states.x, y, minimize=minimize)
    return states._replace(x=x2), elite_x, elite_y


# ---------------------------------------------------------------------------
# Sharded ring migration — bit-identical to migrate_ring
# ---------------------------------------------------------------------------


def ring_shift_sharded(xs: Sequence[torch.Tensor], mesh=None,
                       axis_names: Sequence[str] = ()) -> List[torch.Tensor]:
    """Send each shard's tensor to the next shard in row-major order over
    `axis_names`: shard j receives shard j-1's tensor (shard 0 the last
    one's), on its own device.

    `xs` holds one tensor a shard, in the logical order of
    `mesh.shard_devices(axis_names)`.  Over several axes this is one global
    ring over the raveled axis tuple, as the JAX package's `ppermute`
    cascade makes it; the devices behind the positions never enter the
    order, so shards that share a device form the same ring.  Without a
    mesh `xs` is one tensor, the whole ring, and comes back as it is."""
    devices = ([x.device for x in xs[:1]] if mesh is None
               else mesh.shard_devices(axis_names))
    if len(xs) != len(devices):
        raise ValueError(f"{len(xs)} tensors for {len(devices)} mesh shards")
    return [xs[j - 1].to(devices[j]) for j in range(len(xs))]


def migrate_ring_sharded(states: Sequence[G.GAState],
                         ys: Sequence[torch.Tensor], *, minimize: bool,
                         mesh=None, axis_names: Sequence[str] = ()
                         ) -> Tuple[List[G.GAState], List[torch.Tensor],
                                    List[torch.Tensor]]:
    """`migrate_ring` over an island axis split into per-shard blocks.

    states/ys hold each shard's [..., I_local, ...] block in the order of
    `ring_shift_sharded`.  Locally the elites shift down by one island;
    the last local island's elite crosses to the next shard and lands on
    its island 0 — globally the roll by one of `migrate_ring`, bit for bit
    (without a mesh, one state: `migrate_ring` itself).  Returns
    (new_states, elite_x, elite_y), each a list a shard."""
    elites = [best_of(s, y, minimize=minimize) for s, y in zip(states, ys)]
    recv = ring_shift_sharded([ex[..., -1, :] for ex, _ in elites], mesh,
                              axis_names)
    out = []
    for s, y, (ex, _), r in zip(states, ys, elites, recv):
        shifted = torch.cat([r.unsqueeze(-2), ex[..., :-1, :]], dim=-2)
        out.append(splice_elites(s, y, shifted, minimize=minimize))
    return out, [ex for ex, _ in elites], [ey for _, ey in elites]


# ---------------------------------------------------------------------------
# Single-device oracle
# ---------------------------------------------------------------------------


def make_local_step(cfg: IslandConfig, fit: G.FitnessFn, generation_fn=None):
    """One epoch of an island stack: `migrate_every` generations of every
    island, then one ring migration on the final populations' fitness.
    The plain oracle the island backends are held against.  Returns
    (states, elite_x, elite_y)."""
    gen = generation_fn or G.generation

    def epoch(states: G.GAState):
        for _ in range(cfg.migrate_every):
            states, _y = gen(states, cfg.ga, fit)
        return migrate_ring(states, fit(states.x), minimize=cfg.ga.minimize)

    return epoch
