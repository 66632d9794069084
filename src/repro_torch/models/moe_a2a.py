"""Explicit expert-parallel MoE: per-shard buckets and an all-to-all token
exchange; the JAX package's `repro.models.moe_a2a`, over the port's
single-controller `repro_torch.launch.mesh.Mesh`.

Where the JAX module runs one `shard_map` body a device, one process here
runs every (dp, ep) shard's body in turn, each on its shard's device:

  * each shard takes its dp slice of the batch and, within it, its ep
    rank's slice of the tokens, so the work is disjoint;
  * it routes them (`moe.route`), buckets every (token, choice) row by the
    ep rank that owns its expert (`E / ep` experts a rank), positioned by a
    running count a destination, and drops rows past the capacity into a
    drop slot: the send buffer (ep, cap, d) and its metadata (local
    expert id, source slot);
  * the all-to-all is a transpose of the per-shard buffers: rank r
    receives block r of every source's buffer, moved to its device;
  * each rank buckets the received rows by local expert, (E/ep, ecap, d),
    and runs its experts' gated FFN against its slice of the weights;
  * the inverse exchange returns every result to its source's slot, where
    the source's OWN slot metadata places it (the remote kept the block's
    row order, so no second metadata exchange is needed), and the top-k
    weights combine the rows back into token order;
  * the all-gather over ep is a concatenation, onto the mesh's first
    device, and so is the dp axis: the output is (B, S, D) there.

The capacities are the JAX module's expressions, so the same rows are
kept and dropped.  Everything is autograd-differentiable (`index_add`,
gathers and `.to(device)`), so `loss.backward()` gives the weight
gradients.

    y = moe_a2a_forward(moe, x, cfg, mesh)          # moe: models.moe.MoE
    y, dropped = moe_a2a_forward(moe, x, cfg, mesh, with_dropped=True)
"""

from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import common as C
from repro_torch.models.moe import MoEConfig, route


def _bucket_positions(dst: torch.Tensor, n_dst: int, cap: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dst: (R,) destination id a row -> (position within its destination,
    keep)."""
    oh = F.one_hot(dst, n_dst)                                 # (R, n_dst)
    pos = torch.cumsum(oh, dim=0) - 1
    pos = torch.sum(pos * oh, dim=1)                           # (R,)
    return pos, pos < cap


def _scatter_max(n: int, index: torch.Tensor, values: torch.Tensor
                 ) -> torch.Tensor:
    """A (n,) int64 buffer of -1 with `values` max-reduced at `index`
    (JAX's `.at[index].max`)."""
    out = torch.full((n,), -1, dtype=torch.int64, device=values.device)
    return out.scatter_reduce(0, index, values, "amax")


def _send(my: torch.Tensor, router_w: torch.Tensor, cfg: MoEConfig,
          ep: int, e_loc: int):
    """One source shard's routing and send buffer: (send (ep*cap, d),
    meta_e, meta_s, combine weights (rows,), dropped (rows,))."""
    t_loc, d = my.shape
    weights, idx, _ = route(router_w, my[None], cfg)          # (1,T,k)
    weights, idx = weights[0], idx[0]
    rows = t_loc * cfg.top_k
    flat_expert = idx.reshape(rows)
    flat_w = weights.reshape(rows)
    src_slot = torch.arange(rows, device=my.device)
    dst = flat_expert // e_loc                                 # rank
    cap = int(np.ceil(t_loc * cfg.top_k / ep
                      * cfg.capacity_factor))
    pos, keep = _bucket_positions(dst, ep, cap)

    flat_idx = torch.where(keep, dst * cap + pos,
                           torch.full_like(dst, ep * cap))    # drop slot
    rows_x = torch.repeat_interleave(my, cfg.top_k, dim=0)
    send = torch.zeros((ep * cap + 1, d), dtype=my.dtype, device=my.device)
    send = send.index_add(0, flat_idx,
                          rows_x * keep[:, None].to(my.dtype))[:-1]
    minus = torch.full_like(flat_expert, -1)
    meta_e = _scatter_max(ep * cap + 1, flat_idx,
                          torch.where(keep, flat_expert % e_loc, minus))[:-1]
    meta_s = _scatter_max(ep * cap + 1, flat_idx,
                          torch.where(keep, src_slot, minus))[:-1]
    return send, meta_e, meta_s, flat_w, ~keep, cap


def _experts(recv: torch.Tensor, recv_e: torch.Tensor, wg: torch.Tensor,
             wu: torch.Tensor, wd: torch.Tensor, cfg: MoEConfig,
             e_loc: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's received rows through its local experts, back in
    received-row order: (out_rows, dropped (rows,) of valid rows past
    the expert capacity)."""
    d = recv.shape[1]
    ecap = int(np.ceil(recv.shape[0] / e_loc * cfg.capacity_factor))
    valid = recv_e >= 0
    e_of_row = torch.where(valid, recv_e, torch.zeros_like(recv_e))
    pos2, keep2 = _bucket_positions(
        torch.where(valid, e_of_row, torch.full_like(recv_e, e_loc)),
        e_loc + 1, ecap)
    keep2 = keep2 & valid
    bidx = torch.where(keep2, e_of_row * ecap + pos2,
                       torch.full_like(recv_e, e_loc * ecap))
    buckets = torch.zeros((e_loc * ecap + 1, d), dtype=recv.dtype,
                          device=recv.device)
    buckets = buckets.index_add(
        0, bidx, recv * keep2[:, None].to(recv.dtype))[:-1]
    bx = buckets.reshape(e_loc, ecap, d)
    h = C.silu(torch.einsum("ecd,edf->ecf", bx, wg)) * \
        torch.einsum("ecd,edf->ecf", bx, wu)
    out_b = torch.einsum("ecf,efd->ecd", h.to(bx.dtype), wd)
    out_rows = out_b.reshape(e_loc * ecap, d)[
        torch.clamp(bidx, 0, e_loc * ecap - 1)] * \
        keep2[:, None].to(out_b.dtype)
    return out_rows, valid & ~keep2


def moe_a2a_forward(moe, x: torch.Tensor, cfg: MoEConfig, mesh,
                    ep_axis: str = "model", dp_axis: str = "data",
                    with_dropped: bool = False
                    ) -> Union[torch.Tensor, Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """x: (B, S, D), B split over `dp_axis`; the experts of `moe` (its
    `router`, and `w_gate`/`w_up`/`w_down` (E, d, f)/(E, f, d)) split on
    the expert dim over `ep_axis`.  Returns (B, S, D) on the mesh's first
    device (aux loss, as in the JAX module, comes from `route` in the
    caller); with `with_dropped`, also a (B, S, top_k) bool tensor there
    of the (token, choice) rows a capacity dropped."""
    ep = mesh.shape[ep_axis]
    dp = mesh.shape[dp_axis]
    e_loc = cfg.n_experts // ep
    if e_loc * ep != cfg.n_experts:
        raise ValueError(f"{cfg.n_experts} experts do not split over "
                         f"{ep} ranks of {ep_axis!r}")
    b, s, d = x.shape
    if b % dp or (b // dp * s) % ep:
        raise ValueError(f"a ({b}, {s}) batch does not split over {dp} dp "
                         f"and {ep} ep shards")
    b_loc = b // dp
    t_all = b_loc * s
    t_loc = t_all // ep
    out_dev = mesh.first_device
    k = cfg.top_k

    ys: List[torch.Tensor] = []
    drops: List[torch.Tensor] = []
    for i in range(dp):
        devs = [mesh.device_at(**{dp_axis: i, ep_axis: j})
                for j in range(ep)]
        toks = x[i * b_loc:(i + 1) * b_loc].reshape(t_all, d)
        sent = [_send(toks[j * t_loc:(j + 1) * t_loc].to(devs[j]),
                      moe.router.to(devs[j]), cfg, ep, e_loc)
                for j in range(ep)]
        cap = sent[0][5]
        back_parts: List[List[torch.Tensor]] = [[] for _ in range(ep)]
        drop_remote = [torch.zeros(ep * cap, dtype=torch.bool,
                                   device=devs[j]) for j in range(ep)]
        for r in range(ep):
            # all-to-all: block r of every source's buffer, to rank r
            blk = slice(r * cap, (r + 1) * cap)
            recv = torch.cat([sent[j][0][blk].to(devs[r])
                              for j in range(ep)])
            recv_e = torch.cat([sent[j][1][blk].to(devs[r])
                                for j in range(ep)])
            ex = slice(r * e_loc, (r + 1) * e_loc)
            out_rows, lost = _experts(
                recv, recv_e, moe.w_gate[ex].to(devs[r]),
                moe.w_up[ex].to(devs[r]), moe.w_down[ex].to(devs[r]),
                cfg, e_loc)
            # the inverse all-to-all: block j of the result to source j
            for j in range(ep):
                src = slice(j * cap, (j + 1) * cap)
                back_parts[j].append(out_rows[src].to(devs[j]))
                drop_remote[j][blk] = lost[src].to(devs[j])
        rows = t_loc * k
        for j in range(ep):
            _, _, meta_s, flat_w, dropped, _ = sent[j]
            back = torch.cat(back_parts[j])                    # (ep*cap, d)
            ok = meta_s >= 0
            slot = torch.where(ok, meta_s, torch.full_like(meta_s, rows))
            contrib = torch.zeros((rows + 1, d), dtype=back.dtype,
                                  device=back.device)
            contrib = contrib.index_add(
                0, slot, back * ok[:, None].to(back.dtype))[:-1]
            y_my = torch.sum(contrib.reshape(t_loc, k, d) *
                             flat_w.reshape(t_loc, k)[..., None]
                             .to(back.dtype), dim=1)
            ys.append(y_my.to(out_dev))
            if with_dropped:
                lost = torch.zeros(rows + 1, dtype=torch.bool,
                                   device=back.device)
                lost[slot] = drop_remote[j] & ok
                drops.append((dropped | lost[:-1]).to(out_dev))
    y = torch.cat(ys).reshape(b, s, d)
    if with_dropped:
        return y, torch.cat(drops).reshape(b, s, k)
    return y
