#!/usr/bin/env python3
"""Launch shapes of K1's global form on one CUDA card.

    python3 scripts/torch_global_tiles_sweep.py [--out sweep.json]

Times (device ms a launch, a CUDA graph of 20 launches: `chip_smoke.graph_ms`)
on random card tensors:

  * ga_operators at the tile `kernels.ga_step.operators_tiling` chooses and
    at half and twice it, at the shapes of chip_smoke.py phase 17 and its
    blackbox and ring runs;
  * ga_operators with every selection word 0 (each tournament draws index
    0, so y and the parents are read from one row: the kernel's traffic
    without its random reads), beside `clone()` of the same bytes;
  * ga_best over clusters of 1, 2, 4 and 8 blocks, beside torch.argmin
    over the same y.

Every launch's output is held against the plain twin first.  Exits 2
without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

OPS_SHAPES = ((65536, 2, 16), (8192, 2, 16), (1024, 32, 16), (4096, 64, 16),
              (1024, 3, 128), (1024, 6, 128), (65536, 100, 3))
PROBE_SHAPES = ((65536, 2, 16), (4096, 64, 16))
BEST_SHAPES = ((65536, 2, 16), (8192, 2, 16), (4096, 64, 16), (1024, 3, 128))


def operators_at(K, x, y, banks, cfg, tile, chunk):
    """A call of ga_operators at an explicit (tile, chunk)."""
    lib = K.kernel_library()
    r, n, v = x.shape

    def run():
        outs = [torch.empty_like(t) for t in (x,) + banks]
        err = lib.ga_operators_launch(
            x.data_ptr(), y.data_ptr(), *(t.data_ptr() for t in banks),
            *(t.data_ptr() for t in outs), r, n, v, cfg.c, cfg.idx_bits,
            cfg.cut_bits, min(cfg.p, n), cfg.steps_per_draw,
            int(cfg.minimize), tile, chunk,
            torch.cuda.current_stream().cuda_stream)
        K._check_launch(err, "ga_operators")
        return outs
    return run


def best_at(K, x, y, by, bx, blocks):
    """A call of ga_best over clusters of `blocks` blocks."""
    lib = K.kernel_library()
    r, n, v = x.shape
    slice_ = -(-n // blocks)
    slice_ += -slice_ % 4

    def run():
        o1, o2 = torch.empty_like(by), torch.empty_like(bx)
        err = lib.ga_best_launch(
            x.data_ptr(), y.data_ptr(), by.data_ptr(), bx.data_ptr(),
            o1.data_ptr(), o2.data_ptr(), r, n, v, 1, blocks, slice_,
            torch.cuda.current_stream().cuda_stream)
        K._check_launch(err, "ga_best")
        return o1, o2
    return run, (blocks - 1) * slice_ < n


def held(got, want, what):
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise SystemExit(f"{what}: kernel and plain differ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the rows here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_global_tiles_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as CS
    from repro_torch.core import ga as TG
    from repro_torch.kernels import build
    from repro_torch.kernels import ga_step as K
    build.build_all(["ga_step"])
    dev = torch.device("cuda")
    card = CS.card_line()
    print(card)
    rows = []

    def cfg_of(n, v):
        return TG.GAConfig(n=n, c=16, v=v, seed=1, mode="arith",
                           sel_lane="gather", mutation_rate=0.02)

    for n, v, r in OPS_SHAPES:
        x, y, *banks = CS.edge_banks(r, n, v, 16, n + v + r, dev)
        banks, cfg = tuple(banks), cfg_of(n, v)
        want = K.ga_operators_plain(x, y, *banks, cfg=cfg)
        chosen, chunk = K.operators_tiling(n, v, r)
        for tile in sorted({chosen // 2, chosen, 2 * chosen}):
            if not (1 <= tile <= n // 2 and K.operators_tile_bytes(
                    tile, chunk) <= K.OPS_SMEM_LIMIT):
                continue
            run = operators_at(K, x, y, banks, cfg, tile, chunk)
            held(run(), want, f"ga_operators N={n} V={v} tile={tile}")
            rows.append({"kernel": "ga_operators", "n": n, "v": v,
                         "replicas": r, "tile": tile, "chunk": chunk,
                         "chosen": tile == chosen,
                         "graph_ms": CS.graph_ms(run)})
            print(f"ga_operators N={n} V={v} x{r} tile {tile} chunk {chunk}"
                  f"{' (chosen)' if tile == chosen else ''}: "
                  f"{rows[-1]['graph_ms']:.4f} ms  [{card}]")
        del x, y, banks, want

    for n, v, r in PROBE_SHAPES:
        x, y, *banks = CS.edge_banks(r, n, v, 16, n + v + r, dev)
        cfg = cfg_of(n, v)
        zero = (torch.zeros_like(banks[0]),) + tuple(banks[1:])
        row = {"kernel": "ga_operators", "probe": True, "n": n, "v": v,
               "replicas": r}
        for name, sel in (("graph_ms", tuple(banks)),
                          ("sel_zero_graph_ms", zero)):
            call = (lambda s=sel: K.ga_operators_kernel(x, y, *s, cfg=cfg))
            held(call(), K.ga_operators_plain(x, y, *sel, cfg=cfg),
                 f"ga_operators N={n} V={v} ({name})")
            row[name] = CS.graph_ms(call)
        words = sum(t.numel() for t in [x, y] + list(banks))
        flat = torch.empty(words, dtype=torch.int32, device=dev)
        row["clone_graph_ms"] = CS.graph_ms(flat.clone)
        row["clone_mb"] = 2 * 4 * words / 1e6
        rows.append(row)
        print(f"ga_operators N={n} V={v} x{r}: {row['graph_ms']:.4f} ms; "
              f"selection words 0 (no random reads) "
              f"{row['sel_zero_graph_ms']:.4f} ms; clone() of the same "
              f"{row['clone_mb']:.1f} MB {row['clone_graph_ms']:.4f} ms  "
              f"[{card}]")
        del x, y, banks, zero, flat

    for n, v, r in BEST_SHAPES:
        x, y = CS.edge_banks(r, n, v, 16, 3 * n + v, dev)[:2]
        by = torch.full((r,), float("inf"), device=dev)
        bx = torch.zeros((r, v), dtype=torch.int32, device=dev)
        want = K.ga_best_plain(x, y, by, bx, minimize=True)
        chosen = K.best_split(n)[0]
        for blocks in (1, 2, 4, 8):
            run, fits = best_at(K, x, y, by, bx, blocks)
            if not fits:
                continue
            held(run(), want, f"ga_best N={n} blocks={blocks}")
            rows.append({"kernel": "ga_best", "n": n, "v": v,
                         "replicas": r, "blocks": blocks,
                         "chosen": blocks == chosen,
                         "graph_ms": CS.graph_ms(run)})
            print(f"ga_best N={n} V={v} x{r} clusters of {blocks}"
                  f"{' (chosen)' if blocks == chosen else ''}: "
                  f"{rows[-1]['graph_ms']:.4f} ms  [{card}]")
        ms = CS.graph_ms(lambda: torch.argmin(y, dim=1))
        rows.append({"kernel": "torch.argmin", "n": n, "replicas": r,
                     "graph_ms": ms})
        print(f"torch.argmin over the same y (not ga_best's function): "
              f"{ms:.4f} ms  [{card}]")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
