#!/usr/bin/env python3
"""Launch shapes of K1's global form on one CUDA card.

    python3 scripts/torch_global_tiles_sweep.py [--out sweep.json]
        [--only ga_operators ga_best ga_ffm] [--baseline OLD_ga_step.cu]

Times (device ms a launch, a CUDA graph of 20 launches: `chip_smoke.graph_ms`)
on random card tensors:

  * ga_operators at the tile `kernels.ga_step.operators_tiling` chooses and
    at half and twice it, at the shapes of chip_smoke.py phase 17 and its
    blackbox and ring runs;
  * ga_operators with every selection word 0 (each tournament draws index
    0, so y and the parents are read from one row: the kernel's traffic
    without its random reads), beside `clone()` of the same bytes;
  * ga_best over clusters of 1, 2, 4 and 8 blocks, beside torch.argmin
    over the same y;
  * ga_ffm at the tile `kernels.ga_step.ffm_tiling` chooses and at half
    and twice it, at phase 17 (c)'s six shapes, and in both of its forms
    (rows: a thread whole rows; spread: a thread a term) at V from 2 to
    16, where `ffm_spreads` switches from one to the other; with
    `--baseline`, at the six shapes also the `ga_ffm` of another
    ga_step.cu whose launcher has the earlier signature (x, y, lo, span,
    replicas, n, v, c, problem, stream): a thread a row, walking it in
    global memory.  The two run in turns in one process (old, new, new,
    old), so they are compared on one card.

Every launch's output is held against the plain twin first.  Exits 2
without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

OPS_SHAPES = ((65536, 2, 16), (8192, 2, 16), (1024, 32, 16), (4096, 64, 16),
              (1024, 3, 128), (1024, 6, 128), (65536, 100, 3))
PROBE_SHAPES = ((65536, 2, 16), (4096, 64, 16))
BEST_SHAPES = ((65536, 2, 16), (8192, 2, 16), (4096, 64, 16), (1024, 3, 128))
KERNELS = ("ga_operators", "ga_best", "ga_ffm")
FFM_SHAPES = (("rastrigin", 8192, 2, 16), ("rastrigin", 65536, 2, 16),
              ("rastrigin", 1024, 32, 16), ("sphere", 4096, 64, 16),
              ("rosenbrock", 4096, 64, 16), ("ackley", 4096, 64, 16))
FORM_SHAPES = tuple((p, n, v, 16) for p in ("rastrigin", "sphere")
                    for n in (1024, 8192, 65536) for v in (2, 4, 8, 16))


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


def ffm_at(K, x, prog, tile, chunk, spread):
    """A call of ga_ffm at an explicit (tile, chunk) and form."""
    lib = K.kernel_library()
    r, n, v = x.shape
    lo, span = prog.device_consts(x.device)

    def run():
        y = torch.empty((r, n), dtype=torch.float32, device=x.device)
        err = lib.ga_ffm_launch(
            x.data_ptr(), y.data_ptr(), lo.data_ptr(), span.data_ptr(), r, n,
            v, prog.bits_per_var, K.PROBLEM_IDS[prog.name],
            tile, chunk, int(spread), torch.cuda.current_stream().cuda_stream)
        K._check_launch(err, "ga_ffm")
        return (y,)
    return run


def baseline_ffm(path):
    """`ga_ffm_launch` of another build of ga_step.cu, with the earlier
    signature, compiled with the port's flags into build/."""
    from repro_torch.kernels import build
    out = ROOT / "build" / "baseline_ga_step.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
                    str(path)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ga_ffm_launch.argtypes = [p] * 4 + [i] * 5 + [p]
    lib.ga_ffm_launch.restype = i
    return lib


def old_ffm_at(K, lib, x, prog):
    """A call of the baseline's ga_ffm."""
    r, n, v = x.shape
    lo, span = prog.device_consts(x.device)

    def run():
        y = torch.empty((r, n), dtype=torch.float32, device=x.device)
        err = lib.ga_ffm_launch(
            x.data_ptr(), y.data_ptr(), lo.data_ptr(), span.data_ptr(), r, n,
            v, prog.bits_per_var, K.PROBLEM_IDS[prog.name],
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline ga_ffm: CUDA error {err}")
        return (y,)
    return run


def held(got, want, what):
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise SystemExit(f"{what}: kernel and plain differ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the rows here")
    ap.add_argument("--only", nargs="+", default=KERNELS, choices=KERNELS,
                    help="time these kernels only")
    ap.add_argument("--baseline", default=None,
                    help="a ga_step.cu with the earlier ga_ffm_launch, "
                         "timed beside ga_ffm")
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

    for n, v, r in OPS_SHAPES * ("ga_operators" in args.only):
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

    for n, v, r in PROBE_SHAPES * ("ga_operators" in args.only):
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

    for n, v, r in BEST_SHAPES * ("ga_best" in args.only):
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
    from repro_torch.core import fitness as TF
    old = baseline_ffm(args.baseline) if args.baseline else None
    for problem, n, v, r in FFM_SHAPES * ("ga_ffm" in args.only):
        prog = TF.compile_program(problem=f"{problem}:{v}", bits_per_var=16)
        x = CS.edge_banks(r, n, v, 16, 5 * n + v, dev)[0]
        want = (prog.stage(x),)
        spread = K.ffm_spreads(n, v, r)
        chosen, chunk = K.ffm_tiling(n, v, r)
        if old is not None:
            base = old_ffm_at(K, old, x, prog)
            held(base(), want, f"baseline ga_ffm {problem}:{v} N={n}")
            first = CS.graph_ms(base)
        low = 1 if spread else K.FFM_THREADS
        high = K.FFM_THREADS if spread else K.FFM_ROWS_TILE
        for tile in sorted({chosen // 2, chosen, 2 * chosen}):
            if not (low <= tile <= high and K.ffm_tile_bytes(
                    tile, chunk, spread) <= K.FFM_SMEM_LIMIT):
                continue
            run = ffm_at(K, x, prog, tile, chunk, spread)
            held(run(), want, f"ga_ffm {problem}:{v} N={n} tile={tile}")
            rows.append({"kernel": "ga_ffm", "problem": problem, "n": n,
                         "v": v, "replicas": r, "spread": spread,
                         "tile": tile, "chunk": chunk,
                         "chosen": tile == chosen,
                         "graph_ms": CS.graph_ms(run)})
            print(f"ga_ffm {problem}:{v} N={n} x{r} "
                  f"{'spread' if spread else 'rows'} tile {tile} chunk "
                  f"{chunk}{' (chosen)' if tile == chosen else ''}: "
                  f"{rows[-1]['graph_ms']:.4f} ms  [{card}]")
        if old is not None:
            new = CS.graph_ms(ffm_at(K, x, prog, chosen, chunk, spread))
            rows.append({"kernel": "ga_ffm", "baseline": True,
                         "problem": problem, "n": n, "v": v, "replicas": r,
                         "baseline_graph_ms": [first, CS.graph_ms(base)],
                         "chosen_graph_ms": new})
            print(f"ga_ffm {problem}:{v} N={n} x{r}: baseline "
                  f"{first:.4f}, {rows[-1]['baseline_graph_ms'][1]:.4f} ms "
                  f"around the chosen tile's {new:.4f} ms  [{card}]")
        del x, want

    for problem, n, v, r in FORM_SHAPES * ("ga_ffm" in args.only):
        prog = TF.compile_program(problem=f"{problem}:{v}", bits_per_var=16)
        x = CS.edge_banks(r, n, v, 16, 7 * n + v, dev)[0]
        want = (prog.stage(x),)
        row = {"kernel": "ga_ffm", "forms": True, "problem": problem,
               "n": n, "v": v, "replicas": r,
               "chosen": "spread" if K.ffm_spreads(n, v, r) else "rows"}
        for form, spread in (("rows", False), ("spread", True)):
            tile, chunk = K.ffm_tiling(n, v, r, spread)
            if K.ffm_tile_bytes(tile, chunk, spread) > K.FFM_SMEM_LIMIT:
                continue
            run = ffm_at(K, x, prog, tile, chunk, spread)
            held(run(), want, f"ga_ffm {problem}:{v} N={n} {form}")
            row[f"{form}_tile"] = tile
            row[f"{form}_graph_ms"] = CS.graph_ms(run)
        rows.append(row)
        print(f"ga_ffm {problem}:{v} N={n} x{r}: rows form "
              f"{row.get('rows_graph_ms', float('nan')):.4f} ms (tile "
              f"{row.get('rows_tile')}), spread form "
              f"{row['spread_graph_ms']:.4f} ms (tile {row['spread_tile']});"
              f" ffm_spreads chooses {row['chosen']}  [{card}]")
        del x, want
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
