#!/usr/bin/env python3
"""Where ga_ffm's time goes on one CUDA card: probe builds of its steps.

    python3 scripts/torch_ffm_probes.py [--out probes.json]

Compiles two probe copies of src/repro_torch/kernels/csrc/ga_step.cu with
the port's flags into build/ffm_probes/:

  * `load` ends each block after step 1 of ga_ffm (the tile's words in
    shared memory): y gets one word of the tile, no FFM is evaluated;
  * `terms` ends it after the spread form's term pass (rastrigin and
    ackley; sphere and rosenbrock have no pass): y gets one term, nothing
    is folded.

It times both (device ms a launch by a CUDA graph of 20 launches,
`chip_smoke.graph_ms`) beside the real ga_ffm (held against its plain twin
first) and beside `clone()` of x, at chip_smoke.py phase 17's ga_ffm
shapes, all on the same card tensors.  A probe's y is not the FFM.  The
probes edit the source at fixed lines and stop if one is missing.  Exits 2
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
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "ga_step.cu"

SHAPES = (("rastrigin", 8192, 2, 16), ("rastrigin", 65536, 2, 16),
          ("rastrigin", 1024, 32, 16), ("sphere", 4096, 64, 16),
          ("rosenbrock", 4096, 64, 16), ("ackley", 4096, 64, 16))

# the rows form's evaluation, and the spread form's code after the load and
# after the term pass
ROWS_FFM = ("    ffm<K>(problem, TileDecoder{w, stride, mask, tlo, tspan}, i, "
            "v, out);\n")
ROWS_WORD = ("    for (int k = 0; k < K; ++k) out[k] = "
             "__uint_as_float(w[i[k] * stride]);\n")
AFTER_LOAD = "      if constexpr (cos_terms) {\n"
LOAD_OUT = ("      if (tid < here) y[row0 + tid] = "
            "__uint_as_float(w[tid * stride]);\n      return;\n")
AFTER_TERMS = ("        __syncthreads();\n      }\n"
               "      if (tid < here && terms > 0) {")
TERMS_OUT = ("        __syncthreads();\n"
             "        if (tid < here) y[row0 + tid] = t[tid * stride];\n"
             "        return;\n      }\n"
             "      if (tid < here && terms > 0) {")
PROBES = {"load": ((ROWS_FFM, ROWS_WORD), (AFTER_LOAD, LOAD_OUT + AFTER_LOAD)),
          "terms": ((AFTER_TERMS, TERMS_OUT),)}


def build_probes(build) -> dict:
    """name -> the ctypes library of that probe build."""
    out_dir = ROOT / "build" / "ffm_probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    source, procs, libs = SRC.read_text(), {}, {}
    for name, edits in PROBES.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"probe {name}: the line {old!r} of "
                                 f"{SRC.name} is gone; update this script")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
             str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"probe {name} did not build:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        lib.ga_ffm_launch.argtypes = [p] * 4 + [i] * 8 + [p]
        lib.ga_ffm_launch.restype = i
        libs[name] = lib
    return libs


def ffm_call(K, lib, x, prog):
    """A call of `lib`'s ga_ffm at the wrapper's form and tiling."""
    r, n, v = x.shape
    lo, span = prog.device_consts(x.device)
    spread = K.ffm_spreads(n, v, r)
    tile, chunk = K.ffm_tiling(n, v, r, spread)

    def run():
        y = torch.empty((r, n), dtype=torch.float32, device=x.device)
        err = lib.ga_ffm_launch(
            x.data_ptr(), y.data_ptr(), lo.data_ptr(), span.data_ptr(), r, n,
            v, prog.bits_per_var, K.PROBLEM_IDS[prog.name], tile, chunk,
            int(spread), torch.cuda.current_stream().cuda_stream)
        K._check_launch(err, "ga_ffm probe")
        return y
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the rows here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_ffm_probes: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as CS
    from repro_torch.core import fitness as TF
    from repro_torch.kernels import build
    from repro_torch.kernels import ga_step as K
    build.build_all(["ga_step"])
    libs = {"ga_ffm": K.kernel_library(), **build_probes(build)}
    dev = torch.device("cuda")
    card = CS.card_line()
    print(card)
    rows = []
    for problem, n, v, r in SHAPES:
        prog = TF.compile_program(problem=f"{problem}:{v}", bits_per_var=16)
        x = CS.edge_banks(r, n, v, 16, 5 * n + v, dev)[0]
        if not torch.equal(ffm_call(K, libs["ga_ffm"], x, prog)(),
                           prog.stage(x)):
            raise SystemExit(f"ga_ffm {problem}:{v} N={n}: kernel and plain "
                             "differ")
        row = {"problem": problem, "n": n, "v": v, "replicas": r,
               "spread": K.ffm_spreads(n, v, r),
               "tile_chunk": K.ffm_tiling(n, v, r)}
        for name in ("ga_ffm", "load", "terms"):
            if name == "terms" and not (row["spread"] and problem in
                                        ("rastrigin", "ackley")):
                continue
            row[f"{name}_graph_ms"] = CS.graph_ms(
                ffm_call(K, libs[name], x, prog))
        flat = torch.empty(x.numel(), dtype=torch.int32, device=dev)
        row["clone_graph_ms"] = CS.graph_ms(flat.clone)
        rows.append(row)
        print(f"ga_ffm {problem}:{v} N={n} x{r} "
              f"({'spread' if row['spread'] else 'rows'} form, (tile, chunk) "
              f"{row['tile_chunk']}): whole {row['ga_ffm_graph_ms']:.4f} ms;"
              f" load only {row['load_graph_ms']:.4f}"
              + (f"; load and terms {row['terms_graph_ms']:.4f}"
                 if "terms_graph_ms" in row else "")
              + f"; clone() of x {row['clone_graph_ms']:.4f}  [{card}]")
        del x, flat
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
