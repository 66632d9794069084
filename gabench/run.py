"""Run one cell of the port's benchmark once and print its result.

    python3 gabench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout: `BENCHMARK.json` names the cells, and each
cell's configuration and traffic files sit under `gabench/`.  The port
(`src/repro_torch`) runs on the card; without one the run fails, and it
never falls back to the CPU.  The last line of standard output is the
result as one JSON object; the numbers the check compared, each beside
its limit, are the last lines of standard error.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    with open(ROOT / "BENCHMARK.json") as f:
        manifest = json.load(f)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; cells: {sorted(cells)}",
              file=sys.stderr)
        return 2

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the port on the card "
              "and does not run on the CPU", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} cards, this host has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2

    from gabench.harness import forbidden_loaded, run_cell
    result = run_cell(ROOT, manifest, args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t0=T0)
    found = forbidden_loaded(sys.modules)
    if found:
        print(f"the run's process loaded {found}: the benchmark measures the "
              "port alone", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
