"""Read the control on the card: the plain reference with its fitness in
bfloat16, put in the program's place, run through a cell's whole
harness (its traffic, window, samples and check) at the cell's own
sizes, once a seed in one process.  Every seed must come out not
correct; the numbers it prints are the control's readings that the
limits sit below.  The benchmark's own runs never run it.

    python3 gabench/control.py --workload <cell> --seeds 1 2 3 \
        --seconds 5
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from gabench.harness import run_cell
    with open(ROOT / "BENCHMARK.json") as f:
        manifest = json.load(f)
    rejected = True
    for seed in args.seeds:
        res = run_cell(ROOT, manifest, args.workload, seed, args.seconds,
                       False, device="cuda", t0=time.perf_counter(),
                       system="control-bf16")
        rejected &= not res["correct"]
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "check": res["check"]}))
    return 0 if rejected else 1


if __name__ == "__main__":
    sys.exit(main())
