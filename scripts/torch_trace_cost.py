#!/usr/bin/env python3
"""What the port's span recorder (`repro_torch.trace`) costs when on, on
one CUDA card, with no profiler running.

    python3 scripts/torch_trace_cost.py --config CONF.json --kind stream \
        --seconds 10 --seeds 3 [--out cost.json]

CONF.json holds a `spec` (the `ga.GASpec` fields), a `backend` and, for a
stream, `chunk_generations`.  For each seed, in one process, it runs the
spec with the recorder off and on, the order alternating by seed (off,
on; on, off; ...):

  * `--kind stream`: one `Engine.run_chunked` run; its first chunk warms
    up, then chunks run for `--seconds`; the rate is replicas x N x
    generations over the chunks' host seconds.
  * `--kind jobs`: one warm `solve`, then `solve` of spec seeds `seed`,
    `seed + replicas`, ... for `--seconds`; the job median and the rate.

The same seeds feed both sides.  The recorder is emptied before each run;
each line gives the spans it kept and dropped.  Prints one JSON object
(the card's name and power limit beside every number) and writes it to
`--out`.  Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import ga  # noqa: E402
from repro_torch import trace as TR  # noqa: E402


def card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0)


def stream(spec, backend, options, chunk, seconds) -> dict:
    eng = ga.Engine(spec, backend, options=options)
    chunks = eng.run_chunked(chunk_generations=chunk,
                             generations=1_000_000_000)
    next(chunks)                        # the warm-up chunk
    torch.cuda.synchronize()
    gens, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        gens += next(chunks)["chunk_gens"]
    dt = time.perf_counter() - t0
    chunks.close()
    return {"evals_per_s": spec.n_repeats * spec.n * gens / dt,
            "gens": gens, "seconds": dt}


def jobs(spec, backend, options, seconds) -> dict:
    ga.solve(dataclasses.replace(spec, seed=spec.seed - spec.n_repeats),
             backend, options=options)
    torch.cuda.synchronize()
    times, gens, j = [], 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        s = dataclasses.replace(spec, seed=spec.seed + spec.n_repeats * j)
        j += 1
        ta = time.perf_counter()
        res = ga.solve(s, backend, options=options)
        times.append(time.perf_counter() - ta)
        gens += res.generations
    dt = time.perf_counter() - t0
    return {"evals_per_s": spec.n_repeats * spec.n * gens / dt,
            "job_median_ms": 1e3 * statistics.median(times),
            "jobs": len(times), "seconds": dt}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--kind", choices=("stream", "jobs"), required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--seed0", type=int, default=2 ** 31 + 101)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the recorder's cost is measured on the card",
              file=sys.stderr)
        return 2
    conf = json.loads(Path(args.config).read_text())
    options = ga.EngineOptions(device="cuda", cost_table=False, faults=False)
    spec0 = ga.GASpec(**conf["spec"])
    runs = []
    for i in range(args.seeds):
        seed = args.seed0 + 1000 * i
        spec = dataclasses.replace(spec0, seed=seed)
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            TR.clear()
            (TR.enable if on else TR.disable)()
            if args.kind == "stream":
                r = stream(spec, conf["backend"], options,
                           conf["chunk_generations"], args.seconds)
            else:
                r = jobs(spec, conf["backend"], options, args.seconds)
            TR.disable()
            r.update(seed=seed, trace=on, spans=len(TR.records()),
                     dropped=TR.dropped())
            runs.append(r)
            print(json.dumps(r), file=sys.stderr, flush=True)
    TR.clear()
    key = "job_median_ms" if args.kind == "jobs" else "evals_per_s"
    med = {side: statistics.median(r[key] for r in runs if r["trace"] == on)
           for side, on in (("off", False), ("on", True))}
    out = {"config": args.config, "kind": args.kind, "card": card(),
           "metric": key, "median": med,
           "on_over_off": med["on"] / med["off"], "runs": runs}
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
