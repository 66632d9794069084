#!/usr/bin/env python3
"""Render a dry-run results directory of the PyTorch port as the roofline
table (the markdown of scripts/roofline_table.py, from the records that
`repro_torch.launch.dryrun` writes, one JSON file a cell):

    python scripts/torch_roofline_table.py [RESULTS_DIR [pod1|pod2]]

RESULTS_DIR defaults to `repro_torch.launch.dryrun.RESULTS_DIR`, where
`python -m repro_torch.launch.dryrun` writes without `--out`.

Or render a cost table written by the port's autotune as a measured-plan
table (each epoch mode's gens/s as a fraction of the best plan measured for
its spec):

    python scripts/torch_roofline_table.py --ga-cost-table path/to/table.json
"""
import glob
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def render_ga(path):
    from repro_torch.autotune import CostTable
    from repro_torch.roofline import ga_measured_points
    table = CostTable.load(path)
    if table is None:
        print(f"no usable cost table at {path}")
        return 1
    print("| stage | migration | mode | N | I/shard | shards | E |"
          " gens/launch | gens/s | % of best | reps | cov |")
    print("|---|---|---|---|---|---|---|---|---|---|---|---|")
    for r in ga_measured_points(table):
        print(f"| {r['stage']} | {r['migration']} | {r['mode']} | {r['n']} |"
              f" {r['i_local']} | {r['shards']} | {r['E']} |"
              f" {r['gens_per_launch']} |"
              f" {r['gens_per_s']:.1f} | {r['frac_of_best']*100:.1f} |"
              f" {r['reps']} | {r['cov']:.3f} |")
    return 0


def render_dryrun(dirname, mesh):
    print("| arch | shape | compute (ms) | memory (ms) | collective (ms) |"
          " dominant | MODEL/HLO | roofline % | temp GiB/dev |")
    print("|---|---|---|---|---|---|---|---|---|")
    for f in sorted(glob.glob(f"{dirname}/*.json")):
        with open(f) as fh:
            d = json.load(fh)
        if d.get("mesh") != mesh:
            continue
        if d["status"] != "ok":
            print(f"| {d['arch']} | {d['shape']} | — | — | — | *skipped* |"
                  " — | — | — |")
            continue
        print(f"| {d['arch']} | {d['shape']} | {d['t_compute']*1e3:.1f} |"
              f" {d['t_memory']*1e3:.1f} | {d['t_collective']*1e3:.1f} |"
              f" {d['dominant']} | {d['useful_flops_ratio']:.2f} |"
              f" {d['roofline_fraction']*100:.1f} |"
              f" {d['memory_analysis']['temp_size_in_bytes']/2**30:.1f} |")
    return 0


def main(argv):
    if len(argv) > 0 and argv[0] == "--ga-cost-table":
        return render_ga(argv[1])
    if len(argv) > 0:
        dirname = argv[0]
    else:
        from repro_torch.launch.dryrun import RESULTS_DIR
        dirname = RESULTS_DIR
    mesh = argv[1] if len(argv) > 1 else "pod1"
    return render_dryrun(dirname, mesh)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
