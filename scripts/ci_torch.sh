#!/usr/bin/env bash
# The PyTorch port's counterpart of scripts/ci.sh: its tests, then the
# launch smokes of the port's GA engine.  The benchmark steps and the bench
# regression gate of scripts/ci.sh are not ported.
#
#   bash scripts/ci_torch.sh               # on the card (the default)
#   DEVICE=cpu bash scripts/ci_torch.sh    # on the CPU
#
# The parity tests import the JAX package as their reference; the card
# tests (tests/test_torch_cuda.py) skip without a card.
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
DEVICE="${DEVICE:-cuda}"

echo "== the port's tests =="
python -m pytest -q tests/test_torch_*.py

echo "== engine smoke (reference backend) =="
timeout 120 python -m repro_torch.launch.ga_run \
    --problem F1 --n 16 --k 20 --backend reference --device "$DEVICE"

echo "== n-variable smoke (rastrigin:4 through the fused kernel FFM stage) =="
timeout 120 python -m repro_torch.launch.ga_run \
    --problem rastrigin:4 --n 16 --k 20 --backend fused --mode arith \
    --device "$DEVICE"

echo "== mesh smoke (fused-islands on every device of the host, RESIDENT"
echo "   epochs: gens_per_epoch > migrate_every, the ring inside K2) =="
timeout 180 python -m repro_torch.launch.ga_run \
    --problem rastrigin:4 --n 16 --k 16 --islands 2 --migrate-every 4 \
    --backend fused-islands --mesh auto --gens-per-epoch 8 \
    --device "$DEVICE"

echo "== scheduler smoke (packing + preemption on 8 logical shards; per-job"
echo "   bests bit-identical to solo runs) =="
timeout 420 python scripts/torch_scheduler_smoke.py --device "$DEVICE"

echo "== chaos smoke (fault injection: crash retry, corrupt checkpoint"
echo "   fallback, pack quarantine, preemption + journal recovery) =="
timeout 420 python scripts/torch_chaos_smoke.py --device "$DEVICE"

echo "== autotune smoke (a tiny sweep; the table written, the planner"
echo "   consumes it) =="
mkdir -p artifacts
timeout 420 python scripts/torch_autotune_smoke.py --device "$DEVICE" \
    --out artifacts/torch_autotune_table.json

echo "== streaming smoke (8 islands through the streamed mode under a"
echo "   planning shared-memory budget; bit-identical to islands) =="
timeout 420 python scripts/torch_streaming_smoke.py --device "$DEVICE"

echo "== dry-run smoke (one cell on the meta mesh: no allocation, no"
echo "   kernel; runs on the host whatever DEVICE is) =="
timeout 300 python -m repro_torch.launch.dryrun --arch minitron-8b \
    --shape train_4k --mesh pod1 --out artifacts/dryrun_results_torch

echo "== roofline table of the dry-run smoke's cell =="
python scripts/torch_roofline_table.py artifacts/dryrun_results_torch pod1

echo "CI OK"
