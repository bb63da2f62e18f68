#!/bin/bash
# The hashgrid-family quality gate at the reference recipe's 20k
# iterations (the reference's main.py:75-76) on the CUDA card, the twin of
# tools/run_hashgrid20k.sh: per-epoch checkpoints + --resume, so that a
# run cut by a time limit goes on from its last epoch when started again.
# The hash grid trains and renders on the plain path, its encode on the
# hash_grid_forward kernel and its table gradient on hash_grid_backward
# (csrc/hashgrid.cu).
#
# Usage: bash sanerf_tpu_torch/scripts/run_hashgrid20k.sh [workspace] [iters]
WS=${1:-/tmp/qg20k}
ITERS=${2:-20000}
for i in $(seq 1 30); do
  echo "== attempt $i ($(date -u +%H:%M:%S)) =="
  timeout 16000 python -m sanerf_tpu_torch.tools.quality_gate --families hashgrid \
    --iters "$ITERS" --save_cnt $((ITERS / 500)) --resume \
    --workspace "$WS" && exit 0
  echo "== attempt $i failed (rc=$?); resuming in 30 s =="
  sleep 30
done
exit 1
