#!/bin/bash
# Two-stage Mip-360 sweep (reference scripts/run1.sh): stage-1 20k iters
# then stage-2 --with_sam --iters 5000 per scene.
DATA_ROOT=${1:-data}
python -m sanerf_tpu_torch.apps.batch train-rgb --data_root "$DATA_ROOT" --data_type mip
python -m sanerf_tpu_torch.apps.batch train-sam --data_root "$DATA_ROOT" --data_type mip
