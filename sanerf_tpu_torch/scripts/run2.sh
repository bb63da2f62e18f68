#!/bin/bash
# LLFF sweep: stage-1 RGB then stage-2 SAM distillation per scene
# (reference scripts/run2.sh; run1.sh covers the Mip-360 sweep)
DATA_ROOT="${DATA_ROOT:-data/nerf_llff_data}"
for scene in fern horns orchids; do
  python -m sanerf_tpu_torch.apps.main "$DATA_ROOT/$scene" \
    --workspace "trial_$scene" --data_type llff --downscale 4
  python -m sanerf_tpu_torch.apps.main "$DATA_ROOT/$scene" \
    --workspace "trial2_$scene" --data_type llff --downscale 4 \
    --with_sam --init_ckpt "trial_$scene/checkpoints" --iters 5000
done
