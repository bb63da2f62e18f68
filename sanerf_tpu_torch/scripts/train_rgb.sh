#!/bin/bash
# Stage 1: RGB NeRF (reference scripts/train_rgb.sh)
python -m sanerf_tpu_torch.apps.main "$1" \
  --workspace "${2:-trial_rgb}" \
  --enable_cam_center --data_type mip --iters 20000 \
  --val_type default --random_image_batch
