#!/bin/bash
# Stage-1 RGB evaluation on the val split (reference scripts/eval_rgb.sh)
python -m sanerf_tpu_torch.apps.main "$1" \
  --workspace "${2:-trial_rgb}" \
  --enable_cam_center --data_type "${3:-mip}" \
  --test --test_split val --val_type val_all --num_rays 16384
