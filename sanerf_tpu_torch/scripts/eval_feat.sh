#!/bin/bash
# Stage-2 SAM-feature evaluation: teacher-feature MSE + point-IoU debug on
# the val split (reference scripts/eval_feat.sh)
python -m sanerf_tpu_torch.apps.main "$1" \
  --workspace "${2:-trial_sam}" \
  --enable_cam_center --data_type "${3:-mip}" \
  --test --test_split val --val_type val_all \
  --with_sam --sam_use_view_direction --num_rays 16384
