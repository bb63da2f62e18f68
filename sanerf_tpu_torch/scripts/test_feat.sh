#!/bin/bash
# Offline feature-render test frames + per-frame .npy dumps
# (reference scripts/test_feat.sh; --return_extra saves <name>_sam.npy)
python -m sanerf_tpu_torch.apps.main "$1" \
  --workspace "${2:-trial_sam}" \
  --enable_cam_center --data_type "${3:-mip}" \
  --test --test_split test \
  --with_sam --sam_use_view_direction --num_rays 16384 --return_extra
