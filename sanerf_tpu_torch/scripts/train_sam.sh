#!/bin/bash
# Stage 2: SAM feature distillation (reference scripts/train_sam.sh)
python -m sanerf_tpu_torch.apps.main "$1" \
  --workspace "${2:-trial_sam}" \
  --enable_cam_center --with_sam --data_type mip --iters 5000 \
  --sam_use_view_direction --init_ckpt "$3"
