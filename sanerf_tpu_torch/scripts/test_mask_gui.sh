#!/bin/bash
# Interactive mask viewer: composition render of the trained mask field
# (reference scripts/test_mask_gui.sh)
python -m sanerf_tpu_torch.apps.main "$1" \
  --workspace "${2:-trial_mask}" \
  --enable_cam_center --data_type "${3:-mip}" \
  --test --gui --W 512 --H 512 \
  --with_mask --mask_mlp_type default --adaptive_mlp_type density \
  --render_mask_type composition --sum_after_mlp
