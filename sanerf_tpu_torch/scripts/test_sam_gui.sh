#!/bin/bash
# Interactive segmentation viewer (reference scripts/test_sam_gui.sh)
python -m sanerf_tpu_torch.apps.main "$1" \
  --workspace "${2:-trial_sam}" --test --gui --with_sam \
  --sam_use_view_direction --data_type mip
