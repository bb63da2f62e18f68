#!/bin/bash
# Interactive RGB viewer (reference scripts/test_rgb_gui.sh), rendered on
# the port's ray and field kernels for the MLP family.
# Falls back to the headless viewer automatically when dearpygui is absent.
python -m sanerf_tpu_torch.apps.main "$1" \
  --workspace "${2:-trial_rgb}" \
  --enable_cam_center --data_type "${3:-mip}" \
  --test --gui --W 512 --H 512 --max_ray_batch 262144
