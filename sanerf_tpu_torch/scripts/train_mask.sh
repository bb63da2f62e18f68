#!/bin/bash
# Stage 3: mask field (reference scripts/train_mask.sh flag set)
python -m sanerf_tpu_torch.apps.main "$1" \
  --workspace "${2:-trial_mask}" \
  --enable_cam_center --with_mask --data_type mip \
  --patch_size 1 --num_rays 6000 --iters 1000 \
  --rgb_similarity_loss_weight 5 --rgb_similarity_threshold 0.15 \
  --incoherent_uncertainty_weight 1 --redundant_instance 0 \
  --mask_mlp_type adaptive --adaptive_mlp_type density --sum_after_mlp \
  --mask_folder_name "${4:-object_masks}" --init_ckpt "$3" \
  --rgb_similarity_num_sample 20 --num_local_sample 16 \
  --local_sample_patch_size 16 --mixed_sampling \
  --use_dynamic_incoherent --incoherent_downsample_scale 4 --error_map
