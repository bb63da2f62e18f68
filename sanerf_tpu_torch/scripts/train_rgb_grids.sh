#!/bin/bash
# Stage 1 with the measured-best GRID-family field (README "Field-family
# quality gate"): shallow depth-3 decoder over high-resolution CP + VM
# ladders with TV, coarse-to-fine encode annealing, table upsampling and
# DIRECT-density sigma grids (TensoRF §4.1). 18.57 dB held-out on the
# adversarial fixture at 4k iters vs 19.47 for the hashgrid family (the
# JAX package's numbers). Training runs the plain path; the tables of this
# recipe are past RenderConfig.grid_vmem_budget, so its renders take the
# plain path too (the CUDA field kernels, csrc/fused_mlp_t.cu, serve grid
# models whose tables fit that budget).
python -m sanerf_tpu_torch.apps.main "$1" \
  --workspace "${2:-trial_rgb_grids}" \
  --enable_cam_center --data_type mip --iters 20000 \
  --val_type default --random_image_batch \
  --mlp_depth 3 \
  --cp_rank 96 --cp_res 2048 --cp_levels 4 \
  --vm_rank 32 --vm_res 1024 --vm_levels 4 \
  --sigma_cp_rank 96 --sigma_cp_res 2048 \
  --sigma_vm_rank 16 --sigma_vm_res 512 \
  --lambda_tv 1e-3 --anneal_iters 4000 \
  --grid_upsample_steps 2000 4000 8000
