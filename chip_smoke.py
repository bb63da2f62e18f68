"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. build the CUDA kernels from sanerf_tpu_torch/csrc (one nvcc per source,
     all started together, and beside them fused_mlp_t.cu with the planted
     faults PROP_FAULT, in prop_kernel, RING_FAULT, in the bf16 V_WIDE
     kernels' weight ring, GRID_FAULT, in the V_GRID kernels' encoders,
     and F32_RING_FAULT, in the float32 V_WIDE32 kernels' ring, into
     PLANTED_DIR) and print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card, at
     every shape the main path gives it (captured from 512^2 frames of the
     shipped asset at the (32, 16) and (128, 64, 32) hierarchies; each
     launch timed, with its bound) and at small ragged shapes. Ray
     kernels: 1e-5 (|d| <= tol + tol |ref|). MLP
     kernels: with the serving bf16 weights the JAX suite's 0.05 (see
     MLP_TOL), and with float32 weights the JAX suite's float32 bounds,
     element by element, and against the float64 plain version within
     F32_F64_MULT times cuBLAS float32's own error;
  3. drive the main path: a 512^2 frame of assets/serving_student through
     render_frame at (32, 16) and at (128, 64, 32) with bf16 params, with
     every launch counter set to 0 just before and read just after; then
     the fast path against the plain path with float32 params (2e-3, see
     PATH_TOL) and frame times;
  4. held-out PSNR on the textured fixture (bench.py:149-170 protocol)
     against the JAX package's value for the same protocol;
  5. the interactive segmentation frame (bench.py's product loop): the
     asset with a seeded SAM feature head and SAM's full decoder
     (`SamConfig()`, seeded bf16 weights), one 3D point at the origin,
     512^2 through `InteractiveSession.step` at (32, 16) and (128, 64, 32),
     launch counters set to 0 just before a frame and read just after,
     finite depth / samvit [32, 32, 256] / mask logits; every kernel
     launch of one such frame (RGB and feature render) held against its
     plain version as in phase 2 (bf16 weights and their float32 twins)
     and timed against its bound, summed per kernel as its loss per frame;
     ray_level0's launch shapes (the 512^2 RGB render's and the 1,024-ray
     feature render's) also as medians of PROBE_REPS interleaved launches
     queued behind a backlog, with their 10th and 90th percentiles;
  6. the render options on the same frames: `flatten_kernel` (flatten3_nt
     launches, pixels identical to the default) and `packed_epilogue` on
     the RGB frame (within 1e-6 of the default), each path driven with the
     counters set to 0; flatten3_nt and the packed variants of ray_level0,
     ray_level and run_tmlp_composite held against their plain versions at
     those frames' shapes and at ragged ones; flatten3_nt timed against
     its `clone` as medians of PROBE_REPS interleaved launches;
  7. mask mIoU of assets/serving_student_mask through the port's fast path
     (bench.py:173-225 protocol) against the JAX package's value;
  8. interactive frame times (bench.py:_drive protocol), pipelined and sync;
  9. the table gather `gather_rows` at the shapes of the eight Pallas probes
     of tools/probe_gather.py (2^19-row tables, 2^21 indices; C = 2, 128
     and 8-row blocks; float32 and bf16), bit for bit against its plain
     version, with the out-of-range fill, bounds, and the kernel's and
     `torch.index_select`'s times as medians of PROBE_REPS interleaved
     launches queued behind a backlog (the card's time; also unqueued, on
     an idle card, where the host's work before each kernel counts);
 10. the hash-grid family's interactive frame: `ModelConfig(field_type=
     "hashgrid", with_sam=True)` at full width, tables redrawn
     U(-TABLE_STD, TABLE_STD), bf16, 512^2 through `InteractiveSession.step`
     at (128, 64, 32) with SAM's seeded decoder, the counters of
     hash_grid_forward and gather_rows set to 0 just before a frame and
     read just after (HASHGRID_LAUNCHES and 0), finite depth / samvit
     [32, 32, 256] / mask logits, every hash_grid_forward launch of that
     frame bit for bit (torch.equal) against its plain version and timed
     against it and the parent's route, the level route on the gather_rows
     kernel (medians of HASHGRID_REPS interleaved launches, summed; byte
     bound from the rows the points touch), FORWARD_FAULTS planted in the
     kernel's level inputs at the first, the first hashed and the last
     level of each grid and its smoothstep flag flipped, each caught by
     that hold; frame times and the 512^2 RGB render, this route and the
     parent's in turns;
 11. the same RGB frame with float32 params, on the plain route (the level
     route on the plain gather) inside this script: identical to the
     kernel's frame;
 12. a 64^2 frame of the same model with the numpy-seeded params of
     port_tools/hashgrid_params.py against the JAX package's values
     (JAX_HASHGRID, 2e-3);
 13. `run_rays(return_mask=True)` at 512^2 with the default mask head
     (MASK_LAUNCHES hash_grid_forward launches and no gather, each held
     and timed as in 10, the faults planted in the m_grid's; finite
     logits);
 14. the MLP family's factorized-grid configurations that the kernels
     serve (GRID_SERVED: VM planes, CP and VM ladders, sigma-CP; full
     width, numpy-seeded params of port_tools/grid_params.py, bf16 and
     float32 twins): every encoding column and the sigma sum of each
     field's tables read back through run_tmlp's encode probes (PROBE_TOL;
     the bf16 probes on their field's route); a 512^2 RGB frame of each
     through render_frame at (32, 16) and (128, 64, 32), the counters set
     to 0 just before and read just after (GRID_LAUNCHES), each of the
     frame's run_tmlp launches (the default w64 d4 proposal nets') on
     prop_kernel and its composite on the V_GRID kernels where the field
     takes them (grid_student's; the ladders, whose weights stream, keep
     V_SERVED), every run_tmlp /
     run_tmlp_composite launch held against its plain version (bf16 at
     GRID_TOL, float32 twins as in phase 2 and at F32_FAITHFUL; the probes
     too) and timed against its bound and against the same launch on the
     route before V_GRID (route_twin), frame times, ptxas's registers
     and spills of the V_GRID kernels (every instance found in the nvcc
     log of the library loaded) and none of them serialized (C7511);
     grid_student's (32, 16) proposal launch on prop_kernel built with
     PROP_FAULT, and its composite on the V_GRID kernels built with
     GRID_FAULT, fail that hold;
 15. grid_student with a seeded SAM head through InteractiveSession.step
     at 512^2, (32, 16): launch counts (its two proposal launches on
     prop_kernel, the field's density query with tables and the composite
     on V_GRID), finite depth / samvit / mask logits, every MLP launch
     held (bf16, GRID_TOL), frame times;
 16. the sigma-VM model of port_tools/grid_params.py (sigma-CP and
     sigma-VM tables beside CP and VM features): its encode probes, its
     launches at SIGMA_RAYS ragged rays (the field's on V_GRID) held
     against their plain versions, and the fast path against the plain
     path;
 17. quality_recipe, over RenderConfig.grid_vmem_budget: not on the fast
     path, a 512^2 frame with 0 kernel launches, its time;
 18. 64^2 frames of grid_student (fast path) and quality_recipe (plain
     path) against the JAX package's values (JAX_GRID, 2e-3);
 T1. stage-1 training, the convergence protocol of
     tests/test_train_e2e.py:40-74 on the card: its hash-grid and MLP
     configurations on the 48^2 12-view sphere fixture, 400 steps of its
     TrainConfig; PSNR of view 0 > before + 5 dB and > 15 dB; it/s;
 T2. the default ModelConfig() (w128 d8) and ModelConfig(field_type=
     "hashgrid") at full width with RenderConfig() and TrainConfig()
     through Trainer.train on the textured fixture, 2 epochs of 4 steps
     with 64^2 evaluation; the launch counters set to 0 before the run
     and read after; one evaluation frame's launches counted, each float32
     launch of the MLP's held against its plain version (RAY_TOL /
     MLP_F32_TOL and F32_FAITHFUL) and timed, kernel and plain version
     each as the mean of 10 queued launches, against its bounds (the
     field kernels' CUDA-core and 3xTF32 ones); a resume in a fresh
     Trainer identical; step ms, peak memory, evaluation frame ms;
 T3. one full-width hash-grid step (8,192 rays) as shipped (HASH_GRIDS
     hash_grid_forward and hash_grid_backward launches, none of gather_rows
     or gather_rows_backward) and with the plain versions swapped in (the
     level route on the plain gather, hash_grid_backward_plain): table
     gradients within SCATTER_TOL and SCATTER_MAG (a floor scaled by the
     adds' magnitudes), the rest within GRAD_TOL x max|ref|; a fault
     planted in the kernel's inputs (a level's output gradient zeroed, or
     every other point's) at the first, the first hashed and the last
     level of each grid fails that hold; every hash_grid_forward launch
     held bit for bit and timed as in 10, with its faults; the s_grid's
     whole training encode (forward and table gradient) on the kernels
     against the level route; every hash_grid_backward
     launch, and one of ModelConfig()'s s_grid (C = 8), held alone against
     its plain version and timed (medians of PROBE_REPS interleaved queued
     launches) against it, one `index_add_` of the same adds and the
     parent's route (one gather_rows_backward launch a level on the rows
     its glue made, each of those launches also held and timed against
     index_add_), with its byte bound and the adds at the card's rate of
     vector atomics (port_tools/red_probe.cu); the full step on this
     tree's route, the parent's (the level route forward) and the level
     route both ways (ms, peak memory); one step with the TV term, whose
     gather_rows_backward and gather_rows launches are those kernels'
     counts;
 T4. the recipe of scripts/train_rgb_grids.sh (RECIPE_TRAIN: its first
     upsampling milestone moved to step 2) through Trainer.train for
     quality_recipe (over the budget: plain-path evaluation, 0 launches)
     and grid_student (fast path): finite losses, tables at
     grid_upsample_targets;
 B1. the asset at (32, 24) and (24, 12), whose composites take rays of 24
     and 12 samples (RAGGED_HIERARCHIES): a 512^2 frame through
     render_frame with the counters set to 0 just before and read just
     after, every launch held against its plain version as in phase 2 and
     timed, the fast path against the plain path (PATH_TOL), held-out PSNR
     against the JAX package's value at that hierarchy
     (JAX_PSNR_RAGGED_BF16); at (32, 24) one InteractiveSession.step with
     its launch counts and the packed_epilogue frame (PACKED_TOL, its
     composite held);
 B2. ModelConfig(mlp_field_width=256) with numpy-seeded params (WIDE_MC):
     512^2 RGB frames at (32, 16) and (128, 64, 32) in bf16 and float32,
     counted, every launch held (bf16 at GRID_TOL, float32 at MLP_F32_TOL
     and F32_FAITHFUL) and timed, every float32 launch on the V_WIDE32
     ring (3xTF32 on wgmma; port_tools/wide_variants.py --f32 times the
     design before it from the parent's source); the float32 (32, 16)
     composite against the float64 plain version beside cuBLAS float32,
     and on the kernels built with F32_RING_FAULT failing its F32_FAITHFUL
     hold; a 64^2 frame against the JAX package's values (JAX_WIDE, 2e-3); the FEAT_HW^2-ray
     feature render of a 512^2 interactive frame of that field with a
     seeded SAM head at both hierarchies, bf16 and float32 (its width-256
     run_tmlp launch: counted, held, timed), the bf16 launch at (32, 16)
     on the kernels built with RING_FAULT failing the same hold;
     Trainer.train for 2 epochs of 4 steps, its float32 evaluation frame's
     launches counted, held and on the ring;
 B3. the asset's field with seeded biases, and its chain over the Fourier
     features with the dense-sin encode, through the (32, 16) frame's
     render_frame (counted) and at its level-0 points, bf16 and float32
     twins, every launch held and timed;
 L1. the asset at (128, 256) and (256, 128, 64), whose levels pass 128
     samples a ray: a 512^2 frame through render_frame with the counters
     set to 0 just before and read just after, every launch of the frame
     held whole against its plain version run on slices of SLICE_RAYS
     rays (the plain composite of a whole frame at once does not fit the
     card's memory), both timed, the fast path against the plain path (PATH_TOL), held-out PSNR at
     (128, 256) against the JAX package's (JAX_PSNR_LONG_BF16);
 L1-L7. 64^2 frames of port_tools/grid_params.py:LIMITS, the seeded
     configurations past each former limit of the kernels (rays of 512 /
     256 samples, 12 and 16 layers, widths 320 and 512, view heads 48 and
     128, 31 geometry features, CP and VM ladders of 16 levels, the
     quality recipe's tables with RenderConfig.grid_vmem_budget raised
     past them): on the kernels, float32 params against the JAX
     package's frame (port_tools/jax_limits.jsonl, JAX_GRID; JAX_WIDE_TOL)
     and against the plain path, the bf16 frame's proposal launches on
     prop_kernel, every bf16 launch held (GRID_TOL;
     float32 twins at MLP_F32_TOL and F32_FAITHFUL) and timed; a 512^2
     frame of width 512
     at (32, 16) (held whole, the plain version on slices; timed); the
     feature render of 31
     geometry features (its run_tmlp of 32 outputs held); the quality
     recipe's 512^2 frame on the kernels (counted, timed);
 S.  ModelConfig(sum_after_mlp=True)'s 64^2 frame: the final level's field
     through run_tmlp (launch counts 1 / 2 / 3 / 0), against the plain
     path, its launches held and timed;
 C.  the CLI (`sanerf_tpu_torch.apps.main.main`, on the card) on scene
     files it writes from the textured fixture (CLI_SIZE^2, CLI_VIEWS
     views; port_tools/scene_files.py): a transforms.json scene with PNG
     images, the same cameras as a binary COLMAP model, per-view
     `<name>_masks.npy` (the spheres), and a seeded SAM ViT-H state dict in
     the official key layout (port_tools/sam_weights.py, float32, ~2.5 GB
     under build/); at ModelConfig()'s full width and `--num_steps 128 64
     32`, with the counters set to 0 just before each call and read just
     after: stage 1 (CLI_ITERS; no per-view near/far, so the native ray
     loader, which must be taken), its validation PSNR rising; `--test`;
     `--test` on the COLMAP copy (`--data_type mip --enable_cam_center`),
     its PSNR within CLI_MIP_PSNR_TOL of the llff one; `--with_sam` from
     the stage-1 checkpoint with the ViT-H teacher (bf16), the feature MSE
     of the val view after training below SAM_LEARN x before;
     `--with_mask`, the mIoU after above max(before, MIOU_FLOOR); the
     handed-off leaves bit for bit the checkpoint's and the heads moved;
     the four kernels launched in stage 1's, the tests' and stage 2's
     renders, the three of a per-point head render in stage 3's; finite
     losses; it/s, seconds and peak memory of each stage and the
     teacher's 1024^2 forward time (CUDA events), printed beside the card;
 D.  the apps on phase C's scene files and workspaces, each part with the
     counters (and gather_rows') set to 0 just before and read just after:
     D1 `sam_project.generate_masks` over the CLI_VIEWS views from 3D
     points on the spheres (APPS_SPHERES), on the stage-2 model's rendered
     features and, on APPS_TEACHER_VIEWS views, through the seeded ViT-H
     (`set_image`): valid.json against the occlusion test recomputed on
     the NeRF's depth, the labels' shapes and values, the feature route's
     labels against a rerun on the plain path (use_fused_mlp=False) on
     MASK_AGREE of the pixels, both decoded in float32 (with the served
     bf16 decoder reported), the masks' IoU with the spheres reported (a
     seeded decoder: not held until SAM's checkpoint ships); D2
     `evaluation.evaluate_scene` of stage 3's `--test` renders against
     D1's labels, equal to a numpy recomputation; D3
     `AutomaticMaskGenerator` at its default grid and crop layers on an
     AUTO_FEAT^2 rendered feature map (AUTO_HW^2 masks, the score filters
     off), at least one mask, the same masks (MASK_AGREE of their pixels,
     scores within BF16_TOL) as the same generator one point a decode, and
     the batched decode within DEC_TOL of one prompt at a time (float32
     weights); D4 `main(... --test --gui)`: 10
     headless 512^2 frames, then a HeadlessViewer with a Trainer and the
     train split for VIEWER_FRAMES frames (fps; the trainer stepped); D5
     LangDistillTrainer at D = LANG_DIM from the stage-1 checkpoint with
     a region teacher, the feature MSE below SAM_LEARN x its first value,
     a text query's IoU with the region reported, and `python -m
     sanerf_tpu_torch.apps.open_vocab` with an .npz vocabulary on the
     stage-2 workspace; D6 `batch.main eval-rgb` on the llff and mip
     copies; D7 a `--field_type hashgrid` stage 1 (HASH_TEACHER_ITERS),
     `distill_to_mlp` (DISTILL, DISTILL_STUDENT) with finite, falling
     losses, the student's frames against the teacher's on the scene's
     views past the untrained student's by DISTILL_MARGIN_DB, render_psnr
     past the untrained student's, the teacher's encode on
     hash_grid_forward,
     and the
     student's 512^2 RGB frame at (32, 16) on the four kernels once each,
     within PATH_TOL of the plain path;
 E.  data parallelism (sanerf_tpu_torch/parallel), on phase C's scene
     files and the shipped asset, each part's seconds printed beside the
     card: E1 (in a child process with deterministic algorithms and
     cuBLAS) the DP stage-1 step over a 1-rank NCCL group against the
     single-device step, DP_STEPS steps of DP_RAYS rays at ModelConfig()'s
     width and (128, 64, 32), params, EMA and moments bit for bit (two
     single-device runs bit for bit first); E2 `python -m
     sanerf_tpu_torch.apps.main <scene> --n_devices 2 --dist_backend gloo`
     (two ranks on the one card) through stage 1 (DP_ITERS), `--with_sam`,
     `--with_mask` and `--test`, every save's replica digests equal across
     the ranks, finite losses, stage 1's PSNR within DP_PSNR_TOL_DB of a
     1-rank run of the same steps (stages 2, 3 and --test run at once,
     all from stage 1's checkpoint); E3 (two gloo ranks spawned by E1's
     process) the asset's 512^2 frame through dp.render_frame_dp at both
     hierarchies against the one-rank frame (PATH_TOL; whether bit for bit
     is recorded), the sharded InteractiveSession frame (rank 1
     following without a SAM decoder) within 1 uint8 level and 1e-4 depth of the single one,
     each kernel launched in a sharded frame on both ranks, frame times
     (gloo's gathers go through the host: not a claim), and which
     collectives gloo takes as CUDA tensors;
 F.  the asset pipeline (sanerf_tpu_torch/tools), each tool through its
     `main` on the card in build/chip_smoke_tools/ (deleted at the end),
     every step with the counters set to 0 just before and read just
     after, its seconds and peak memory: F1 `quality_gate` at its defaults
     for QG_ITERS iterations a family, PSNR above the untrained model's on
     the same ring, the MLP family's evaluation on the four kernels, the
     hash grid's training on hash_grid_forward and hash_grid_backward; F2
     `eval_student` on a workspace of the shipped asset's params, its
     three PSNRs within PSNR_TOL_DB of the JAX package's, the four kernels
     launched; F3 `hierarchy_gate` on F1's MLP checkpoint at three
     hierarchies, and on a copy whose params/ are F1's EMA weights within
     HGATE_TOL_DB of F1's PSNR; F4 `redistill_asset` from a copy of the
     asset (the student of the asset's shape); F5 `finetune_student` on
     it, then `eval_student`; F6 `pack_asset` (the npz's keys and shapes
     the asset's, `load_asset` takes it) and a 512^2
     `InteractiveSession.step` at (32, 16) on it, every kernel launched;
     F7 `mask_asset` on the packed asset, its frozen leaves bit for bit,
     `load_mask_asset` takes the output; F8 `serve_finetune --pack` on a
     copy, repacked if and only if the target PSNR rose; F9
     `import_checkpoint` of a full-width seeded reference-layout .pth,
     `--keep_hashgrid` bit for bit and distilled (the teacher's targets on
     hash_grid_forward), and `distill_serving` of a seeded quality-recipe
     workspace (port_tools/grid_params.py), each output rendered (the
     students on the four kernels, the hash grid on hash_grid_forward);
     assets/ unchanged (sha256);
 G.  the probes and the pipeline's wall clock (sanerf_tpu_torch/tools),
     each through its `main` on the card, every step with the counters
     set to 0 just before and read just after, its seconds and peak
     memory: G1 `hw_parity` at HW_PARITY_ARGV, plain and with `--packed
     --flatten`, exit code 0 on all four shapes, every kernel counter of
     each run above 0 (the packed composite in the second); G2
     `probe_gather` at its defaults, every kernel probe bit for bit
     against its plain version; G3 `kbench` at its defaults, every row a
     finite time; G4 `two_stage_wall` at TSW_ITERS in build/ (deleted at
     the end), the ViT-H teacher at 1024^2, the JAX tool's JSON keys, then
     again with `--resume`, which reuses stage 1 (its stamped seconds) and
     the finished stage 2;
 and before phase 3, the asset's served bf16 launches of both 512^2 RGB
     frames digested (port_tools/served_digests.py) and held bit for bit
     to SERVED_DIGESTS;
 19. one {"kernels": [...]} line (prop_kernel's row, run_tmlp[prop_kernel],
     at the grid student's frames and the (512, 256) 64^2 launch, beside
     the same launches' times on tmlp_kernel in this run), one {"frames": ...} line, one
     {"interactive": ...} line, one {"hashgrid": ...} line, one
     {"grids": ...} line, one {"train": ...} line, one {"branches": ...}
     line, one {"limits": ...} line, one {"cli": ...} line and its summary
     lines, one {"apps": ...} line and its summary lines, one {"dp": ...}
     line and its summary lines, one {"tools": ...} line and its summary
     lines, the run's wall time {"wall_s": ...}, and last {"ok": true,
     "device": {...}}.
Kernel times are CUDA events around launches queued behind a sleep
kernel (`backlog`), so they are the card's time even where the host's
wrapper takes longer than the kernel. Needs no network; builds into
build/kernels/.
"""

import contextlib
import copy
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: Held-out PSNR of the shipped asset through the JAX package's XLA path
#: (use_fused_mlp=False) on the CPU, bf16 params, (32, 16) hierarchy, the
#: bench.py:149-170 protocol; from
#: `JAX_PLATFORMS=cpu python port_tools/jax_psnr_reference.py`.
JAX_PSNR_32_16_BF16 = 21.203517998498757
#: the same at the full (128, 64, 32) hierarchy
JAX_PSNR_FULL_BF16 = 21.39814067011814
PSNR_TOL_DB = 0.2
#: the same at the hierarchies whose final level the composite takes at a T
#: that neither divides 16 nor is a multiple of it (RAGGED_HIERARCHIES),
#: from `JAX_PLATFORMS=cpu python port_tools/jax_psnr_reference.py 32,24
#: 24,12`
JAX_PSNR_RAGGED_BF16 = {"32,24": 21.50282090357984,
                        "24,12": 20.66268365014556}
#: Held-out mask mIoU of assets/serving_student_mask through the JAX
#: package's XLA path on the CPU, bf16 params, (32, 16), bench.py:173-225
#: protocol; from `JAX_PLATFORMS=cpu python port_tools/jax_miou_reference.py`.
JAX_MIOU_32_16_BF16 = 0.9080225199611455
MIOU_TOL = 0.005
#: packed epilogue against the default frame (the JAX suite's bound,
#: tests/test_ray_kernels.py:197-226)
PACKED_TOL = 1e-6
RAY_TOL = 1e-5
#: bf16 MLP kernels against their plain versions: the JAX suite's bf16
#: bound, |d| <= 0.05 + 0.05 |ref| element by element
#: (tests/test_fused_mlp_t.py), on all but FLIP_SHARE of the outputs, and
#: those few within MLP_TOL * max|ref|. Both versions round the hidden
#: activations to bf16 after a float32 sum taken in another order
#: (tensor-core MMA against cuBLAS); among millions of points a few
#: activations land on the other side of a rounding boundary, and each such
#: flip moves an output by one bf16 step of that activation (0.25 at 32-64),
#: whatever the size of the output it lands in. The float32-weight check
#: below holds the same kernels element by element.
MLP_TOL = 0.05
FLIP_SHARE = 1e-5
#: float32 weights: the JAX suite's float32 bounds (tests/test_fused_mlp_t.py)
MLP_F32_TOL = {"run_tmlp": 3e-4, "run_tmlp_composite": 1e-3}
#: and the float32-faithful hold beside them: |d| <= F32_FAITHFUL +
#: F32_FAITHFUL |ref| on T2's evaluation frame and the grid phases' float32
#: twins and encode probes (seeded weights). MLP_F32_TOL would pass a chain
#: that rounds its products to tf32 (10 bits of mantissa): one-pass TF32
#: reads 2e-5 to 1e-4 there, the 3xTF32 chain ~4e-7.
F32_FAITHFUL = 1e-5
#: The asset's trained float32 weights (phases 2, 5 and 6) have large
#: activations that cancel: there cuBLAS float32 itself is 3.4e-5 / 3.9e-4
#: of 1 + |ref| from the float64 answer (run_tmlp / composite; PERF.md §6),
#: and two float32 chains that sum in different orders differ by more than
#: F32_FAITHFUL (a CUDA-core FMA chain reads 5.8e-5 from cuBLAS). Their
#: launches are held against the float64 plain version r64 instead (the
#: same float32 operands, float64 arithmetic): the kernel's largest |d| /
#: (1 + |r64|) at most F32_F64_MULT times cuBLAS float32's own on the same
#: inputs, plus F32_ULP (the float32 spacing at 1). A float32 chain in
#: another summation order lands within a small factor of cuBLAS's error;
#: one-pass TF32 rounds every product to 2^-11.
F32_F64_MULT = 4.0
F32_ULP = 2.0 ** -23
#: fast path against the plain path, float32 params: 2e-3 element by element
#: (the JAX suite's bound, tests/test_ray_kernels.py:74-148) for image and
#: weights_sum on every ray, and for depth on all but DEPTH_SHARE of the
#: rays, those within DEPTH_MAX. The two paths compute the frame by
#: different arithmetic (angle-doubling against dense Fourier features, the
#: clamped-ramp resample against sample_pdf), and on a few rays whose weight
#: sits between two depths the depth moves by more than 2e-3: the JAX
#: package's own two paths do the same on this frame
#: (`JAX_PLATFORMS=cpu python port_tools/jax_path_gap.py`).
PATH_TOL = 2e-3
DEPTH_SHARE = 5e-4
DEPTH_MAX = 0.05
#: H100 SXM (NVIDIA data sheet, dense, at 700 W): 3.35 TB/s HBM3,
#: 989 TFLOP/s bf16 tensor cores, 67 TFLOP/s float32 outside them, 495
#: TFLOP/s tf32 tensor cores.
HBM_BPS, BF16_FLOPS, F32_FLOPS, TF32_FLOPS = 3.35e12, 989e12, 67e12, 495e12
SERVE_POSE = [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 2.0], [0, 0, 0, 1]]
SIZE = 512
HIERARCHIES = {"32,16": (32, 16), "128,64,32": (128, 64, 32)}
KERNELS = ("ray_level0", "ray_level", "run_tmlp", "run_tmlp_composite")
#: phase B1: (32, 24) was bench.py's primary hierarchy, (24, 12) the
#: README's fine-tuned serving one
RAGGED_HIERARCHIES = {"32,24": (32, 24), "24,12": (24, 12)}
#: the fast path against the plain path there: image and weights_sum at
#: PATH_TOL on every ray, depth on all but DEPTH_SHARE of the rays and those
#: within DEPTH_MAX or the JAX package's own gap between its two paths at
#: that hierarchy, whichever is larger: at (24, 12) the reference's fast
#: path is 0.1201 off its XLA path in depth (10 of the band's 65,536 rays
#: past 2e-3; 0.0290 and 2 at (32, 24)), from `JAX_PLATFORMS=cpu python
#: port_tools/jax_path_gap.py --steps 32,24 24,12`
RAGGED_DEPTH_MAX = {"32,24": DEPTH_MAX, "24,12": 0.12013816833496094}
#: ray_level0 / ray_level / run_tmlp / run_tmlp_composite launches per
#: 512^2 RGB frame at a two-level hierarchy
TWO_LEVEL_LAUNCHES = [1, 1, 1, 1]
#: phase B2: the MLP field at width 256 (`--mlp_width 256`, README's "MLP
#: family, width 256": 63 -> 256 x 7, the skip at 4, -> 16), numpy-seeded
#: params of port_tools/grid_params.py:make_flat(shapes, GRID_SEED)
WIDE_MC = {"mlp_field_width": 256}
#: the interactive frame's feature render: FEAT_HW x FEAT_HW rays
FEAT_HW = 32
#: its 64^2 frame, RenderConfig() defaults ((128, 64, 32)), float32 params,
#: through the JAX package's XLA path on the CPU; from
#: `JAX_PLATFORMS=cpu python port_tools/jax_wide_reference.py`
JAX_WIDE = {
    "pixels": [0, 650, 1500, 2015, 2080, 2700, 3333, 4095],
    "mean": {"image": 0.5018570725223981, "depth": 3.413804577488918,
             "weights_sum": 0.999999999825377},
    "image": [[0.5011590123176575, 0.5054100751876831, 0.5108699798583984],
              [0.5012319684028625, 0.5062021613121033, 0.5096240639686584],
              [0.499909371137619, 0.504497766494751, 0.5037614703178406],
              [0.4990406632423401, 0.5022103786468506, 0.5015493035316467],
              [0.4988788068294525, 0.5017434358596802, 0.5016143918037415],
              [0.4981839060783386, 0.5041024684906006, 0.5056597590446472],
              [0.49788030982017517, 0.5053727626800537, 0.5065138339996338],
              [0.49551844596862793, 0.4976722300052643, 0.5068801641464233]],
    "depth": [3.4194321632385254, 3.4220995903015137, 3.4112892150878906,
              3.418302536010742, 3.4261345863342285, 3.4120335578918457,
              3.406040668487549, 3.4042129516601562],
    "weights_sum": [0.9999999403953552, 1.0, 0.9999998807907104,
                    0.9999998807907104, 0.9999998807907104,
                    1.0000001192092896, 1.0000001192092896, 1.0],
}
JAX_WIDE_TOL = 2e-3
#: phase B3: the seeded biases given to the asset's field, N(0, BIAS_STD)
BIAS_STD = 0.1
#: launches per interactive frame (RGB render + 32^2 feature render) of
#: ray_level0 / ray_level / run_tmlp / run_tmlp_composite / flatten3_nt
INTERACTIVE_LAUNCHES = {"32,16": [2, 2, 3, 1, 0],
                        "128,64,32": [2, 4, 5, 1, 0]}
#: flatten3_nt launches per interactive frame under flatten_kernel
FLATTEN_LAUNCHES = {"32,16": 4, "128,64,32": 6}
#: hash_grid_forward launches per 512^2 hash-grid interactive frame at
#: (128, 64, 32), one a grid: the RGB render (2 proposal grids + the field)
#: and the 32^2 feature render (the same 3 + the s_grid); none of
#: gather_rows (the parent's route made one gather a level, 26 + 42)
HASHGRID_LAUNCHES = 3 + 4
#: hash_grid_forward launches of one return_mask frame: the RGB render's 3
#: + the m_grid (the parent's route: 26 + 16 gathers)
MASK_LAUNCHES = 3 + 1
#: the faults planted in hash_grid_forward's level inputs at the first, the
#: first hashed and the last level of each grid (forward_fault); the
#: smoothstep flag is flipped once a launch
FORWARD_FAULTS = ("offset", "multiplier")
#: The 64^2 frame of ModelConfig(field_type="hashgrid", with_sam=True),
#: RenderConfig() defaults, float32 params of
#: port_tools/hashgrid_params.py:make_flat(shapes, 0) (TABLE_STD 2.0),
#: through the JAX package's run_rays(return_feats=True) on the CPU; from
#: `JAX_PLATFORMS=cpu python port_tools/jax_hashgrid_reference.py`.
JAX_HASHGRID = {
    "pixels": [0, 650, 1500, 2015, 2080, 2700, 3333, 4095],
    "channels": [0, 1, 128, 255],
    "mean": {"image": 0.5037444182986898, "depth": 1.243341827444965,
             "weights_sum": 1.000000001047738,
             "samvit": 1.7307304743009733e-10},
    "image": [[0.49564194679260254, 0.5094882845878601, 0.5137070417404175],
              [0.49897682666778564, 0.5119962692260742, 0.5117372870445251],
              [0.5011422038078308, 0.5100667476654053, 0.512299120426178],
              [0.5014047026634216, 0.5072685480117798, 0.5100390911102295],
              [0.5010114908218384, 0.5068326592445374, 0.5094492435455322],
              [0.49927613139152527, 0.5050472617149353, 0.5087454319000244],
              [0.49737322330474854, 0.5017687082290649, 0.5110596418380737],
              [0.4961124062538147, 0.5009494423866272, 0.5003986358642578]],
    "depth": [1.2447432279586792, 1.2623270750045776, 1.2497308254241943,
              1.2582191228866577, 1.2572133541107178, 1.2506392002105713,
              1.2629318237304688, 1.2255713939666748],
    "weights_sum": [1.0000001192092896, 0.9999999403953552,
                    0.9999998211860657, 1.0, 1.0, 0.9999998807907104,
                    0.9999999403953552, 1.0000001192092896],
    "samvit": [[0.31635668873786926, -1.5217617750167847, -0.9209179282188416,
                -0.808202862739563],
               [0.13284479081630707, -1.7957218885421753, -0.540861964225769,
                -0.7752104997634888],
               [0.4856792688369751, -1.773276448249817, -0.7730880379676819,
                -0.7996563911437988],
               [0.6615070104598999, -1.4945847988128662, -1.1283538341522217,
                -0.7630659341812134],
               [0.6404577493667603, -1.5550992488861084, -1.0329889059066772,
                -0.7169311046600342],
               [1.055557370185852, -1.727152943611145, -1.3863506317138672,
                -0.6143483519554138],
               [0.7812843322753906, -1.2480156421661377, -0.8907264471054077,
                -0.756634533405304],
               [0.38222193717956543, -1.5014022588729858, -1.0049128532409668,
                -0.7024018168449402]],
}
JAX_HASHGRID_TOL = 2e-3
#: the eight Pallas probes of tools/probe_gather.py as gathers of a
#: 2^19-row table at 2^21 seeded indices: (name, probe line, row width C,
#: table rows used (None = all), index form, block_rows).
#: pallas_take_small and p_blk cannot run as written (operands in the
#: reverse order of their in_specs; a 1-D index read as i[:n, 0]); these
#: rows compute their evident intent.
PROBE_ROWS, PROBE_IDX = 2 ** 19, 2 ** 21
#: launches of gather_rows and of torch.index_select, interleaved, whose
#: median times each probe (a launch of ~20-40 us moves with L2 state and
#: clocks from one to the next)
PROBE_REPS = 101
#: the same for each hash_grid_forward launch of the hash-grid frames (11
#: launches, each beside its plain version and the parent's route)
HASHGRID_REPS = 11
PROBES = (
    ("pallas_dynloop", 90, 2, None, "blocks", 1),
    ("pallas_dynloop_vmem", 109, 2, None, "blocks", 1),
    ("pallas_take", 125, 2, None, "blocks", 1),
    ("pallas_take_small", 142, 128, 4096, "mod4096", 1),
    ("p_loop", 185, 2, None, "flat", 1),
    ("p2_take", 202, 2, None, "flat", 1),
    ("p_loop8", 226, 2, None, "flat", 1),
    ("p_blk", 244, 2, None, "div8", 8),
)
#: the MLP family's factorized-grid configurations
#: (port_tools/grid_params.py: full width, numpy-seeded tables N(0, 1)):
#: those within RenderConfig.grid_vmem_budget, served by the kernels' VM,
#: ladder and sigma branches, and the one over it, served by the plain path
GRID_SERVED = ("grid_student", "cp_ladder", "vm_ladder")
GRID_OVER_BUDGET = "quality_recipe"
GRID_SEED = 0
#: ray_level0 / ray_level / run_tmlp / run_tmlp_composite launches per
#: 512^2 RGB frame of a served grid configuration (the asset's counts)
GRID_LAUNCHES = {"32,16": [1, 1, 1, 1], "128,64,32": [1, 2, 2, 1]}
#: bf16 launches of the grid configurations against their plain versions:
#: |d| <= GRID_TOL + GRID_TOL |ref| on every output. Their numpy-seeded nets
#: (weights U(+-1/sqrt(fan_in)), depth 8 in the ladders) shrink what the
#: encoding does to the output, so MLP_TOL would pass a composite that reads
#: no grid at all: with a grid's reads left out of the kernel the ladders'
#: composites move by 0.022-0.059, sound kernels by at most 7.4e-4
#: (port_tools/grid_breakdown.py, PERF.md).
GRID_TOL = 5e-3
#: the encode probes (fused_mlp_t.encode_probes: one output per encoding
#: column, and the sigma sum) at PROBE_POINTS points, bf16 tables: one bf16
#: step (2^-8) of a feature where the two float32 features differ in their
#: last bit; float32 tables at MLP_F32_TOL
PROBE_TOL = 1e-2
PROBE_POINTS = 100003
#: the sigma-VM model of port_tools/grid_params.py (no served configuration
#: has a sigma-VM table within the budget), held at SIGMA_RAYS rays, (8, 4)
SIGMA_RAYS = 997
#: 64^2 frames of grid_student (the fast path) and quality_recipe (the plain
#: path), RenderConfig() defaults ((128, 64, 32)), float32 params of
#: port_tools/grid_params.py:make_flat(shapes, GRID_SEED), through the JAX
#: package's XLA path (use_fused_mlp=False) on the CPU; from
#: `JAX_PLATFORMS=cpu python port_tools/jax_grid_reference.py`.
JAX_GRID = {
    "pixels": [0, 650, 1500, 2015, 2080, 2700, 3333, 4095],
    "grid_student": {
        "mean": {"image": 0.4997529357885166, "depth": 1.5001957927743206,
                 "weights_sum": 1.000000000189175},
        "image": [
            [0.5020421743392944, 0.4938781261444092, 0.4991452395915985],
            [0.500408947467804, 0.49434414505958557, 0.5008178949356079],
            [0.49857956171035767, 0.4948754608631134, 0.5049996376037598],
            [0.5006763935089111, 0.4949491322040558, 0.5038001537322998],
            [0.5010836720466614, 0.4956475794315338, 0.5031304359436035],
            [0.5012758374214172, 0.49418002367019653, 0.5019010901451111],
            [0.5010660886764526, 0.4960882365703583, 0.5008257627487183],
            [0.5042369365692139, 0.49573901295661926, 0.5042673349380493]],
        "depth": [
            1.5291187763214111, 1.8011256456375122, 1.1373339891433716,
            1.2023043632507324, 1.0240651369094849, 1.136056661605835,
            0.9013692736625671, 1.3753163814544678],
        "weights_sum": [
            1.000000238418579, 0.9999998807907104, 1.0000001192092896,
            1.0, 0.9999998807907104, 1.0,
            1.000000238418579, 1.0000001192092896],},
    "quality_recipe": {
        "mean": {"image": 0.49722376603313023, "depth": 0.8174584086664254,
                 "weights_sum": 0.9999999853171175},
        "image": [
            [0.49869996309280396, 0.5022567510604858, 0.4890907108783722],
            [0.49874982237815857, 0.5010635852813721, 0.488813579082489],
            [0.49793776869773865, 0.49951207637786865, 0.4925764799118042],
            [0.49824416637420654, 0.49857014417648315, 0.4940393269062042],
            [0.4976920783519745, 0.4999743700027466, 0.49367570877075195],
            [0.4974334239959717, 0.49929362535476685, 0.4930310547351837],
            [0.4984947741031647, 0.4976397752761841, 0.4954723119735718],
            [0.5000168085098267, 0.49781978130340576, 0.5012606382369995]],
        "depth": [
            0.5412604808807373, 0.5128118991851807, 0.5741956830024719,
            1.3134548664093018, 0.7449401617050171, 0.6462126970291138,
            1.6264522075653076, 0.9368830919265747],
        "weights_sum": [
            1.0, 1.0000001192092896, 0.9999998807907104,
            0.9999998807907104, 1.0000001192092896, 0.9999998807907104,
            1.0, 0.9999999403953552],},
}
JAX_GRID_TOL = 2e-3
SOURCES = {
    "ray_level0": ("sanerf_tpu_torch/csrc/ray_kernels.cu",
                   "sanerf_tpu/ops/ray_kernels.py:275"),
    "ray_level": ("sanerf_tpu_torch/csrc/ray_kernels.cu",
                  "sanerf_tpu/ops/ray_kernels.py:310"),
    "run_tmlp": ("sanerf_tpu_torch/csrc/fused_mlp_t.cu",
                 "sanerf_tpu/ops/fused_mlp_t.py:1077"),
    "run_tmlp_composite": ("sanerf_tpu_torch/csrc/fused_mlp_t.cu",
                           "sanerf_tpu/ops/fused_mlp_t.py:885"),
    "flatten3_nt": ("sanerf_tpu_torch/csrc/ray_kernels.cu",
                    "sanerf_tpu/ops/ray_kernels.py:247"),
    "packed_epilogue": ("sanerf_tpu_torch/csrc/fused_mlp_t.cu",
                        "sanerf_tpu/ops/fused_mlp_t.py:757"),
}


#: stage-1 training (phases T1-T4). T1 is the convergence protocol of
#: tests/test_train_e2e.py:19-74: its RC, MC (hash grid), MC_MLP and TC on
#: the 48^2 12-view sphere fixture, 400 steps, and its bounds
TRAIN_RC = dict(num_steps=(16, 8), bound=4.0, contract=True,
                max_ray_batch=2048)
TRAIN_MC = {
    "hashgrid": dict(field_type="hashgrid", grid_num_levels=8,
                     grid_log2_hashmap=13, grid_desired_resolution=128,
                     prop_num_levels=4, prop_log2_hashmap=10,
                     prop_resolutions=(64,)),
    "mlp": dict(field_type="mlp", prop_resolutions=(64,), mlp_enc_freqs=6,
                mlp_field_width=64, mlp_field_depth=4, mlp_prop_enc_freqs=4,
                mlp_prop_width=32, mlp_prop_depth=2)}
TRAIN_TC = dict(iters=300, lr=1e-2, num_rays=1024, adaptive_num_rays=False,
                lambda_distort=0.01)
CONVERGE_STEPS, CONVERGE_GAIN_DB, CONVERGE_MIN_DB = 400, 5.0, 15.0
#: T2: the defaults through Trainer.train on the textured fixture, two
#: epochs of TRAIN_STEPS steps, evaluation at EVAL_SIZE^2
TRAIN_EPOCHS, TRAIN_STEPS, EVAL_SIZE = 2, 4, 64
#: the hash grid's gathers per ray batch on the parent's level route: 16
#: levels + 2 proposal grids of 5
HASH_GATHERS = 16 + 2 * 5
#: its encode and table-gradient launches per step with proposal updates
#: and per evaluation render: one a grid (hash_grid_forward,
#: hash_grid_backward), the field's and the two proposal grids'
HASH_GRIDS = 3
#: T3's planted faults in hash_grid_backward's inputs at a level: its
#: output gradient zeroed, every other point's zeroed
HASH_FAULTS = ("zero", "half")
#: T3's C = 8 launch: ModelConfig()'s s_grid at this many of the field's
#: points; the rounds of its step timing (parent, change, change, parent)
S_GRID_POINTS, STEP_ROUNDS = 262144, 3
#: T3's TV step: the hash grid's TV term adds one gather_rows_backward
#: launch a level of the field's grid
TV_LAMBDA = 1e-3
#: gather_rows_backward against index_add_, hash_grid_backward against
#: its plain version: the atomics sum in another order. Element i is held at |d| <= SCATTER_TOL[0] + SCATTER_TOL[1] |ref|
#: and at |d| <= SCATTER_MAG S_i + SCATTER_TOL[1] |ref|, S_i the sum of
#: |grad_out| over the adds into i (index_add_ of the magnitudes). A float32
#: sum of n terms in another order moves by ~2^-24 sqrt(n) S_i a side:
#: 6.7e-6 S_i for two orders of the ~6,400 adds a row of the coarse
#: proposal level, hence 1e-5. The second floor scales with the terms: a
#: step's table gradients are 1e-6 and below, where the first alone would
#: pass a table with no adds at all. Every other gradient of the step
#: within GRAD_TOL x max|ref| of the plain step's
SCATTER_TOL, SCATTER_MAG, GRAD_TOL = (1e-6, 1e-5), 1e-5, 1e-5
#: the table gradients of the hash-grid step
HASH_TABLES = ("grid", "prop/0/grid", "prop/1/grid")
#: T4: scripts/train_rgb_grids.sh's recipe with its first milestone moved
#: from 2000 to 2, so that two epochs of 2 steps cross it
RECIPE_TRAIN = dict(lambda_tv=1e-3, anneal_iters=4000,
                    grid_upsample_steps=(2, 4000, 8000))


#: SHA-256 of the outputs of each served bf16 launch of the asset's 512^2
#: RGB frames, in launch order (port_tools/served_digests.py), as the
#: port of the commit before the kernel limits were lifted computes them
#: on the H100 (`python3 port_tools/served_digests.py build/parent`): the
#: lifted kernels must give the served launches the same bits
SERVED_DIGESTS = {
    "32,16": [
        ("ray_level0",
         "fd0e67dec8635ddac7759e3f66c16771eb24700a1d3560d9bd848f48cc3bd932"),
        ("run_tmlp",
         "eed2e1de8908a455124b3eed7847ad962b8419b242dea7598bb782b29e145e1e"),
        ("ray_level",
         "1262584429b2539a6bdd1d1ba53c26ad76387e5be780068ed703ff1ab202cbf4"),
        ("run_tmlp_composite",
         "61d929ad47ea37cb7f74ca25214e202b0e04682dbf11907220159fb761988a5c"),
    ],
    "128,64,32": [
        ("ray_level0",
         "1d4e72a473a501b970dcec81df4c7db41816784089810ef1054affd3188a0328"),
        ("run_tmlp",
         "7934e5a671eb8161b34b9de2e8a20712e1da02fd18af220bc0b9c1c7f0f81ca2"),
        ("ray_level",
         "7be9d7ee7072c01fbc8dd5499a732c712b03f4ec8b24ddb544c408313f45e507"),
        ("run_tmlp",
         "9c1e547712f6ac551cdba96eefd1723332b0201b8f00d53661171084ccd94990"),
        ("ray_level",
         "dcbb38dc2efc6b88c1edece234c304dd0698831fe7c85101d34dddfc26d323f0"),
        ("run_tmlp_composite",
         "581570aa6797cc921b563587dff58c84cac8a8b568c05d33eeadfa2186c1547a"),
    ],
}
#: phases L1-L7 and S (limit_phases): the asset at hierarchies past 128
#: samples a ray, each 512^2 frame's launches held and timed whole against
#: their plain versions run on slices of SLICE_RAYS rays (the plain
#: composite of a whole frame at once does not fit the card's memory); then the seeded configurations past the former
#: limits (port_tools/grid_params.py:LIMITS), each a 64^2 frame against the
#: JAX package's (port_tools/jax_limits.jsonl from `JAX_PLATFORMS=cpu
#: python port_tools/jax_limits_reference.py`; the quality recipe's is
#: JAX_GRID's) at JAX_WIDE_TOL
LONG_HIERARCHIES = {"128,256": (128, 256), "256,128,64": (256, 128, 64)}
SLICE_RAYS = 32768
#: phase C: the CLI (`sanerf_tpu_torch.apps.main.main`) on scene files of
#: the textured fixture: CLI_VIEWS views of CLI_SIZE^2 (val: view 0), at
#: ModelConfig()'s full width and `--num_steps 128 64 32`; the iterations
#: of stage 1, 2 and 3; stage 2's teacher is SAM ViT-H on seeded weights
#: (port_tools/sam_weights.py, SAM_SEED) written as a float32 .pth
CLI_SIZE, CLI_VIEWS = 128, 16
CLI_ARGS = ["--data_type", "llff", "--bound", "4",
            "--num_steps", "128", "64", "32"]
CLI_ITERS = {"rgb": 1000, "sam": 90, "mask": 300}
CLI_SAM_LR = CLI_MASK_LR = "5e-3"
SAM_SEED = 0
#: tests/test_stages.py's "learns" bounds: the feature MSE ends below
#: SAM_LEARN x its first value, the mIoU above max(first, MIOU_FLOOR)
SAM_LEARN, MIOU_FLOOR = 0.8, 0.6
#: the COLMAP copy of the scene renders the llff one's PSNR within this
CLI_MIP_PSNR_TOL = 0.05
#: phase D: the apps on phase C's workspace and scene files. D1 prompts
#: SAM with points on the textured scene's three spheres (APPS_SPHERES,
#: data/synthetic.py:ray_textured_scene), 8 around each at 20 degrees of
#: elevation and one on top, moved into the provider's frame; the ViT-H
#: teacher route on the first APPS_TEACHER_VIEWS views
APPS_SPHERES = (((0.0, 0.0, 0.0), 0.5), ((0.55, -0.15, 0.35), 0.3),
                ((-0.5, -0.25, -0.3), 0.35))
APPS_TEACHER_VIEWS = 2
#: D1: the share of label pixels on which the kernels' run of
#: generate_masks must agree with the plain path's, both decoded by a
#: float32 copy of the SAM predictor (tests/test_torch_apps.py holds the
#: port against JAX at the same share)
MASK_AGREE = 0.999
#: D3: the rendered feature map's side, the frame it stands for
AUTO_FEAT, AUTO_HW = 64, 256
#: D4: the viewer's frames with a trainer stepping between them
VIEWER_FRAMES = 4
#: D5: the language field's width, its epochs x steps, its lr
LANG_DIM, LANG_EPOCHS, LANG_STEPS, LANG_LR = 512, 4, 30, 1e-2
#: D7: the hash-grid teacher's stage-1 iterations; distill_to_mlp at full
#: size but its iterations (8000 by default) cut to DISTILL["iters"]; the
#: student the shipped asset's architecture (tools/redistill_asset.py:
#: 40-51). The student's frames against the teacher's on the scene's 16
#: views must pass the untrained student's PSNR by DISTILL_MARGIN_DB;
#: render_psnr (distill_to_mlp's orbit at twice the cameras' distance,
#: which sees the teacher's unconstrained far field) is held at a margin of
#: 0 dB over the untrained student's: its gain over 23 hash-grid teachers
#: on an H100 ranged +1.07 to +15.85 dB; on the scene's views (17 of them)
#: +7.18 to +11.30 (PERF.md, PR 13; port_tools/distill_spread.py)
HASH_TEACHER_ITERS = 300
DISTILL = dict(n_points=1 << 22, batch=1 << 15, iters=1024, lr=2e-3)
DISTILL_STUDENT = dict(cp_rank=64, cp_res=128, sigma_cp_rank=32,
                       sigma_cp_res=128, width=128, depth=3, prop_width=32,
                       prop_depth=2)
DISTILL_MARGIN_DB = 3.0
#: the decoder's batched decode against its one-prompt decode (float32
#: weights): tests/test_torch_sam.py's DEC_TOL
DEC_TOL = 1e-4
#: D3: the bf16 predictor's scores at 64 against 1 point a decode. Its
#: products round their inputs to bf16 (models/sam/common.py:
#: _in_weight_dtype), and a float32 sum whose order follows the batch size
#: can move one such input by bf16's rounding, 2^-8 of it
BF16_TOL = 2.0 ** -8
#: phase E: data parallelism. E1: DP_STEPS steps of DP_RAYS rays at
#: ModelConfig()'s width over a 1-rank NCCL group against the single step;
#: E2: the CLI on phase C's scene over two gloo ranks, stage 1 for DP_ITERS
#: iterations at DP_LR (its PSNR within DP_PSNR_TOL_DB of one rank's on the
#: same steps, tests/test_parallel.py:372), stages 2 and 3 one epoch each;
#: E3: the asset's sharded frames, each timed as the median of DP_FRAMES.
#: The child process (E1, E3) and each CLI run have these time limits
DP_RAYS, DP_STEPS = 8192, 4
DP_ITERS, DP_LR, DP_PSNR_TOL_DB = 180, "5e-3", 3.0
DP_FRAMES = 5
DP_CHILD_TIMEOUT_S, DP_CLI_TIMEOUT_S = 400, 300
#: the held-out PSNR of the asset at (128, 256), bf16, through the JAX
#: package's XLA path on the CPU, bench.py:149-170 protocol; from
#: `JAX_PLATFORMS=cpu python port_tools/jax_psnr_reference.py 128,256`
JAX_PSNR_LONG_BF16 = {"128,256": 21.446619081724656}
#: prop_kernel's planted fault (port_tools/field_branch_variants.py), built
#: beside the kernels into PLANTED_DIR: its layers past the first drop their
#: last k step of 16 inputs. The grid phase's hold of the proposal launch
#: must fail on it
PROP_FAULT = "prop_lost_k"
#: the bf16 V_WIDE weight ring's planted fault (the same file), built into
#: the same tree: its producer leaves out the last k block of every unit but
#: a chunk's first. Phase B2's hold of the width-256 field's run_tmlp
#: launch must fail on it
RING_FAULT = "ring_lost_k"
#: the V_GRID kernels' planted fault (the same file), built into the same
#: tree: the encoders mark a slot full without the last VM mode's columns,
#: so the consumers read the previous tile's there. Phase 14's hold of
#: grid_student's (32, 16) composite must fail on it
GRID_FAULT = "grid_lost_vm"
#: the float32 V_WIDE32 ring's planted fault (the same file), built into the
#: same tree: its producer leaves out the copies of every other unit past a
#: chunk's first group, so the products read what those stages held.
#: Phase B2's F32_FAITHFUL hold of the width-256 float32 (32, 16)
#: composite must fail on it
F32_RING_FAULT = "f32_ring_lost_k"
PLANTED_DIR = os.path.join(ROOT, "build", "chip_smoke_planted")
#: the fields of a V_GRID launch's plan the grid rows of the kernels line
#: carry
PLAN_KEYS = ("variant", "wgs", "w_mode", "stages", "slots", "slot_b",
             "w_bytes", "v_bytes", "per_wg", "total", "general")


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def planted_tree(dest=PLANTED_DIR, faults=(PROP_FAULT, RING_FAULT,
                                            GRID_FAULT, F32_RING_FAULT)):
    """A copy of the kernels' sources under dest/csrc with the planted
    faults of port_tools/field_branch_variants.py named in `faults` (text
    substitutions of fused_mlp_t.cu) -> dest, a Path."""
    from pathlib import Path

    from sanerf_tpu_torch.ops import _build

    sys.path.insert(0, os.path.join(ROOT, "port_tools"))
    from field_branch_variants import VARIANTS

    d = Path(dest)
    shutil.rmtree(d / "csrc", ignore_errors=True)
    shutil.copytree(_build.CSRC, d / "csrc")
    p = d / "csrc" / "fused_mlp_t.cu"
    text = p.read_text()
    for old, new in (sub for f in faults for sub in VARIANTS[f]):
        check(text.count(old) == 1, f"planted fault: {old!r} not in the source")
        text = text.replace(old, new)
    p.write_text(text)
    return d


@contextlib.contextmanager
def kernels_from(tree):
    """Inside the block, fused_mlp_t's launches go to the kernels built from
    tree/csrc into tree/kernels."""
    from sanerf_tpu_torch.ops import _build
    from sanerf_tpu_torch.ops import fused_mlp_t as fm

    saved = _build.CSRC, _build.BUILD_DIR, _build._libs.pop("fused_mlp_t",
                                                           None)
    _build.CSRC, _build.BUILD_DIR = tree / "csrc", tree / "kernels"
    fm._lib.cache_clear()
    try:
        yield
    finally:
        _build.CSRC, _build.BUILD_DIR = saved[:2]
        _build._libs.pop("fused_mlp_t", None)
        if saved[2] is not None:
            _build._libs["fused_mlp_t"] = saved[2]
        fm._lib.cache_clear()


_CYCLES_PER_MS = []


def backlog(ms):
    """Queues a sleep kernel of about `ms` milliseconds on the current
    stream, so that the launches the host enqueues behind it run back to
    back: their CUDA-event times are then the card's, not the host's (a
    wrapper's Python takes 20-60 us a launch, as long as a small kernel)."""
    import torch

    if not _CYCLES_PER_MS:
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        a.record()
        torch.cuda._sleep(1_000_000)
        b.record()
        torch.cuda.synchronize()
        _CYCLES_PER_MS.append(1_000_000 / a.elapsed_time(b))
    torch.cuda._sleep(int(ms * _CYCLES_PER_MS[0]))


def interleaved_ms(fns, n=None, queued=True):
    """[(median, 10th, 90th percentile) ms] of each fn over n rounds
    (PROBE_REPS), a round launching each fn once, each launch timed alone
    with CUDA events. `queued`: behind a backlog, the card's time; without
    it, each launch starts on an idle card and its time includes the host's
    work before the kernel starts."""
    import torch

    n = n or PROBE_REPS
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    ev = [[(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(n)]
          for _ in fns]
    if queued:
        backlog(0.3 * n * len(fns))
    for i in range(n):
        for j, fn in enumerate(fns):
            ev[j][i][0].record()
            fn()
            ev[j][i][1].record()
    torch.cuda.synchronize()
    out = []
    for e in ev:
        t = sorted(a.elapsed_time(b) for a, b in e)
        out.append((statistics.median(t), t[n // 10], t[n - 1 - n // 10]))
    return out


def check(cond, msg):
    if not cond:
        fail(msg)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


@contextlib.contextmanager
def spying(renderer, fields, kern_fn, calls, h):
    """Records every call of the four main-path kernels, as the renderer and
    the fields module make it, under calls[(h, name)] as (args, kwargs)."""
    spied = {"ray_level0": renderer, "ray_level": renderer,
             "run_tmlp": fields, "run_tmlp_composite": fields}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.setdefault((h, name), []).append((a, k))
            return fn(*a, **k)
        return wrapped

    for n, m in spied.items():
        setattr(m, n, spy(n, kern_fn[n]))
    try:
        yield
    finally:
        for n, m in spied.items():
            setattr(m, n, kern_fn[n])


def scatter_floor(got, ref, mag):
    """The least c with |got - ref| <= c mag + SCATTER_TOL[1] |ref| at every
    element, mag the sum of the magnitudes of the adds into it (inf where
    mag is 0 and that fails, and where |got - ref| exceeds SCATTER_TOL's
    absolute bound); the scatter-add is held at c <= SCATTER_MAG."""
    import torch

    over = ((got - ref).abs() - SCATTER_TOL[1] * ref.abs()).clamp(min=0)
    if bool((over > SCATTER_TOL[0]).any()):
        return math.inf
    c = torch.where(mag > 0, over / mag.clamp(min=1e-38),
                    torch.where(over > 0, math.inf, 0.0))
    return float(c.max())


def record_forward(hg, run):
    """Runs run() with every hash_grid_forward call recorded. -> (run's
    result, [(x01, table, spec, n_active)] in call order)."""
    real, seen = hg.hash_grid_forward, []

    def recording(x01, table, spec, n=None):
        seen.append((x01, table, spec, n))
        return real(x01, table, spec, n)

    hg.hash_grid_forward = recording
    try:
        return run(), seen
    finally:
        hg.hash_grid_forward = real


def level_route(hg, gather):
    """The encode on the level route (hash_grid_forward_plain) with `gather`
    for its row reads: ga.gather_rows_plain, the plain version; the
    gather_rows kernel, the parent's route."""
    def run(x01, table, spec, n=None):
        real = hg.gather_rows
        hg.gather_rows = gather
        try:
            return hg.hash_grid_forward_plain(x01, table, spec, n)
        finally:
            hg.gather_rows = real
    return run


def forward_fault(hg, x01, table, spec, n, level, kind):
    """One hash_grid_forward launch with a fault planted in its level
    inputs: "offset" moves the level's first row by 8 rows, "multiplier"
    swaps its multipliers (the hash primes for the dense strides, or back),
    "smooth" flips the launch's smoothstep flag. -> its output."""
    import ctypes

    import torch

    D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
    n = L if n is None else n
    arrays = hg._level_arrays(spec, n)
    offsets, _, _, hashed = arrays
    smooth = int(spec.interpolation == "smoothstep")
    if kind == "offset":
        offsets[level] += 8 if level == 0 else -8
    elif kind == "multiplier":
        hashed[level] = 1 - hashed[level]
    else:
        smooth = 1 - smooth
    out = torch.empty((x01.shape[0], L * C), device=table.device)
    code = hg._lib().hash_grid_forward_launch(
        out.data_ptr(), table.data_ptr(), table.element_size(), C,
        x01.data_ptr(), D, x01.shape[0], L, n,
        *(ctypes.addressof(a) for a in arrays), int(spec.align_corners),
        smooth, torch.cuda.current_stream().cuda_stream)
    check(code == 0, f"forward_fault {kind}: CUDA error {code}")
    return out


def forward_faults(hg, ga, recs, names):
    """FORWARD_FAULTS planted at the first, the first hashed and the last
    active level of each recorded launch's grid (names[j]: its grid), and
    the smoothstep flag once a launch; each output must differ from the
    plain version's. -> [[grid, level, kind, elements that differ]]."""
    import torch

    out = []
    for j, (x01, table, spec, n) in enumerate(recs):
        table = table.detach()
        k = spec.num_levels if n is None else n
        ref = level_route(hg, ga.gather_rows_plain)(x01, table, spec, n)
        hashed = [lv for lv in range(k) if spec.hashed[lv]]
        plants = [(lv, kind) for lv in sorted({0, k - 1, *hashed[:1]})
                  for kind in FORWARD_FAULTS] + [(None, "smooth")]
        for level, kind in plants:
            got = forward_fault(hg, x01, table, spec, n, level or 0, kind)
            torch.cuda.synchronize()
            diff = int((got != ref).sum())
            check(diff > 0, f"a planted fault ({kind}) at level {level} of "
                            f"{names[j]} passed the hold")
            out.append([names[j], level, kind, diff])
            del got
        del ref
    return out


def hold_forward(hg, ga, recs, reps=None, compare=True):
    """Every recorded hash_grid_forward launch run alone, held bit for bit
    (torch.equal) against its plain version (the level route on the plain
    gather) and timed against it and the parent's route (the level route
    on the gather_rows kernel) on the same inputs: medians and 10th / 90th
    percentiles of `reps` (PROBE_REPS) interleaved launches queued behind a
    backlog. The byte bound: the points read once, the features written
    once, each table row the in-cube points touch read once (counted from
    their taps). compare=False times the kernel alone. -> (sums over the
    launches, one record a launch)."""
    import torch

    kern = hg._HASH_GRID_FORWARD
    plain = level_route(hg, ga.gather_rows_plain)
    parent = level_route(hg, ga.gather_rows)
    keys = ("ms", "plain_ms", "parent_route_ms")
    tot = {**{k: 0.0 for k in keys}, **{k + "_p10_p90": [0.0, 0.0]
                                         for k in keys},
           "bound_ms": 0.0, "bytes": 0, "launches": 0, "equal": True,
           "max_abs_err": 0.0,
           "timed_as": f"sums of medians of {reps or PROBE_REPS} "
                       f"interleaved launches queued behind a backlog"}
    out = []
    for x01, table, spec, n in recs:
        table = table.detach()
        D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
        n = L if n is None else n
        B = x01.shape[0]
        got = kern(x01, table, spec, n)
        ref = plain(x01, table, spec, n)
        torch.cuda.synchronize()
        equal = torch.equal(got, ref)
        err = float((got - ref).abs().max()) if got.numel() else 0.0
        check(equal, f"hash_grid_forward D {D} C {C} {n} levels "
                     f"{table.dtype}: differs from its plain version by "
                     f"{err:.3g}")
        del got, ref
        inb = ((x01 >= 0.0) & (x01 <= 1.0)).all(dim=-1)
        rows = 0
        for level in range(n):
            _, idx = hg._level_taps(x01[inb], spec, level)
            seen = torch.zeros(spec.sizes[level], dtype=torch.bool,
                               device=x01.device)
            seen[idx.reshape(-1).long()] = True
            rows += int(seen.sum())
            del idx, seen
        nbytes = 4 * D * B + 4 * L * C * B + rows * C * table.element_size()
        times = interleaved_ms([lambda: kern(x01, table, spec, n),
                                lambda: plain(x01, table, spec, n),
                                lambda: parent(x01, table, spec, n)
                                ][:3 if compare else 1], n=reps)
        bound = nbytes / HBM_BPS * 1e3
        rec = {"spec": f"D {D}, C {C}, {n} of {L} levels, "
                       f"{spec.total_params} rows, {spec.interpolation}, "
                       f"{spec.gridtype}, {str(table.dtype)[6:]}",
               "points": B, "touched_rows": rows, "bytes": nbytes,
               "bound_ms": bound, "share": bound / times[0][0],
               "equal": equal, "max_abs_err": err}
        for k, t in zip(keys, times):
            rec[k] = list(t)
            tot[k] += t[0]
            tot[k + "_p10_p90"] = [tot[k + "_p10_p90"][0] + t[1],
                                   tot[k + "_p10_p90"][1] + t[2]]
        tot["bound_ms"] += bound
        tot["bytes"] += nbytes
        tot["launches"] += 1
        tot["equal"] = tot["equal"] and equal
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        out.append(rec)
        torch.cuda.empty_cache()
    return tot, out


def record_fused(hg, step, fault=None):
    """Runs step() with every hash_grid_backward launch recorded. ->
    (step's result, [(x01, g, spec, n_active)] in launch order). fault =
    (j, level, kind) plants a fault in launch j's inputs: "zero" zeroes
    that level's output gradient, "half" every other point's."""
    real, seen = hg.hash_grid_backward, []

    def recording(x01, g, spec, n=None):
        j = len(seen)
        seen.append((x01, g, spec, n))
        if fault is not None and fault[0] == j:
            _, level, kind = fault
            C = spec.level_dim
            g = g.clone()
            cols = g[:, level * C:(level + 1) * C]
            if kind == "zero":
                cols.zero_()
            else:
                cols[::2] = 0
        return real(x01, g, spec, n)

    hg.hash_grid_backward = recording
    try:
        return step(), seen
    finally:
        hg.hash_grid_backward = real


def parent_launches(hg, x01, g, spec, n=None):
    """The route hash_grid_backward replaced, on the same inputs: each
    active level's taps and gradient rows as the parent's glue made them
    (`_level_taps`' [K, B] int32 indices, the rows w g [K, B, C] float32,
    zeros outside the cube). -> [(level rows, idx, rows, level offset)],
    one gather_rows_backward launch each."""
    B, L, C = x01.shape[0], spec.num_levels, spec.level_dim
    oob = ((x01 < 0.0) | (x01 > 1.0)).any(dim=-1)
    gl = g.reshape(B, L, C).masked_fill(oob[:, None, None], 0.0)
    out = []
    for level in range(L if n is None else n):
        w, idx = hg._level_taps(x01, spec, level)
        out.append((spec.sizes[level], idx,
                    (w[..., None] * gl[None, :, level]).contiguous(),
                    spec.offsets[level]))
    return out


def hold_fused(hg, ga, recs, dev, red):
    """Every recorded hash_grid_backward launch run alone, held against
    its plain version (scatter_floor, with the plain version of |g| as its
    scale) and timed against the plain version, one `index_add_` of the
    same adds (the rows of parent_launches, offsets added) and the parent's
    route on the same inputs (a zero gradient and one gather_rows_backward
    launch a level): medians and 10th / 90th percentiles of PROBE_REPS
    interleaved launches queued behind a backlog. Bounds: the bytes
    (points and output gradient read once, each touched row read and
    written, the others written) and the adds at the card's rate for the
    row's piece width (`red`, port_tools/red_probe.py's 4 MB table). ->
    (sums over the launches, one record a launch)."""
    import torch

    kern = hg.hash_grid_backward
    keys = ("ms", "plain_ms", "library_ms", "parent_route_ms")
    tot = {**{k: 0.0 for k in keys}, **{k + "_p10_p90": [0.0, 0.0]
                                         for k in keys},
           "bound_ms": 0.0, "red_bound_ms": 0.0, "max_abs_err": 0.0,
           "floor": 0.0, "adds": 0, "parent_launches": 0,
           "timed_as": f"sums of medians of {PROBE_REPS} interleaved "
                       f"launches queued behind a backlog"}
    out = []
    for x01, g, spec, n in recs:
        D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
        n = L if n is None else n
        B, R = x01.shape[0], spec.total_params
        got = kern(x01, g, spec, n)
        ref = hg.hash_grid_backward_plain(x01, g, spec, n)
        mag = hg.hash_grid_backward_plain(x01, g.abs(), spec, n)
        floor = scatter_floor(got, ref, mag)
        parents = parent_launches(hg, x01, g, spec, n)
        inb = ((x01 >= 0.0) & (x01 <= 1.0)).all(dim=-1)
        U = sum(int(torch.unique(i[:, inb]).numel())
                for _, i, _, _ in parents)
        adds = int(inb.sum()) * (1 << D) * n
        width = 4 if C % 4 == 0 else (2 if C % 2 == 0 else 1)
        rate = red["4 MB"][{1: "f32", 2: "f32x2", 4: "f32x4"}[width]]
        rec = {"spec": f"D {D}, C {C}, {n} of {L} levels, {R} rows, "
                       f"{spec.interpolation}, {spec.gridtype}",
               "points": B,
               "hashed_levels": [lv for lv in range(n) if spec.hashed[lv]],
               "adds": adds, "touched_rows": U,
               "max_abs_ref": float(ref.abs().max()),
               "max_abs_err": float((got - ref).abs().max()),
               "floor": floor}
        check(floor <= SCATTER_MAG, f"hash_grid_backward {rec['spec']}: "
                                    f"{rec}")
        flat_i = torch.cat([i.reshape(-1).long() + o
                            for _, i, _, o in parents])
        flat_r = torch.cat([r.reshape(-1, C) for _, _, r, _ in parents])
        buf = torch.zeros(R, C, device=dev)

        def parent_route():
            gt = torch.zeros(R, C, device=dev)
            for s_, i, r, o in parents:
                ga.gather_rows_backward(gt[o:o + s_], i, r)

        del got, ref, mag
        times = interleaved_ms([
            lambda: kern(x01, g, spec, n),
            lambda: hg.hash_grid_backward_plain(x01, g, spec, n),
            lambda: buf.index_add_(0, flat_i, flat_r),
            parent_route])
        bound = (4 * D * B + 4 * L * C * B + 4 * C * (R + U)) / HBM_BPS * 1e3
        red_ms = adds * (C // width) / (rate * 1e9) * 1e3
        for k, t in zip(keys, times):
            rec[k] = list(t)
            tot[k] += t[0]
            tot[k + "_p10_p90"] = [tot[k + "_p10_p90"][0] + t[1],
                                   tot[k + "_p10_p90"][1] + t[2]]
        rec.update(bound_ms=bound, red_bound_ms=red_ms,
                   share_bytes=bound / times[0][0],
                   share_red=red_ms / times[0][0],
                   parent_launches=len(parents))
        tot["bound_ms"] += bound
        tot["red_bound_ms"] += red_ms
        tot["adds"] += adds
        tot["parent_launches"] += len(parents)
        tot["max_abs_err"] = max(tot["max_abs_err"], rec["max_abs_err"])
        tot["floor"] = max(tot["floor"], floor)
        out.append(rec)
        del parents, flat_i, flat_r, buf
        torch.cuda.empty_cache()
    return tot, out


def hold_backward(ga, seen, dev):
    """Every recorded gather_rows_backward launch run alone into a zero
    table, held against index_add_ on the same views (scatter_floor, with
    the magnitudes of the adds summed by index_add_ as its scale) and
    timed against it and the plain version: medians and 10th / 90th
    percentiles of PROBE_REPS interleaved launches queued behind a backlog,
    with the byte bound (indices and gradient rows read once, each distinct
    touched row read and written once). -> the step's sums and one record
    a launch, with max|ref| and the median |ref| over the touched rows."""
    import torch

    kern_fn = ga.gather_rows_backward
    tot = {"ms": 0.0, "ms_p10_p90": [0.0, 0.0], "plain_ms": 0.0,
           "library_ms": 0.0, "library_ms_p10_p90": [0.0, 0.0],
           "bound_ms": 0.0, "max_abs_err": 0.0, "floor": 0.0,
           "timed_as": f"sums of medians of {PROBE_REPS} interleaved "
                       f"launches queued behind a backlog"}
    launches = []
    for R, idx, go in seen:
        C = go.shape[-1]
        zeros = torch.zeros(R, C, device=dev)
        got = kern_fn(zeros.clone(), idx, go)
        ref = ga.gather_rows_backward_plain(zeros.clone(), idx, go)
        mag = ga.gather_rows_backward_plain(zeros.clone(), idx, go.abs())
        floor = scatter_floor(got, ref, mag)
        M = idx.numel()
        rows = torch.unique(idx[(idx >= 0) & (idx < R)]).long()
        U = int(rows.numel())
        rec = {"shape": f"{list(idx.shape)} x {C} into {R} rows",
               "distinct_rows": U, "adds_per_row": M / max(U, 1),
               "max_abs_ref": float(ref.abs().max()),
               "median_abs_ref": float(ref[rows].abs().median())
               if U else 0.0,
               "max_abs_err": float((got - ref).abs().max()),
               "floor": floor}
        launches.append(rec)
        check(floor <= SCATTER_MAG,
              f"gather_rows_backward {rec['shape']}: {rec}")
        flat_i, flat_g = idx.reshape(-1).long(), go.reshape(-1, C)
        buf_k, buf_l, buf_p = zeros.clone(), zeros.clone(), zeros.clone()
        kern, lib, plain = interleaved_ms([
            lambda: kern_fn(buf_k, idx, go),
            lambda: buf_l.index_add_(0, flat_i, flat_g),
            lambda: ga.gather_rows_backward_plain(buf_p, idx, go)])
        bound = (4 * M + 4 * M * C + 8 * U * C) / HBM_BPS * 1e3
        rec.update(ms=list(kern), library_ms=list(lib), plain_ms=plain[0],
                   bound_ms=bound)
        for key, t in (("ms", kern), ("library_ms", lib)):
            tot[key] += t[0]
            tot[key + "_p10_p90"] = [tot[key + "_p10_p90"][0] + t[1],
                                     tot[key + "_p10_p90"][1] + t[2]]
        tot["plain_ms"] += plain[0]
        tot["bound_ms"] += bound
        tot["max_abs_err"] = max(tot["max_abs_err"], rec["max_abs_err"])
        tot["floor"] = max(tot["floor"], floor)
        del got, ref, mag, buf_k, buf_l, buf_p, zeros
    return tot, launches


def s_grid_launch(model, seen, dev):
    """T3's C = 8 launch: ModelConfig()'s s_grid at S_GRID_POINTS of the
    recorded step's field points, its output gradient drawn at the scale
    of the field's (a step's gradients are 1e-6 and below, the scale
    SCATTER_TOL's absolute floor holds). -> (x01, g, spec, None)."""
    import torch

    from sanerf_tpu_torch.config import ModelConfig, RenderConfig
    from sanerf_tpu_torch.models import fields

    s_spec = fields.make_model(ModelConfig(field_type="hashgrid",
                                           with_sam=True),
                               RenderConfig()).s_grid_spec
    x_f, g_f = next((x, g) for x, g, sp, _ in seen if sp == model.grid_spec)
    x8 = x_f[:S_GRID_POINTS].contiguous()
    g8 = torch.randn(x8.shape[0], s_spec.output_dim,
                     generator=torch.Generator(device=dev).manual_seed(8),
                     device=dev) * float(g_f.std())
    return x8, g8, s_spec, None


def s_grid_encode(hg, s8, dev):
    """The SAM grid's whole encode in training (hash_encode_01 of a float32
    table that needs its gradient, then the gradient g of the output) at
    s_grid_launch's points: on the kernels (hash_grid_forward +
    hash_grid_backward) and on the level route (_level_taps, one
    gather_rows a level through gather_row_ranges, one
    gather_rows_backward a level); medians and 10th / 90th percentiles of
    HASHGRID_REPS interleaved runs queued behind a backlog."""
    import torch

    x8, g8, spec, _ = s8
    gen = torch.Generator(device=dev).manual_seed(9)
    t8 = (torch.rand(spec.total_params, spec.level_dim, generator=gen,
                     device=dev) * 2 - 1).requires_grad_(True)
    real = hg.forward_takes, hg.backward_takes

    def run(kernels):
        def go():
            if not kernels:
                hg.forward_takes = hg.backward_takes = lambda s, k: False
            try:
                t8.grad = None
                hg.hash_encode_01(x8, t8, spec).backward(g8)
            finally:
                hg.forward_takes, hg.backward_takes = real
        return go

    kern, level = interleaved_ms([run(True), run(False)], n=HASHGRID_REPS)
    del t8
    return {"points": x8.shape[0], "kernels_ms": list(kern),
            "level_route_ms": list(level),
            "timed_as": f"medians and 10th / 90th percentiles of "
                        f"{HASHGRID_REPS} interleaved runs"}


def hash_step(model, tc, params, batch, draws):
    """One rgb_loss_fn gradient of the hash-grid step (state.loss_and_grads
    with proposal updates) -> (loss, {leaf path: gradient})."""
    from sanerf_tpu_torch.train import state as st_lib
    from sanerf_tpu_torch.train.tree import leaves_with_paths

    loss, _, g = st_lib.loss_and_grads(model, tc, params, batch, draws, 0,
                                       True)
    return float(loss), dict(leaves_with_paths(g))


def hash_step_phase(dev, textured):
    """Phase T3: one full-width hash-grid step (RenderConfig(),
    TrainConfig(), 8,192 rays) as shipped (HASH_GRIDS hash_grid_forward and
    HASH_GRIDS hash_grid_backward launches, no gather_rows or
    gather_rows_backward) and with the plain versions swapped in (the level
    route on the plain gather, hash_grid_backward_plain); each table
    gradient held at scatter_floor, the rest at GRAD_TOL x max|ref|;
    planted faults in hash_grid_backward's inputs (a level's output
    gradient zeroed, or every other point's) at the first, the first
    hashed and the last level of each grid must fail that hold, and
    FORWARD_FAULTS in hash_grid_forward's level inputs its bit-for-bit
    hold; every launch of both kernels held alone and timed (hold_forward,
    hold_fused), and ModelConfig()'s s_grid (C = 8) at S_GRID_POINTS of
    the step's points, also its whole training encode (forward and table
    gradient) on the kernels against the level route; the level route's
    gradient (one gather_rows_backward a level, on the rows its glue
    made) held and timed launch by launch (hold_backward); the full step
    (optimizer and EMA too) timed on this tree's route, the parent's (the
    level route forward) and the level route both ways, and its peak
    memory; one step with the TV term (TV_LAMBDA), which adds one
    gather_rows_backward launch and 1 + 2 D gather_rows launches a level
    of the field's grid. -> (T3's record, hold_fused's sums, the level
    route's sums and launches, the TV step's launches)."""
    import dataclasses

    import numpy as np
    import torch

    from sanerf_tpu_torch.config import ModelConfig, RenderConfig, TrainConfig
    from sanerf_tpu_torch.models import fields
    from sanerf_tpu_torch.ops import gather as ga
    from sanerf_tpu_torch.ops import hashgrid as hg
    from sanerf_tpu_torch.train import state as st_lib

    sys.path.insert(0, os.path.join(ROOT, "port_tools"))
    import red_probe

    model = fields.make_model(ModelConfig(field_type="hashgrid"),
                              RenderConfig())
    tc = TrainConfig()
    n = st_lib.adaptive_num_rays(tc, model.render_cfg.num_steps[-1])
    params = fields.init_params(model, torch.Generator().manual_seed(0), dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             textured.collate_train(np.random.default_rng(0), n).items()
             if isinstance(v, np.ndarray)}
    draws = st_lib.draw_step(model, tc, n,
                             torch.Generator(device=dev).manual_seed(0), dev)

    def step():
        out = hash_step(model, tc, params, batch, draws)
        torch.cuda.synchronize()
        return out

    fused_n, level_n = hg._HASH_GRID_BACKWARD, ga._GATHER_ROWS_BACKWARD
    fwd_n, gat_n = hg._HASH_GRID_FORWARD, ga._GATHER_ROWS
    counts = (fused_n, level_n, fwd_n, gat_n)
    for c in counts:
        c.launches = 0
    ((loss_k, g_k), seen), fseen = record_forward(
        hg, lambda: record_fused(hg, step))
    launched = {c.__name__: c.launches for c in counts}
    check(launched == {"hash_grid_backward": HASH_GRIDS,
                       "gather_rows_backward": 0,
                       "hash_grid_forward": HASH_GRIDS, "gather_rows": 0}
          and len(seen) == len(fseen) == HASH_GRIDS,
          f"T3: launches {launched}, {len(seen)} / {len(fseen)} recorded")

    def grid_names(recs):
        return [next(name for name, sp in (
            ("grid", model.grid_spec),
            *((f"prop/{i}/grid", sp) for i, sp in
              enumerate(model.prop_specs))) if sp == spec)
                for _, _, spec, _ in recs]

    grids, fgrids = grid_names(seen), grid_names(fseen)
    check(sorted(grids) == sorted(fgrids) == sorted(HASH_TABLES),
          f"T3: launches of {grids}, {fgrids}")
    real_fwd, real_takes = hg.gather_rows, hg.forward_takes

    def plain_step(bwd):
        hg.gather_rows = ga.gather_rows_plain
        hg.forward_takes = lambda spec, k: False
        hg.hash_grid_backward = bwd
        try:
            return step()
        finally:
            hg.gather_rows, hg.forward_takes = real_fwd, real_takes
            hg.hash_grid_backward = fused_n

    loss_p, g_p = plain_step(hg.hash_grid_backward_plain)
    # each table's S: the step's table gradient with every add's magnitude
    # (the weights are >= 0)
    _, g_m = plain_step(lambda x01, g, spec, k: hg.hash_grid_backward_plain(
        x01, g.abs(), spec, k))
    mag = {k: g_m[k] for k in HASH_TABLES}
    del g_m
    check(loss_k == loss_p, f"T3: loss {loss_k} vs plain {loss_p}")
    check(sorted(g_k) == sorted(g_p), f"T3: leaves {sorted(g_k)}")
    ref = g_p

    def held(g):
        """{leaf: (ok, |d| max, floor or None)} against the plain step."""
        out = {}
        for k, r in ref.items():
            got = g[k]
            d = float((got - r).abs().max())
            if k in HASH_TABLES:
                f = scatter_floor(got, r, mag[k])
                out[k] = (f <= SCATTER_MAG, d, f)
            else:
                out[k] = (d <= GRAD_TOL * float(r.abs().max()), d, None)
        return out

    step_held = held(g_k)
    tables = {k: {"max_abs_err": step_held[k][1], "floor": step_held[k][2],
                  "max_abs_ref": float(ref[k].abs().max()),
                  "median_abs_ref_nonzero": float(
                      ref[k][ref[k] != 0].abs().median())
                  if bool((ref[k] != 0).any()) else 0.0}
              for k in HASH_TABLES}
    log(f"T3: table gradients {tables}")
    for k, (ok, d, f) in step_held.items():
        check(ok, f"T3: gradient {k} off the plain step: {d} (floor {f})")
    del g_k
    # the hold must see a fault planted in the kernel's inputs at the
    # first, the first hashed and the last level of each grid
    caught, least, faults = 0, math.inf, []
    for j, (x01, _, spec, k) in enumerate(seen):
        k = spec.num_levels if k is None else k
        hashed = [lv for lv in range(k) if spec.hashed[lv]]
        for level in sorted({0, k - 1, *hashed[:1]}):
            for kind in HASH_FAULTS:
                (_, g_f), _ = record_fused(hg, step, (j, level, kind))
                worst = max(f for ok, d, f in held(g_f).values()
                            if f is not None)
                check(worst > SCATTER_MAG,
                      f"T3: a planted fault ({kind}) at level {level} of "
                      f"{grids[j]} passed the hold: floor {worst}")
                caught += 1
                least = min(least, worst)
                faults.append([grids[j], level, kind, worst])
                del g_f
    del g_p, ref, mag
    # the encode: every launch of the step held bit for bit and timed, and
    # the faults planted in its level inputs caught
    ffwd, fwd_launches = hold_forward(hg, ga, fseen)
    for rec, name in zip(fwd_launches, fgrids):
        rec["grid"] = name
    fwd_faults = forward_faults(hg, ga, fseen, fgrids)
    log(f"T3: hash_grid_forward launches {fwd_launches}, faults "
        f"{fwd_faults}")
    del fseen
    red = red_probe.rates(dev)
    log(f"T3: red_probe {red}")
    fused, per_launch = hold_fused(hg, ga, seen, dev, red)
    log(f"T3: hash_grid_backward launches {per_launch}")
    s8 = s_grid_launch(model, seen, dev)
    _, c8 = hold_fused(hg, ga, [s8], dev, red)
    s8_encode = s_grid_encode(hg, s8, dev)
    log(f"T3: the s_grid's training encode {s8_encode}")
    del s8
    # the parent's route, launch by launch
    level_seen = [(s_, i, r) for x01, g, spec, k in seen
                  for s_, i, r, _ in parent_launches(hg, x01, g, spec, k)]
    bwd, level_launches = hold_backward(ga, level_seen, dev)
    del level_seen
    log(f"T3: the parent's route, launch by launch {level_launches}")
    # the full step on each route: host clock around a synchronised step,
    # its peak memory; the parent's route (the level route forward) and the
    # level route both ways by the encode's own tests
    state = st_lib.create_train_state(model, tc, params=params)
    train_step = st_lib.make_rgb_train_step(model, tc)
    real_bwd_takes = hg.backward_takes
    routes = ("fused", "parent_route", "level_route")
    steps = {k: [] for k in routes}
    peaks = {k: 0 for k in routes}
    for rnd in range(STEP_ROUNDS + 1):
        for name in routes + routes[::-1]:
            if name != "fused":
                hg.forward_takes = lambda spec, k: False
            if name == "level_route":
                hg.backward_takes = lambda spec, k: False
            try:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                state, _ = train_step(state, batch, draws, True)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t) * 1e3
            finally:
                hg.backward_takes = real_bwd_takes
                hg.forward_takes = real_takes
            if rnd:  # the first round warms up
                steps[name].append(ms)
                peaks[name] = max(peaks[name],
                                  torch.cuda.max_memory_allocated())
    step_cmp = {k: {"step_ms_median": statistics.median(v),
                    "step_ms_runs": v, "max_memory_allocated": peaks[k]}
                for k, v in steps.items()}
    log(f"T3: steps {step_cmp}")
    # the TV term: gather_rows_backward's launches on the training path
    tc_tv = dataclasses.replace(tc, lambda_tv=TV_LAMBDA)
    tv_step = st_lib.make_rgb_train_step(model, tc_tv)
    draws_tv = st_lib.draw_step(model, tc_tv, n,
                                torch.Generator(device=dev).manual_seed(1),
                                dev)
    torch.cuda.synchronize()
    for c in counts:
        c.launches = 0
    tv_step(state, batch, draws_tv, True)
    torch.cuda.synchronize()
    tv = {c.__name__: c.launches for c in counts}
    L, D = model.grid_spec.num_levels, model.grid_spec.input_dim
    check(tv == {"hash_grid_backward": HASH_GRIDS,
                 "gather_rows_backward": L, "hash_grid_forward": HASH_GRIDS,
                 "gather_rows": (1 + 2 * D) * L},
          f"T3: the TV step's launches {tv}")
    del seen, params, batch, draws, draws_tv, state
    torch.cuda.empty_cache()
    return {"rays": n, "tables": tables,
            "grad_max_abs_err": {k: v[1] for k, v in step_held.items()},
            "launches_of": dict(zip(grids, (r["points"]
                                            for r in per_launch))),
            "planted_faults_caught": caught,
            "least_planted_fault_floor": least, "planted_faults": faults,
            "red_probe_gadds_per_s": red, "fused": fused,
            "fused_launches": per_launch, "s_grid_c8": c8[0],
            "s_grid_encode_train": s8_encode,
            "forward": ffwd, "forward_launches": fwd_launches,
            "forward_planted_faults": fwd_faults,
            "parent_route": bwd, "parent_route_launches": level_launches,
            "steps": step_cmp, "tv_step_launches": tv}, fused, bwd, tv


def path_gap(renderer, fast_model, slow_model, params, rays_o, rays_d, what,
             depth_max=DEPTH_MAX):
    """The fast path against the plain path (slow_model) on rows 128-255 of
    the frame (the band of port_tools/jax_path_gap.py), float32 params:
    image and weights_sum within PATH_TOL on every ray, depth on all but
    DEPTH_SHARE of the rays and those within depth_max. -> {output:
    {max_abs_err, rays_over}}."""
    import torch

    band = slice(SIZE * SIZE // 4, SIZE * SIZE // 2)
    fast = renderer.run_rays(fast_model, params, rays_o[band], rays_d[band])
    slow = renderer.run_rays(slow_model, params, rays_o[band], rays_d[band])
    torch.cuda.synchronize()
    out = {}
    for k in ("image", "depth", "weights_sum"):
        d = (fast[k] - slow[k]).abs()
        over = d > PATH_TOL + PATH_TOL * slow[k].abs()
        if over.dim() > 1:
            over, d = over.any(dim=-1), d.amax(dim=-1)
        n_over, e = int(over.sum()), float(d.max())
        out[k] = {"max_abs_err": e, "rays_over": n_over}
        allowed = math.floor(DEPTH_SHARE * d.numel()) if k == "depth" else 0
        check(n_over <= allowed and (k != "depth" or e <= depth_max),
              f"{what}: fast path {k} off the plain path: max {e:.3g}, "
              f"{n_over} of {d.numel()} rays past {PATH_TOL}")
    del fast, slow
    torch.cuda.empty_cache()
    return out


def heldout_psnr(renderer, model, params, nets, dev, what):
    """Held-out PSNR of a 128^2 model by the bench.py:149-170 protocol
    (textured fixture, 8 views, ring radius 1.8, per-view cam_near_far,
    render_staged)."""
    import numpy as np
    import torch

    from sanerf_tpu_torch.data.synthetic import SyntheticSphereDataset
    from sanerf_tpu_torch.train.metrics import PSNRMeter

    ds = SyntheticSphereDataset(H=128, W=128, n_views=8, radius=1.8,
                                scene="textured", training=False)
    meter = PSNRMeter()
    for idx in range(len(ds)):
        fr = ds.frame(idx)
        out = renderer.render_staged(
            model, params, torch.as_tensor(fr["rays_o"], device=dev),
            torch.as_tensor(fr["rays_d"], device=dev),
            cam_near_far=torch.as_tensor(fr["cam_near_far"], device=dev),
            nets=nets)
        img = out["image"].float().cpu().numpy()
        check(np.isfinite(img).all() and img.shape == (128 * 128, 3),
              f"{what}: PSNR frame {idx} not finite or misshapen")
        meter.update(img, fr["images"])
    return meter.measure()


def views_psnr(tm, tp, sm, sp, views, dev):
    """D7 (and port_tools/distill_spread.py): the student's (sm, sp) frames
    against the teacher's (tm, tp) on the scene's views, render_staged:
    PSNR of the mean square error."""
    import numpy as np
    import torch

    from sanerf_tpu_torch.models import renderer

    mse = []
    for i in range(len(views)):
        fr = views.frame(i)
        ro, rd = (torch.as_tensor(fr[k], device=dev)
                  for k in ("rays_o", "rays_d"))
        with torch.no_grad():
            a, b = (renderer.render_staged(m, p, ro, rd)["image"].float()
                    for m, p in ((tm, tp), (sm, sp)))
        mse.append(float(((a - b) ** 2).mean()))
    return float(-10.0 * np.log10(max(np.mean(mse), 1e-10)))


def field_of(name, a):
    """The TransposedFieldMLP of a run_tmlp / run_tmlp_composite launch."""
    return a[1] if name == "run_tmlp" else a[3]


def ptxas_of(log, tag):
    """{kernel: {registers, spill_stores, spill_loads}} of the entries of
    an nvcc -Xptxas -v log whose mangled names hold `tag`, and the entries
    whose wgmma pipelines ptxas serialized (C7511 / C7520) under
    "serialized"."""
    import re

    out, entry, serialized = {}, None, []
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            entry = m.group(1)
        if ("C7511" in line or "C7520" in line) and tag in line:
            serialized.append(line.strip()[:160])
        if not entry or tag not in entry:
            continue
        rec = out.setdefault(entry, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rec["spill_stores"], rec["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rec["registers"] = int(m.group(1))
    out["serialized"] = serialized
    return out


def route_twin(fm, tm, route, T=None, view=None):
    """A copy of tm (the same weights) planned with a route taken away: the
    route such nets took before it. "prop": run_tmlp launches it on
    tmlp_kernel, not prop_kernel; "grid": run_tmlp (T None) or the
    composite over rays of T samples with `view` on the V_SERVED /
    V_BRANCHES kernels, not V_GRID's."""
    attr, off = {"prop": ("_prop_plan", lambda *a, **k: None),
                 "grid": ("_grid_net", lambda *a, **k: False)}[route]
    twin = copy.copy(tm)
    twin._plans, twin._parks = {}, {}
    real = getattr(fm, attr)
    setattr(fm, attr, off)
    try:
        fm.kernel_plan(twin, T, view)
    finally:
        setattr(fm, attr, real)
    return twin


def field_op_ms(name, a, k):
    """(CUDA-core ms, tensor-core ms) of the operations of one field-kernel
    launch (run_tmlp or run_tmlp_composite with its arguments a, k): the
    chain's MACs over every point and the view head's over every ray, 2
    operations each. bf16 weights: all on the tensor cores at BF16_FLOPS,
    the same number twice. float32 weights: all on the CUDA cores at
    F32_FLOPS, against the chain as 3xTF32 (three tf32 products a MAC) on
    the tensor cores at TF32_FLOPS with the view head on the CUDA cores.
    The float32 encode and CP taps, on other units, are left out."""
    import torch

    tm = field_of(name, a)
    P = a[0].shape[1]
    macs = sum(int(w.shape[0]) * int(w.shape[1]) for w in tm.ws) * P
    view, vmacs = k.get("view"), 0
    if name == "run_tmlp_composite" and view is not None:
        N = P // (a[1].shape[1] if a[1].dim() == 2 else k["T"])
        vmacs = N * (view.H * (view.geo + view.sh_dim) + sum(
            int(w.shape[0]) * int(w.shape[1]) for w in view.rest))
    if tm.dtype == torch.bfloat16:
        t = 2.0 * (macs + vmacs) / BF16_FLOPS * 1e3
        return t, t
    return (2.0 * (macs + vmacs) / F32_FLOPS * 1e3,
            (6.0 * macs / TF32_FLOPS + 2.0 * vmacs / F32_FLOPS) * 1e3)


def plain_f64(name, a, k, chunk=1 << 21):
    """The float64 plain version of a run_tmlp / run_tmlp_composite launch
    with arguments a, k (the same float32 operands, float64 arithmetic), in
    slices of about `chunk` points (whole rays) -> a tuple of outputs."""
    import torch

    from sanerf_tpu_torch.ops import fused_mlp_t as fm

    f64 = torch.float64
    if name == "run_tmlp":
        xT, tm = a[0], a[1]
        return (torch.cat([fm.run_tmlp_plain(xT[:, i:i + chunk], tm, f64)
                           for i in range(0, xT.shape[1], chunk)], 1),)
    xT, dl, ts = a[:3]
    k = dict(k)
    q, T = k.pop("pack_q", 1), k.pop("T", None)
    dl, ts = fm._unpack_rows(dl, q, T), fm._unpack_rows(ts, q, T)
    T = dl.shape[1]
    n = max(1, chunk // T)
    parts = []
    for i in range(0, dl.shape[0], n):
        kk = dict(k)  # opaque, view, rays8
        if kk.get("rays8") is not None:
            kk["rays8"] = kk["rays8"][i:i + n]
        parts.append(fm.run_tmlp_composite_plain(
            xT[:, i * T:(i + n) * T], dl[i:i + n], ts[i:i + n], *a[3:],
            **kk, dtype=f64))
    return tuple(torch.cat(o, 0) for o in zip(*parts))


def slice_launch(name, a, k, lo, hi):
    """A launch (name, arguments a, k) cut to its rays lo..hi (run_tmlp:
    its points lo..hi), each slice contiguous."""
    c = lambda t: None if t is None else t[lo:hi].contiguous()  # noqa: E731
    k = dict(k)
    if name == "run_tmlp":
        return (a[0][:, lo:hi].contiguous(),) + tuple(a[1:]), k
    if name == "run_tmlp_composite":
        T = a[1].shape[1]
        if k.get("rays8") is not None:
            k["rays8"] = c(k["rays8"])
        return ((a[0][:, lo * T:hi * T].contiguous(), c(a[1]), c(a[2]))
                + tuple(a[3:]), k)
    if k.get("jitter") is not None:
        k["jitter"] = c(k["jitter"])
    if name == "ray_level0":
        return (c(a[0]),) + tuple(a[1:]), k
    return (c(a[0]), c(a[1]), c(a[2])) + tuple(a[3:]), k


def plain_in_slices(plain, name, a, k, rays=None):
    """The plain version `plain` of a whole launch (name, arguments a, k)
    run on its rays in slices of `rays` (SLICE_RAYS) rays (run_tmlp: rays
    x 64 points) and the slices' outputs put together, where the plain
    version of the whole launch at once would not fit the card's memory
    -> a tuple."""
    import torch

    if name == "run_tmlp_composite" and (k.get("pack_q", 1) > 1
                                         or a[1].dim() != 2):
        fail("plain_in_slices: a packed composite launch")
    rays = rays or SLICE_RAYS
    step = rays * 64 if name == "run_tmlp" else rays
    total = (a[0].shape[1] if name == "run_tmlp"
             else a[1].shape[0] if name == "run_tmlp_composite"
             else a[0].shape[0])
    outs = []
    for lo in range(0, total, step):
        sa, sk = slice_launch(name, a, k, lo, min(lo + step, total))
        o = plain(*sa, **sk)
        outs.append(o if isinstance(o, tuple) else (o,))
        del sa, sk
    # run_tmlp [kout, P] and the ray kernels' x3 [3, N, T] along dim 1
    dims = ((1,) if name == "run_tmlp" else (0,) * 4 if name.startswith(
        "run_tmlp") else (0, 0, 0, 1, 0, 0))
    return tuple(torch.cat(parts, d) for parts, d in zip(zip(*outs), dims))


def f64_errors(got, ref, ref64):
    """(kernel's, plain version's) largest |d| / (1 + |r64|) over every
    output of a launch, against its float64 plain version ref64."""
    e_k = e_p = 0.0
    for g, r, r64 in zip(got, ref, ref64):
        if not r64.numel():
            continue
        s = 1.0 + r64.abs()
        e_k = max(e_k, float(((g.double() - r64).abs() / s).max()))
        e_p = max(e_p, float(((r.double() - r64).abs() / s).max()))
    return e_k, e_p


def shape_key(a, k):
    """One launch's operands as text: tensor shapes, the MLP's layer widths,
    scalars."""
    def f(v):
        if hasattr(v, "shape"):
            return "x".join(map(str, v.shape))
        if hasattr(v, "ws"):
            return "mlp(" + "-".join(str(int(w.shape[1])) for w in v.ws) + ")"
        if hasattr(v, "H"):
            return f"view({v.H})"
        return str(v)
    return ", ".join([f(v) for v in a]
                     + [f"{kk}={f(v)}" for kk, v in sorted(k.items())])


def main():
    import torch

    t_wall = time.time()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not os.path.isdir(os.path.join(ROOT, "sanerf_tpu_torch")):
        fail("run from a checkout of the repository (sanerf_tpu_torch/ missing)")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import dataclasses

    import numpy as np

    from sanerf_tpu_torch.data.rays import full_frame_rays
    from sanerf_tpu_torch.models import fields, renderer
    from sanerf_tpu_torch.models.asset import load_asset
    from sanerf_tpu_torch.ops import _build
    from sanerf_tpu_torch.ops import fused_mlp_t as fm
    from sanerf_tpu_torch.ops import ray_kernels as rk
    from sanerf_tpu_torch.utils.camera import fov_to_focal

    # -- 1. build + card --------------------------------------------------
    t0 = time.time()
    planted = planted_tree()
    # the planted copy's nvcc runs beside the kernels' own
    planted_job = _build._start("fused_mlp_t", planted / "csrc",
                                planted / "kernels")
    try:
        logs = _build.build_all()
    finally:
        _build._finish("fused_mlp_t", *planted_job)
    log(f"build: {time.time() - t0:.1f} s (with {PROP_FAULT}, {RING_FAULT}, "
        f"{GRID_FAULT} and {F32_RING_FAULT} planted)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    mc, rc, params32 = load_asset(os.path.join(ROOT, "assets",
                                               "serving_student"), device=dev)
    params = fields.cast_params(params32, torch.bfloat16)

    def model_at(steps, **kw):
        return fields.make_model(mc, dataclasses.replace(
            rc, num_steps=steps, max_ray_batch=SIZE * SIZE, **kw))

    focal = fov_to_focal(60.0, SIZE)
    intr = [focal, focal, SIZE / 2, SIZE / 2]
    rays_o, rays_d = full_frame_rays(np.asarray(SERVE_POSE, np.float32),
                                     np.asarray(intr, np.float32), SIZE, SIZE,
                                     device=dev)
    models = {h: model_at(s) for h, s in HIERARCHIES.items()}
    # the packed weights depend on the params only, not on the hierarchy
    nets = fields.KernelNets(models["32,16"], params)
    nets32 = fields.KernelNets(models["32,16"], params32)
    twin = {id(a): b for a, b in zip([*nets.props, nets.field, nets.view],
                                     [*nets32.props, nets32.field,
                                      nets32.view])}

    # -- 2. kernels against their plain versions ---------------------------
    kern_fn = {"ray_level0": rk.ray_level0, "ray_level": rk.ray_level,
               "run_tmlp": fm.run_tmlp,
               "run_tmlp_composite": fm.run_tmlp_composite,
               "flatten3_nt": rk.flatten3_nt}
    plain_fn = {
        "ray_level0": rk.ray_level0_plain,
        "ray_level": rk.ray_level_plain,
        "run_tmlp": lambda x, tm, transposed: fm.run_tmlp_plain(x, tm),
        "run_tmlp_composite": fm.run_tmlp_composite_plain,
        "flatten3_nt": rk.flatten3_nt_plain,
    }
    # every call of each kernel in one frame per hierarchy: [(args, kwargs)]
    calls = {}
    for h, model in models.items():
        with spying(renderer, fields, kern_fn, calls, h):
            renderer.render_frame(model, params, rays_o, rays_d,
                                  chunk=SIZE * SIZE, nets=nets)
        torch.cuda.synchronize()
        check({n for (hh, n) in calls if hh == h} == set(KERNELS),
              f"{h}: the main path missed a kernel: {sorted(calls)}")
    seen = {key: v[0] for key, v in calls.items()}
    # the served launches bit for bit as before the limits were lifted
    sys.path.insert(0, os.path.join(ROOT, "port_tools"))
    from served_digests import served_launches

    digests = {h: [(r["kernel"], r["digest"]) for r in rows_]
               for h, rows_ in served_launches(ROOT, 0, dev).items()}
    for h, want in SERVED_DIGESTS.items():
        check(digests[h] == [tuple(w) for w in want],
              f"{h}: the served bf16 launches' outputs differ from "
              f"SERVED_DIGESTS: {digests[h]}")
    log("served launches: digests equal SERVED_DIGESTS")

    # field kernel -> its float32 launches' largest max |d| / (1 + |ref|)
    # of those held at F32_FAITHFUL ("held"), and the largest kernel and
    # cuBLAS errors against the float64 plain version of the others ("f64")
    faithful = {"held": {}, "f64": {}}

    def compare(name, a, k, tol, flips, faithful_hold=False,
                in_slices=False):
        """Kernel vs plain on the same inputs -> (max abs err, outputs past
        tol + tol |ref|); with `in_slices` the plain version runs on slices
        of the launch's rays (plain_in_slices). Fails where
        |d| > tol + tol |ref|; with `flips` (bf16 weights), on more than
        FLIP_SHARE of the outputs or past tol * max|ref| (see MLP_TOL). A
        field kernel with float32 weights also fails, with `faithful_hold`
        (seeded weights), where |d| > F32_FAITHFUL + F32_FAITHFUL |ref|, and
        without it (trained weights) where its error against the float64
        plain version passes F32_F64_MULT times the plain version's plus
        F32_ULP."""
        f32_field = (name.startswith("run_tmlp")
                     and field_of(name, a).dtype == torch.float32)
        got = kern_fn[name](*a, **k)
        ref = (plain_in_slices(plain_fn[name], name, a, k) if in_slices
               else plain_fn[name](*a, **k))
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        err, past = 0.0, 0
        for g, r in zip(got, ref):
            check(g.shape == r.shape, f"{name}: shape {g.shape} vs {r.shape}")
            check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
            if not r.numel():
                continue
            d = (g - r).abs()
            e = float(d.max())
            err = max(err, e)
            n_over = int((d > tol + tol * r.abs()).sum())
            past += n_over
            if flips:
                ok = (n_over <= math.ceil(FLIP_SHARE * r.numel())
                      and e <= tol * max(1.0, float(r.abs().max())))
            else:
                ok = n_over == 0
            check(ok, f"{name}: kernel disagrees with its plain version "
                      f"(max abs err {e:.3g}, {n_over} of {r.numel()} "
                      f"outputs past {tol} + {tol} |ref|)")
            if f32_field and faithful_hold:
                ratio = float((d / (1.0 + r.abs())).max())
                held = faithful["held"]
                held[name] = max(held.get(name, 0.0), ratio)
                check(ratio <= F32_FAITHFUL,
                      f"{name}: float32 kernel not faithful to its plain "
                      f"version: max |d| / (1 + |ref|) {ratio:.3g} > "
                      f"{F32_FAITHFUL}")
        if f32_field and not faithful_hold:
            e_k, e_p = f64_errors(got, ref, plain_f64(name, a, k))
            f64 = faithful["f64"].setdefault(name, [0.0, 0.0])
            f64[:] = [max(f64[0], e_k), max(f64[1], e_p)]
            check(e_k <= F32_F64_MULT * e_p + F32_ULP,
                  f"{name}: float32 kernel off the float64 plain version by "
                  f"{e_k:.3g} of 1 + |ref|, cuBLAS float32 by {e_p:.3g}: "
                  f"past {F32_F64_MULT} x that + {F32_ULP:.3g}")
        del got, ref
        torch.cuda.empty_cache()
        return err, past

    def to_f32(a, k):
        return (tuple(twin.get(id(v), v) for v in a),
                {kk: twin.get(id(v), v) for kk, v in k.items()})

    errs = {n: {} for n in KERNELS}
    errs32 = {n: {} for n in KERNELS}
    flipped = {n: {} for n in KERNELS}

    def hold(name, key, a, k, f32):
        """One main-path launch against its plain version (an MLP kernel
        also with the float32 twins f32(a, k) of its weights); the errors
        go to errs / errs32 / flipped[name][key]."""
        if name.startswith("ray"):
            e, _ = compare(name, a, k, RAY_TOL, flips=False)
            errs[name][key] = max(errs[name].get(key, 0.0), e)
            return
        e, past = compare(name, a, k, MLP_TOL, flips=True)
        e32, _ = compare(name, *f32(a, k), MLP_F32_TOL[name], flips=False)
        errs[name][key] = max(errs[name].get(key, 0.0), e)
        errs32[name][key] = max(errs32[name].get(key, 0.0), e32)
        flipped[name][key] = flipped[name].get(key, 0) + past

    for (h, name), launches_hn in calls.items():
        for a, k in launches_hn:  # every launch shape of the frame
            hold(name, h, a, k, to_f32)
    log(f"main-path shapes: max abs err bf16 {errs} f32 {errs32}, "
        f"bf16 outputs past the elementwise bound {flipped}")

    # small ragged shapes, and the options the main path does not take
    g = torch.Generator(device=dev).manual_seed(0)
    n_r = 997
    r8 = seen[("32,16", "ray_level0")][0][0][:n_r].contiguous()
    b0, _, _, _ = rk.ray_level0(r8, 128, True)
    w0 = torch.rand(n_r, 128, generator=g, device=dev)
    w0[::7] = 0.0
    compare("ray_level0", (r8, 128, True),
            {"jitter": (torch.rand(n_r, 129, generator=g, device=dev) - .5)
             / 128}, RAY_TOL, flips=False)
    compare("ray_level0", (r8, 7, False), {}, RAY_TOL, flips=False)
    for uniform_prev in (False, True):
        compare("ray_level", (r8, w0, b0, 64, True),
                {"uniform_prev": uniform_prev,
                 "jitter": (torch.rand(n_r, 65, generator=g, device=dev) - .5)
                 / 65}, RAY_TOL, flips=False)
    xr = torch.rand(3, n_r * 16 + 5, generator=g, device=dev) * 4 - 2
    for tm in (nets.props[0], nets.field):
        compare("run_tmlp", (xr, tm), {"transposed": True}, MLP_TOL,
                flips=True)
        compare("run_tmlp", *to_f32((xr, tm), {"transposed": True}),
                MLP_F32_TOL["run_tmlp"], flips=False)
    for T, opaque, view in ((16, True, nets.view), (32, False, nets.view),
                            (4, True, None)):
        xT = torch.rand(3, n_r * T, generator=g, device=dev) * 4 - 2
        dl = torch.rand(n_r, T, generator=g, device=dev) * 0.1
        ts = torch.cumsum(dl, 1) + 0.5
        a = (xT, dl, ts, nets.field)
        k = {"opaque": opaque, "view": view, "rays8": r8}
        compare("run_tmlp_composite", a, k, MLP_TOL, flips=True)
        compare("run_tmlp_composite", *to_f32(a, k),
                MLP_F32_TOL["run_tmlp_composite"], flips=False)
    log("ragged shapes: ok")

    # -- 3. the main path --------------------------------------------------
    counters = [kern_fn[n] for n in KERNELS]
    for c in counters:
        c.launches = 0
    per_frame, frames = {}, {}
    for h, model in models.items():
        before = [c.launches for c in counters]
        frames[h] = renderer.render_frame(model, params, rays_o, rays_d,
                                          chunk=SIZE * SIZE)
        torch.cuda.synchronize()
        per_frame[h] = [c.launches - b for c, b in zip(counters, before)]
    launches = [c.launches for c in counters]
    check(all(n > 0 for n in launches), f"a kernel never ran: {launches}")
    for h, out in frames.items():
        check(out["image"].shape == (SIZE * SIZE, 3), f"{h}: image shape")
        for k, v in out.items():
            check(bool(torch.isfinite(v).all()), f"{h}: {k} not finite")
        check(float(out["weights_sum"].min()) > 0.5,
              f"{h}: weights_sum {float(out['weights_sum'].min())}")
    log(f"launches per frame {per_frame}")
    del frames

    # fast vs plain path, float32 params, on a quarter of the frame
    path_err = {}
    for h, steps in HIERARCHIES.items():
        gap = path_gap(renderer, model_at(steps),
                       model_at(steps, use_fused_mlp=False), params32, rays_o,
                       rays_d, h)
        path_err.update({f"{h}/{k}": v for k, v in gap.items()})
    log(f"fast vs plain (f32 params): {path_err}")

    def frame_ms(model, n=5):
        ts_ = []
        for _ in range(n + 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            renderer.render_frame(model, params, rays_o, rays_d,
                                  chunk=SIZE * SIZE, nets=nets)
            torch.cuda.synchronize()
            ts_.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts_[1:]), ts_[1:]

    frame_times = {h: frame_ms(m) for h, m in models.items()}

    # -- kernel times against bound and plain ----------------------------
    def cuda_ms(fn, reps):
        """Mean ms of reps launches queued behind a backlog (the card's
        time)."""
        fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        backlog(0.5 * reps)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def bound(name, a, k):
        """(ms, bound_by) of one launch: the larger of its byte time and its
        operation time (bound_parts)."""
        return bound_of([bound_parts(name, a, k)])

    def bound_of(parts):
        """(ms, bound_by) of launches run in series: their byte times and
        their operation times each summed, then the larger."""
        t_b, t_o = sum(p[0] for p in parts), sum(p[1] for p in parts)
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    def bound_parts(name, a, k):
        """(byte ms, operation ms): each input read once and each output
        written once over HBM, and the operations at their type's peak:
        ray_level's float32 resample as the function needs it (pdf and CDF,
        5 a previous sample; about one ramp of 10 a previous interval and
        one a new edge, the CDF walk; 20 a new edge and a new sample for
        edges and geometry), the MLPs' MACs at the peak of their weights'
        type (field_op_ms: float32 at the lower of its CUDA-core and 3xTF32
        times)."""
        if name == "flatten3_nt":
            # a copy: each float read once and written once
            return 2 * a[0].numel() * 4 / HBM_BPS * 1e3, 0.0
        if name in ("ray_level0", "ray_level"):
            N = a[0].shape[0]
            T = a[1] if name == "ray_level0" else a[3]
            nbytes = N * 32 + N * (6 * T + 1) * 4
            if k.get("pack_q"):
                nbytes += N * 2 * T * 4  # the packed ts / dl rows
            ops = 0.0
            if name == "ray_level":
                T0 = a[1].shape[1]
                nbytes += N * T0 * 4
                if not k.get("uniform_prev"):
                    nbytes += N * (T0 + 1) * 4
                ops = N * (5.0 * T0 + 10.0 * (T0 + T + 1)
                           + 20.0 * (2 * T + 1))
            op_ms = ops / F32_FLOPS * 1e3
        else:
            tm = field_of(name, a)
            P = a[0].shape[1]
            op_ms = min(field_op_ms(name, a, k))
            if name == "run_tmlp":
                nbytes = P * 12 + P * tm.kout * 4
            else:
                N = P // (a[1].shape[1] if a[1].dim() == 2 else k["T"])
                # x3, dl, ts per point; rays8 per ray; gsum, depth, wsum, rgb
                nbytes = P * 20 + N * 32 + N * (tm.kout + 5) * 4
            nbytes += tm.table_bytes + sum(w.numel() * w.element_size()
                                           for w in tm.ws)
        return nbytes / HBM_BPS * 1e3, op_ms

    def launch_times(name, launches_, plain=True, in_slices=False):
        """[{shape, ms, plain_ms, bound_ms, bound_by}] of each launch, in
        the frame's order; a shape seen before is timed once: the kernel and
        the plain version (with `in_slices`, on slices of the launch's
        rays: plain_in_slices) each as the mean of 10 launches queued behind
        a backlog. A field kernel with float32 weights also gets both of its
        bounds (field_op_ms), bound_ms being the lower; a run_tmlp launch
        on prop_kernel also gets tmlp_kernel_ms, the same launch on
        tmlp_kernel (route_twin), a launch of a grid-family bf16 net
        grid_old_ms, the same launch on the route before V_GRID, timed
        alike; a float32 launch on the V_WIDE32 ring is marked so
        (variant)."""
        out, done = [], {}
        for a, k in launches_:
            key = shape_key(a, k)
            if key not in done:
                b_ms, b_by = bound(name, a, k)
                done[key] = {
                    "shape": key,
                    "ms": cuda_ms(lambda: kern_fn[name](*a, **k), reps=10),
                    "plain_ms": (cuda_ms(
                        (lambda: plain_in_slices(plain_fn[name], name, a, k))
                        if in_slices else (lambda: plain_fn[name](*a, **k)),
                        reps=10) if plain else None),
                    "bound_ms": b_ms, "bound_by": b_by}
                tm_ = field_of(name, a) if name.startswith("run_tmlp") \
                    else None
                T_ = None if name != "run_tmlp_composite" else (
                    k.get("T") or a[1].shape[1])
                if tm_ is not None and fm._grid_net(tm_):
                    # the same launch on the route before V_GRID, timed
                    # alike
                    twin = route_twin(fm, tm_, "grid", T_, k.get("view"))
                    ta = ((a[0], twin, *a[2:]) if name == "run_tmlp"
                          else (*a[:3], twin, *a[4:]))
                    done[key]["grid_old_ms"] = cuda_ms(
                        lambda: kern_fn[name](*ta, **k), reps=10)
                    done[key]["variant"] = "V_GRID"
                    del twin, ta
                if (tm_ is not None and fm.kernel_plan(
                        tm_, T_, k.get("view")).variant == fm.V_WIDE32):
                    done[key]["variant"] = "V_WIDE32"
                if (name == "run_tmlp"
                        and fm.route(a[1]) == "prop_kernel"):
                    # the earlier route of the same launch, timed alike
                    twin = route_twin(fm, a[1], "prop")
                    done[key]["tmlp_kernel_ms"] = cuda_ms(
                        lambda: kern_fn[name](a[0], twin, *a[2:], **k),
                        reps=10)
                    del twin
                if (name.startswith("run_tmlp")
                        and field_of(name, a).dtype == torch.float32):
                    b_bytes = bound_parts(name, a, k)[0]
                    core, tensor = field_op_ms(name, a, k)
                    done[key]["bound_f32_cuda_core_ms"] = max(b_bytes, core)
                    done[key]["bound_3xtf32_ms"] = max(b_bytes, tensor)
                torch.cuda.empty_cache()
            out.append(done[key])
        return out

    timing = {n: {} for n in KERNELS}
    rgb_launches = {n: {} for n in KERNELS}
    for (h, name), launches_hn in calls.items():
        rgb_launches[name][h] = launch_times(name, launches_hn)
        timing[name][h] = {kk: v for kk, v in rgb_launches[name][h][0].items()
                           if kk != "shape"}
    del seen, calls

    # -- 4. held-out PSNR on the textured fixture ---------------------------
    psnr = {h: heldout_psnr(renderer, fields.make_model(mc, dataclasses.replace(
        rc, num_steps=steps, max_ray_batch=128 * 128)), params, nets, dev, h)
        for h, steps in HIERARCHIES.items()}
    jax_psnr = {"32,16": JAX_PSNR_32_16_BF16, "128,64,32": JAX_PSNR_FULL_BF16}
    for h, ref in jax_psnr.items():
        check(abs(psnr[h] - ref) <= PSNR_TOL_DB,
              f"{h}: PSNR {psnr[h]:.3f} dB vs JAX {ref:.3f} dB")

    inter = interactive_phases(
        torch, np, dev, card, fields, renderer, rk, fm, compare, hold,
        cuda_ms, bound, bound_parts, bound_of,
        lambda steps, **kw: model_at(steps, **kw), rays_o, rays_d, nets,
        params, to_f32, kern_fn, launch_times)
    # errs / errs32 / flipped now also hold every launch of the interactive
    # frames (keys "interactive <hierarchy>")
    rows = []
    for i, name in enumerate(KERNELS):
        serve = timing[name]["32,16"]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": launches[i],
            "launches_per_frame": {h: per_frame[h][i] for h in per_frame},
            "max_abs_err": max(errs[name].values()),
            "max_abs_err_by_frame": errs[name],
            "tol": RAY_TOL if name.startswith("ray") else MLP_TOL,
            "tol_kind": ("elementwise" if name.startswith("ray") else
                         f"elementwise on all but {FLIP_SHARE} of the "
                         f"outputs, those within tol * max|ref|"),
            "max_abs_err_f32_weights": (max(errs32[name].values())
                                        if errs32[name] else None),
            "outputs_past_tol": flipped[name] or None,
            "ms": serve["ms"], "plain_ms": serve["plain_ms"],
            "bound_ms": serve["bound_ms"], "bound_by": serve["bound_by"],
            "library_ms": None,
            "library": "none: no single PyTorch call computes this function",
            "shapes_of": "32,16, first launch of the RGB frame",
            "by_hierarchy": timing[name],
            "rgb_frame_launches": rgb_launches[name]})
    rows += inter.pop("rows")
    inter_launches = inter.pop("launch_times")
    level0_served(rows[KERNELS.index("ray_level0")],
                  inter.pop("level0_launches"), rk.ray_level0, bound)
    for row in rows[:len(KERNELS)]:
        name = row["name"]
        row["launches_interactive_per_frame"] = {
            h: v[KERNELS.index(name)]
            for h, v in inter["launches_per_frame"].items()}
        # every launch of one interactive frame (RGB + feature render)
        row["interactive_frame_launches"] = inter_launches[name]
        row["interactive_loss_ms"] = {
            h: sum(t["ms"] - t["bound_ms"] for t in ts)
            for h, ts in inter_launches[name].items()}
    torch.cuda.empty_cache()
    hgrid = hashgrid_phases(torch, np, dev, card, cuda_ms)
    rows += hgrid.pop("rows")
    torch.cuda.empty_cache()
    grids = grid_phases(torch, np, dev, card, compare, launch_times, kern_fn,
                        planted, logs.get("fused_mlp_t", ""))
    rows += grids.pop("rows")
    torch.cuda.empty_cache()
    with contextlib.redirect_stdout(sys.stderr):  # the Trainer's log lines
        train = train_phases(torch, np, dev, card, compare, launch_times,
                             kern_fn)
    for row in rows[:len(KERNELS)]:
        row["train_eval_f32_launches"] = train["eval_launches"][row["name"]]
        if row["name"] in faithful["held"]:
            # the float32 launches' largest max |d| / (1 + |ref|) held at
            # F32_FAITHFUL (T2, grid twins and probes), and the asset's
            # against the float64 plain version: the kernel's, cuBLAS's
            e_k, e_p = faithful["f64"].get(row["name"], (None, None))
            row["f32_faithful"] = {
                "tol": F32_FAITHFUL,
                "held_max_err_ratio": faithful["held"][row["name"]],
                "f64_mult": F32_F64_MULT,
                "asset_f64_err": e_k, "asset_cublas_f64_err": e_p}
    del train["eval_launches"]
    rows += train.pop("rows")
    hstep = train["hashgrid_step"]
    for row in rows:
        # gather_rows left the hash-grid frames: its launches are now those
        # of T3's step with the TV term
        if row["name"].startswith("gather_rows["):
            row["launches"] = hstep["tv_step_launches"]["gather_rows"]
        if row["name"] == "hash_grid_forward":
            row["train_step"] = {
                **hstep["forward"], "launches_rec": hstep["forward_launches"],
                "planted_faults": hstep["forward_planted_faults"],
                "steps": hstep["steps"]}
    check(all(r["launches"] > 0 for r in rows
              if r["name"].startswith("gather_rows[")),
          "gather_rows: no launch in T3's TV step")
    torch.cuda.empty_cache()
    branches = branch_phases(torch, np, dev, card, compare, launch_times,
                             kern_fn, model_at, rays_o, rays_d, nets, params,
                             params32, mc, rc, planted,
                             logs.get("fused_mlp_t", ""))
    rows += branches.pop("rows")
    torch.cuda.empty_cache()
    limits = limit_phases(torch, np, dev, card, compare, launch_times,
                          kern_fn, model_at, rays_o, rays_d, nets, params,
                          params32)
    rows += limits.pop("rows")
    rows.append(prop_row(
        grids.pop("prop"),
        next(r for r in rows if r["name"] == "run_tmlp[L1 default (512, 256)]"),
        {n: limits["max_abs_err"][n]["run_tmlp"] for n in limits["seeded_64"]}))
    torch.cuda.empty_cache()
    with contextlib.redirect_stdout(sys.stderr):  # the trainers' log lines
        cli, cli_ctx = cli_phase(torch, np, dev, card)
        torch.cuda.empty_cache()
        apps = apps_phase(torch, np, dev, card, cli_ctx, rays_o, rays_d)
        torch.cuda.empty_cache()
        dpr = dp_phase(torch, np, dev, card, cli_ctx)
    shutil.rmtree(cli_ctx["base"], ignore_errors=True)
    torch.cuda.empty_cache()
    with contextlib.redirect_stdout(sys.stderr):  # the tools' own lines
        tools = tools_phase(torch, np, dev, card)
        torch.cuda.empty_cache()
        probes = probes_phase(torch, np, dev, card)
    e3 = dpr["e3"]
    for row in rows:
        # phase E: each kernel's launches in one sharded frame of each rank
        # (E3; E1 trains on the plain path and launches none)
        name = row["name"]
        row["dp_launches"] = {
            **{f"E3 render {h} rank {r}": n.get(name, 0)
               for r, rr in enumerate((e3, e3["follower"]))
               for h, n in rr["dp_render_launches"].items()},
            **{f"E3 interactive {h} rank {r}": n.get(name, 0)
               for r, rr in enumerate((e3, e3["follower"]))
               for h, n in rr["interactive_launches"].items()}}
        # phase F: each kernel's launches in each tool's step
        row["tools_launches"] = {
            step: r["launches"].get(name.split("[")[0], 0)
            for step, r in tools.items()
            if isinstance(r, dict) and "launches" in r}
        # phase G: each kernel's launches in each probe's and
        # two_stage_wall's step
        row["probes_launches"] = {
            step: r["launches"].get(name.split("[")[0], 0)
            for step, r in probes.items()
            if isinstance(r, dict) and "launches" in r}

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({
        "frames": {"size": SIZE, "param_dtype": "bfloat16",
                   "frame_ms": {h: v[0] for h, v in frame_times.items()},
                   "frame_ms_runs": {h: v[1] for h, v in frame_times.items()},
                   "launches_per_frame": per_frame,
                   "fast_vs_plain_f32_max_abs_err": path_err,
                   "psnr_db": psnr,
                   "jax_psnr_db_bf16_cpu": jax_psnr,
                   "card": card}}), flush=True)
    print(json.dumps({"interactive": inter}), flush=True)
    print(json.dumps({"hashgrid": hgrid}), flush=True)
    print(json.dumps({"grids": grids}), flush=True)
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"branches": branches}), flush=True)
    print(json.dumps({"limits": limits}), flush=True)
    print(json.dumps({"cli": cli}), flush=True)
    for line in cli["summary"]:
        print(f"{line} ({card})", flush=True)
    print(json.dumps({"apps": apps}), flush=True)
    for line in apps["summary"]:
        print(f"{line} ({card})", flush=True)
    print(json.dumps({"dp": dpr}), flush=True)
    for line in dpr["summary"]:
        print(f"{line} ({card})", flush=True)
    print(json.dumps({"tools": tools}), flush=True)
    for line in tools["summary"]:
        print(f"{line} ({card})", flush=True)
    print(json.dumps({"probes": probes}), flush=True)
    for line in probes["summary"]:
        print(f"{line} ({card})", flush=True)
    print(json.dumps({"wall_s": time.time() - t_wall}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def prop_row(prop, l1, limit_errs):
    """The kernel row of prop_kernel, run_tmlp's route for the bf16
    proposal nets past small_kernel: its launches, errors and times at the
    grid student's 512^2 RGB frames (phase 14's record `prop`) and at
    ModelConfig()'s (512, 256) 64^2 frame (`l1`, that launch's row of the
    L phases; `limit_errs`, the L phases' bf16 proposal launches' errors),
    beside the times of the same launches on tmlp_kernel, these nets' route
    before prop_kernel, taken in this run (launch_times: tmlp_kernel_ms),
    and the planted fault that failed the hold."""
    keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
            "tmlp_kernel_ms")
    by_shape = {k: [{kk: t[kk] for kk in keys} for t in v]
                for k, v in prop["launch_times"].items()}
    by_shape["L1 default (512, 256)"] = [
        {kk: l1["launch_times"][0][kk] for kk in keys}]
    first = by_shape["grid_student 32,16"][0]
    errs = dict(prop["max_abs_err_by_frame"], **limit_errs)
    return {"name": "run_tmlp[prop_kernel]", "route": "cuda",
            "source": SOURCES["run_tmlp"][0],
            "replaces": SOURCES["run_tmlp"][1], "kernel": "prop_kernel",
            "launches": sum(n for v in prop["launches_per_frame"].values()
                            for n in v.values()),
            "launches_of": "the proposal launches of the 512^2 RGB frames of "
                           "grid_student, cp_ladder and vm_ladder at (32, 16) "
                           "and (128, 64, 32) (phase 14)",
            "launches_per_frame": prop["launches_per_frame"]["grid_student"],
            "max_abs_err": max(errs.values()), "max_abs_err_by_frame": errs,
            "tol": GRID_TOL, "tol_kind": "elementwise",
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": None,
            "library": "none: no single PyTorch call computes this function",
            "shapes_of": "grid_student's 32,16 RGB frame, its proposal launch",
            "by_shape": by_shape,
            "earlier_ms": {k: [t["tmlp_kernel_ms"] for t in v]
                           for k, v in by_shape.items()},
            "earlier": "the same launches on tmlp_kernel, these nets' route "
                       "before prop_kernel, timed in this run as ms is",
            "planted_fault": prop["planted_fault"]}


def level0_served(row, launches, kern, bound):
    """ray_level0's times at each launch shape of one interactive frame per
    hierarchy (the 512^2 RGB render's and the 1,024-ray feature render's) as
    median / 10th / 90th percentile of PROBE_REPS interleaved launches
    queued behind a backlog, into its kernel row; "ms" becomes the median
    at the (32, 16) RGB launch."""
    served = []
    a0, k0 = next(iter(launches.values()))[0]
    interleaved_ms([lambda: kern(*a0, **k0)])  # warm-up, not kept
    for h, ls in launches.items():
        for a, k in ls:
            key = shape_key(a, k)
            same = [s for s in served if s["shape"] == key]
            if same:
                same[0]["launches_per_frame"][h] = (
                    same[0]["launches_per_frame"].get(h, 0) + 1)
                continue
            t, = interleaved_ms([lambda: kern(*a, **k)])
            served.append({"shape": key, "N": int(a[0].shape[0]), "T": a[1],
                           "launches_per_frame": {h: 1}, "ms": t[0],
                           "ms_p10_p90": list(t[1:]),
                           "bound_ms": bound("ray_level0", a, k)[0]})
    first = next(s for s in served if s["N"] == SIZE * SIZE and s["T"] == 32)
    row.update({"ms": first["ms"], "ms_p10_p90": first["ms_p10_p90"],
                "timed_as": f"median of {PROBE_REPS} interleaved launches "
                            f"queued behind a backlog",
                "served_launches": served})


def interactive_phases(torch, np, dev, card, fields, renderer, rk, fm,
                       compare, hold, cuda_ms, bound, bound_parts, bound_of,
                       model_at, rays_o, rays_d, nets, params, to_f32,
                       kern_fn, launch_times):
    """Phases 5-8: the interactive frame, the render options, mask mIoU and
    frame times. -> the {"interactive": ...} record, with the kernel rows of
    flatten3_nt and the packed epilogue under "rows" and the times of every
    main-path kernel launch of one interactive frame under
    "launch_times"."""
    import dataclasses

    from sanerf_tpu_torch.apps import frame_pipeline as fp
    from sanerf_tpu_torch.apps.interactive import InteractiveSession
    from sanerf_tpu_torch.data.synthetic import SyntheticSphereDataset
    from sanerf_tpu_torch.models.asset import load_asset, load_mask_asset
    from sanerf_tpu_torch.models.sam import predictor as sam_mod
    from sanerf_tpu_torch.train.metrics import MeanIoUMeter

    asset = os.path.join(ROOT, "assets", "serving_student")
    pose = np.asarray(SERVE_POSE, np.float32)
    counters = [rk.ray_level0, rk.ray_level, fm.run_tmlp,
                fm.run_tmlp_composite, rk.flatten3_nt]
    packed_counters = [rk.ray_level0, rk.ray_level, fm.run_tmlp_composite]

    def zero():
        for c in counters:
            c.launches = 0
        for c in packed_counters:
            c.packed_launches = 0

    # -- 5. the interactive frame ------------------------------------------
    mcs, rcs, ps32 = load_asset(asset, device=dev, with_sam=True, seed=0)
    ps = fields.cast_params(ps32, torch.bfloat16)
    sam_cfg = sam_mod.SamConfig()
    sam_params = fields.cast_params(sam_mod.init_params(
        sam_cfg, torch.Generator().manual_seed(1), dev))

    def session(steps, **rc_kw):
        model = fields.make_model(mcs, dataclasses.replace(
            rcs, num_steps=steps, max_ray_batch=SIZE * SIZE, **rc_kw))
        return InteractiveSession(
            None, model, ps, sam_mod.SamPredictor(sam_cfg, sam_params,
                                                  device=dev),
            H=SIZE, W=SIZE, device=dev)

    def warm(s):
        """bench.py:_drive: a frame, one point at the origin, a frame."""
        s.step(pose)
        if not s.points_3d:
            s.points_3d.append(np.zeros(3, np.float32))
        s.step(pose)

    def counted_frame(s):
        """One sync frame with the counters set to 0 just before; -> (the
        frame, launches per counter, packed launches, samvit, mask
        logits)."""
        got = {}
        dfused, dec = fp.decode_fused, sam_mod.decode

        def spy_fused(cfg, p, feats, *a, **k):
            got.setdefault("samvit", feats)
            return dfused(cfg, p, feats, *a, **k)

        def spy_dec(*a, **k):
            out = dec(*a, **k)
            got.setdefault("logits", out[0])
            return out

        fp.decode_fused, sam_mod.decode = spy_fused, spy_dec
        try:
            torch.cuda.synchronize()
            zero()
            r = s.step(pose, pipelined=False)
            torch.cuda.synchronize()
        finally:
            fp.decode_fused, sam_mod.decode = dfused, dec
        return (r, [c.launches for c in counters],
                [c.packed_launches for c in packed_counters],
                got.get("samvit"), got.get("logits"))

    sessions = {h: session(st) for h, st in HIERARCHIES.items()}
    per_frame, frames = {}, {}
    for h, s in sessions.items():
        warm(s)
        r, n, _, samvit, logits = counted_frame(s)
        per_frame[h], frames[h] = n, r
        check(n == INTERACTIVE_LAUNCHES[h],
              f"{h}: interactive frame launches {n}, expected "
              f"{INTERACTIVE_LAUNCHES[h]} (ray_level0, ray_level, run_tmlp, "
              f"run_tmlp_composite, flatten3_nt)")
        check(r.rgb_u8.shape == (SIZE, SIZE, 3), f"{h}: frame shape")
        check(bool(torch.isfinite(r.depth).all()), f"{h}: depth not finite")
        check(samvit is not None
              and tuple(samvit.shape) == (s.h, s.w, mcs.sam_feat_dim),
              f"{h}: samvit {None if samvit is None else samvit.shape}")
        check(bool(torch.isfinite(samvit).all()), f"{h}: samvit not finite")
        check(logits is not None and bool(torch.isfinite(logits).all()),
              f"{h}: mask logits not finite")
        check(r.mask is not None and tuple(r.mask.shape) == (SIZE, SIZE),
              f"{h}: mask missing or misshapen")
        check(len(s.points_3d) == 1, f"{h}: the click memory")
    log(f"interactive launches per frame {per_frame}")
    # every launch of one interactive frame (RGB and feature render) held
    # against its plain version, with the bf16 weights and their float32
    # twins, and each distinct shape timed
    icalls = {}
    for h, s in sessions.items():
        with spying(renderer, fields, kern_fn, icalls, h):
            torch.cuda.synchronize()
            s.step(pose, pipelined=False)
            torch.cuda.synchronize()
    # the packed weights depend on the params only, not on the hierarchy
    n32 = fields.KernelNets(sessions["32,16"].model, ps32)
    twins = [*n32.props, n32.field, n32.view]

    def weights(v):
        return [v.w1, *v.rest] if isinstance(v, fm.ViewMLP) else v.ws

    def twin(v):
        """v's float32 twin: the net of n32 whose weights, rounded to
        bf16, are v's."""
        if not isinstance(v, (fm.TransposedFieldMLP, fm.ViewMLP)):
            return v
        for c in twins:
            if (type(c) is type(v) and len(weights(c)) == len(weights(v))
                    and all(a.shape == b.shape
                            and torch.equal(a, b.to(a.dtype))
                            for a, b in zip(weights(v), weights(c)))):
                return c
        fail("interactive frame: a kernel net with no float32 twin")

    def f32(a, k):
        return (tuple(twin(v) for v in a),
                {kk: twin(v) for kk, v in k.items()})

    launch_t = {n: {} for n in KERNELS}
    for (h, name), ls in icalls.items():
        for a, k in ls:
            hold(name, f"interactive {h}", a, k, f32)
        launch_t[name][h] = launch_times(name, ls, plain=False)
    log(f"interactive frames' launches against plain: "
        f"{sum(map(len, icalls.values()))} held")
    # ray_level0's launches of one interactive frame (RGB, feature render)
    level0 = {h: icalls[(h, "ray_level0")] for h in HIERARCHIES}
    del icalls
    torch.cuda.empty_cache()

    # -- 6. the render options -----------------------------------------------
    seen = {}

    def spy(mod, name, fn, key, when):
        def wrapped(*a, **k):
            if when(a, k):
                seen.setdefault(key, (a, k))
            return fn(*a, **k)
        setattr(mod, name, wrapped)

    flat_launches = {}
    for h, st in HIERARCHIES.items():
        s = session(st, flatten_kernel=True)
        warm(s)
        spy(renderer, "flatten3_nt", rk.flatten3_nt, (h, "flatten3_nt"),
            lambda a, k: True)
        try:
            r, n, _, _, _ = counted_frame(s)
        finally:
            renderer.flatten3_nt = rk.flatten3_nt
        flat_launches[h] = n[4]
        check(n[4] == FLATTEN_LAUNCHES[h],
              f"{h}: flatten3_nt launches {n[4]}, expected "
              f"{FLATTEN_LAUNCHES[h]}")
        check(np.array_equal(r.rgb_u8, frames[h].rgb_u8)
              and torch.equal(r.depth, frames[h].depth),
              f"{h}: the flatten_kernel frame differs from the default")
        del s
    packed_launches, packed_err = {}, {}
    for h, st in HIERARCHIES.items():
        ref = renderer.render_frame(model_at(st), params, rays_o, rays_d,
                                    chunk=SIZE * SIZE, nets=nets)
        spy(renderer, "ray_level", rk.ray_level, (h, "packed/ray_level"),
            lambda a, k: k.get("pack_q", 0) > 0)
        spy(fields, "run_tmlp_composite", fm.run_tmlp_composite,
            (h, "packed/run_tmlp_composite"),
            lambda a, k: k.get("pack_q", 1) > 1)
        try:
            torch.cuda.synchronize()
            zero()
            got = renderer.render_frame(
                model_at(st, packed_epilogue=True), params, rays_o, rays_d,
                chunk=SIZE * SIZE, nets=nets)
            torch.cuda.synchronize()
            packed_launches[h] = [c.packed_launches for c in packed_counters]
        finally:
            renderer.ray_level = rk.ray_level
            fields.run_tmlp_composite = fm.run_tmlp_composite
        check(packed_launches[h] == [0, 1, 1],
              f"{h}: packed launches {packed_launches[h]} (ray_level0, "
              f"ray_level, run_tmlp_composite), expected [0, 1, 1]")
        packed_err[h] = {}
        for k in ("image", "depth", "weights_sum"):
            d = (got[k] - ref[k]).abs()
            packed_err[h][k] = float(d.max())
            check(bool((d <= PACKED_TOL + PACKED_TOL * ref[k].abs()).all()),
                  f"{h}: packed epilogue {k} off the default by "
                  f"{float(d.max()):.3g}")
        del got, ref
    log(f"flatten launches {flat_launches}, packed launches "
        f"{packed_launches}, packed vs default {packed_err}")

    # kernels against their plain versions at those frames' shapes ...
    errs = {"flatten3_nt": 0.0, "packed_epilogue": 0.0}
    for (h, key), (a, k) in seen.items():
        name = key.split("/")[-1]
        if name == "flatten3_nt":
            errs[name] = max(errs[name],
                             compare(name, a, k, 0.0, flips=False)[0])
            continue
        tol = RAY_TOL if name == "ray_level" else MLP_TOL
        e, _ = compare(name, a, k, tol, flips=name != "ray_level")
        errs["packed_epilogue"] = max(errs["packed_epilogue"], e)
        if name == "ray_level":
            out = rk.ray_level(*a, **k)
            torch.cuda.synchronize()
            check(torch.equal(out[4].reshape(out[1].shape), out[1])
                  and torch.equal(out[5].reshape(out[2].shape), out[2]),
                  f"{h}: packed ts/dl rows are not the flat ts/dl")
            del out
        else:
            compare(name, *to_f32(a, k), MLP_F32_TOL[name], flips=False)
    # ... and at ragged ones (N = 1000: not a multiple of the warps' rays)
    g = torch.Generator(device=dev).manual_seed(7)
    r8 = seen[("32,16", "packed/ray_level")][0][0][:1000].contiguous()
    for N_, T_ in ((997, 7), (1000, 16)):
        x3 = torch.randn(3, N_, T_, generator=g, device=dev)
        compare("flatten3_nt", (x3,), {}, 0.0, flips=False)
    w0 = torch.rand(1000, 32, generator=g, device=dev)
    b0 = rk.ray_level0(r8, 32, True)[0]
    for q in (8, 4):
        e0, _ = compare("ray_level0", (r8, 16, True), {"pack_q": q}, RAY_TOL,
                        flips=False)
        e1, _ = compare("ray_level", (r8, w0, b0, 16, True), {"pack_q": q},
                        RAY_TOL, flips=False)
        o0 = rk.ray_level0(r8, 16, True, pack_q=q)
        check(torch.equal(o0[4].reshape(1000, 16), o0[1])
              and torch.equal(o0[5].reshape(1000, 16), o0[2]),
              "ragged: packed ray_level0 rows are not the flat ts/dl")
        T_ = 128 // q
        xT = torch.rand(3, 1000 * T_, generator=g, device=dev) * 4 - 2
        dl = torch.rand(1000, T_, generator=g, device=dev) * 0.1
        ts = torch.cumsum(dl, 1) + 0.5
        pk = lambda v: v.reshape(1000 // q, q * T_, 1)  # noqa: E731
        kw = {"opaque": True, "view": nets.view, "rays8": r8, "pack_q": q,
              "T": T_}
        e2, _ = compare("run_tmlp_composite", (xT, pk(dl), pk(ts),
                                               nets.field), kw, MLP_TOL,
                        flips=True)
        flat = fm.run_tmlp_composite(xT, dl, ts, nets.field, opaque=True,
                                     view=nets.view, rays8=r8)
        pkd = fm.run_tmlp_composite(xT, pk(dl), pk(ts), nets.field, **kw)
        torch.cuda.synchronize()
        for x, y in zip(pkd, flat):
            check(bool(((x - y).abs() <= PACKED_TOL
                        + PACKED_TOL * y.abs()).all()),
                  "ragged: packed composite off the unpacked one")
        errs["packed_epilogue"] = max(errs["packed_epilogue"], e0, e1, e2)
        del o0, flat, pkd
    log(f"flatten / packed kernels vs plain: {errs}")

    # -- 7. mask mIoU ----------------------------------------------------------
    mcm, rcm, pm32 = load_mask_asset(asset, device=dev)
    pm = fields.cast_params(pm32, torch.bfloat16)
    mmodel = fields.make_model(mcm, dataclasses.replace(
        rcm, num_steps=(32, 16), max_ray_batch=128 * 128))
    check(renderer.uses_kernels(mmodel), "mIoU: the fast path is off")
    ds = SyntheticSphereDataset(H=128, W=128, n_views=8, radius=1.8,
                                scene="textured", training=False)
    meter = MeanIoUMeter()
    for idx in range(len(ds)):
        fr = ds.frame(idx)
        out = renderer.render_staged(
            mmodel, pm, torch.as_tensor(fr["rays_o"], device=dev),
            torch.as_tensor(fr["rays_d"], device=dev), return_mask=True,
            cam_near_far=torch.as_tensor(fr["cam_near_far"], device=dev))
        logits = out["instance_mask_logits"]
        check(bool(torch.isfinite(logits).all()), f"mIoU frame {idx}")
        meter.update(logits.argmax(-1).cpu().numpy(), fr["masks"])
    miou = meter.measure()
    check(abs(miou - JAX_MIOU_32_16_BF16) <= MIOU_TOL,
          f"mask mIoU {miou:.4f} vs JAX {JAX_MIOU_32_16_BF16:.4f}")
    log(f"mask mIoU {miou}")

    # -- 8. frame times (bench.py:_drive) --------------------------------------
    def drive(s, n, sync):
        ts_ = []
        for _ in range(n):
            t = time.perf_counter()
            s.step(pose, pipelined=not sync)
            ts_.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts_), ts_

    times = {}
    for h, s in sessions.items():
        drive(s, 3, False)  # refill the pipeline
        pipelined = drive(s, 7, False)
        sync = drive(s, 5, True)
        times[h] = {"pipelined_ms": pipelined[0], "sync_ms": sync[0],
                    "pipelined_runs": pipelined[1], "sync_runs": sync[1]}
    log(f"interactive frame times {times}")

    # -- kernel rows of this slice -------------------------------------------
    a, k = seen[("32,16", "flatten3_nt")]
    x3 = a[0]
    fl_b = bound("flatten3_nt", a, k)
    fl_k, fl_lib = interleaved_ms([lambda: rk.flatten3_nt(x3),
                                   lambda: x3.reshape(3, -1).clone()])
    rows = [{
        "name": "flatten3_nt", "route": "cuda",
        "source": SOURCES["flatten3_nt"][0],
        "replaces": SOURCES["flatten3_nt"][1],
        "launches": sum(flat_launches.values()),
        "launches_per_frame": flat_launches,
        "max_abs_err": errs["flatten3_nt"], "tol": 0.0,
        "tol_kind": "bit for bit",
        "ms": fl_k[0], "ms_p10_p90": fl_k[1:],
        "plain_ms": cuda_ms(lambda: rk.flatten3_nt_plain(x3), reps=20),
        "bound_ms": fl_b[0], "bound_by": fl_b[1],
        "library_ms": fl_lib[0], "library_ms_p10_p90": fl_lib[1:],
        "median_at_or_below_library": fl_k[0] <= fl_lib[0],
        "p90_below_library_p10": fl_k[2] < fl_lib[1],
        "timed_as": f"median of {PROBE_REPS} interleaved launches queued "
                    f"behind a backlog",
        "shapes_of": "32,16 interactive frame, first launch",
        "shape": list(x3.shape)}]
    pk_ms = pk_plain = 0.0
    pk_parts = []
    for key, name, fn, plain in (
            ("packed/ray_level", "ray_level", rk.ray_level,
             rk.ray_level_plain),
            ("packed/run_tmlp_composite", "run_tmlp_composite",
             fm.run_tmlp_composite, fm.run_tmlp_composite_plain)):
        a, k = seen[("32,16", key)]
        pk_ms += cuda_ms(lambda: fn(*a, **k), reps=10)
        pk_plain += cuda_ms(lambda: plain(*a, **k), reps=10)
        pk_parts.append(bound_parts(name, a, k))
        torch.cuda.empty_cache()
    rows.append({
        "name": "packed_epilogue", "route": "cuda",
        "source": SOURCES["packed_epilogue"][0],
        "also_source": "sanerf_tpu_torch/csrc/ray_kernels.cu",
        "replaces": SOURCES["packed_epilogue"][1],
        "also_replaces": "sanerf_tpu/ops/ray_kernels.py:131",
        "launches": sum(sum(v) for v in packed_launches.values()),
        "launches_per_frame": packed_launches,
        "launches_of": "ray_level0, ray_level, run_tmlp_composite with "
                       "pack_q",
        "max_abs_err": errs["packed_epilogue"], "tol": MLP_TOL,
        "tol_kind": "as ray_level (1e-5) and run_tmlp_composite (bf16); "
                    f"frame within {PACKED_TOL} of the default",
        "ms": pk_ms, "plain_ms": pk_plain,
        "bound_ms": bound_of(pk_parts)[0], "bound_by": bound_of(pk_parts)[1],
        "library_ms": None,
        "library": "none: no single PyTorch call computes this function",
        "shapes_of": "32,16 RGB frame: packed ray_level + packed composite",
        "frame_max_abs_err_vs_default": packed_err})
    return {"size": SIZE, "param_dtype": "bfloat16",
            "sam": "SamConfig() decoder, seeded random bf16 weights",
            "frame_ms": times, "launches_per_frame": per_frame,
            "flatten_launches_per_frame": flat_launches,
            "packed_launches_per_frame": packed_launches,
            "packed_vs_default_max_abs_err": packed_err,
            "mask_miou": miou, "jax_mask_miou_bf16_cpu": JAX_MIOU_32_16_BF16,
            "card": card, "rows": rows, "launch_times": launch_t,
            "level0_launches": level0}


def hashgrid_phases(torch, np, dev, card, cuda_ms):
    """Phases 9-13: the gather kernel at the probe shapes, and the
    hash-grid family's interactive frame, path check, JAX reference and
    mask frame. -> the {"hashgrid": ...} record, with the gather's kernel
    rows under "rows"."""
    import dataclasses

    from sanerf_tpu_torch.apps import frame_pipeline as fp
    from sanerf_tpu_torch.apps.interactive import InteractiveSession
    from sanerf_tpu_torch.config import ModelConfig, RenderConfig
    from sanerf_tpu_torch.models import fields, renderer
    from sanerf_tpu_torch.models.asset import expected_shapes, params_from_jax
    from sanerf_tpu_torch.models.sam import predictor as sam_mod
    from sanerf_tpu_torch.ops import gather as ga
    from sanerf_tpu_torch.ops import hashgrid as hg

    sys.path.insert(0, os.path.join(ROOT, "port_tools"))
    import hashgrid_params as hp

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16
                      else torch.int32)

    def same_bits(a, b):
        return a.shape == b.shape and a.dtype == b.dtype \
            and torch.equal(bits(a), bits(b))

    gather_err = [0.0]  # the largest kernel-vs-plain difference seen

    def held(got, ref):
        """Bit equality of kernel and plain outputs; records their
        largest absolute difference."""
        if got.shape == ref.shape:
            gather_err[0] = max(gather_err[0], float(
                (got.float() - ref.float()).abs().max()) if got.numel()
                else 0.0)
        return same_bits(got, ref)

    def gather_bytes(table, idx, block_rows):
        """idx read once, the table read once, each output row written
        once."""
        row = block_rows * table.shape[1] * table.element_size()
        return (idx.numel() * 4 + table.numel() * table.element_size()
                + idx.numel() * row)

    # -- 9. the probe shapes --------------------------------------------------
    g = torch.Generator(device=dev).manual_seed(0)
    idx = torch.randint(0, PROBE_ROWS, (PROBE_IDX,), generator=g, device=dev,
                        dtype=torch.int32)
    base = {C: torch.randn(PROBE_ROWS, C, generator=g, device=dev)
            for C in (2, 128)}
    probe_idx = {
        "blocks": idx.reshape(64, PROBE_IDX // 64),
        "flat": idx,
        "mod4096": (idx % 4096).reshape(64, PROBE_IDX // 64),
        "div8": (idx[:PROBE_IDX // 8] // 8).contiguous(),
    }
    probes = {}
    for name, line, C, rows_used, form, br in PROBES:
        i = probe_idx[form]
        rec = {"replaces": f"tools/probe_gather.py:{line}",
               "shape": {"table": [rows_used or PROBE_ROWS, C],
                         "idx": list(i.shape), "block_rows": br}}
        for dt in (torch.float32, torch.bfloat16):
            t = base[C].to(dt)
            if rows_used:
                t = t[:rows_used]
            got = ga.gather_rows(t, i, br)
            ref = ga.gather_rows_plain(t, i, br)
            torch.cuda.synchronize()
            check(held(got, ref),
                  f"gather {name} {dt}: kernel differs from its plain version")
            del got, ref
            tv = t.reshape(t.shape[0] // br, br * C)
            flat_i = i.reshape(-1)
            key = "f32" if dt == torch.float32 else "bf16"
            pair = [lambda: ga.gather_rows(t, i, br),
                    lambda: torch.index_select(tv, 0, flat_i)]
            kern, lib = interleaved_ms(pair)
            kern_u, lib_u = interleaved_ms(pair, queued=False)
            rec[key] = {
                "ms": kern[0], "ms_p10_p90": kern[1:],
                "plain_ms": cuda_ms(lambda: ga.gather_rows_plain(t, i, br),
                                    reps=5),
                "library_ms": lib[0], "library_ms_p10_p90": lib[1:],
                "timed_as": f"median of {PROBE_REPS} interleaved launches "
                            f"queued behind a backlog (the card's time)",
                "unqueued": {"ms": kern_u, "library_ms": lib_u,
                             "timed_as": "the same on an idle card: each "
                                         "time includes the host's work "
                                         "before its kernel starts"},
                "bound_ms": gather_bytes(t, i, br) / HBM_BPS * 1e3}
            torch.cuda.empty_cache()
        probes[name] = rec
    # p2_take's fill: indices outside the table give rows of zeros
    fill = idx.clone()
    fill[::16] = -1
    fill[8::16] = PROBE_ROWS + 5
    for dt in (torch.float32, torch.bfloat16):
        t = base[2].to(dt)
        got = ga.gather_rows(t, fill)
        torch.cuda.synchronize()
        check(held(got, ga.gather_rows_plain(t, fill))
              and not got[::8].any(),
              f"gather fill {dt}: out-of-range rows are not zeros")
    del base, probe_idx, idx, fill, got
    torch.cuda.empty_cache()
    log(f"gather probes: {probes}")

    # -- 10. the hash-grid interactive frame -----------------------------------
    mc = ModelConfig(field_type="hashgrid", with_sam=True)
    model = fields.make_model(mc, RenderConfig())
    gen = torch.Generator().manual_seed(0)
    p32 = fields.init_params(model, gen, dev)
    # tables redrawn so that densities and features vary across the frame
    p32["grid"] = hg.init_params(gen, model.grid_spec, hp.TABLE_STD, dev)
    p32["s_grid"] = hg.init_params(gen, model.s_grid_spec, hp.TABLE_STD, dev)
    for p, spec in zip(p32["prop"], model.prop_specs):
        p["grid"] = hg.init_params(gen, spec, hp.TABLE_STD, dev)
    params = fields.cast_params(p32, torch.bfloat16)
    check(not renderer.uses_kernels(model), "hash-grid: took the MLP path")
    sam_cfg = sam_mod.SamConfig()
    sam_params = fields.cast_params(sam_mod.init_params(
        sam_cfg, torch.Generator().manual_seed(1), dev))
    sess = InteractiveSession(None, model, params,
                              sam_mod.SamPredictor(sam_cfg, sam_params,
                                                   device=dev),
                              H=SIZE, W=SIZE, device=dev)
    pose = np.asarray(SERVE_POSE, np.float32)
    sess.step(pose)
    sess.points_3d.append(np.zeros(3, np.float32))
    sess.step(pose)
    check(sess._pipe(SIZE, SIZE)._kernel_nets() is None,
          "hash-grid: the frame packed MLP kernel weights")

    got = {}
    real_gather, real_takes = hg.gather_rows, hg.forward_takes
    dfused, dec = fp.decode_fused, sam_mod.decode
    fwd_n, gat_n = hg._HASH_GRID_FORWARD, ga._GATHER_ROWS
    grid_of = {id(model.grid_spec): "grid", id(model.s_grid_spec): "s_grid",
               **{id(sp): f"prop{i}" for i, sp in
                  enumerate(model.prop_specs)}}

    def spy_fused(cfg, p, feats, *a, **k):
        got.setdefault("samvit", feats)
        return dfused(cfg, p, feats, *a, **k)

    def spy_dec(*a, **k):
        out = dec(*a, **k)
        got.setdefault("logits", out[0])
        return out

    fp.decode_fused, sam_mod.decode = spy_fused, spy_dec
    try:
        torch.cuda.synchronize()
        fwd_n.launches = gat_n.launches = 0
        r, calls = record_forward(hg, lambda: sess.step(pose,
                                                        pipelined=False))
        torch.cuda.synchronize()
        launches, gathers = fwd_n.launches, gat_n.launches
    finally:
        fp.decode_fused, sam_mod.decode = dfused, dec
    check(launches == len(calls) == HASHGRID_LAUNCHES and gathers == 0,
          f"hash-grid frame: {launches} hash_grid_forward launches "
          f"({len(calls)} recorded), {gathers} gathers; expected "
          f"{HASHGRID_LAUNCHES} and 0")
    names = [grid_of.get(id(c[2]), "?") for c in calls]
    check(sorted(names) == sorted(["prop0", "prop1", "grid"] * 2
                                  + ["s_grid"]),
          f"hash-grid frame: launches of {names}")
    check(r.rgb_u8.shape == (SIZE, SIZE, 3), "hash-grid frame shape")
    check(bool(torch.isfinite(r.depth).all()), "hash-grid depth not finite")
    sv = got.get("samvit")
    check(sv is not None and tuple(sv.shape) == (sess.h, sess.w,
                                                 mc.sam_feat_dim)
          and bool(torch.isfinite(sv).all()), "hash-grid samvit")
    check(got.get("logits") is not None
          and bool(torch.isfinite(got["logits"]).all()),
          "hash-grid mask logits not finite")
    check(r.mask is not None and tuple(r.mask.shape) == (SIZE, SIZE),
          "hash-grid mask missing")
    del r, got
    # every launch of that frame against its plain version, timed beside it
    # and the parent's route; the RGB render's (its launches of SIZE^2
    # rays' samples) summed apart
    fr, per_launch = hold_forward(hg, ga, calls, HASHGRID_REPS)
    for rec, name in zip(per_launch, names):
        rec["grid"] = name
        rec["render"] = "rgb" if rec["points"] >= SIZE * SIZE else "feature"
    rgb_encode = {k: sum(rec[k][0] for rec in per_launch
                         if rec["render"] == "rgb")
                  for k in ("ms", "plain_ms", "parent_route_ms")}
    rgb_encode["bound_ms"] = sum(rec["bound_ms"] for rec in per_launch
                                 if rec["render"] == "rgb")
    firsts = {}
    for c, name in zip(calls, names):
        firsts.setdefault(name, c)
    faults = forward_faults(hg, ga, list(firsts.values()), list(firsts))
    del calls
    torch.cuda.empty_cache()
    log(f"hash-grid frame: {launches} hash_grid_forward launches, {fr}, "
        f"{per_launch}, RGB encode {rgb_encode}, faults {faults}")

    def drive(n, sync):
        ts_ = []
        for _ in range(n):
            t = time.perf_counter()
            sess.step(pose, pipelined=not sync)
            ts_.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts_), ts_

    def parent_route(fn):
        """fn() on the parent's route: the level route on the gather_rows
        kernel."""
        hg.forward_takes = lambda spec, n: False
        try:
            return fn()
        finally:
            hg.forward_takes = real_takes

    rays_o, rays_d = (torch.from_numpy(a).to(dev)
                      for a in hp.frame_rays(SIZE))

    def rgb_render():
        torch.cuda.synchronize()
        t = time.perf_counter()
        renderer.run_rays(model, params, rays_o, rays_d)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    drive(2, False)
    parent_route(lambda: drive(1, False))
    times = {}
    # this tree's route and the parent's in turns: change, parent, parent,
    # change
    for route in ("change", "parent", "parent", "change"):
        def run():
            return (drive(5, False), drive(3, True),
                    [rgb_render() for _ in range(3)])
        pl, sy, rgb = run() if route == "change" else parent_route(run)
        t = times.setdefault(route, {"pipelined_runs": [], "sync_runs": [],
                                     "rgb_render_runs": []})
        t["pipelined_runs"] += pl[1]
        t["sync_runs"] += sy[1]
        t["rgb_render_runs"] += rgb
    for t in times.values():
        for k in ("pipelined", "sync", "rgb_render"):
            t[k + "_ms"] = statistics.median(t[k + "_runs"])
    times.update({k + "_ms": times["change"][k + "_ms"]
                  for k in ("pipelined", "sync", "rgb_render")})
    del sess
    torch.cuda.empty_cache()
    log(f"hash-grid frame times {times}")

    # -- 11. the kernel frame against the plain route's frame -----------------
    kern = renderer.run_rays(model, p32, rays_o, rays_d)
    hg.gather_rows = ga.gather_rows_plain
    try:
        plain = parent_route(lambda: renderer.run_rays(model, p32, rays_o,
                                                       rays_d))
    finally:
        hg.gather_rows = real_gather
    torch.cuda.synchronize()
    for k in ("image", "depth", "weights_sum"):
        check(torch.equal(kern[k], plain[k]),
              f"hash-grid {k}: the kernel frame differs from the plain "
              f"route's frame by "
              f"{float((kern[k] - plain[k]).abs().max()):.3g}")
    depth_std = float(kern["depth"].std())
    del kern, plain
    torch.cuda.empty_cache()

    # -- 12. against the JAX package ----------------------------------------------
    ref = JAX_HASHGRID
    pj = params_from_jax(hp.make_flat(expected_shapes(model), 0), model, dev)
    o64, d64 = (torch.from_numpy(a).to(dev) for a in hp.frame_rays(64))
    out = renderer.run_rays(model, pj, o64, d64, return_feats=True)
    px = torch.tensor(ref["pixels"], device=dev)
    vals = {"mean": {k: float(out[k].double().mean()) for k in ref["mean"]},
            "image": out["image"][px], "depth": out["depth"][px],
            "weights_sum": out["weights_sum"][px],
            "samvit": out["samvit"][px][:, ref["channels"]]}
    jax_err = {}
    for k, v in vals.items():
        if k == "mean":
            got_v = np.asarray([v[m] for m in ref["mean"]])
            want = np.asarray([ref["mean"][m] for m in ref["mean"]])
        else:
            got_v, want = v.double().cpu().numpy(), np.asarray(ref[k])
        d = np.abs(got_v - want)
        jax_err[k] = float(d.max())
        check(bool((d <= JAX_HASHGRID_TOL + JAX_HASHGRID_TOL
                    * np.abs(want)).all()),
              f"hash-grid {k} off the JAX values: max {d.max():.3g}")
    del out, pj
    log(f"hash-grid vs JAX: {jax_err}")

    # -- 13. the mask frame ----------------------------------------------------------
    mmodel = fields.make_model(dataclasses.replace(mc, with_mask=True),
                               RenderConfig())
    mgen = torch.Generator().manual_seed(2)
    pm = dict(params)
    pm["m_grid"] = hg.init_params(mgen, mmodel.m_grid_spec, hp.TABLE_STD,
                                  dev).to(torch.bfloat16)
    pm["mask_mlp"] = fields.cast_params([
        fields.init_linear(mgen, a, b, False, dev)
        for a, b in fields.mask_mlp_shapes(mmodel)])
    torch.cuda.synchronize()
    fwd_n.launches = gat_n.launches = 0
    mout, mcalls = record_forward(hg, lambda: renderer.run_rays(
        mmodel, pm, rays_o, rays_d, return_mask=True))
    torch.cuda.synchronize()
    mask_launches, mask_gathers = fwd_n.launches, gat_n.launches
    logits = mout["instance_mask_logits"]
    check(mask_launches == len(mcalls) == MASK_LAUNCHES and mask_gathers == 0,
          f"mask frame: {mask_launches} hash_grid_forward launches, "
          f"{mask_gathers} gathers; expected {MASK_LAUNCHES} and 0")
    check(tuple(logits.shape) == (SIZE * SIZE, mmodel.mask_out_dim())
          and bool(torch.isfinite(logits).all()), "mask frame logits")
    del mout, logits
    mnames = [{id(mmodel.m_grid_spec): "m_grid", id(mmodel.grid_spec): "grid",
               **{id(sp): f"prop{i}" for i, sp in
                  enumerate(mmodel.prop_specs)}}.get(id(c[2]), "?")
              for c in mcalls]
    check(sorted(mnames) == ["grid", "m_grid", "prop0", "prop1"],
          f"mask frame: launches of {mnames}")
    mfr, mper = hold_forward(hg, ga, mcalls, HASHGRID_REPS)
    for rec, name in zip(mper, mnames):
        rec["grid"] = name
    m_i = mnames.index("m_grid")
    faults += forward_faults(hg, ga, [mcalls[m_i]], ["m_grid"])
    del mcalls, pm
    torch.cuda.empty_cache()
    log(f"mask frame: {mfr}, {mper}")

    common = {"route": "cuda", "source": "sanerf_tpu_torch/csrc/gather.cu",
              "launches": 0,
              "launches_of": "gather_rows in T3's hash-grid training step "
                             "with the TV term (set after phase T3); the "
                             "hash-grid frames launch none since "
                             "hash_grid_forward",
              "frame_launches": gathers,
              "max_abs_err": gather_err[0], "tol": 0.0,
              "tol_kind": "bit for bit",
              "bound_by": "bytes"}
    rows = [{"name": f"gather_rows[{name}]", **common,
             "replaces": rec["replaces"], "ms": rec["f32"]["ms"],
             "plain_ms": rec["f32"]["plain_ms"],
             "bound_ms": rec["f32"]["bound_ms"],
             "library_ms": rec["f32"]["library_ms"],
             "library": "torch.index_select", "dtype": "float32",
             "unqueued": rec["f32"]["unqueued"],
             "bf16": rec["bf16"], "shape": rec["shape"]}
            for name, rec in probes.items()]
    rows.append({
        "name": "hash_grid_forward", "route": "cuda",
        "source": "sanerf_tpu_torch/csrc/hashgrid.cu",
        "replaces": "tools/probe_gather.py:90",
        "also_replaces": "the lookups of tools/probe_gather.py:90-247 and "
                         "the encode around them, sanerf_tpu/ops/"
                         "hashgrid.py:170-239 hash_encode_01 (XLA; its "
                         "jnp.take at :229)",
        "launches": launches,
        "launches_of": "hash_grid_forward in one 512^2 hash-grid "
                       "interactive frame at (128, 64, 32)",
        "max_abs_err": max(fr["max_abs_err"], mfr["max_abs_err"]),
        "tol": 0.0, "tol_kind": "bit for bit (torch.equal) against "
                                "hash_grid_forward_plain",
        "ms": fr["ms"], "ms_p10_p90": fr["ms_p10_p90"],
        "plain_ms": fr["plain_ms"], "bound_ms": fr["bound_ms"],
        "bound_by": "bytes",
        "bound_kind": "points read once, features written once, each "
                      "touched table row read once",
        "library_ms": None,
        "library": "none: no single PyTorch call computes the encode",
        "parent_route_ms": fr["parent_route_ms"],
        "parent_route_ms_p10_p90": fr["parent_route_ms_p10_p90"],
        "parent_route": "the level route on the gather_rows kernel "
                        "(one gather a level and the index math in "
                        "PyTorch)",
        "dtype": "bfloat16 tables", "sum_of": f"the {launches} launches of "
                                             f"one frame",
        "timed_as": fr["timed_as"], "rgb_render_encode": rgb_encode,
        "frame_launches": per_launch, "mask_frame": {**mfr,
                                                     "launches": mper},
        "planted_faults": faults})
    return {"size": SIZE, "param_dtype": "bfloat16",
            "model": "ModelConfig(field_type='hashgrid', with_sam=True), "
                     "RenderConfig() (128, 64, 32)",
            "table_std": hp.TABLE_STD, "launches_per_frame": launches,
            "gathers_per_frame": gathers,
            "mask_frame_launches": mask_launches, "frame_ms": times,
            "forward_per_frame": fr, "rgb_render_encode": rgb_encode,
            "planted_faults_caught": len(faults),
            "depth_std_f32": depth_std,
            "vs_jax_max_abs_err": jax_err, "jax_tol": JAX_HASHGRID_TOL,
            "probes": probes, "card": card, "rows": rows}


def grid_phases(torch, np, dev, card, compare, launch_times, kern_fn,
                planted, ptxas_log):
    """Phases 14-18: the factorized-grid configurations of the MLP family.
    -> the {"grids": ...} record, with the kernel rows of the grid branches
    of run_tmlp and run_tmlp_composite (the V_GRID kernels: their plans,
    and their registers and spills from ptxas_log, the nvcc log of
    fused_mlp_t.cu) under "rows" and what the proposal launches on
    prop_kernel showed under "prop" (their route, errors and times;
    PROP_FAULT planted in the kernel, built into `planted`, against the
    same hold; GRID_FAULT, in the same tree, against the hold of
    grid_student's composite)."""
    import dataclasses

    from sanerf_tpu_torch.apps import frame_pipeline as fp
    from sanerf_tpu_torch.apps.interactive import InteractiveSession
    from sanerf_tpu_torch.config import ModelConfig, RenderConfig
    from sanerf_tpu_torch.models import fields, renderer
    from sanerf_tpu_torch.models.asset import expected_shapes, params_from_jax
    from sanerf_tpu_torch.models.sam import predictor as sam_mod
    from sanerf_tpu_torch.ops import fused_mlp_t as fm
    from sanerf_tpu_torch.ops import gather as ga
    from sanerf_tpu_torch.ops import ray_kernels as rk

    sys.path.insert(0, os.path.join(ROOT, "port_tools"))
    import grid_params as gp

    counters = [rk.ray_level0, rk.ray_level, fm.run_tmlp,
                fm.run_tmlp_composite]
    mlps = ("run_tmlp", "run_tmlp_composite")
    pose = np.asarray(SERVE_POSE, np.float32)
    rays_o, rays_d = (torch.from_numpy(a).to(dev)
                      for a in gp.frame_rays(SIZE))

    def model_of(name, steps=(32, 16), **kw):
        return fields.make_model(ModelConfig(**gp.CONFIGS[name], **kw),
                                 RenderConfig(num_steps=steps,
                                              max_ray_batch=SIZE * SIZE))

    def params_of(model):
        """float32 params of grid_params.make_flat, on the card."""
        return params_from_jax(gp.make_flat(expected_shapes(model),
                                            GRID_SEED), model, dev)

    def twins(model, pbf, p32):
        """(bf16 nets, {id of a bf16 net: its float32 twin})."""
        nets = fields.KernelNets(model, pbf)
        n32 = fields.KernelNets(model, p32)
        return nets, {id(a): b for a, b in zip(
            [*nets.props, nets.field, nets.view],
            [*n32.props, n32.field, n32.view])}

    def zero(cs):
        torch.cuda.synchronize()
        for c in cs:
            c.launches = 0
        fm.run_tmlp.prop_launches = 0
        fm.run_tmlp.grid_launches = fm.run_tmlp_composite.grid_launches = 0

    def spied(fn):
        """fn() with every main-path kernel call recorded -> {name: [(args,
        kwargs)]}."""
        calls = {}
        with spying(renderer, fields, kern_fn, calls, None):
            fn()
        torch.cuda.synchronize()
        return {n: v for (_, n), v in calls.items()}

    errs = {n: {} for n in mlps}
    errs32 = {n: {} for n in mlps}
    past = {n: {} for n in mlps}

    def hold(name, key, a, k, twin=None):
        """One launch against its plain version with the bf16 weights at
        GRID_TOL and, with `twin`, with their float32 twins."""
        e, n_past = compare(name, a, k, GRID_TOL, flips=False)
        errs[name][key] = max(errs[name].get(key, 0.0), e)
        past[name][key] = past[name].get(key, 0) + n_past
        if twin is not None:
            e32, _ = compare(name, tuple(twin.get(id(v), v) for v in a),
                             {kk: twin.get(id(v), v) for kk, v in k.items()},
                             MLP_F32_TOL[name], flips=False,
                             faithful_hold=True)
            errs32[name][key] = max(errs32[name].get(key, 0.0), e32)

    probe_err = {}

    def probe(key, field, field32):
        """run_tmlp through the encode probes of a field's tables (bf16 and
        their float32 twins): every encoding column and the sigma sum,
        held element by element at PROBE_POINTS points in and around the
        grids' bounds."""
        g_ = torch.Generator(device=dev).manual_seed(GRID_SEED)
        xp = (torch.rand(3, PROBE_POINTS, generator=g_, device=dev) * 2.2
              - 1.1) * field.bound
        e16 = e32 = 0.0
        for p16, p32 in zip(fm.encode_probes(field),
                            fm.encode_probes(field32)):
            # the bf16 probe on its field's route (V_GRID or not)
            check((fm.kernel_plan(p16).variant == fm.V_GRID)
                  == fm._grid_net(field),
                  f"{key}: an encode probe not on its field's route")
            e16 = max(e16, compare("run_tmlp", (xp, p16), {"transposed": True},
                                   PROBE_TOL, flips=False)[0])
            e32 = max(e32, compare("run_tmlp", (xp, p32), {"transposed": True},
                                   MLP_F32_TOL["run_tmlp"], flips=False,
                                   faithful_hold=True)[0])
        probe_err[key] = {"bf16": e16, "f32": e32,
                          "columns": field.F + field.kc}

    def host_ms(fn, n=3):
        ts_ = []
        for _ in range(n + 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts_.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts_[1:]), ts_[1:]

    def finite(out, what):
        check(out["image"].shape == (rays_o.shape[0], 3), f"{what}: image")
        for k in ("image", "depth", "weights_sum"):
            check(bool(torch.isfinite(out[k]).all()),
                  f"{what}: {k} not finite")

    # -- 14. the served configurations' RGB frames ----------------------------
    per_frame, frame_ms, table_bytes, prop_per_frame = {}, {}, {}, {}
    grid_plans, grid_per_frame = {}, {}
    launch_t = {n: {} for n in mlps}
    for name in GRID_SERVED:
        m0 = model_of(name)
        check(renderer.uses_kernels(m0), f"{name}: not on the fast path")
        table_bytes[name] = m0.grid_table_bytes
        p32 = params_of(m0)
        pbf = fields.cast_params(p32, torch.bfloat16)
        nets, twin = twins(m0, pbf, p32)
        probe(name, nets.field, twin[id(nets.field)])
        per_frame[name], frame_ms[name] = {}, {}
        for h, steps in HIERARCHIES.items():
            model = model_of(name, steps)

            def frame():
                return renderer.render_frame(model, pbf, rays_o, rays_d,
                                             chunk=SIZE * SIZE, nets=nets)
            zero(counters)
            out = frame()
            torch.cuda.synchronize()
            n = [c.launches for c in counters]
            per_frame[name][h] = n
            check(n == GRID_LAUNCHES[h],
                  f"{name} {h}: launches {n}, expected {GRID_LAUNCHES[h]} "
                  f"(ray_level0, ray_level, run_tmlp, run_tmlp_composite)")
            # every run_tmlp launch of the RGB frame is a proposal net's,
            # each on prop_kernel
            prop_per_frame.setdefault(name, {})[h] = fm.run_tmlp.prop_launches
            check(fm.run_tmlp.prop_launches == n[2],
                  f"{name} {h}: {fm.run_tmlp.prop_launches} of {n[2]} "
                  f"proposal launches on prop_kernel")
            # and its composite on the V_GRID kernels where the field
            # takes them (grid_student), else on the route before them
            want = n[3] if fm._grid_net(nets.field) else 0
            grid_per_frame.setdefault(name, {})[h] = \
                fm.run_tmlp_composite.grid_launches
            check(fm.run_tmlp_composite.grid_launches == want,
                  f"{name} {h}: {fm.run_tmlp_composite.grid_launches} "
                  f"composite launches on V_GRID, expected {want} of {n[3]}")
            grid_plans.setdefault(name, {})[h] = {
                kk: v for kk, v in fm.kernel_plan(
                    nets.field, steps[-1], nets.view).as_dict().items()
                if kk in PLAN_KEYS}
            finite(out, f"{name} {h}")
            check(float(out["weights_sum"].min()) > 0.5,
                  f"{name} {h}: weights_sum {float(out['weights_sum'].min())}")
            del out
            calls = spied(frame)
            key = f"{name} {h}"
            for kn in mlps:
                for a, k in calls[kn]:
                    hold(kn, key, a, k, twin)
                launch_t[kn][key] = launch_times(kn, calls[kn])
            if key == "grid_student 32,16":
                prop_launch = calls["run_tmlp"][0]
                comp_launch = calls["run_tmlp_composite"][0]
            del calls
            frame_ms[name][h] = host_ms(frame)
            torch.cuda.empty_cache()
        del nets, twin, p32, pbf
        torch.cuda.empty_cache()
    log(f"grid frames: launches {per_frame}, ms {frame_ms}; vs plain bf16 "
        f"{errs} f32 {errs32} past {past}; encode probes {probe_err}")

    # the planted fault: grid_student's (32, 16) proposal launch on
    # prop_kernel built with PROP_FAULT must fail the hold that the kernel
    # itself passed above (GRID_TOL, element by element)
    a, k = prop_launch
    ref = fm.run_tmlp_plain(a[0], a[1])

    def past_tol(got):
        d = (got - ref).abs()
        return int((d > GRID_TOL + GRID_TOL * ref.abs()).sum()), float(d.max())

    own = past_tol(fm.run_tmlp(*a, **k))
    with kernels_from(planted):
        before = fm.run_tmlp.prop_launches
        bad = past_tol(fm.run_tmlp(*a, **k))
        check(fm.run_tmlp.prop_launches == before + 1,
              f"{PROP_FAULT}: the planted launch did not take prop_kernel")
    check(own[0] == 0 and bad[0] > 0,
          f"planted {PROP_FAULT}: {bad[0]} of {ref.numel()} outputs past "
          f"GRID_TOL (the kernel's own: {own[0]})")
    planted_rec = {"fault": PROP_FAULT, "outputs_past_tol": bad[0],
                   "of": ref.numel(), "max_abs_err": bad[1],
                   "kernel_outputs_past_tol": own[0],
                   "kernel_max_abs_err": own[1], "tol": GRID_TOL}
    del prop_launch, a, k, ref
    torch.cuda.empty_cache()
    log(f"planted fault in prop_kernel: {planted_rec}")

    # the planted grid fault: grid_student's (32, 16) composite on the
    # V_GRID kernels built with GRID_FAULT must fail the hold that the
    # kernel itself passed above (GRID_TOL, element by element, over
    # gsum, depth, weights_sum and rgb)
    a, k = comp_launch
    check(fm.kernel_plan(a[3], a[1].shape[1], k["view"]).variant == fm.V_GRID,
          f"{GRID_FAULT}: grid_student's composite does not take V_GRID")
    ref = fm.run_tmlp_composite_plain(*a, **k)

    def past_grid(got):
        n_, e_ = 0, 0.0
        for g_, r_ in zip(got, ref):
            d = (g_ - r_).abs()
            n_ += int((d > GRID_TOL + GRID_TOL * r_.abs()).sum())
            e_ = max(e_, float(d.max()))
        return n_, e_

    own = past_grid(fm.run_tmlp_composite(*a, **k))
    with kernels_from(planted):
        before = fm.run_tmlp_composite.grid_launches
        bad = past_grid(fm.run_tmlp_composite(*a, **k))
        check(fm.run_tmlp_composite.grid_launches == before + 1,
              f"{GRID_FAULT}: the planted launch did not take V_GRID")
    n_out = sum(r_.numel() for r_ in ref)
    check(own[0] == 0 and bad[0] > 0,
          f"planted {GRID_FAULT}: {bad[0]} of {n_out} outputs past GRID_TOL "
          f"(the kernel's own: {own[0]})")
    grid_planted = {"fault": GRID_FAULT, "outputs_past_tol": bad[0],
                    "of": n_out, "max_abs_err": bad[1],
                    "kernel_outputs_past_tol": own[0],
                    "kernel_max_abs_err": own[1], "tol": GRID_TOL}
    del comp_launch, a, k, ref
    torch.cuda.empty_cache()
    log(f"planted fault in V_GRID: {grid_planted}")

    # -- 15. grid_student's interactive frame ---------------------------------
    mi = model_of("grid_student", with_sam=True)
    pi = fields.cast_params(params_of(mi), torch.bfloat16)
    sam_cfg = sam_mod.SamConfig()
    sam_params = fields.cast_params(sam_mod.init_params(
        sam_cfg, torch.Generator().manual_seed(1), dev))
    sess = InteractiveSession(None, mi, pi, sam_mod.SamPredictor(
        sam_cfg, sam_params, device=dev), H=SIZE, W=SIZE, device=dev)
    sess.step(pose)
    sess.points_3d.append(np.zeros(3, np.float32))
    sess.step(pose)
    got = {}
    dfused, dec = fp.decode_fused, sam_mod.decode

    def spy_fused(cfg, p, feats, *a, **k):
        got.setdefault("samvit", feats)
        return dfused(cfg, p, feats, *a, **k)

    def spy_dec(*a, **k):
        out = dec(*a, **k)
        got.setdefault("logits", out[0])
        return out

    fp.decode_fused, sam_mod.decode = spy_fused, spy_dec
    try:
        zero(counters + [rk.flatten3_nt])
        r = sess.step(pose, pipelined=False)
        torch.cuda.synchronize()
        inter_n = [c.launches for c in counters + [rk.flatten3_nt]]
        inter_prop = fm.run_tmlp.prop_launches
        inter_grid = [fm.run_tmlp.grid_launches,
                      fm.run_tmlp_composite.grid_launches]
    finally:
        fp.decode_fused, sam_mod.decode = dfused, dec
    check(inter_n == INTERACTIVE_LAUNCHES["32,16"],
          f"grid_student interactive launches {inter_n}, expected "
          f"{INTERACTIVE_LAUNCHES['32,16']}")
    # the RGB and the feature render's proposal launches; the field's
    # density query of the feature render (with tables) on tmlp_kernel
    check(inter_prop == inter_n[2] - 1,
          f"grid interactive: {inter_prop} of {inter_n[2]} run_tmlp launches "
          f"on prop_kernel, expected {inter_n[2] - 1}")
    # ... and that density query and the RGB composite on V_GRID
    check(inter_grid == [1, inter_n[3]],
          f"grid interactive: launches on V_GRID {inter_grid} (run_tmlp, "
          f"composite), expected [1, {inter_n[3]}]")
    check(r.rgb_u8.shape == (SIZE, SIZE, 3), "grid interactive frame shape")
    check(bool(torch.isfinite(r.depth).all()), "grid interactive depth")
    sv = got.get("samvit")
    check(sv is not None and tuple(sv.shape) == (sess.h, sess.w,
                                                 mi.cfg.sam_feat_dim)
          and bool(torch.isfinite(sv).all()), "grid interactive samvit")
    check(got.get("logits") is not None
          and bool(torch.isfinite(got["logits"]).all()),
          "grid interactive mask logits not finite")
    check(r.mask is not None and tuple(r.mask.shape) == (SIZE, SIZE),
          "grid interactive mask missing")
    del r, got, sv
    icalls = spied(lambda: sess.step(pose, pipelined=False))
    ikey = "interactive grid_student 32,16"
    for kn in mlps:
        for a, k in icalls.get(kn, []):
            hold(kn, ikey, a, k)
        launch_t[kn][ikey] = launch_times(kn, icalls.get(kn, []), plain=False)
    # the field's density query of the feature render: run_tmlp with tables
    grid_at = [i for i, (a, _) in enumerate(icalls["run_tmlp"])
               if a[1].tables]
    check(len(grid_at) == 1, f"grid interactive: {len(grid_at)} run_tmlp "
                             f"launches with grid tables, expected 1")
    tmlp_grid = launch_times("run_tmlp", [icalls["run_tmlp"][grid_at[0]]])[0]
    tmlp_args = icalls["run_tmlp"][grid_at[0]][0]
    del icalls

    def drive(n, sync):
        ts_ = []
        for _ in range(n):
            t = time.perf_counter()
            sess.step(pose, pipelined=not sync)
            ts_.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts_), ts_

    drive(3, False)
    pipelined, sync = drive(7, False), drive(5, True)
    inter = {"launches_per_frame": inter_n,
             "prop_kernel_launches_per_frame": inter_prop,
             "v_grid_launches_per_frame": inter_grid,
             "pipelined_ms": pipelined[0], "sync_ms": sync[0],
             "pipelined_runs": pipelined[1], "sync_runs": sync[1]}
    del sess, pi
    torch.cuda.empty_cache()
    log(f"grid interactive frame {inter}")

    # -- 16. sigma-VM with CP and VM features, ragged -------------------------
    ms_ = fields.make_model(ModelConfig(**gp.SIGMA_VM), RenderConfig(
        num_steps=(8, 4), bound=4.0, contract=True))
    check(renderer.uses_kernels(ms_) and ms_.has_sigma_grid,
          "sigma-VM model: not on the fast path")
    p32 = params_from_jax(gp.make_flat(expected_shapes(ms_), GRID_SEED), ms_,
                          dev)
    pbf = fields.cast_params(p32, torch.bfloat16)
    nets, twin = twins(ms_, pbf, p32)
    probe("sigma_vm", nets.field, twin[id(nets.field)])
    rng = np.random.default_rng(GRID_SEED)
    so = torch.from_numpy((rng.normal(0, 0.1, (SIGMA_RAYS, 3))
                           + [0.0, 0.0, 2.0]).astype(np.float32)).to(dev)
    sd = rng.normal(0, 1, (SIGMA_RAYS, 3)) + [0.0, 0.0, -2.0]
    sd = torch.from_numpy((sd / np.linalg.norm(sd, axis=-1, keepdims=True))
                          .astype(np.float32)).to(dev)
    zero(counters)
    scalls = spied(lambda: renderer.run_rays(ms_, pbf, so, sd, nets=nets))
    # its field's launches, run_tmlp and the composite, on V_GRID
    sigma_grid = [fm.run_tmlp.grid_launches,
                  fm.run_tmlp_composite.grid_launches]
    check(sigma_grid[1] == sum(fm._grid_net(a[3]) for a, _ in
                               scalls["run_tmlp_composite"]) > 0
          and sigma_grid[0] == sum(fm._grid_net(a[1])
                                   for a, _ in scalls["run_tmlp"]),
          f"sigma-VM: launches on V_GRID {sigma_grid}")
    for kn in mlps:
        for a, k in scalls[kn]:
            hold(kn, "sigma_vm", a, k, twin)
    g = torch.Generator(device=dev).manual_seed(GRID_SEED)
    xr = torch.rand(3, SIGMA_RAYS * 8 + 5, generator=g, device=dev) * 4 - 2
    hold("run_tmlp", "sigma_vm", (xr, nets.field), {"transposed": True}, twin)
    fast = renderer.run_rays(ms_, p32, so, sd)
    slow = renderer.run_rays(dataclasses.replace(
        ms_, render_cfg=dataclasses.replace(ms_.render_cfg,
                                            use_fused_mlp=False)),
        p32, so, sd)
    sigma_path = {}
    for k in ("image", "depth", "weights_sum"):
        d = (fast[k] - slow[k]).abs()
        over = d > PATH_TOL + PATH_TOL * slow[k].abs()
        if over.dim() > 1:
            over, d = over.any(dim=-1), d.amax(dim=-1)
        n_over, e = int(over.sum()), float(d.max())
        sigma_path[k] = {"max_abs_err": e, "rays_over": n_over}
        allowed = math.floor(DEPTH_SHARE * d.numel()) if k == "depth" else 0
        check(n_over <= allowed and (k != "depth" or e <= DEPTH_MAX),
              f"sigma-VM: fast path {k} off the plain path: max {e:.3g}, "
              f"{n_over} of {d.numel()} rays past {PATH_TOL}")
    del scalls, fast, slow, nets, twin, p32, pbf
    log(f"sigma-VM: kernels vs plain bf16 {errs['run_tmlp'].get('sigma_vm')}"
        f" / {errs['run_tmlp_composite'].get('sigma_vm')}, encode probes "
        f"{probe_err['sigma_vm']}, fast vs plain path {sigma_path}")

    # -- 17. quality_recipe: over the budget, the plain path ------------------
    mq = fields.make_model(ModelConfig(**gp.CONFIGS[GRID_OVER_BUDGET]),
                           RenderConfig())
    check(mq.grid_table_bytes > RenderConfig().grid_vmem_budget
          and not renderer.uses_kernels(mq),
          f"{GRID_OVER_BUDGET}: {mq.grid_table_bytes} B of tables took the "
          f"fast path")
    pq32 = params_of(mq)
    pq = fields.cast_params(pq32, torch.bfloat16)
    every = counters + [rk.flatten3_nt, ga.gather_rows]
    zero(every)
    out = renderer.render_frame(mq, pq, rays_o, rays_d)
    torch.cuda.synchronize()
    q_n = [c.launches for c in every]
    check(sum(q_n) == 0, f"{GRID_OVER_BUDGET}: kernel launches {q_n}")
    finite(out, GRID_OVER_BUDGET)
    del out
    quality = {"grid_table_bytes": mq.grid_table_bytes,
               "grid_vmem_budget": RenderConfig().grid_vmem_budget,
               "uses_kernels": renderer.uses_kernels(mq),
               "kernel_launches": q_n,
               "frame_ms": host_ms(lambda: renderer.render_frame(
                   mq, pq, rays_o, rays_d), n=2)}
    del pq
    torch.cuda.empty_cache()
    log(f"{GRID_OVER_BUDGET}: {quality}")

    # -- 18. against the JAX package ------------------------------------------
    o64, d64 = (torch.from_numpy(a).to(dev) for a in gp.frame_rays(64))
    mg = fields.make_model(ModelConfig(**gp.CONFIGS["grid_student"]),
                           RenderConfig())
    jax_err = {}
    for name, model, p in (("grid_student", mg, params_of(mg)),
                           (GRID_OVER_BUDGET, mq, pq32)):
        ref = JAX_GRID[name]
        out = renderer.run_rays(model, p, o64, d64)
        px = torch.tensor(JAX_GRID["pixels"], device=dev)
        for k in ("mean", "image", "depth", "weights_sum"):
            if k == "mean":
                got_v = np.asarray([float(out[m].double().mean())
                                    for m in ref["mean"]])
                want = np.asarray(list(ref["mean"].values()))
            else:
                got_v, want = (out[k][px].double().cpu().numpy(),
                               np.asarray(ref[k]))
            d = np.abs(got_v - want)
            jax_err[f"{name}/{k}"] = float(d.max())
            check(bool((d <= JAX_GRID_TOL + JAX_GRID_TOL
                        * np.abs(want)).all()),
                  f"{name} {k} off the JAX values: max {d.max():.3g}")
        del out, p
    del pq32
    torch.cuda.empty_cache()
    log(f"grids vs JAX: {jax_err}")

    def loss(ts_):
        return sum(t["ms"] - t["bound_ms"] for t in ts_)

    comp = launch_t["run_tmlp_composite"]["grid_student 32,16"][0]
    v_grid = ptxas_of(ptxas_log, "13__nv_bfloat16Li3E")
    # tmlp_kernel and both composite_kernel instances (GEN false, true)
    found = [k for k, v in v_grid.items()
             if k != "serialized" and "registers" in v]
    check(len(found) == 3 and sum("composite" in k for k in found) == 2,
          f"the nvcc log of fused_mlp_t holds {len(found)} of the 3 V_GRID "
          f"kernels: {found}")
    check(not v_grid["serialized"],
          f"ptxas serialized the V_GRID kernels' wgmmas: "
          f"{v_grid['serialized'][:2]}")
    common = {"route": "cuda", "source": SOURCES["run_tmlp"][0],
              "variant": "V_GRID", "ptxas": v_grid,
              "library_ms": None,
              "library": "none: no single PyTorch call computes this function",
              "tol": GRID_TOL, "f32_tol": MLP_F32_TOL,
              "encode_probes": probe_err, "probe_tol": PROBE_TOL,
              "also_replaces": "sanerf_tpu/ops/fused_mlp_t.py:323 "
                               "(_grid_blocks: _cp_level :235 per CP level, "
                               "_vm_block :263 per VM level and sigma-VM)"}
    rows = [{
        "name": "run_tmlp_composite[grids]", **common,
        "replaces": SOURCES["run_tmlp_composite"][1],
        "launches": sum(v[h] for v in grid_per_frame.values() for h in v),
        "launches_of": "the RGB frames of grid_student, cp_ladder and "
                       "vm_ladder at (32, 16) and (128, 64, 32): "
                       "grid_student's composites (the ladders' take "
                       "V_SERVED)",
        "v_grid_launches_by_frame": grid_per_frame,
        "max_abs_err": max(errs["run_tmlp_composite"].values()),
        "max_abs_err_by_frame": errs["run_tmlp_composite"],
        "max_abs_err_f32_weights": max(errs32["run_tmlp_composite"].values()),
        "outputs_past_tol": past["run_tmlp_composite"],
        "ms": comp["ms"], "plain_ms": comp["plain_ms"],
        "bound_ms": comp["bound_ms"], "bound_by": comp["bound_by"],
        "grid_old_ms": comp["grid_old_ms"],
        "plans": grid_plans, "planted_fault": grid_planted,
        "shapes_of": "grid_student, 32,16 RGB frame",
        "launch_times": launch_t["run_tmlp_composite"],
        "loss_ms_per_frame": {k: loss(v) for k, v in
                              launch_t["run_tmlp_composite"].items()}}, {
        "name": "run_tmlp[grids]", **common,
        "replaces": SOURCES["run_tmlp"][1],
        "launches": inter_grid[0],
        "launches_of": "run_tmlp on V_GRID in one 512^2 grid_student "
                       "interactive frame at (32, 16): the feature render's "
                       "field launch, the one with tables (its 2 proposal "
                       "launches are prop_kernel's)",
        "max_abs_err": max(errs["run_tmlp"].values()),
        "max_abs_err_by_frame": errs["run_tmlp"],
        "max_abs_err_f32_weights": max(errs32["run_tmlp"].values()),
        "outputs_past_tol": past["run_tmlp"],
        "ms": tmlp_grid["ms"], "plain_ms": tmlp_grid["plain_ms"],
        "bound_ms": tmlp_grid["bound_ms"], "bound_by": tmlp_grid["bound_by"],
        "grid_old_ms": tmlp_grid["grid_old_ms"],
        "plan": {kk: v for kk, v in fm.kernel_plan(
            field_of("run_tmlp", tmlp_args)).as_dict().items()
            if kk in PLAN_KEYS},
        "shapes_of": "the field launch with tables of that frame",
        "shape": tmlp_grid["shape"],
        "launch_times": launch_t["run_tmlp"],
        "loss_ms_per_frame": {k: loss(v) for k, v in
                              launch_t["run_tmlp"].items()}}]
    prop = {"launches_per_frame": prop_per_frame,
            "max_abs_err_by_frame": {kk: v for kk, v in errs["run_tmlp"].items()
                                     if not kk.startswith(("interactive",
                                                           "sigma"))},
            "launch_times": {kk: launch_t["run_tmlp"][kk]
                             for kk in ("grid_student 32,16",
                                        "grid_student 128,64,32")},
            "planted_fault": planted_rec}
    return {"size": SIZE, "param_dtype": "bfloat16", "seed": GRID_SEED,
            "prop": prop,
            "configs": {n: gp.CONFIGS[n] for n in gp.CONFIGS},
            "sources": gp.SOURCES, "grid_table_bytes": table_bytes,
            "launches_per_frame": per_frame, "frame_ms": frame_ms,
            "interactive_grid_student_32_16": inter,
            "sigma_vm_fast_vs_plain_f32": sigma_path,
            "encode_probes_max_abs_err": probe_err,
            "over_budget": {GRID_OVER_BUDGET: quality},
            "vs_jax_max_abs_err": jax_err, "jax_tol": JAX_GRID_TOL,
            "card": card, "rows": rows}


def train_phases(torch, np, dev, card, compare, launch_times, kern_fn):
    """Phases T1-T4, stage-1 training. -> the {"train": ...} record, with
    the kernel rows of hash_grid_backward and gather_rows_backward under
    "rows" and the float32 launches of T2's evaluation frame per kernel
    under "eval_launches"."""
    import shutil

    from sanerf_tpu_torch.config import (Config, ModelConfig, RenderConfig,
                                         TrainConfig)
    from sanerf_tpu_torch.data.synthetic import SyntheticSphereDataset
    from sanerf_tpu_torch.models import fields, renderer
    from sanerf_tpu_torch.ops import fused_mlp_t as fm
    from sanerf_tpu_torch.ops import gather as ga
    from sanerf_tpu_torch.ops import hashgrid as hg
    from sanerf_tpu_torch.ops import ray_kernels as rk
    from sanerf_tpu_torch.train import state as st_lib
    from sanerf_tpu_torch.train.checkpoints import flatten_tree
    from sanerf_tpu_torch.train.trainer import Trainer
    from sanerf_tpu_torch.train.tree import leaves_with_paths

    sys.path.insert(0, os.path.join(ROOT, "port_tools"))
    import grid_params as gp

    ray_mlp = [rk.ray_level0, rk.ray_level, fm.run_tmlp,
               fm.run_tmlp_composite]
    ws = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(ws, ignore_errors=True)

    def on_card(batch):
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
                if isinstance(v, np.ndarray)}

    def zero(cs):
        torch.cuda.synchronize()
        for c in cs:
            c.launches = 0

    def epoch_losses(tr):
        with open(tr.metrics_path) as f:
            return [json.loads(line)["loss"] for line in f]

    # -- T1. convergence (tests/test_train_e2e.py:40-74) -----------------------
    sphere = SyntheticSphereDataset(H=48, W=48, n_views=12)
    fr0 = sphere.frame(0)
    o0, d0, cnf0 = (torch.as_tensor(fr0[k], device=dev)
                    for k in ("rays_o", "rays_d", "cam_near_far"))
    gt0 = torch.as_tensor(fr0["images"], device=dev)
    converge = {}
    for fam, mkw in TRAIN_MC.items():
        model = fields.make_model(ModelConfig(**mkw),
                                  RenderConfig(**TRAIN_RC))
        tc = TrainConfig(**TRAIN_TC)
        state = st_lib.create_train_state(
            model, tc, torch.Generator().manual_seed(0), device=dev)
        step = st_lib.make_rgb_train_step(model, tc)
        rng = np.random.default_rng(0)
        gen = torch.Generator(device=dev).manual_seed(1)

        def psnr(p):
            with torch.no_grad():
                out = renderer.render_staged(model, p, o0, d0,
                                             cam_near_far=cnf0)
            return float(-10 * torch.log10(((out["image"] - gt0) ** 2)
                                           .mean()))

        before = psnr(state.params)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(CONVERGE_STEPS):
            batch = on_card(sphere.collate_train(rng, tc.num_rays))
            state, aux = step(state, batch, st_lib.draw_step(
                model, tc, tc.num_rays, gen, dev),
                st_lib.update_proposal_now(tc, i))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        after = psnr(state.params)
        loss = float(aux["loss"])
        check(math.isfinite(loss), f"T1 {fam}: loss {loss}")
        check(after > before + CONVERGE_GAIN_DB,
              f"T1 {fam}: no convergence, {before:.2f} -> {after:.2f} dB")
        check(after > CONVERGE_MIN_DB, f"T1 {fam}: PSNR {after:.2f} dB")
        converge[fam] = {"psnr_before_db": before, "psnr_after_db": after,
                         "final_loss": loss, "steps": CONVERGE_STEPS,
                         "it_per_s": CONVERGE_STEPS / secs, "card": card}
        log(f"T1 {fam}: {converge[fam]}")
    del state, step
    torch.cuda.empty_cache()

    # -- T2. the defaults through Trainer.train ---------------------------------
    textured = SyntheticSphereDataset(H=64, W=64, n_views=8, scene="textured")
    valid = SyntheticSphereDataset(H=EVAL_SIZE, W=EVAL_SIZE, n_views=2,
                                   scene="textured", training=False)
    defaults, eval_launches, path_launches = {}, {}, {}
    for fam, mc in (("mlp", ModelConfig()),
                    ("hashgrid", ModelConfig(field_type="hashgrid"))):
        cfg = Config(workspace=os.path.join(ws, fam), model=mc)
        model = fields.make_model(cfg.model, cfg.render)
        tr = Trainer("t2", cfg, model, use_checkpoint="scratch", device=dev)
        step_ms, real_step = [], tr._train_step

        def timed(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real_step(*a, **k)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            return out

        tr._train_step = timed
        torch.cuda.reset_peak_memory_stats()
        counters = ray_mlp + [ga.gather_rows, ga.gather_rows_backward,
                              hg.hash_grid_backward, hg.hash_grid_forward]
        zero(counters)
        tr.train(textured, valid_dataset=valid, max_epoch=TRAIN_EPOCHS,
                 steps_per_epoch=TRAIN_STEPS)
        torch.cuda.synchronize()
        path_launches[fam] = {c.__name__: c.launches for c in counters}
        peak = torch.cuda.max_memory_allocated()
        check(tr.global_step == TRAIN_EPOCHS * TRAIN_STEPS,
              f"T2 {fam}: {tr.global_step} steps")
        losses = epoch_losses(tr)
        check(len(losses) == TRAIN_EPOCHS and all(map(math.isfinite,
                                                     losses)),
              f"T2 {fam}: epoch losses {losses}")
        fast = renderer.uses_kernels(model)
        check(fast == model.is_mlp_field, f"T2 {fam}: fast path {fast}")
        if fast:
            check(all(path_launches[fam][c.__name__] > 0 for c in ray_mlp),
                  f"T2 {fam}: a kernel never ran: {path_launches[fam]}")
        else:
            # every step updates the proposal nets (prop_warmup_steps);
            # the evaluation renders encode too
            steps = TRAIN_EPOCHS * TRAIN_STEPS * HASH_GRIDS
            check(path_launches[fam]["hash_grid_backward"] == steps
                  and path_launches[fam]["hash_grid_forward"] >= steps
                  and path_launches[fam]["gather_rows_backward"] == 0
                  and path_launches[fam]["gather_rows"] == 0,
                  f"T2 {fam}: encode and table-gradient launches "
                  f"{path_launches[fam]}")
        # one evaluation frame, its launches counted and recorded
        frame = valid.frame(0)
        params = tr.eval_params()
        calls = {}
        zero(counters)
        with spying(renderer, fields, kern_fn, calls, None):
            tr._render(params, frame)
        torch.cuda.synchronize()
        frame_launches = {c.__name__: c.launches for c in counters}
        if fast:
            check(all(frame_launches[c.__name__] > 0 for c in ray_mlp),
                  f"T2 {fam}: the evaluation frame missed a kernel: "
                  f"{frame_launches}")
            check(all(t.dtype == torch.float32 for _, t in
                      leaves_with_paths(params)),
                  f"T2 {fam}: evaluation weights not float32")
            errs32 = {}
            for (_, name), ls in calls.items():
                for a, k in ls:
                    e, _ = compare(name, a, k,
                                   RAY_TOL if name.startswith("ray")
                                   else MLP_F32_TOL[name], flips=False,
                                   faithful_hold=True)
                    errs32[name] = max(errs32.get(name, 0.0), e)
                eval_launches[name] = launch_times(name, ls)
        else:
            check(frame_launches["hash_grid_forward"] == HASH_GRIDS
                  and frame_launches["gather_rows"] == 0
                  and not any(frame_launches[c.__name__] for c in ray_mlp),
                  f"T2 {fam}: evaluation frame launches {frame_launches}")
            errs32 = None
        del calls
        ts_ = []
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            tr._render(params, frame)
            torch.cuda.synchronize()
            ts_.append((time.perf_counter() - t) * 1e3)
        # resume in a fresh Trainer: identical params, EMA and step
        tr2 = Trainer("t2", cfg, model, use_checkpoint="latest", device=dev)
        check(tr2.global_step == tr.global_step
              and tr2.state.step == tr.state.step,
              f"T2 {fam}: resumed at step {tr2.global_step}")
        for a_, b_ in ((tr.state.params, tr2.state.params),
                       (tr.state.ema_params, tr2.state.ema_params)):
            fa, fb = flatten_tree(a_), flatten_tree(b_)
            check(sorted(fa) == sorted(fb)
                  and all(np.array_equal(fa[k], fb[k]) for k in fa),
                  f"T2 {fam}: resumed params differ")
        defaults[fam] = {
            "config": "ModelConfig(%s), RenderConfig(), TrainConfig()" % (
                "" if fast else "field_type='hashgrid'"),
            "rays_per_step": st_lib.adaptive_num_rays(
                cfg.train, cfg.render.num_steps[-1]),
            "step_ms_median": statistics.median(step_ms[1:]),
            "step_ms_runs": step_ms, "max_memory_allocated": peak,
            "epoch_losses": losses, "launches_of_the_run": path_launches[fam],
            "eval_frame_launches": frame_launches,
            "eval_frame_ms": statistics.median(ts_[1:]),
            "eval_frame_runs": ts_, "eval_size": EVAL_SIZE,
            "eval_max_abs_err_f32": errs32, "card": card}
        log(f"T2 {fam}: {defaults[fam]}")
        del tr, tr2, params
        torch.cuda.empty_cache()

    # -- T3. the hash grid's step: kernels against the plain versions --------
    hstep, fused, bwd, tv = hash_step_phase(dev, textured)
    shapes = {}
    for rec in hstep["parent_route_launches"]:
        shapes[rec["shape"]] = shapes.get(rec["shape"], 0) + 1
    hstep["t2_step"] = {k: defaults["hashgrid"][k] for k in (
        "step_ms_median", "max_memory_allocated")}
    log(f"T3: {hstep}")

    # -- T4. the grid recipe: ladders, sigma grids, TV, annealing, upsampling --
    recipe = {}
    for name in (GRID_OVER_BUDGET, "grid_student"):
        mc = ModelConfig(**gp.CONFIGS[name])
        cfg = Config(workspace=os.path.join(ws, name), model=mc,
                     train=TrainConfig(**RECIPE_TRAIN))
        model = fields.make_model(mc, cfg.render)
        tr = Trainer("t4", cfg, model, use_checkpoint="scratch", device=dev)
        zero(ray_mlp)
        tr.train(textured, valid_dataset=valid, max_epoch=2,
                 steps_per_epoch=2)
        torch.cuda.synchronize()
        launched = {c.__name__: c.launches for c in ray_mlp}
        losses = epoch_losses(tr)
        check(all(map(math.isfinite, losses)), f"T4 {name}: losses {losses}")
        want = st_lib.grid_upsample_targets(cfg.train, mc, tr.global_step)
        got = fields.grid_resolutions(tr.state.params)
        check(got == want, f"T4 {name}: tables at {got}, targets {want}")
        fast = model.grid_table_bytes <= cfg.render.grid_vmem_budget
        check(renderer.uses_kernels(model) == fast
              and (sum(launched.values()) > 0) == fast,
              f"T4 {name}: evaluation route {launched}, budget says "
              f"{'fast' if fast else 'plain'}")
        recipe[name] = {"grid_table_bytes": model.grid_table_bytes,
                        "route": "fast" if fast else "plain",
                        "eval_launches": launched, "epoch_losses": losses,
                        "resolutions": got}
        log(f"T4 {name}: {recipe[name]}")
        del tr
        torch.cuda.empty_cache()
    shutil.rmtree(ws, ignore_errors=True)

    hash_rows = [{
        "name": "hash_grid_backward", "route": "cuda",
        "source": "sanerf_tpu_torch/csrc/hashgrid.cu",
        "replaces": "none: no Pallas kernel; the gradient of "
                    "sanerf_tpu/ops/hashgrid.py:170-239 hash_encode_01 in "
                    "the table (the jnp.take at :229), XLA's scatter-add; "
                    "on the training step it replaces gather_rows_backward's "
                    "one launch a level",
        "launches": path_launches["hashgrid"]["hash_grid_backward"],
        "launches_of": f"Trainer.train of ModelConfig(field_type="
                       f"'hashgrid'): {TRAIN_EPOCHS * TRAIN_STEPS} steps",
        "max_abs_err": fused["max_abs_err"],
        "tol": list(SCATTER_TOL) + [SCATTER_MAG],
        "tol_kind": "as gather_rows_backward's, S from the plain version "
                    "with |g| (the weights are >= 0)",
        "floor": fused["floor"],
        "ms": fused["ms"], "ms_p10_p90": fused["ms_p10_p90"],
        "plain_ms": fused["plain_ms"], "bound_ms": fused["bound_ms"],
        "bound_by": "bytes",
        "bound_kind": "points and output gradient read once, each touched "
                      "row read and written, the other rows written",
        "red_bound_ms": fused["red_bound_ms"],
        "red_bound_kind": "the step's adds at port_tools/red_probe.cu's "
                          "rate for the row's piece width",
        "library_ms": fused["library_ms"],
        "library_ms_p10_p90": fused["library_ms_p10_p90"],
        "library": "torch.Tensor.index_add_ of the same adds (the rows "
                   "the parent's glue made)",
        "parent_route_ms": fused["parent_route_ms"],
        "parent_route_ms_p10_p90": fused["parent_route_ms_p10_p90"],
        "parent_route": f"a zero gradient and the "
                        f"{fused['parent_launches']} gather_rows_backward "
                        f"launches of the same adds",
        "dtype": "float32", "sum_of": f"the {HASH_GRIDS} launches of one "
                                      f"step",
        "timed_as": fused["timed_as"], "s_grid_c8": hstep["s_grid_c8"]}, {
        "name": "gather_rows_backward", "route": "cuda",
        "source": "sanerf_tpu_torch/csrc/gather.cu",
        "replaces": "none: no Pallas kernel; the gradient of "
                    "sanerf_tpu/ops/hashgrid.py:229 (jnp.take), XLA's "
                    "scatter-add",
        "launches": tv["gather_rows_backward"],
        "launches_of": f"one hash-grid training step with lambda_tv "
                       f"{TV_LAMBDA} (the TV term; the default step makes "
                       f"none since hash_grid_backward)",
        "max_abs_err": bwd["max_abs_err"],
        "tol": list(SCATTER_TOL) + [SCATTER_MAG],
        "tol_kind": "|d| <= tol[0] + tol[1] |ref| and |d| <= tol[2] S "
                    "+ tol[1] |ref|, S the sum of |grad_out| over the "
                    "adds into the element (atomics sum in another "
                    "order)",
        "floor": bwd["floor"],
        "ms": bwd["ms"], "ms_p10_p90": bwd["ms_p10_p90"],
        "plain_ms": bwd["plain_ms"], "bound_ms": bwd["bound_ms"],
        "bound_by": "bytes", "library_ms": bwd["library_ms"],
        "library_ms_p10_p90": bwd["library_ms_p10_p90"],
        "library": "torch.Tensor.index_add_", "dtype": "float32",
        "sum_of": f"the {HASH_GATHERS} launches of the level route on "
                  f"T3's step",
        "timed_as": bwd["timed_as"], "shapes": shapes}]
    return {"convergence": converge, "defaults": defaults,
            "hashgrid_step": hstep,
            "grid_recipe": recipe, "card": card, "rows": hash_rows,
            "eval_launches": eval_launches}


def branch_phases(torch, np, dev, card, compare, launch_times, kern_fn,
                  model_at, rays_o, rays_d, nets, params, params32, mc, rc,
                  planted, ptxas_log):
    """Phases B1-B4: the field kernels' branches beyond the served (32, 16)
    and (128, 64, 32) frames; RING_FAULT and F32_RING_FAULT planted in the
    kernels built into `planted` fail B2's holds; ptxas_log, the nvcc log
    of fused_mlp_t (the V_WIDE32 kernels' registers, spills and serialized
    wgmma pipelines, recorded). -> the {"branches": ...}
    record, with the kernel rows of those launches under "rows"."""
    import dataclasses
    import shutil

    from sanerf_tpu_torch.apps.interactive import InteractiveSession
    from sanerf_tpu_torch.config import Config, ModelConfig, RenderConfig
    from sanerf_tpu_torch.data.rays import full_frame_rays
    from sanerf_tpu_torch.data.synthetic import SyntheticSphereDataset
    from sanerf_tpu_torch.models import fields, renderer
    from sanerf_tpu_torch.models.asset import (expected_shapes, load_asset,
                                               params_from_jax)
    from sanerf_tpu_torch.models.sam import predictor as sam_mod
    from sanerf_tpu_torch.ops import fused_mlp_t as fm
    from sanerf_tpu_torch.ops import ray_kernels as rk
    from sanerf_tpu_torch.train.trainer import Trainer
    from sanerf_tpu_torch.train.tree import leaves_with_paths
    from sanerf_tpu_torch.utils.camera import fov_to_focal

    sys.path.insert(0, os.path.join(ROOT, "port_tools"))
    import grid_params as gp

    counters = [rk.ray_level0, rk.ray_level, fm.run_tmlp,
                fm.run_tmlp_composite]
    mlps = ("run_tmlp", "run_tmlp_composite")
    pose = np.asarray(SERVE_POSE, np.float32)
    errs, errs32, past, launch_t = {}, {}, {}, {}
    # the float32 launches of nets wider than 128 held in B1-B3, each of
    # which must take the V_WIDE32 ring
    f32_ring = {}

    def zero(cs=counters):
        torch.cuda.synchronize()
        for c in cs:
            c.launches = 0

    def spied(fn):
        calls = {}
        with spying(renderer, fields, kern_fn, calls, None):
            fn()
        torch.cuda.synchronize()
        return {n: v for (_, n), v in calls.items()}

    def twin_of(pairs):
        return lambda a, k: (tuple(pairs.get(id(v), v) for v in a),
                             {kk: pairs.get(id(v), v) for kk, v in k.items()})

    def hold(key, name, a, k, f32, seeded):
        """One launch against its plain version: ray kernels at RAY_TOL;
        bf16 weights at MLP_TOL with FLIP_SHARE (trained weights) or
        GRID_TOL element by element (seeded weights, `seeded`); float32
        weights, and with `f32` the float32 twins f32(a, k) of bf16 ones,
        at MLP_F32_TOL and at F32_FAITHFUL (seeded) or against the float64
        plain version (trained)."""
        if name.startswith("ray"):
            e, n = compare(name, a, k, RAY_TOL, flips=False)
        elif field_of(name, a).dtype == torch.float32:
            tm_ = field_of(name, a)
            if max(w.shape[1] for w in tm_.ws) > fm.CHUNK:
                T_ = None if name == "run_tmlp" else (
                    k.get("T") or a[1].shape[1])
                v_ = fm.kernel_plan(tm_, T_, k.get("view")).variant
                check(v_ == fm.V_WIDE32,
                      f"{key}: a float32 {name} launch wider than 128 on "
                      f"variant {v_}, not the V_WIDE32 ring")
                f32_ring[key] = f32_ring.get(key, 0) + 1
            e, n = compare(name, a, k, MLP_F32_TOL[name], flips=False,
                           faithful_hold=seeded)
        elif seeded:
            e, n = compare(name, a, k, GRID_TOL, flips=False)
        else:
            e, n = compare(name, a, k, MLP_TOL, flips=True)
        errs.setdefault(key, {})[name] = max(errs.get(key, {}).get(name, 0.0),
                                             e)
        past.setdefault(key, {})[name] = past.get(key, {}).get(name, 0) + n
        if f32 is not None and not name.startswith("ray"):
            e32, _ = compare(name, *f32(a, k), MLP_F32_TOL[name], flips=False,
                             faithful_hold=seeded)
            errs32.setdefault(key, {})[name] = max(
                errs32.get(key, {}).get(name, 0.0), e32)

    def frame_path(key, model, p, frame_nets, expect, f32, seeded):
        """One 512^2 RGB frame with the counters set to 0 just before and
        read just after (expect: ray_level0 / ray_level / run_tmlp /
        run_tmlp_composite), every launch of it held and timed."""
        def frame():
            return renderer.render_frame(model, p, rays_o, rays_d,
                                         chunk=SIZE * SIZE, nets=frame_nets)
        zero()
        out = frame()
        torch.cuda.synchronize()
        n = [c.launches for c in counters]
        check(n == expect, f"{key}: launches {n}, expected {expect}")
        for kk in ("image", "depth", "weights_sum"):
            check(bool(torch.isfinite(out[kk]).all()), f"{key}: {kk}")
        check(float(out["weights_sum"].min()) > 0.5,
              f"{key}: weights_sum {float(out['weights_sum'].min())}")
        del out
        calls = spied(frame)
        for name in KERNELS:
            for a, k in calls.get(name, []):
                hold(key, name, a, k, f32, seeded)
        launch_t[key] = {name: launch_times(name, calls[name])
                         for name in mlps}
        del calls
        ts_ = []
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            frame()
            torch.cuda.synchronize()
            ts_.append((time.perf_counter() - t) * 1e3)
        torch.cuda.empty_cache()
        return n, statistics.median(ts_[1:])

    rec = {"card": card}
    n32 = fields.KernelNets(model_at((32, 16)), params32)
    twin = twin_of({id(a): b for a, b in zip(
        [*nets.props, nets.field, nets.view],
        [*n32.props, n32.field, n32.view])})

    # -- B1. the asset at (32, 24) and (24, 12) -------------------------------
    ragged = {}
    for h, steps in RAGGED_HIERARCHIES.items():
        model = model_at(steps)
        n, ms = frame_path(f"asset {h}", model, params, nets,
                           TWO_LEVEL_LAUNCHES, twin, seeded=False)
        gap = path_gap(renderer, model, model_at(steps, use_fused_mlp=False),
                       params32, rays_o, rays_d, f"asset {h}",
                       RAGGED_DEPTH_MAX[h])
        psnr = heldout_psnr(renderer, fields.make_model(
            mc, dataclasses.replace(rc, num_steps=steps,
                                    max_ray_batch=128 * 128)),
            params, nets, dev, h)
        check(abs(psnr - JAX_PSNR_RAGGED_BF16[h]) <= PSNR_TOL_DB,
              f"{h}: PSNR {psnr:.3f} dB vs JAX "
              f"{JAX_PSNR_RAGGED_BF16[h]:.3f} dB")
        ragged[h] = {"launches_per_frame": n, "frame_ms": ms,
                     "fast_vs_plain_f32": gap, "psnr_db": psnr,
                     "jax_psnr_db_bf16_cpu": JAX_PSNR_RAGGED_BF16[h]}
    log(f"B1 asset at ragged T: {ragged}")

    # the interactive frame and the packed epilogue at (32, 24)
    h, steps = "32,24", RAGGED_HIERARCHIES["32,24"]
    mcs, rcs, ps32 = load_asset(os.path.join(ROOT, "assets",
                                             "serving_student"),
                                device=dev, with_sam=True, seed=0)
    sam_cfg = sam_mod.SamConfig()
    sess = InteractiveSession(
        None, fields.make_model(mcs, dataclasses.replace(
            rcs, num_steps=steps, max_ray_batch=SIZE * SIZE)),
        fields.cast_params(ps32, torch.bfloat16),
        sam_mod.SamPredictor(sam_cfg, fields.cast_params(sam_mod.init_params(
            sam_cfg, torch.Generator().manual_seed(1), dev)), device=dev),
        H=SIZE, W=SIZE, device=dev)
    sess.step(pose)
    sess.points_3d.append(np.zeros(3, np.float32))
    sess.step(pose)
    zero(counters + [rk.flatten3_nt])
    r = sess.step(pose, pipelined=False)
    torch.cuda.synchronize()
    inter_n = [c.launches for c in counters + [rk.flatten3_nt]]
    check(inter_n == INTERACTIVE_LAUNCHES["32,16"],
          f"{h}: interactive launches {inter_n}, expected "
          f"{INTERACTIVE_LAUNCHES['32,16']}")
    check(r.rgb_u8.shape == (SIZE, SIZE, 3)
          and bool(torch.isfinite(r.depth).all()) and r.mask is not None,
          f"{h}: interactive frame")
    ragged[h]["interactive_launches"] = inter_n
    del sess, r, ps32
    torch.cuda.empty_cache()
    ref = renderer.render_frame(model_at(steps), params, rays_o, rays_d,
                                chunk=SIZE * SIZE, nets=nets)
    packed_model = model_at(steps, packed_epilogue=True)
    zero()
    fm.run_tmlp_composite.packed_launches = 0
    got = renderer.render_frame(packed_model, params, rays_o, rays_d,
                                chunk=SIZE * SIZE, nets=nets)
    torch.cuda.synchronize()
    packed_n = fm.run_tmlp_composite.packed_launches
    check(packed_n == 1, f"{h}: packed composite launches {packed_n}")
    packed_err = {}
    for k in ("image", "depth", "weights_sum"):
        d = (got[k] - ref[k]).abs()
        packed_err[k] = float(d.max())
        check(bool((d <= PACKED_TOL + PACKED_TOL * ref[k].abs()).all()),
              f"{h}: packed epilogue {k} off the default by {d.max():.3g}")
    del got, ref
    pcalls = spied(lambda: renderer.render_frame(
        packed_model, params, rays_o, rays_d, chunk=SIZE * SIZE, nets=nets))
    for a, k in pcalls["run_tmlp_composite"]:
        check(k.get("pack_q", 1) > 1, f"{h}: the composite was not packed")
        hold(f"asset {h} packed", "run_tmlp_composite", a, k, twin, False)
    launch_t[f"asset {h} packed"] = {"run_tmlp_composite": launch_times(
        "run_tmlp_composite", pcalls["run_tmlp_composite"])}
    ragged[h].update(packed_launches=packed_n,
                     packed_vs_default_max_abs_err=packed_err)
    del pcalls
    log(f"B1 (32, 24): interactive {inter_n}, packed {packed_err}")
    rec["asset_ragged_T"] = ragged

    # -- B2. the width-256 field ----------------------------------------------
    wide = {"config": WIDE_MC, "seed": GRID_SEED}
    mw = fields.make_model(ModelConfig(**WIDE_MC), RenderConfig(
        num_steps=(32, 16), max_ray_batch=SIZE * SIZE))
    check(renderer.uses_kernels(mw), "width 256: not on the fast path")
    pw32 = params_from_jax(gp.make_flat(expected_shapes(mw), GRID_SEED), mw,
                           dev)
    pw = fields.cast_params(pw32, torch.bfloat16)
    wn, wn32 = fields.KernelNets(mw, pw), fields.KernelNets(mw, pw32)
    wide["frames"] = {}
    for h, steps in HIERARCHIES.items():
        model = fields.make_model(ModelConfig(**WIDE_MC), RenderConfig(
            num_steps=steps, max_ray_batch=SIZE * SIZE))
        for dt, p, nn in (("bf16", pw, wn), ("f32", pw32, wn32)):
            key = f"w256 {h} {dt}"
            n, ms = frame_path(key, model, p, nn, GRID_LAUNCHES[h], None,
                               seeded=True)
            wide["frames"][key] = {"launches_per_frame": n, "frame_ms": ms}
    # the float32 ring (V_WIDE32): the (32, 16) float32 frame's composite
    # against the float64 plain version beside cuBLAS float32 (the error of
    # its order of products and sums), and on the kernels built with
    # F32_RING_FAULT, where it must fail the F32_FAITHFUL hold that the
    # kernel itself passed above
    m16w = fields.make_model(ModelConfig(**WIDE_MC), RenderConfig(
        num_steps=HIERARCHIES["32,16"], max_ray_batch=SIZE * SIZE))
    a, k = spied(lambda: renderer.render_frame(
        m16w, pw32, rays_o, rays_d, chunk=SIZE * SIZE,
        nets=wn32))["run_tmlp_composite"][0]
    check(fm.kernel_plan(a[3], a[1].shape[1], k.get("view")).variant
          == fm.V_WIDE32, f"{F32_RING_FAULT}: the float32 composite is not "
                          f"on the V_WIDE32 ring")
    ref = fm.run_tmlp_composite_plain(*a, **k)

    def past_faithful(got):
        n_, worst = 0, 0.0
        for g_, r_ in zip(got, ref):
            q = (g_ - r_).abs() / (1.0 + r_.abs())
            n_ += int((q > F32_FAITHFUL).sum())
            worst = max(worst, float(q.max()))
        return n_, worst

    got = fm.run_tmlp_composite(*a, **k)
    own = past_faithful(got)
    e_k, e_p = f64_errors(got, ref, plain_f64("run_tmlp_composite", a, k))
    del got
    with kernels_from(planted):
        bad = past_faithful(fm.run_tmlp_composite(*a, **k))
    check(own[0] == 0 and bad[0] > 0,
          f"planted {F32_RING_FAULT}: {bad[0]} outputs past F32_FAITHFUL "
          f"(the kernel's own: {own[0]})")
    wide["f32_ring"] = {
        "launch": "the (32, 16) float32 frame's composite",
        "vs_float64_of_1_plus_ref": {"kernel": e_k, "cublas_float32": e_p},
        "planted_fault": {"fault": F32_RING_FAULT,
                          "outputs_past_faithful": bad[0],
                          "max_ratio": bad[1],
                          "kernel_outputs_past_faithful": own[0],
                          "kernel_max_ratio": own[1],
                          "tol": F32_FAITHFUL}}
    log(f"B2 float32 ring: {wide['f32_ring']}")
    del a, k, ref
    torch.cuda.empty_cache()
    o64, d64 = (torch.from_numpy(a).to(dev) for a in gp.frame_rays(64))
    out = renderer.run_rays(fields.make_model(ModelConfig(**WIDE_MC),
                                              RenderConfig()), pw32, o64, d64)
    px = torch.tensor(JAX_WIDE["pixels"], device=dev)
    jax_err = {}
    for k in ("mean", "image", "depth", "weights_sum"):
        if k == "mean":
            got_v = np.asarray([float(out[m].double().mean())
                                for m in JAX_WIDE["mean"]])
            want = np.asarray(list(JAX_WIDE["mean"].values()))
        else:
            got_v = out[k][px].double().cpu().numpy()
            want = np.asarray(JAX_WIDE[k])
        d = np.abs(got_v - want)
        jax_err[k] = float(d.max())
        check(bool((d <= JAX_WIDE_TOL + JAX_WIDE_TOL * np.abs(want)).all()),
              f"width 256 {k} off the JAX values: max {d.max():.3g}")
    wide["vs_jax_max_abs_err"] = jax_err
    del out, wn, wn32, pw, pw32
    torch.cuda.empty_cache()
    # the feature render of a 512^2 interactive frame of the width-256
    # field with a seeded SAM head: its 32 x 32 rays, where the field's
    # run_tmlp runs at width 256 (no RGB frame launches it)
    focal_lr = fov_to_focal(60.0, SIZE) * FEAT_HW / SIZE
    ro_lr, rd_lr = full_frame_rays(
        pose, np.asarray([focal_lr, focal_lr, FEAT_HW / 2, FEAT_HW / 2],
                         np.float32), FEAT_HW, FEAT_HW, device=dev)
    wide["feature_render"] = {}
    for h, steps in HIERARCHIES.items():
        mf = fields.make_model(ModelConfig(**WIDE_MC, with_sam=True),
                               RenderConfig(num_steps=steps))
        pf32 = params_from_jax(gp.make_flat(expected_shapes(mf), GRID_SEED),
                               mf, dev)
        for dt in ("bf16", "f32"):
            pf = (fields.cast_params(pf32, torch.bfloat16) if dt == "bf16"
                  else pf32)
            fnets = fields.KernelNets(mf, pf)
            key = f"w256 feature {h} {dt}"
            zero()
            fcalls = spied(lambda: renderer.run_rays(
                mf, pf, ro_lr, rd_lr, return_feats=True, nets=fnets))
            n = [c.launches for c in counters]
            zero()
            renderer.run_rays(mf, pf, ro_lr, rd_lr, return_feats=True,
                              nets=fnets)
            torch.cuda.synchronize()
            check([c.launches for c in counters] == n and n[2] > 0,
                  f"{key}: launches {n}")
            widths = [max(w.shape[1] for w in field_of("run_tmlp", a).ws)
                      for a, _ in fcalls["run_tmlp"]]
            check(max(widths) == 256,
                  f"{key}: no width-256 run_tmlp {widths}")
            for name, ls in fcalls.items():
                for a, k in ls:
                    hold(key, name, a, k, None, seeded=True)
            launch_t[key] = {"run_tmlp": launch_times("run_tmlp",
                                                      fcalls["run_tmlp"])}
            wide["feature_render"][f"{h} {dt}"] = {
                "rays": FEAT_HW * FEAT_HW, "launches": n,
                "run_tmlp_widths": widths,
                "run_tmlp_launches": launch_t[key]["run_tmlp"]}
            if h == "32,16" and dt == "bf16":
                ring_launch = fcalls["run_tmlp"][widths.index(256)]
            del pf, fnets, fcalls
            torch.cuda.empty_cache()
        del pf32
    # the planted ring fault: the width-256 field's run_tmlp launch of the
    # (32, 16) feature render on the kernels built with RING_FAULT must fail
    # the hold that the kernel itself passed above (GRID_TOL, element by
    # element)
    a, k = ring_launch
    ref = fm.run_tmlp_plain(a[0], a[1])

    def past_tol(got):
        d = (got - ref).abs()
        return int((d > GRID_TOL + GRID_TOL * ref.abs()).sum()), float(d.max())

    check(fm.kernel_plan(a[1]).w_mode == fm.W_RING,
          f"{RING_FAULT}: the width-256 launch does not take the ring")
    own = past_tol(fm.run_tmlp(*a, **k))
    with kernels_from(planted):
        bad = past_tol(fm.run_tmlp(*a, **k))
    check(own[0] == 0 and bad[0] > 0,
          f"planted {RING_FAULT}: {bad[0]} of {ref.numel()} outputs past "
          f"GRID_TOL (the kernel's own: {own[0]})")
    wide["planted_fault"] = {"fault": RING_FAULT, "outputs_past_tol": bad[0],
                             "of": ref.numel(), "max_abs_err": bad[1],
                             "kernel_outputs_past_tol": own[0],
                             "kernel_max_abs_err": own[1], "tol": GRID_TOL}
    log(f"planted fault in the ring: {wide['planted_fault']}")
    del ring_launch, a, k, ref
    torch.cuda.empty_cache()
    # Trainer.train with a float32 evaluation through the kernels
    ws = os.path.join(ROOT, "build", "chip_smoke_wide")
    shutil.rmtree(ws, ignore_errors=True)
    cfg = Config(workspace=ws, model=ModelConfig(**WIDE_MC))
    tmodel = fields.make_model(cfg.model, cfg.render)
    tr = Trainer("w256", cfg, tmodel, use_checkpoint="scratch", device=dev)
    textured = SyntheticSphereDataset(H=64, W=64, n_views=8, scene="textured")
    valid = SyntheticSphereDataset(H=EVAL_SIZE, W=EVAL_SIZE, n_views=2,
                                   scene="textured", training=False)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        tr.train(textured, valid_dataset=valid, max_epoch=TRAIN_EPOCHS,
                 steps_per_epoch=TRAIN_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    check(tr.global_step == TRAIN_EPOCHS * TRAIN_STEPS,
          f"width 256: {tr.global_step} steps")
    eparams = tr.eval_params()
    check(all(t.dtype == torch.float32 for _, t in leaves_with_paths(eparams)),
          "width 256: evaluation weights not float32")
    ecalls = {}
    zero()
    with spying(renderer, fields, kern_fn, ecalls, None):
        tr._render(eparams, valid.frame(0))
    torch.cuda.synchronize()
    eval_n = [c.launches for c in counters]
    check(all(v > 0 for v in eval_n),
          f"width 256: the evaluation frame missed a kernel: {eval_n}")
    for (_, name), ls in ecalls.items():
        for a, k in ls:
            hold("w256 train eval f32", name, a, k, None, seeded=True)
    launch_t["w256 train eval f32"] = {
        name: launch_times(name, ecalls[(None, name)]) for name in mlps}
    wide["train"] = {"steps": tr.global_step, "seconds": train_s,
                     "eval_launches": eval_n, "eval_size": EVAL_SIZE}
    del tr, eparams, ecalls
    shutil.rmtree(ws, ignore_errors=True)
    torch.cuda.empty_cache()
    for key in ("w256 32,16 f32", "w256 128,64,32 f32",
                "w256 feature 32,16 f32", "w256 feature 128,64,32 f32",
                "w256 train eval f32"):
        check(f32_ring.get(key, 0) > 0,
              f"{key}: no float32 launch wider than 128 held on the ring")
    wide["f32_ring_launches_held"] = {k: v for k, v in f32_ring.items()
                                      if k.startswith("w256")}
    # the V_WIDE32 kernels: tmlp_kernel and both composite_kernel instances
    v32 = ptxas_of(ptxas_log, "IfLi4E")
    found = [k for k, v in v32.items()
             if k != "serialized" and "registers" in v]
    check(len(found) == 3 and sum("composite" in k for k in found) == 2,
          f"the nvcc log of fused_mlp_t holds {len(found)} of the 3 "
          f"V_WIDE32 kernels: {found}")
    # recorded, not held: ptxas serializes the served composite's wgmmas
    # with a fresh accumulator a group of 32-128 columns (C7511; PERF.md)
    wide["v_wide32_ptxas"] = v32
    log(f"B2 width 256: {wide}")
    rec["w256"] = wide

    # -- B3. biased and dense-sin nets at the asset's widths and frame shapes:
    # the asset's field (bf16 and its float32 twin) with seeded biases, and
    # its chain over the Fourier features alone with the dense-sin encode;
    # each drives the (32, 16) RGB frame's composite through render_frame,
    # and run_tmlp at the frame's level-0 points
    m16 = model_at((32, 16))
    x0 = spied(lambda: renderer.render_frame(
        m16, params, rays_o, rays_d, chunk=SIZE * SIZE,
        nets=nets))["run_tmlp"][0][0][0]
    variants = {}
    for dt, f in (("bf16", nets.field), ("f32", n32.field)):
        g = np.random.default_rng(GRID_SEED)  # the same biases in both
        bias = [torch.from_numpy(g.normal(0, BIAS_STD, w.shape[1]).astype(
            np.float32)).to(dev) for w in f.ws]
        biased = fm.TransposedFieldMLP(
            [{"w": w, "b": b} for w, b in zip(f.ws, bias)], f.enc_freqs,
            f.bound, f.skip, leaky=f.leaky, cp_lines=f.cp,
            sigma_cp_lines=f.scp)
        fourier = []
        for l, w in enumerate(f.ws):
            if l == 0:
                w = w[:f.F]
            elif l in f.skip:
                hid = int(f.ws[l - 1].shape[1])
                w = torch.cat([w[:hid], w[hid:hid + f.F]])
            fourier.append({"w": w.contiguous()})
        dense = fm.TransposedFieldMLP(fourier, f.enc_freqs, f.bound, f.skip,
                                      leaky=f.leaky, angle_double=False)
        variants[dt] = {"bias": biased, "dense_sin": dense}
    vtwin = twin_of({id(a): b for a, b in zip(
        [variants["bf16"]["bias"], variants["bf16"]["dense_sin"], nets.view,
         *nets.props],
        [variants["f32"]["bias"], variants["f32"]["dense_sin"], n32.view,
         *n32.props])})
    branch_n = {}
    for kind in ("bias", "dense_sin"):
        key = f"asset 32,16 {kind}"
        bnets = copy.copy(nets)
        bnets.field = variants["bf16"][kind]

        def frame():
            return renderer.render_frame(m16, params, rays_o, rays_d,
                                         chunk=SIZE * SIZE, nets=bnets)
        zero()
        out = frame()
        torch.cuda.synchronize()
        branch_n[kind] = [c.launches for c in counters]
        check(branch_n[kind] == TWO_LEVEL_LAUNCHES and bool(
            torch.isfinite(out["image"]).all()),
              f"{key}: launches {branch_n[kind]}, finite image")
        del out
        calls = spied(frame)
        calls["run_tmlp"] = [((x0, bnets.field), {"transposed": True})]
        for name in mlps:
            for a, k in calls[name]:
                hold(key, name, a, k, vtwin, seeded=False)
        launch_t[key] = {name: launch_times(name, calls[name])
                         for name in mlps}
        del calls
    del variants, x0
    torch.cuda.empty_cache()
    log(f"B3 biased / dense-sin at the asset's frame shapes: "
        f"{ {k: errs[k] for k in errs if 'bias' in k or 'dense' in k} }")

    def row(name, kernel, key, launches, launches_of):
        lt = launch_t[key][kernel][0]
        rec = {"name": name, "route": "cuda", "source": SOURCES[kernel][0],
               "replaces": SOURCES[kernel][1], "launches": launches,
               "launches_of": launches_of,
               "max_abs_err": errs[key][kernel],
               "max_abs_err_f32_weights": errs32.get(key, {}).get(kernel),
               "ms": lt["ms"], "plain_ms": lt["plain_ms"],
               "bound_ms": lt["bound_ms"], "bound_by": lt["bound_by"],
               "library_ms": None,
               "library": "none: no single PyTorch call computes this "
                          "function",
               "shape": lt["shape"], "launch_times": launch_t[key][kernel]}
        if "variant" in lt:
            rec["variant"] = lt["variant"]
        return rec

    rows = [
        row("run_tmlp_composite[T=24]", "run_tmlp_composite", "asset 32,24",
            ragged["32,24"]["launches_per_frame"][3],
            "the asset's 512^2 RGB frame at (32, 24)"),
        row("run_tmlp_composite[T=12]", "run_tmlp_composite", "asset 24,12",
            ragged["24,12"]["launches_per_frame"][3],
            "the asset's 512^2 RGB frame at (24, 12)"),
        row("run_tmlp_composite[T=24 packed]", "run_tmlp_composite",
            "asset 32,24 packed", packed_n,
            "the asset's 512^2 packed_epilogue frame at (32, 24)")]
    for kern in mlps:
        for h in HIERARCHIES:
            for dt in ("bf16", "f32"):
                key = f"w256 {h} {dt}"
                rows.append(row(
                    f"{kern}[w256 {h} {dt}]", kern, key,
                    wide["frames"][key]["launches_per_frame"][
                        KERNELS.index(kern)],
                    f"the width-256 field's 512^2 RGB frame at {h}, {dt}"))
        rows.append(row(f"{kern}[w256 train eval f32]", kern,
                        "w256 train eval f32",
                        wide["train"]["eval_launches"][KERNELS.index(kern)],
                        "the width-256 Trainer's 64^2 float32 evaluation "
                        "frame"))
        if kern == "run_tmlp":
            for h in HIERARCHIES:
                for dt in ("bf16", "f32"):
                    fr = wide["feature_render"][f"{h} {dt}"]
                    r = row(f"run_tmlp[w256 feature {h}"
                            f"{' f32' if dt == 'f32' else ''}]", kern,
                            f"w256 feature {h} {dt}", fr["launches"][2],
                            f"the {FEAT_HW} x {FEAT_HW}-ray feature render "
                            f"of a 512^2 interactive frame of the width-256 "
                            f"field with a SAM head at {h}, {dt}; times of "
                            f"its width-256 (field) launch")
                    lt = fr["run_tmlp_launches"][
                        fr["run_tmlp_widths"].index(256)]
                    r.update({kk: lt[kk] for kk in (
                        "ms", "plain_ms", "bound_ms", "bound_by", "shape")})
                    r.update({kk: lt[kk] for kk in (
                        "variant", "bound_3xtf32_ms") if kk in lt})
                    rows.append(r)
        for kind in ("bias", "dense_sin"):
            rows.append(row(
                f"{kern}[{kind}]", kern, f"asset 32,16 {kind}",
                branch_n[kind][KERNELS.index(kern)],
                f"the asset's 512^2 RGB frame at (32, 16) with the {kind} "
                f"field; its run_tmlp launch is the proposal net's, the "
                f"{kind} field's run_tmlp is held at the frame's level-0 "
                f"points"))
    rec.update(max_abs_err=errs, max_abs_err_f32_weights=errs32,
               outputs_past_tol=past, rows=rows,
               f32_ring_launches_held=f32_ring)
    return rec


def limit_phases(torch, np, dev, card, compare, launch_times, kern_fn,
                 model_at, rays_o, rays_d, nets, params, params32):
    """Phases L1-L7 and S: the configurations past the kernels' former
    limits and the sum_after_mlp frame. -> the {"limits": ...} record,
    with the kernel rows of their launches under "rows"."""
    import dataclasses

    from sanerf_tpu_torch.config import ModelConfig, RenderConfig
    from sanerf_tpu_torch.models import fields, renderer
    from sanerf_tpu_torch.models.asset import expected_shapes, params_from_jax
    from sanerf_tpu_torch.ops import fused_mlp_t as fm
    from sanerf_tpu_torch.ops import ray_kernels as rk

    sys.path.insert(0, os.path.join(ROOT, "port_tools"))
    import grid_params as gp

    counters = [rk.ray_level0, rk.ray_level, fm.run_tmlp,
                fm.run_tmlp_composite]
    limit_configs = gp.LIMITS
    rec = {"card": card}
    errs, launch_t, rows = {}, {}, []
    with open(os.path.join(ROOT, "port_tools", "jax_limits.jsonl")) as f:
        jax_ref = {r["name"]: r for r in map(json.loads, f)}
    jax_ref["L7 quality recipe"] = JAX_GRID["quality_recipe"]

    def zero():
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0

    def counts():
        torch.cuda.synchronize()
        return [c.launches for c in counters]

    def spied(fn):
        calls = {}
        with spying(renderer, fields, kern_fn, calls, None):
            fn()
        torch.cuda.synchronize()
        return {n: v for (_, n), v in calls.items()}

    def hold(key, name, a, k, twin, seeded, in_slices=False):
        """A launch against its plain version (with `in_slices` run on
        slices of its rays, plain_in_slices): the ray kernels at RAY_TOL;
        bf16 weights at GRID_TOL (seeded) or MLP_TOL with FLIP_SHARE (the
        asset's), their float32 twins at MLP_F32_TOL and F32_FAITHFUL
        (seeded) or against the float64 plain version."""
        if name.startswith("ray"):
            e, _ = compare(name, a, k, RAY_TOL, flips=False,
                           in_slices=in_slices)
        else:
            e, _ = (compare(name, a, k, GRID_TOL, flips=False,
                            in_slices=in_slices) if seeded
                    else compare(name, a, k, MLP_TOL, flips=True,
                                 in_slices=in_slices))
            if twin is not None:
                compare(name, *twin(a, k), MLP_F32_TOL[name], flips=False,
                        faithful_hold=seeded, in_slices=in_slices)
        errs.setdefault(key, {})[name] = max(
            errs.get(key, {}).get(name, 0.0), e)

    def twin_of(bf, f32):
        pairs = {id(x): y for x, y in zip([*bf.props, bf.field, bf.view],
                                          [*f32.props, f32.field, f32.view])}
        return lambda a, k: (tuple(pairs.get(id(v), v) for v in a),
                             {kk: pairs.get(id(v), v) for kk, v in k.items()})

    def frame_ms(fn, n=4):
        ts_ = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts_.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts_[1:])

    def row(name, kernel, key, launches, launches_of, i=0):
        lt = launch_t[key][kernel][i]
        return {"name": name, "route": "cuda", "source": SOURCES[kernel][0],
                "replaces": SOURCES[kernel][1], "launches": launches,
                "launches_of": launches_of,
                "max_abs_err": errs[key][kernel],
                "ms": lt["ms"], "plain_ms": lt["plain_ms"],
                "bound_ms": lt["bound_ms"], "bound_by": lt["bound_by"],
                "library_ms": None,
                "library": "none: no single PyTorch call computes this "
                           "function",
                "shape": lt["shape"], "launch_times": launch_t[key][kernel]}

    # -- L1: the asset past 128 samples a ray, 512^2 --------------------------
    twin = twin_of(nets, fields.KernelNets(model_at((32, 16)), params32))
    long_rec = {}
    for h, steps in LONG_HIERARCHIES.items():
        key = f"asset {h}"
        model = model_at(steps)

        def frame():
            return renderer.render_frame(model, params, rays_o, rays_d,
                                         chunk=SIZE * SIZE, nets=nets)
        zero()
        out = frame()
        n = counts()
        want = [1, len(steps) - 1, len(steps) - 1, 1]
        check(n == want, f"{key}: launches {n}, expected {want}")
        for kk in ("image", "depth", "weights_sum"):
            check(bool(torch.isfinite(out[kk]).all()), f"{key}: {kk}")
        check(float(out["weights_sum"].min()) > 0.5, f"{key}: weights_sum")
        del out
        calls = spied(frame)
        # each launch of the frame whole, its plain version on slices of
        # SLICE_RAYS rays (the plain composite of the whole frame at once
        # does not fit the card's memory)
        for name in KERNELS:
            for a, k in calls.get(name, []):
                hold(key, name, a, k, twin, seeded=False, in_slices=True)
        launch_t[key] = {name: launch_times(name, calls[name],
                                            in_slices=True)
                         for name in calls}
        del calls
        gap = path_gap(renderer, model, model_at(steps, use_fused_mlp=False),
                       params32, rays_o, rays_d, key)
        long_rec[h] = {"launches_per_frame": n, "frame_ms": frame_ms(frame),
                       "fast_vs_plain_f32": gap}
        if h in JAX_PSNR_LONG_BF16:
            psnr = heldout_psnr(renderer, fields.make_model(
                model.cfg, dataclasses.replace(model.render_cfg,
                                               max_ray_batch=128 * 128)),
                params, nets, dev, h)
            check(abs(psnr - JAX_PSNR_LONG_BF16[h]) <= PSNR_TOL_DB,
                  f"{h}: PSNR {psnr:.3f} dB vs JAX "
                  f"{JAX_PSNR_LONG_BF16[h]:.3f} dB")
            long_rec[h].update(psnr_db=psnr,
                               jax_psnr_db_bf16_cpu=JAX_PSNR_LONG_BF16[h])
        torch.cuda.empty_cache()
        log(f"L1 asset {h}: {long_rec[h]}")
    rec["asset_long_rays"] = long_rec
    rows += [
        row("ray_level[T0=128, T=256]", "ray_level", "asset 128,256",
            long_rec["128,256"]["launches_per_frame"][1],
            f"the asset's 512^2 RGB frame at (128, 256); plain in slices of "
            f"{SLICE_RAYS} rays"),
        row("run_tmlp_composite[T=256]", "run_tmlp_composite",
            "asset 128,256", long_rec["128,256"]["launches_per_frame"][3],
            f"the asset's 512^2 RGB frame at (128, 256), segments of 256; "
            f"plain in slices of {SLICE_RAYS} rays"),
        row("ray_level0[T=256]", "ray_level0", "asset 256,128,64",
            long_rec["256,128,64"]["launches_per_frame"][0],
            f"the asset's 512^2 RGB frame at (256, 128, 64); plain in "
            f"slices of {SLICE_RAYS} rays"),
        row("ray_level[T0=256, T=128]", "ray_level", "asset 256,128,64",
            long_rec["256,128,64"]["launches_per_frame"][1],
            f"the asset's 512^2 RGB frame at (256, 128, 64); plain in "
            f"slices of {SLICE_RAYS} rays")]

    # -- L1-L7 at 64^2: the seeded configurations against the JAX package ----
    o64, d64 = (torch.from_numpy(a).to(dev) for a in gp.frame_rays(64))
    px = torch.tensor(JAX_WIDE["pixels"], device=dev)
    seeded = {}
    for name, (mkw, rkw) in limit_configs.items():
        model = fields.make_model(ModelConfig(**mkw), RenderConfig(**rkw))
        plain = fields.make_model(ModelConfig(**mkw), RenderConfig(
            use_fused_mlp=False, **rkw))
        check(renderer.uses_kernels(model), f"{name}: not on the kernels")
        p32 = params_from_jax(gp.make_flat(expected_shapes(model),
                                           GRID_SEED), model, dev)
        pbf = fields.cast_params(p32, torch.bfloat16)
        nbf, n32 = fields.KernelNets(model, pbf), fields.KernelNets(model,
                                                                    p32)
        zero()
        out = renderer.run_rays(model, p32, o64, d64, nets=n32)
        n = counts()
        check(all(v > 0 for v in n), f"{name}: launches {n}")
        ref = jax_ref[name]
        jax_err = {}
        for kk in ("mean", "image", "depth", "weights_sum"):
            if kk == "mean":
                got_v = np.asarray([float(out[m].double().mean())
                                    for m in ref["mean"]])
                want = np.asarray(list(ref["mean"].values()))
            else:
                got_v = out[kk][px].double().cpu().numpy()
                want = np.asarray(ref[kk])
            d = np.abs(got_v - want)
            jax_err[kk] = float(d.max())
            check(bool((d <= JAX_WIDE_TOL + JAX_WIDE_TOL
                        * np.abs(want)).all()),
                  f"{name}: {kk} off the JAX package's frame: "
                  f"max {d.max():.3g}")
        slow = renderer.run_rays(plain, p32, o64, d64)
        gap = {}
        for kk in ("image", "depth", "weights_sum"):
            d = (out[kk] - slow[kk]).abs()
            over = d > PATH_TOL + PATH_TOL * slow[kk].abs()
            if over.dim() > 1:
                over, d = over.any(dim=-1), d.amax(dim=-1)
            n_over, e = int(over.sum()), float(d.max())
            allowed = (math.floor(DEPTH_SHARE * d.numel()) if kk == "depth"
                       else 0)
            check(n_over <= allowed and (kk != "depth" or e <= DEPTH_MAX),
                  f"{name}: fast path {kk} off the plain path: max {e:.3g}, "
                  f"{n_over} rays past {PATH_TOL}")
            gap[kk] = {"max_abs_err": e, "rays_over": n_over}
        del out, slow
        torch.cuda.synchronize()
        fm.run_tmlp.prop_launches = 0
        calls = spied(lambda: renderer.run_rays(model, pbf, o64, d64,
                                                nets=nbf))
        # the bf16 frame's run_tmlp launches are ModelConfig()'s w64 d4
        # proposal nets', each on prop_kernel
        n_prop = fm.run_tmlp.prop_launches
        check(n_prop == len(calls["run_tmlp"]),
              f"{name}: {n_prop} of {len(calls['run_tmlp'])} proposal "
              f"launches on prop_kernel")
        for kname in KERNELS:
            for a, k in calls.get(kname, []):
                hold(name, kname, a, k, twin_of(nbf, n32), seeded=True)
        launch_t[name] = {kname: launch_times(kname, calls[kname])
                          for kname in calls}
        seeded[name] = {"launches": n, "prop_kernel_launches": n_prop,
                        "vs_jax_max_abs_err": jax_err,
                        "fast_vs_plain_f32": gap}
        del calls, nbf, n32, pbf, p32
        torch.cuda.empty_cache()
        log(f"{name}: {seeded[name]}")
    rec["seeded_64"] = seeded
    # a row a new launch shape: each kernel of the (512, 256) frame, the
    # composite of every other configuration
    for name, kernel in ([("L1 default (512, 256)", k) for k in KERNELS]
                         + [(n, "run_tmlp_composite") for n in limit_configs
                            if not n.startswith("L1")]):
        rows.append(row(f"{kernel}[{name}]", kernel, name,
                        seeded[name]["launches"][KERNELS.index(kernel)],
                        f"{name}: the 64^2 frame of the seeded "
                        f"configuration, bf16"))

    # -- L3 at 512^2 and L5's feature render ---------------------------------
    mkw = limit_configs["L3 width 512"][0]
    model = fields.make_model(ModelConfig(**mkw), RenderConfig(
        num_steps=(32, 16), max_ray_batch=SIZE * SIZE))
    p32 = params_from_jax(gp.make_flat(expected_shapes(model), GRID_SEED),
                          model, dev)
    pbf = fields.cast_params(p32, torch.bfloat16)
    nbf, n32 = fields.KernelNets(model, pbf), fields.KernelNets(model, p32)

    def wide_frame():
        return renderer.render_frame(model, pbf, rays_o, rays_d,
                                     chunk=SIZE * SIZE, nets=nbf)
    zero()
    out = wide_frame()
    n = counts()
    check(n == TWO_LEVEL_LAUNCHES and bool(torch.isfinite(out["image"]).all()),
          f"width 512 at 512^2: launches {n}, finite image")
    del out
    calls = spied(wide_frame)
    key = "L3 width 512, 512^2"
    for kname in KERNELS:
        for a, k in calls.get(kname, []):
            hold(key, kname, a, k, twin_of(nbf, n32), seeded=True,
                 in_slices=True)
    launch_t[key] = {"run_tmlp_composite": launch_times(
        "run_tmlp_composite", calls["run_tmlp_composite"], in_slices=True)}
    rec["w512_512"] = {"launches_per_frame": n, "frame_ms": frame_ms(
        wide_frame)}
    rows.append(row("run_tmlp_composite[L3 width 512, 512^2]",
                    "run_tmlp_composite", key, n[3],
                    f"the width-512 field's 512^2 RGB frame at (32, 16), "
                    f"bf16; plain in slices of {SLICE_RAYS} rays"))
    del calls, nbf, n32, pbf, p32
    torch.cuda.empty_cache()
    # the feature render of geom_feat_dim 31: run_tmlp of 32 outputs, then
    # the composite and the SAM head as plain ops; its launches held (the
    # fast and the plain path differ in depth on a few rays, and the SAM
    # head reads the depth)
    mkw = dict(limit_configs["L5 geo 31"][0], with_sam=True)
    model = fields.make_model(ModelConfig(**mkw), RenderConfig())
    p32 = params_from_jax(gp.make_flat(expected_shapes(model), GRID_SEED),
                          model, dev)
    pbf = fields.cast_params(p32, torch.bfloat16)
    nbf, n32 = fields.KernelNets(model, pbf), fields.KernelNets(model, p32)

    def feature_frame():
        return renderer.run_rays(model, pbf, o64, d64, return_feats=True,
                                 nets=nbf)
    zero()
    got = feature_frame()
    n = counts()
    check(n == [1, 2, 3, 0] and got["samvit"].shape == (64 * 64, 256)
          and bool(torch.isfinite(got["samvit"]).all()),
          f"geo 31 feature render: launches {n}, samvit "
          f"{tuple(got['samvit'].shape)}")
    calls = spied(feature_frame)
    for kname in KERNELS:
        for a, k in calls.get(kname, []):
            hold("L5 geo 31 features", kname, a, k, twin_of(nbf, n32),
                 seeded=True)
    rec["geo31_features"] = {"launches": n}
    del got, calls, nbf, n32, pbf, p32
    torch.cuda.empty_cache()

    # -- L7: the quality recipe's 512^2 frame on the kernels -----------------
    mkw, rkw = limit_configs["L7 quality recipe"]
    model = fields.make_model(ModelConfig(**mkw), RenderConfig(
        max_ray_batch=SIZE * SIZE, **rkw))
    pbf = fields.cast_params(params_from_jax(gp.make_flat(
        expected_shapes(model), GRID_SEED), model, dev), torch.bfloat16)
    nbf = fields.KernelNets(model, pbf)
    check(nbf.field.table_bytes == 93_886_464,
          f"quality recipe: {nbf.field.table_bytes} B of tables")

    def recipe_frame():
        return renderer.render_frame(model, pbf, rays_o, rays_d,
                                     chunk=SIZE * SIZE, nets=nbf)
    zero()
    out = recipe_frame()
    n = counts()
    check(n == GRID_LAUNCHES["128,64,32"] and bool(
        torch.isfinite(out["image"]).all()),
          f"quality recipe 512^2 on the kernels: launches {n}")
    del out
    rec["quality_recipe_512"] = {"launches_per_frame": n,
                                 "frame_ms": frame_ms(recipe_frame),
                                 "table_bytes": nbf.field.table_bytes}
    del nbf, pbf
    torch.cuda.empty_cache()
    log(f"L3 / L5 / L7 frames: {rec['w512_512']}, {rec['geo31_features']}, "
        f"{rec['quality_recipe_512']}")

    # -- S: sum_after_mlp ----------------------------------------------------
    mkw = {"sum_after_mlp": True}
    model = fields.make_model(ModelConfig(**mkw), RenderConfig())
    plain = fields.make_model(ModelConfig(**mkw),
                              RenderConfig(use_fused_mlp=False))
    p32 = params_from_jax(gp.make_flat(expected_shapes(model), GRID_SEED),
                          model, dev)
    pbf = fields.cast_params(p32, torch.bfloat16)
    nbf, n32 = fields.KernelNets(model, pbf), fields.KernelNets(model, p32)
    zero()
    got = renderer.run_rays(model, p32, o64, d64, nets=n32)
    n = counts()
    # the proposal nets' two run_tmlp and the final level's field
    check(n == [1, 2, 3, 0], f"sum_after_mlp: launches {n}, expected "
                             f"[1, 2, 3, 0]")
    ref = renderer.run_rays(plain, p32, o64, d64)
    gap = {}
    for kk in ("image", "weights_sum", "depth"):
        d = (got[kk] - ref[kk]).abs()
        gap[kk] = float(d.max())
        over = d > PATH_TOL + PATH_TOL * ref[kk].abs()
        if over.dim() > 1:
            over = over.any(dim=-1)
        allowed = math.floor(DEPTH_SHARE * d.shape[0]) if kk == "depth" else 0
        check(int(over.sum()) <= allowed
              and (kk != "depth" or gap[kk] <= DEPTH_MAX),
              f"sum_after_mlp: fast path {kk} off the plain path by "
              f"{gap[kk]:.3g}")
    calls = spied(lambda: renderer.run_rays(model, pbf, o64, d64, nets=nbf))
    for kname in KERNELS:
        for a, k in calls.get(kname, []):
            hold("sum_after_mlp", kname, a, k, twin_of(nbf, n32),
                 seeded=True)
    launch_t["sum_after_mlp"] = {"run_tmlp": launch_times(
        "run_tmlp", calls["run_tmlp"])}
    rec["sum_after_mlp"] = {"launches": n, "fast_vs_plain_f32": gap}
    rows.append(row("run_tmlp[sum_after_mlp field]", "run_tmlp",
                    "sum_after_mlp", n[2],
                    "the final-level field of ModelConfig(sum_after_mlp="
                    "True)'s 64^2 frame, bf16 (its third run_tmlp launch)",
                    2))
    del calls, nbf, n32, pbf, p32, got, ref
    torch.cuda.empty_cache()
    log(f"S sum_after_mlp: {rec['sum_after_mlp']}")
    rec.update(max_abs_err=errs, rows=rows)
    return rec


def cli_phase(torch, np, dev, card):
    """Phase C: the CLI's three workloads on scene files, end to end
    (CLI_* settings). -> the {"cli": ...} record; its "summary" lines
    (it/s of each stage, the teacher's forward time, peak memory) are
    printed beside the card's name and power limit."""
    import shutil

    from sanerf_tpu_torch.apps import main as cli
    from sanerf_tpu_torch.data import native_loader
    from sanerf_tpu_torch.data.synthetic import SyntheticSphereDataset
    from sanerf_tpu_torch.models import fields
    from sanerf_tpu_torch.models.sam import convert as sam_convert
    from sanerf_tpu_torch.models.sam import image_encoder as ienc
    from sanerf_tpu_torch.models.sam import predictor as sam_pred
    from sanerf_tpu_torch.ops import fused_mlp_t as fm
    from sanerf_tpu_torch.ops import ray_kernels as rk
    from sanerf_tpu_torch.train.checkpoints import (CheckpointManager,
                                                    flatten_tree)
    from sanerf_tpu_torch.train.distill import SamDistillTrainer
    from sanerf_tpu_torch.train.mask_trainer import MaskTrainer

    sys.path.insert(0, os.path.join(ROOT, "port_tools"))
    from sam_weights import seeded_state_dict
    from scene_files import (write_colmap_scene, write_masks,
                             write_transforms_scene)

    counters = [rk.ray_level0, rk.ray_level, fm.run_tmlp,
                fm.run_tmlp_composite]
    base = os.path.join(ROOT, "build", "chip_smoke_cli")
    shutil.rmtree(base, ignore_errors=True)
    t0 = time.perf_counter()
    ds = SyntheticSphereDataset(H=CLI_SIZE, W=CLI_SIZE, n_views=CLI_VIEWS,
                                scene="textured")
    scene = write_transforms_scene(ds, os.path.join(base, "scene"))
    names = [f"r_{i}" for i in range(CLI_VIEWS)]
    write_masks(scene, "obj_masks", names, (ds.instances >= 2))
    mip = write_colmap_scene(ds, os.path.join(base, "scene_colmap"),
                             np.random.default_rng(0).uniform(
                                 -0.5, 0.5, (64, 3)))
    sam_path = os.path.join(base, "sam_vit_h_seeded.pth")
    torch.save(seeded_state_dict(sam_convert.sam_config_for("vit_h"),
                                 SAM_SEED), sam_path)
    rec = {"size": CLI_SIZE, "views": CLI_VIEWS, "iters": CLI_ITERS,
           "sam_ckpt_bytes": os.path.getsize(sam_path),
           "setup_s": time.perf_counter() - t0}
    check(native_loader.available(),
          f"native loader does not build: {native_loader.build_error()}")
    # stage 1's batches are a function of the seed and their number: the
    # Trainer's 4 threads give the batches of 1
    firsts = []
    for n_threads in (4, 1):
        sampler = native_loader.NativeRaySampler(
            ds.poses, ds.intrinsics, ds.images, 4096, seed=1,
            prefetch_depth=6, n_threads=n_threads)
        firsts.append([sampler.next_batch() for _ in range(12)])
        sampler.close()
    check(all(a["index"] == b["index"]
              and all(np.array_equal(a[k], b[k])
                      for k in ("rays_o", "rays_d", "images"))
              for a, b in zip(*firsts)),
          "native loader: 4 threads drew other batches than 1")
    rec["loader_batches_equal"] = len(firsts[0])
    common = list(CLI_ARGS)
    seen = {"mask_eval": [], "feat_mse": []}

    def drive(stage, argv):
        """main(argv) on the card with the counters set to 0 just before
        and read just after; -> (trainer, record)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        t = time.perf_counter()
        tr = cli.main(argv)
        torch.cuda.synchronize()
        r = {"argv": argv, "seconds": time.perf_counter() - t,
             "launches": dict(zip(KERNELS, [c.launches for c in counters])),
             "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
        check(tr.device.type == "cuda", f"{stage}: not on the card")
        if not argv.count("--test") and os.path.exists(tr.metrics_path):
            with open(tr.metrics_path) as f:
                recs = [json.loads(line) for line in f]
            its = [x["it_per_s"] for x in recs if "it_per_s" in x]
            losses = [v for x in recs for k, v in x.items()
                      if k in ("loss", "feat_mse", "mask_loss")]
            check(all(math.isfinite(v) for v in losses),
                  f"{stage}: a loss is not finite: {losses}")
            if its:
                r["it_per_s"] = statistics.median(its[1:] or its)
        log(f"C {stage}: {r}")
        rec[stage] = r
        return tr

    def frozen_and_moved(stage, tr, ck, heads):
        """The stage-1 leaves bit for bit as the checkpoint holds them, the
        heads away from their initial draw."""
        flat0 = CheckpointManager.load_file(ck)[0]
        flat = flatten_tree(tr.state.params, "params/")
        init = flatten_tree(fields.init_params(
            tr.model, torch.Generator().manual_seed(tr.cfg.seed), dev),
            "params/")
        frozen = [k for k in flat0 if k in flat]
        check(len(frozen) > 0, f"{stage}: nothing handed off")
        for k in frozen:
            check(np.array_equal(flat[k], flat0[k]),
                  f"{stage}: frozen leaf {k} changed")
        moved = [k for k in flat if k.split("/")[1] in heads]
        check(moved and all(not np.array_equal(flat[k], init[k])
                            for k in moved if k.endswith("/w")),
              f"{stage}: a trained head did not move")
        rec[stage].update(frozen_leaves=len(frozen), head_leaves=len(moved))

    # -- C1. stage 1 (the native loader: images and no per-view near/far) ---
    ws1 = os.path.join(base, "ws_rgb")
    tr1 = drive("rgb", [scene, *common, "--workspace", ws1, "--iters",
                        str(CLI_ITERS["rgb"]), "--eval_cnt", "4"])
    with open(tr1.log_path) as f:
        check("[native loader]" in f.read(), "stage 1: no native loader")
    psnrs = [r["PSNRMeter"] for r in tr1.stats["results"]]
    rec["rgb"]["val_psnr"] = psnrs
    check(len(psnrs) >= 2 and psnrs[-1] > psnrs[0],
          f"stage 1: validation PSNR {psnrs} did not rise")
    ck1 = tr1.ckpt_mgr.list_checkpoints()[-1]
    del tr1

    # -- C2. --test on the scene, and on its COLMAP copy --------------------
    tr = drive("test", [scene, *common, "--workspace", ws1, "--test"])
    psnr_test = tr.stats["results"][-1]["PSNRMeter"]
    check(any(f.endswith("_rgb.png")
              for f in os.listdir(os.path.join(ws1, "results"))),
          "--test wrote no frames")
    tr = drive("test_mip", [mip, *common[2:], "--data_type", "mip",
                            "--enable_cam_center", "--workspace", ws1,
                            "--test"])
    psnr_mip = tr.stats["results"][-1]["PSNRMeter"]
    rec["test"]["val_psnr"], rec["test_mip"]["val_psnr"] = psnr_test, psnr_mip
    check(abs(psnr_mip - psnr_test) <= CLI_MIP_PSNR_TOL,
          f"--data_type mip PSNR {psnr_mip} vs llff {psnr_test}")
    del tr

    # -- C3. stage 2 from the stage-1 checkpoint, SAM ViT-H teacher ---------
    orig_train = SamDistillTrainer.train

    def sam_train(self, train_ds, valid_ds=None, *a, **k):
        seen["feat_mse"].append(self.eval_feature_mse(valid_ds, n_frames=1))
        out = orig_train(self, train_ds, valid_ds, *a, **k)
        seen["feat_mse"].append(self.eval_feature_mse(valid_ds, n_frames=1))
        return out

    SamDistillTrainer.train = sam_train
    try:
        tr2 = drive("sam", [scene, *common, "--workspace",
                            os.path.join(base, "ws_sam"), "--with_sam",
                            "--init_ckpt", ck1, "--sam_ckpt", sam_path,
                            "--cache_size", "4", "--cache_interval", "2",
                            "--iters", str(CLI_ITERS["sam"]),
                            "--lr", CLI_SAM_LR])
    finally:
        SamDistillTrainer.train = orig_train
    check(tr2.teacher is not None and tr2.cache.full(),
          "stage 2: no teacher or cache")
    mse0, mse1 = seen["feat_mse"]
    rec["sam"]["feat_mse"] = [mse0, mse1]
    check(math.isfinite(mse1) and mse1 < SAM_LEARN * mse0,
          f"stage 2: feature MSE {mse0} -> {mse1}")
    frozen_and_moved("sam", tr2, ck1, ("s_field_mlp", "samvit_mlp",
                                       "samvit_norm"))
    # the teacher's 1024^2 forward in bf16 (CUDA events)
    teacher = tr2.teacher
    check(all(t.dtype == torch.bfloat16 and t.device.type == "cuda"
              for t in sam_pred._flatten(teacher.params).values()),
          "stage 2: the teacher's weights are not bf16 on the card")
    x = ienc.preprocess(torch.randint(0, 256, (1024, 1024, 3), device=dev,
                                      dtype=torch.uint8), 1024)
    with torch.no_grad():
        feats = sam_pred.encode_image(teacher.cfg, teacher.params, x)
        torch.cuda.synchronize()
        check(feats.shape == (1, 64, 64, 256)
              and bool(torch.isfinite(feats).all()), "teacher features")
        times = []
        for _ in range(3):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            sam_pred.encode_image(teacher.cfg, teacher.params, x)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
    rec["sam"]["teacher_forward_ms"] = statistics.median(times)
    rec["sam"]["teacher_forward_ms_runs"] = times
    rec["sam"]["teacher_dtype"] = str(teacher.params["image_encoder"][
        "patch_embed"]["w"].dtype)
    del tr2, teacher, feats, x
    torch.cuda.empty_cache()

    # -- C4. stage 3 from the stage-1 checkpoint and the per-view masks -----
    orig_mtrain, orig_eval = MaskTrainer.train, MaskTrainer.evaluate_mask

    def mask_train(self, train_ds, valid_ds=None, *a, **k):
        self.evaluate_mask(valid_ds)  # its first value, before training
        return orig_mtrain(self, train_ds, valid_ds, *a, **k)

    def mask_eval(self, *a, **k):
        v = orig_eval(self, *a, **k)
        seen["mask_eval"].append(v)
        return v

    MaskTrainer.train, MaskTrainer.evaluate_mask = mask_train, mask_eval
    try:
        tr3 = drive("mask", [scene, *common, "--workspace",
                             os.path.join(base, "ws_mask"), "--with_mask",
                             "--init_ckpt", ck1, "--mask_folder_name",
                             "obj_masks", "--iters", str(CLI_ITERS["mask"]),
                             "--lr", CLI_MASK_LR])
    finally:
        MaskTrainer.train, MaskTrainer.evaluate_mask = orig_mtrain, orig_eval
    miou = seen["mask_eval"]
    rec["mask"]["val_miou"] = miou
    check(miou[-1] > max(miou[0], MIOU_FLOOR),
          f"stage 3: mIoU {miou[0]} -> {miou[-1]}")
    frozen_and_moved("mask", tr3, ck1, ("m_field_mlp", "mask_mlp"))
    del tr3

    # every kernel of the path ran in the stages' renders: stage 1's and
    # stage 2's frames all four; stage 3's mask frames the three of a
    # render with per-point heads (its composite is a plain op)
    for stage, need in (("rgb", KERNELS), ("test", KERNELS),
                        ("test_mip", KERNELS), ("sam", KERNELS),
                        ("mask", KERNELS[:3])):
        n = rec[stage]["launches"]
        check(all(n[k] > 0 for k in need),
              f"{stage}: a kernel was not launched: {n}")
    rec["summary"] = [
        f"cli {s}: {rec[s].get('it_per_s', float('nan')):.1f} it/s, "
        f"{rec[s]['seconds']:.1f} s, peak {rec[s]['peak_gb']:.2f} GiB"
        for s in ("rgb", "sam", "mask")] + [
        f"cli teacher: SAM ViT-H 1024^2 forward, bf16 weights, "
        f"{rec['sam']['teacher_forward_ms']:.1f} ms (CUDA events, median "
        f"of 3)"]
    ctx = {"base": base, "ds": ds, "scene": scene, "mip": mip,
           "sam_path": sam_path, "ws_rgb": ws1,
           "ws_sam": os.path.join(base, "ws_sam"),
           "ws_mask": os.path.join(base, "ws_mask"), "ck1": ck1}
    return rec, ctx


def apps_phase(torch, np, dev, card, ctx, rays_o, rays_d):
    """Phase D: the apps on phase C's scene files and workspaces (ctx), each
    part with the counters set to 0 just before and read just after, its
    seconds and peak memory. -> the {"apps": ...} record; its "summary"
    lines are printed beside the card's name and power limit. Phase E
    runs on the same directory after it; main deletes it."""
    import dataclasses
    import shutil

    from sanerf_tpu_torch.apps import (auto_generator, batch, evaluation,
                                       gui, open_vocab, sam_project)
    from sanerf_tpu_torch.apps import main as cli
    from sanerf_tpu_torch.apps.interactive import InteractiveSession
    from sanerf_tpu_torch.data.provider import SceneDataset
    from sanerf_tpu_torch.models import fields, import_distill, renderer
    from sanerf_tpu_torch.models.sam import predictor as sam_pred
    from sanerf_tpu_torch.ops import fused_mlp_t as fm
    from sanerf_tpu_torch.ops import gather as ga
    from sanerf_tpu_torch.ops import hashgrid as hg
    from sanerf_tpu_torch.ops import ray_kernels as rk
    from sanerf_tpu_torch.train import checkpoints as ckpt_lib
    from sanerf_tpu_torch.train.trainer import Trainer
    from sanerf_tpu_torch.utils.image import read_png, resize

    counters = [rk.ray_level0, rk.ray_level, fm.run_tmlp,
                fm.run_tmlp_composite]
    base, ds, scene = ctx["base"], ctx["ds"], ctx["scene"]
    rec = {"card": card}

    @contextlib.contextmanager
    def part(name):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        ga.gather_rows.launches = hg._HASH_GRID_FORWARD.launches = 0
        r = rec.setdefault(name, {})
        t = time.perf_counter()
        yield r
        torch.cuda.synchronize()
        r["seconds"] = time.perf_counter() - t
        r["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        r["launches"] = dict(zip(KERNELS, [c.launches for c in counters]))
        r["launches"]["gather_rows"] = ga.gather_rows.launches
        r["launches"]["hash_grid_forward"] = hg._HASH_GRID_FORWARD.launches
        log(f"D {name}: {r}")

    def all_four(name):
        n = rec[name]["launches"]
        check(all(n[k] > 0 for k in KERNELS),
              f"D {name}: a kernel was not launched: {n}")

    def cfg_of(argv):
        return cli.config_from_args(cli.build_parser().parse_args(argv))

    # -- D1. multi-view masks from 3D points: both routes ------------------
    cfg2 = cfg_of([scene, *CLI_ARGS, "--workspace", ctx["ws_sam"],
                   "--with_sam", "--sam_ckpt", ctx["sam_path"]])
    with part("masks") as r:
        tr2 = Trainer("ngp", cfg2, fields.make_model(cfg2.model, cfg2.render),
                      workspace=ctx["ws_sam"])
        check(tr2.global_step > 0, "D1: the stage-2 checkpoint did not load")
        sam = cli.build_sam_predictor(cfg2)
        check(sam is not None, "D1: no SAM predictor")
        views = SceneDataset(cfg2, "all")
        check(len(views) == CLI_VIEWS, f"D1: {len(views)} views")
        # the provider centres and scales the cameras: T' = s T + o
        T, T2 = ds.poses[:, :3, 3], views.poses[:, :3, 3]
        sc = float(np.sqrt(((T2 - T2.mean(0)) ** 2).sum()
                           / ((T - T.mean(0)) ** 2).sum()))
        off = T2.mean(0) - sc * T.mean(0)
        check(np.abs(sc * T + off - T2).max() < 1e-4,
              "D1: the provider's cameras are not a scaled copy")
        el = np.deg2rad(20.0)
        dirs = [(np.cos(a) * np.cos(el), np.sin(el), np.sin(a) * np.cos(el))
                for a in np.arange(8) * np.pi / 4] + [(0.0, 1.0, 0.0)]
        pts = np.asarray([np.asarray(c) + rad * np.asarray(d)
                          for c, rad in APPS_SPHERES for d in dirs],
                         np.float32)
        pts_w = (sc * pts + off).astype(np.float32)
        out_f = os.path.join(base, "labels_feature")
        valid = sam_project.generate_masks(cfg2, views, pts_w, sam, out_f,
                                           trainer=tr2,
                                           use_nerf_feature=True)

        class First:
            """The first n views of a dataset."""

            def __init__(self, d, n):
                self.d, self.n = d, n
                self.H, self.W, self.intrinsics = d.H, d.W, d.intrinsics

            def __len__(self):
                return self.n

            def frame(self, i):
                return self.d.frame(i)

        out_t = os.path.join(base, "labels_teacher")
        valid_t = sam_project.generate_masks(
            cfg2, First(views, APPS_TEACHER_VIEWS), pts_w, sam, out_t,
            trainer=tr2)
    all_four("masks")
    with open(os.path.join(out_f, "valid.json")) as f:
        check(json.load(f) == valid, "D1: valid.json is not what ran")
    check(list(valid) == views.names, "D1: valid.json's views")

    def visible(depth, pose, intr, p, thr):
        """At least one prompt point on screen within thr of the depth."""
        xy, z, on = sam_project.project_to_2d(p, pose, intr, ds.H, ds.W)
        return bool(sum(on[k] and abs(z[k] - depth[int(xy[k, 1]),
                                                   int(xy[k, 0])]) <= thr
                        for k in range(len(p))) >= 1)

    # the occlusion test again on the NeRF's depth (what valid.json must
    # say), and on the fixture's exact depths (how good that depth is)
    want, exact = {}, {}
    for i, name in enumerate(views.names):
        depth = tr2.render_pose(views.poses[i], views.intrinsics, ds.H,
                                ds.W)["depth"].reshape(ds.H, ds.W)
        want[name] = visible(depth, views.poses[i], views.intrinsics, pts_w,
                             0.05)
        exact[name] = visible(ds.depths[i], ds.poses[i], ds.intrinsics, pts,
                              0.05 / sc)
    r["valid_views"] = sum(valid.values())
    r["valid_agrees_with_exact_depth"] = sum(valid[n] == exact[n]
                                             for n in valid)
    check(valid == want and r["valid_views"] > 0,
          f"D1: valid.json {valid} against the depth test's {want}")
    spheres = ds.instances >= 2
    ious = []
    for i, name in enumerate(views.names):
        m = np.load(os.path.join(out_f, f"{name}_masks.npy"))
        check(m.shape == (ds.H, ds.W) and m.dtype == np.int64,
              f"D1: {name}: {m.shape} {m.dtype}")
        if not valid[name]:
            check((m == -1).all(), f"D1: {name}: invalid view not -1")
            continue
        check(set(np.unique(m)) <= {0, 1}, f"D1: {name}: labels")
        check(os.path.exists(os.path.join(out_f, f"{name}_overlay.png")),
              f"D1: {name}: no overlay")
        ious.append(evaluation.eval_iou(m, spheres[i].astype(np.int64)))
    check(valid_t == {n: valid[n] for n in views.names[:APPS_TEACHER_VIEWS]},
          f"D1: the teacher route's visibility {valid_t}")
    # the feature route again on the plain path (use_fused_mlp=False: no
    # kernel renders its depths or features): the label maps must agree on
    # MASK_AGREE of the pixels, as tests/test_torch_apps.py holds the port
    # against JAX. Both routes are held decoded by a float32 copy of the
    # predictor; with the served bf16 one the agreement is reported only:
    # its products round their inputs to bf16, so feature changes of 1e-6
    # relative flip 0.08 % of the labels between two plain runs, and the
    # routes' float32 features differ by up to 1.2e-4 relative
    # (port_tools/d1_agreement.py on an NVIDIA H100 80GB HBM3 at 700 W:
    # 99.967 % with bf16, 100 % with float32; D1 read 99.852 / 99.830 %
    # with bf16 in two runs)
    tr2p = Trainer("ngp", cfg2, fields.make_model(
        cfg2.model, dataclasses.replace(cfg2.render, use_fused_mlp=False)),
        workspace=ctx["ws_sam"])
    check(tr2p.global_step == tr2.global_step,
          "D1: the plain trainer loaded another checkpoint")
    sam32 = sam_pred.SamPredictor(sam.cfg, fields.cast_params(
        {k: sam.params[k] for k in ("prompt_encoder", "mask_decoder")},
        torch.float32), device=dev)
    out_p, out_k32, out_p32 = (os.path.join(base, f"labels_{n}") for n in
                               ("plain", "kernels_f32", "plain_f32"))
    valid_p = sam_project.generate_masks(cfg2, views, pts_w, sam, out_p,
                                         trainer=tr2p, use_nerf_feature=True)
    valid_k32 = sam_project.generate_masks(cfg2, views, pts_w, sam32,
                                           out_k32, trainer=tr2,
                                           use_nerf_feature=True)
    valid_p32 = sam_project.generate_masks(cfg2, views, pts_w, sam32,
                                           out_p32, trainer=tr2p,
                                           use_nerf_feature=True)
    del tr2p, sam32

    def agreement(da, db):
        same = total = 0
        for name in views.names:
            a, b = (np.load(os.path.join(d, f"{name}_masks.npy"))
                    for d in (da, db))
            same += int((a == b).sum())
            total += a.size
        return same, total

    fg = sum(int((np.load(os.path.join(out_f, f"{n}_masks.npy")) == 1).sum())
             for n in views.names)
    same, total = agreement(out_k32, out_p32)
    same16, _ = agreement(out_f, out_p)
    r.update(plain_agreement=same / total, plain_agreement_bf16=same16 / total,
             plain_valid=valid_p, foreground_share=fg / total)
    check(valid_p == valid_k32 == valid_p32 == valid
          and same >= MASK_AGREE * total,
          f"D1: the kernels' labels against the plain path's (float32 "
          f"decoder): valid {valid} / {valid_p} / {valid_k32} / {valid_p32}, "
          f"{same} of {total} pixels agree (bf16 decoder: {same16})")
    ious_t = [evaluation.eval_iou(
        np.load(os.path.join(out_t, f"{n}_masks.npy")),
        spheres[i].astype(np.int64))
        for i, n in enumerate(views.names[:APPS_TEACHER_VIEWS]) if valid[n]]
    # reported, not held: the decoder is seeded, so its masks say nothing
    # of quality until SAM's checkpoint is in the repository
    r["miou_feature_route"] = float(np.mean(ious))
    r["miou_teacher_route"] = float(np.mean(ious_t)) if ious_t else None
    r["ious_feature_route"] = ious

    # -- D2. evaluation of stage 3's test renders against D1's labels ------
    with part("evaluation") as r:
        ws_m = ctx["ws_mask"]
        cli.main([scene, *CLI_ARGS, "--workspace", ws_m, "--with_mask",
                  "--mask_folder_name", "obj_masks", "--test",
                  "--test_split", "train"])
        res_dir = os.path.join(ws_m, "results")
        names = [n for n in views.names
                 if os.path.exists(os.path.join(res_dir, f"{n}_mask.npy"))]
        got = evaluation.evaluate_scene(out_f, res_dir, names, "ours")
    all_four("evaluation")
    ious, accs = [], []
    for n in names:  # the numpy recomputation
        gt = np.load(os.path.join(out_f, f"{n}_masks.npy"))
        pred = np.load(os.path.join(res_dir, f"{n}_mask.npy")).argmax(-1)
        lab = gt != -1
        p, g = (pred > 0) & lab, (gt > 0) & lab
        u = int((p | g).sum())
        ious.append(int((p & g).sum()) / u if u else 1.0)
        accs.append(float(np.mean(p[lab] == g[lab])) if lab.any() else 1.0)
    want = {"miou": float(np.mean(ious)), "acc": float(np.mean(accs)),
            "n_views": len(ious)}
    r.update(got)
    check(len(names) == CLI_VIEWS - 1 and got == want,
          f"D2: evaluate_scene {got} against numpy {want}")

    # -- D3. automatic masks on a rendered feature map ---------------------
    with part("auto_masks") as r:
        intr = views.intrinsics * (AUTO_FEAT / views.H)
        intr[2:] = AUTO_FEAT / 2
        feats = tr2.render_pose(views.poses[1], intr, AUTO_FEAT, AUTO_FEAT,
                                return_feats=True)["samvit"].reshape(
            AUTO_FEAT, AUTO_FEAT, -1)
        kw = dict(pred_iou_thresh=float("-inf"), stability_score_thresh=0.0)
        gen = auto_generator.AutomaticMaskGenerator(sam, **kw)
        t = time.perf_counter()
        masks = gen.generate(features=feats, hw=(AUTO_HW, AUTO_HW))
        r["generate_s"] = time.perf_counter() - t
        # the same generator one point a decode, on the same predictor
        masks1 = auto_generator.AutomaticMaskGenerator(
            sam, points_per_batch=1, **kw).generate(features=feats,
                                                     hw=(AUTO_HW, AUTO_HW))
        # the batched decode against one prompt at a time, float32 weights
        dec = sam_pred.SamPredictor(sam.cfg, fields.cast_params(
            {k: sam.params[k] for k in ("prompt_encoder", "mask_decoder")},
            torch.float32))
        dec.set_features(feats, AUTO_HW, AUTO_HW)
        pts16 = gen.point_grid[:16] * AUTO_HW
        lb, ib = dec.predict_batch(pts16[:, None, :], chunk=16)
        err = 0.0
        for k in range(len(pts16)):
            lo, io, _ = dec.predict(pts16[k:k + 1], np.ones(1, np.int32),
                                    multimask_output=True, return_logits=True)
            for a, b in ((lb[k], lo), (ib[k], io)):
                err = max(err, float((np.abs(a - b)
                                      / (DEC_TOL + DEC_TOL * np.abs(b))
                                      ).max()))
    r.update(points=len(gen.point_grid), masks=len(masks),
             batched_vs_loop_err_ratio=err)
    check(len(gen.point_grid) == 32 * 32 and len(masks) >= 1,
          f"D3: {len(masks)} masks from {len(gen.point_grid)} points")
    agree, score_err = [], 0.0
    for a, b in zip(masks, masks1):
        ma, mb = (auto_generator.rle_to_mask(m["segmentation"])
                  for m in (a, b))
        agree.append(float((ma == mb).mean()))
        check(a["point_coords"] == b["point_coords"]
              and a["crop_box"] == b["crop_box"],
              f"D3: the masks of 64 and of 1 point a decode came from other "
              f"prompts: {a['point_coords']} / {b['point_coords']}")
        for k in ("predicted_iou", "stability_score"):
            score_err = max(score_err, abs(a[k] - b[k])
                            / (BF16_TOL + BF16_TOL * abs(b[k])))
    r.update(one_point_masks=len(masks1), one_point_agreement=agree,
             one_point_score_err_ratio=score_err)
    check(len(masks1) == len(masks) and min(agree) >= MASK_AGREE,
          f"D3: {len(masks)} masks at 64 points a decode, {len(masks1)} at "
          f"1; pixel agreement {agree}")
    check(score_err <= 1.0, f"D3: the scores at 64 and at 1 point a decode "
          f"{score_err} x BF16_TOL apart")
    for m in masks:
        mm = auto_generator.rle_to_mask(m["segmentation"])
        check(mm.shape == (AUTO_HW, AUTO_HW) and int(mm.sum()) == m["area"],
              "D3: a mask's RLE")
    check(err <= 1.0, f"D3: batched decode off the loop: {err} x DEC_TOL")
    del sam, dec, feats, masks, masks1, tr2
    torch.cuda.empty_cache()

    # -- D4. --test --gui, then the viewer with a trainer ------------------
    ws1 = ctx["ws_rgb"]
    with part("gui") as r:
        cli.main([scene, *CLI_ARGS, "--workspace", ws1, "--test", "--gui"])
        frames = sorted(os.listdir(os.path.join(ws1, "gui_frames")))
        imgs = [read_png(os.path.join(ws1, "gui_frames", f)) for f in frames]
    all_four("gui")
    check(frames == [f"frame_{i:03d}.png" for i in range(10)]
          and all(im.shape == (512, 512, 3) for im in imgs),
          f"D4: headless frames {frames}")
    r["frames"] = len(frames)
    cfg1 = cfg_of([scene, *CLI_ARGS, "--workspace", ws1])
    with part("viewer") as r:
        model1 = fields.make_model(cfg1.model, cfg1.render)
        tr1 = Trainer("ngp", cfg1, model1, workspace=ws1)
        train_ds = SceneDataset(cfg1, "train")
        session = InteractiveSession(cfg1, model1, tr1.eval_params(), None,
                                     H=512, W=512)
        viewer = gui.HeadlessViewer(cfg1, session, tr1, train_ds)
        step0, fps, steps = tr1.global_step, [], []
        for _ in range(VIEWER_FRAMES):
            viewer.orbit(30, 0)
            steps.append(viewer.ctrl.train_steps)
            res = viewer.frame()
            check(res.rgb_u8.shape == (512, 512, 3)
                  and np.isfinite(res.rgb).all(), "D4: a viewer frame")
            fps.append(viewer.fps)
    all_four("viewer")
    r.update(fps=fps, train_steps=steps, step0=step0,
             steps_taken=tr1.global_step - step0,
             downscale=viewer.ctrl.downscale)
    check(tr1.global_step - step0 == sum(steps) > 0,
          "D4: the viewer did not train")
    check(session.params is tr1.eval_params(), "D4: stale params")
    del tr1, session, viewer

    # -- D5. the language field at D = LANG_DIM, queries, the CLI ----------
    with part("lang") as r:
        mc5 = dataclasses.replace(cfg1.model, with_sam=True,
                                  sam_feat_dim=LANG_DIM)
        cfg5 = dataclasses.replace(
            cfg1, workspace=os.path.join(base, "ws_lang"), model=mc5,
            train=dataclasses.replace(cfg1.train, lr=LANG_LR),
            sam=dataclasses.replace(cfg1.sam, cache_size=4,
                                    cache_interval=2))
        model5 = fields.make_model(mc5, cfg5.render)
        merged, trainable = ckpt_lib.load_partial_and_freeze(
            ctx["ck1"], fields.init_params(
                model5, torch.Generator().manual_seed(1), dev))
        vocab = np.random.default_rng(5).standard_normal(
            (2, LANG_DIM)).astype(np.float32)
        vocab /= np.linalg.norm(vocab, axis=-1, keepdims=True)

        def regions(img):  # the scene's objects against the white background
            return (img.min(-1) < 245).astype(np.int32)

        tr5 = open_vocab.LangDistillTrainer(
            "lang", cfg5, model5,
            teacher=open_vocab.make_region_teacher(regions, vocab, grid=64),
            workspace=cfg5.workspace, use_checkpoint="scratch",
            trainable=trainable, init_params=merged)
        mse0 = tr5.eval_feature_mse(train_ds, n_frames=2)
        tr5.train(train_ds, max_epoch=LANG_EPOCHS,
                  steps_per_epoch=LANG_STEPS)
        mse1 = tr5.eval_feature_mse(train_ds, n_frames=2)
        b = train_ds.collate_sam(np.random.default_rng(0), index=0)
        with torch.no_grad():
            fmap = renderer.run_rays(
                model5, tr5.eval_params(),
                torch.as_tensor(b["rays_o_lr"], device=dev),
                torch.as_tensor(b["rays_d_lr"], device=dev),
                return_feats=True)["samvit"]
            rgb = renderer.render_staged(
                model5, tr5.eval_params(),
                torch.as_tensor(b["rays_o"], device=dev),
                torch.as_tensor(b["rays_d"], device=dev))["image"]
        h, w = b["h"], b["w"]
        check(tuple(fmap.shape) == (h * w, LANG_DIM)
              and bool(torch.isfinite(fmap).all()), "D5: the feature map")
        mask, rel, peak = open_vocab.text_query_mask(
            fmap.reshape(h, w, -1), vocab[1], vocab[:1])
        u8 = (np.clip(rgb.float().cpu().numpy(), 0, 1) * 255).astype(
            np.uint8).reshape(b["H"], b["W"], 3)
        gt = resize(regions(u8).astype(np.uint8), (w, h),
                    "nearest").astype(bool)
        r.update(feat_mse=[mse0, mse1], steps=LANG_EPOCHS * LANG_STEPS,
                 query_iou=float((mask & gt).sum() / max((mask | gt).sum(),
                                                         1)),
                 query_peak=peak)
        # the offline query through the module's entry point, on stage 2
        npz = os.path.join(base, "vocab.npz")
        v256 = np.random.default_rng(6).standard_normal(
            (5, cfg2.model.sam_feat_dim)).astype(np.float32)
        np.savez(npz, **{p: v256[i] for i, p in enumerate(
            ("a sphere", *open_vocab.CANONICAL_NEGATIVES))})
        out_ov = os.path.join(base, "open_vocab")
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "sanerf_tpu_torch.apps.open_vocab", scene,
             *CLI_ARGS, "--workspace", ctx["ws_sam"], "--with_sam",
             "--vocab", npz, "--phrase", "a sphere", "--out_dir", out_ov],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        r["cli_s"] = time.perf_counter() - t
        log(proc.stdout[-2000:] + proc.stderr[-2000:])
    all_four("lang")
    check(math.isfinite(mse1) and mse1 < SAM_LEARN * mse0,
          f"D5: feature MSE {mse0} -> {mse1}")
    check(proc.returncode == 0, f"D5: open_vocab exited {proc.returncode}")
    rels = [np.load(os.path.join(out_ov, f))
            for f in sorted(os.listdir(out_ov)) if f.endswith("_relevancy.npy")]
    check(len(rels) > 0 and all(np.isfinite(x).all() and (x > 0).all()
                                and (x < 1).all() for x in rels),
          "D5: open_vocab's relevancy maps")
    r["cli_maps"] = len(rels)
    del tr5, fmap, rgb
    torch.cuda.empty_cache()

    # -- D6. the batch driver's eval over the llff and mip copies ----------
    with part("batch") as r:
        trials = os.path.join(base, "trials")
        for name, dtype in (("scene", "llff"), ("scene_colmap", "mip")):
            ws = os.path.join(trials, f"{name}_rgb")
            shutil.copytree(os.path.join(ws1, "checkpoints"),
                            os.path.join(ws, "checkpoints"))
            batch.main(["eval-rgb", "--data_root", base, "--out_root",
                        trials, "--data_type", dtype, "--scenes", name])
            pngs = [f for f in os.listdir(os.path.join(ws, "results"))
                    if f.endswith("_rgb.png")]
            check(len(pngs) > 0, f"D6: {name}: no frames")
            r[name] = len(pngs)
    all_four("batch")

    # -- D7. import distillation: hash-grid teacher -> the asset's MLP -----
    with part("hash_teacher") as r:
        trh = cli.main([scene, *CLI_ARGS, "--field_type", "hashgrid",
                        "--workspace", os.path.join(base, "ws_hash"),
                        "--iters", str(HASH_TEACHER_ITERS), "--eval_cnt",
                        "1"])
        r["val_psnr"] = trh.stats["results"][-1]["PSNRMeter"]
    check(rec["hash_teacher"]["launches"]["hash_grid_forward"] > 0,
          "D7: the hash-grid teacher launched no hash_grid_forward")
    tm, tp = trh.model, trh.eval_params()
    with part("distill") as r:
        sm = fields.make_model(import_distill.student_config(
            tm.cfg, **DISTILL_STUDENT), tm.render_cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        sm, sp, report = import_distill.distill_to_mlp(
            tm, tp, gen, student_model=sm, render_check=2, render_hw=128,
            **DISTILL)
    check(r["launches"]["hash_grid_forward"] > 0,
          "D7: the teacher's encode launched no hash_grid_forward")
    hist = report["loss_history"]
    check(all(math.isfinite(v) for v in hist) and hist[-1] < hist[0],
          f"D7: losses {hist[0]} -> {hist[-1]}")
    init = fields.init_params(sm, torch.Generator().manual_seed(
        gen.initial_seed()), dev)
    init["view_mlp"] = tp["view_mlp"]
    psnr0 = import_distill._render_fidelity(tm, tp, sm, init, 2, 128, dev)
    views = SceneDataset(trh.cfg, "all")
    r.update(losses=report["losses"], loss_first=hist[0],
             loss_last=hist[-1], iters=report["iters"],
             render_psnr=report["render_psnr"], untrained_psnr=psnr0,
             views_psnr=views_psnr(tm, tp, sm, sp, views, dev),
             untrained_views_psnr=views_psnr(tm, tp, sm, init, views, dev),
             it_per_s_incl_targets_and_renders=report["iters"]
             / r["seconds"], **{k: v for k, v in DISTILL.items()
                                if k != "iters"})
    check(r["views_psnr"] > r["untrained_views_psnr"] + DISTILL_MARGIN_DB,
          f"D7: the student's views at {r['views_psnr']} dB against the "
          f"untrained student's {r['untrained_views_psnr']}")
    check(report["render_psnr"] > psnr0,
          f"D7: render_psnr {report['render_psnr']} against the untrained "
          f"student's {psnr0}")
    fast = fields.make_model(sm.cfg, dataclasses.replace(
        sm.render_cfg, num_steps=(32, 16), max_ray_batch=SIZE * SIZE))
    slow = fields.make_model(sm.cfg, dataclasses.replace(
        fast.render_cfg, use_fused_mlp=False))
    check(renderer.uses_kernels(fast), "D7: the student is off the kernels")
    with part("student_frame") as r:
        with torch.no_grad():
            out = renderer.render_frame(fast, sp, rays_o, rays_d,
                                        chunk=SIZE * SIZE,
                                        nets=fields.KernelNets(fast, sp))
    check(r["launches"] == {**{k: 1 for k in KERNELS}, "gather_rows": 0,
                            "hash_grid_forward": 0},
          f"D7: the student's frame launched {r['launches']}")
    check(bool(torch.isfinite(out["image"]).all()), "D7: student frame")
    with torch.no_grad():
        r["vs_plain"] = path_gap(renderer, fast, slow, sp, rays_o, rays_d,
                                 "D7 student")
    del trh, tm, tp, sm, sp, init, out
    torch.cuda.empty_cache()

    m, g, l5, d7 = rec["masks"], rec["gui"], rec["lang"], rec["distill"]
    rec["summary"] = [
        f"apps masks: {CLI_VIEWS} views of {ds.H}^2, {m['seconds']:.1f} s, "
        f"{m['valid_views']} valid, mIoU against the spheres "
        f"{m['miou_feature_route']:.3f} (seeded SAM ViT-H)",
        f"apps gui: {g['frames']} headless 512^2 frames in "
        f"{g['seconds']:.1f} s (CLI, model load included); viewer with "
        f"training {statistics.median(rec['viewer']['fps']):.2f} fps",
        f"apps auto masks: {rec['auto_masks']['points']} points on a "
        f"{AUTO_FEAT}^2 feature map, {rec['auto_masks']['generate_s']:.1f} s",
        f"apps lang: D={LANG_DIM}, {l5['steps']} steps, feature MSE "
        f"{l5['feat_mse'][0]:.4f} -> {l5['feat_mse'][1]:.4f}, query IoU "
        f"{l5['query_iou']:.3f}",
        f"apps distill: {d7['iters']} steps of 2^15 of 2^22 points, "
        f"{d7['seconds']:.1f} s with the targets and renders; student "
        f"against teacher {d7['views_psnr']:.2f} dB on the scene's views "
        f"(untrained {d7['untrained_views_psnr']:.2f}), render_psnr "
        f"{d7['render_psnr']:.2f} (untrained {d7['untrained_psnr']:.2f})"]
    return rec


# -- phase E: data parallelism (sanerf_tpu_torch/parallel) --------------------

def _replica_lines(path):
    """The '[ckpt] replica digests' lines of a trainer's log -> [[hex, ...]]
    per save."""
    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("[ckpt] replica digests"):
                out.append(line.split(":", 1)[1].split())
    return out


def _logged_psnr(path):
    """The PSNR of the last '[eval epoch' line of a trainer's log."""
    psnr = None
    with open(path) as f:
        for line in f:
            if line.startswith("[eval epoch") and "PSNR = " in line:
                psnr = float(line.split("PSNR = ")[1].split()[0])
    return psnr


def dp_phase(torch, np, dev, card, ctx):
    """Phase E: data parallelism on the card, on phase C's scene files and
    the shipped asset (DP_* settings). E1 and E3 run in a child process
    (`dp_child`: deterministic cuBLAS for E1's bit-for-bit hold, E3's two
    ranks spawned from it); E2 runs the CLI as a user would, its stages 2
    and 3 and --test at once. -> the
    {"dp": ...} record; its "summary" lines are printed beside the card's
    name and power limit."""
    from sanerf_tpu_torch.apps import main as cli

    base, scene = ctx["base"], ctx["scene"]
    rec = {}
    t_all = time.perf_counter()

    # -- E1 and E3 ------------------------------------------------------------
    out = os.path.join(base, "dp_child.json")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    t = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "import chip_smoke; chip_smoke.dp_child(sys.argv[2], sys.argv[3])",
         ROOT, out, base], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        text, _ = child.communicate(timeout=DP_CHILD_TIMEOUT_S)
    finally:
        if child.poll() is None:  # the child and E3's ranks
            os.killpg(child.pid, 9)
            child.wait()
    for line in text.splitlines()[-40:]:
        log(f"  E child: {line}")
    check(child.returncode == 0, f"E1/E3 child exited {child.returncode}")
    with open(out) as f:
        rec.update(json.load(f))
    rec["child_seconds"] = time.perf_counter() - t

    # -- E2. the CLI over two gloo ranks on the card -----------------------
    common = [scene, *CLI_ARGS, "--lr", DP_LR, "--eval_cnt", "1"]
    two = ["--n_devices", "2", "--dist_backend", "gloo"]

    def start_cli(stage, argv):
        """`python -m sanerf_tpu_torch.apps.main argv` in its own process,
        its output to a file; -> what finish_cli needs."""
        out = open(os.path.join(base, f"e2_{stage}.log"), "w")
        p = subprocess.Popen([sys.executable, "-m",
                              "sanerf_tpu_torch.apps.main", *argv, *two],
                             env=env, cwd=ROOT, stdout=out,
                             stderr=subprocess.STDOUT, text=True,
                             start_new_session=True)
        return stage, argv, p, out, time.perf_counter()

    def stop(started):
        """Kills a start_cli process and its ranks if still running."""
        p = started[2]
        if p.poll() is None:
            os.killpg(p.pid, 9)
            p.wait()
        started[3].close()

    def finish_cli(*runs):
        """Waits for start_cli processes (each one's seconds to its own
        end), then checks each record (the replica digests of every save,
        the losses, it/s, the logged PSNR) and keeps it under
        rec["e2_<stage>"]; -> the first one's workspace."""
        ends = {}
        try:
            while len(ends) < len(runs):
                for i, run in enumerate(runs):
                    if i not in ends and run[2].poll() is not None:
                        ends[i] = time.perf_counter()
                check(time.perf_counter() - runs[0][4] < DP_CLI_TIMEOUT_S,
                      "E2: a CLI run did not end")
                time.sleep(0.1)
        finally:
            for run in runs:
                stop(run)
        for i, run in enumerate(runs):
            check_cli(run, ends[i] - run[4])
        return runs[0][1][runs[0][1].index("--workspace") + 1]

    def check_cli(started, seconds):
        stage, argv, p, out, _ = started
        rc = p.returncode
        r = {"argv": argv + two, "seconds": seconds}
        with open(out.name) as f:
            for line in f.read().splitlines()[-12:]:
                log(f"  E2 {stage}: {line}")
        check(rc == 0, f"E2 {stage}: exited {rc}")
        ws = argv[argv.index("--workspace") + 1]
        logp = os.path.join(ws, "log_ngp.txt")
        with open(logp) as f:
            check("2 ranks (gloo)" in f.read(),
                  f"E2 {stage}: not on 2 gloo ranks")
        if stage != "test":  # --test saves nothing; its log is stage 1's
            digests = _replica_lines(logp)
            r["replica_digests"] = digests
            check(digests and all(len(d) == 2 and d[0] == d[1]
                                  for d in digests),
                  f"E2 {stage}: replica digests {digests}")
            with open(os.path.join(ws, "metrics_ngp.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            losses = [v for x in recs for k, v in x.items()
                      if k in ("loss", "feat_mse", "mask_loss")]
            check(losses and all(math.isfinite(v) for v in losses),
                  f"E2 {stage}: losses {losses}")
            r["losses"] = losses
            its = [x["it_per_s"] for x in recs if "it_per_s" in x]
            if its:
                r["it_per_s"] = statistics.median(its)
        r["psnr"] = _logged_psnr(logp)
        log(f"E2 {stage}: {r}")
        rec[f"e2_{stage}"] = r

    ws = finish_cli(start_cli("rgb", common + [
        "--workspace", os.path.join(base, "ws_dp"), "--iters",
        str(DP_ITERS)]))
    ck = sorted(f for f in os.listdir(os.path.join(ws, "checkpoints"))
                if "_step" in f)[-1]
    ck = os.path.join(ws, "checkpoints", ck)
    # the same steps on one rank, in this process
    t = time.perf_counter()
    tr = cli.main(common + ["--workspace", os.path.join(base, "ws_dp1"),
                            "--iters", str(DP_ITERS)])
    psnr1 = tr.stats["results"][-1]["PSNRMeter"]
    rec["e2_rgb_1rank"] = {"seconds": time.perf_counter() - t,
                           "psnr": psnr1}
    del tr
    torch.cuda.empty_cache()
    psnr2 = rec["e2_rgb"]["psnr"]
    check(psnr2 is not None and abs(psnr2 - psnr1) < DP_PSNR_TOL_DB,
          f"E2: 2-rank PSNR {psnr2} against 1-rank {psnr1}")
    # stages 2 and 3 and --test need only stage 1's checkpoint: they run
    # at once (6 ranks on the card; their it/s are not one stage's alone)
    t = time.perf_counter()
    finish_cli(
        start_cli("sam", [scene, *CLI_ARGS, "--workspace",
                          os.path.join(base, "ws_dp_sam"), "--with_sam",
                          "--init_ckpt", ck, "--sam_ckpt", ctx["sam_path"],
                          "--cache_size", "2", "--cache_interval", "2",
                          "--iters", "1", "--lr", CLI_SAM_LR]),
        start_cli("mask", [scene, *CLI_ARGS, "--workspace",
                           os.path.join(base, "ws_dp_mask"), "--with_mask",
                           "--init_ckpt", ck, "--mask_folder_name",
                           "obj_masks", "--iters", "1", "--lr",
                           CLI_MASK_LR]),
        start_cli("test", common + ["--workspace", ws, "--test"]))
    rec["e2_concurrent_seconds"] = time.perf_counter() - t
    check(rec["e2_test"]["psnr"] is not None
          and math.isfinite(rec["e2_test"]["psnr"]),
          f"E2: --test PSNR {rec['e2_test']['psnr']}")
    rec["seconds"] = time.perf_counter() - t_all
    e1, e3 = rec["e1"], rec["e3"]
    rec["summary"] = [
        f"dp E1: NCCL 1-rank DP step = single step bit for bit, "
        f"{DP_STEPS} steps of {DP_RAYS} rays at (128, 64, 32), "
        f"{e1['dp_step_ms']:.1f} ms a step against "
        f"{e1['single_step_ms']:.1f}; its {e1['frame_rays']}-ray sharded "
        f"frame, barrier, object broadcast and replica check on NCCL",
        f"dp E2: 2 gloo ranks on one card, stage 1 {DP_ITERS} steps "
        f"{rec['e2_rgb'].get('it_per_s', float('nan')):.1f} it/s, PSNR "
        f"{psnr2:.2f} dB (1 rank {psnr1:.2f}); stages 2, 3 and --test; "
        f"replicas equal at every save",
        *(f"dp E3 {h}: sharded 512^2 frame {e3['dp_render_ms'][h]:.1f} ms "
          f"(1 rank {e3['single_render_ms'][h]:.1f}), interactive "
          f"{e3['sharded_frame_ms'][h]:.1f} ms (1 rank "
          f"{e3['single_frame_ms'][h]:.1f}); gloo gathers through the host"
          for h in HIERARCHIES),
        f"dp phase: {rec['seconds']:.1f} s"]
    return rec


def _digest_hex(dp, state):
    return dp.replica_digest(state).hex()


def dp_child(out_path, base):
    """E1, then E3's two ranks; writes their records to out_path (run in a
    process of its own by dp_phase)."""
    import tempfile

    import torch.multiprocessing as mp

    rec = {"e1": e1_nccl()}
    store = tempfile.mkdtemp(dir=base)
    t = time.perf_counter()
    ctx = mp.start_processes(e3_rank, nprocs=2, join=False,
                             start_method="spawn",
                             args=(os.path.join(store, "s"), base))
    try:
        while not ctx.join(timeout=5):
            check(time.perf_counter() - t < DP_CHILD_TIMEOUT_S - 60,
                  "E3: the ranks did not end")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = []
    for r in range(2):
        with open(os.path.join(base, f"e3_{r}.json")) as f:
            ranks.append(json.load(f))
    e3 = ranks[0]
    e3["follower"] = ranks[1]
    e3["seconds"] = time.perf_counter() - t
    rec["e3"] = e3
    with open(out_path, "w") as f:
        json.dump(rec, f)


def e1_nccl():
    """E1: the DP step over a 1-rank NCCL group on the card against the
    single-device step, DP_STEPS steps of DP_RAYS rays at ModelConfig()'s
    width and (128, 64, 32), deterministic algorithms on: the params, EMA
    and moments bit for bit (one rank's all-reduce is the identity), and
    two single-device runs bit for bit first (else the hold says
    nothing). Then, on the same group, a sharded evaluation frame of the
    trained EMA weights bit for bit render_staged's, the barrier, the
    object broadcast and the replica check."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from sanerf_tpu_torch.config import ModelConfig, RenderConfig, TrainConfig
    from sanerf_tpu_torch.data.synthetic import SyntheticSphereDataset
    from sanerf_tpu_torch.models import fields, renderer
    from sanerf_tpu_torch.parallel import collectives, dp
    from sanerf_tpu_torch.train import state as st
    from sanerf_tpu_torch.train.tree import leaves_with_paths

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    store = tempfile.mkdtemp()
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(store, "s"), 1), rank=0, world_size=1)
    torch.use_deterministic_algorithms(True)
    try:
        mesh = dp.make_mesh(1, dev)
        check(mesh.backend == "nccl" and mesh.size == 1,
              f"E1: mesh {mesh.backend} x {mesh.size}")
        model = fields.make_model(ModelConfig(), RenderConfig(
            num_steps=(128, 64, 32), bound=4.0))
        tc = TrainConfig(num_rays=DP_RAYS, adaptive_num_rays=False,
                         iters=1000, lr=float(DP_LR))
        ds = SyntheticSphereDataset(H=CLI_SIZE, W=CLI_SIZE,
                                    n_views=CLI_VIEWS, scene="textured")
        params = fields.init_params(model, torch.Generator().manual_seed(0),
                                    dev)

        def run(step, sharded):
            s = st.create_train_state(model, tc, params=params)
            rng = np.random.default_rng(0)
            gen = torch.Generator(device=dev).manual_seed(0)
            losses, times = [], []
            for i in range(DP_STEPS):
                host = {k: v for k, v in ds.collate_train(rng, DP_RAYS).items()
                        if isinstance(v, np.ndarray)}
                b = (dp.shard_batch(host, mesh) if sharded else
                     {k: torch.as_tensor(v, device=dev)
                      for k, v in host.items()})
                draws = st.draw_step(model, tc, DP_RAYS, gen, dev)
                torch.cuda.synchronize()
                t = time.perf_counter()
                s, aux = step(s, b, draws, update_proposal=(
                    st.update_proposal_now(tc, i + 1)))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
                losses.append(float(aux["loss"]))
            return s, losses, times

        single = st.make_rgb_train_step(model, tc)
        s1, l1, t1 = run(single, False)
        s2, _, _ = run(single, False)
        check(_digest_hex(dp, s1) == _digest_hex(dp, s2),
              "E1: two single-device runs differ (not deterministic)")
        sd, ld, td = run(dp.make_dp_train_step(model, tc, mesh), True)
        check(_digest_hex(dp, sd) == _digest_hex(dp, s1),
              "E1: the 1-rank NCCL step differs from the single step")
        check(all(math.isfinite(v) for v in l1 + ld), f"E1: losses {l1}")
        torch.use_deterministic_algorithms(False)
        # the rest of what a multi-card run calls, on NCCL: the sharded
        # evaluation frame, the barrier, the object broadcast and the
        # replica check of a save
        frame = ds.frame(0)
        ro, rd = (torch.as_tensor(frame[k], device=dev)
                  for k in ("rays_o", "rays_d"))
        with torch.no_grad():
            ref = renderer.render_staged(model, sd.ema_params, ro, rd)
        got = dp.render_frame_dp(model, mesh, dp.make_dp_render(model, mesh),
                                 sd.ema_params, ro, rd)
        frame_equal = all(torch.equal(got[k], ref[k])
                          for k in ("image", "depth", "weights_sum"))
        check(frame_equal, "E1: the 1-rank NCCL frame differs from "
              "render_staged's")
        mesh.barrier()
        check(collectives.broadcast_object(mesh, {"path": "x"})
              == {"path": "x"}, "E1: broadcast_object on NCCL")
        check(dp.check_replicas(sd, mesh, "E1")[0] == dp.replica_digest(sd),
              "E1: check_replicas on NCCL")
        return {"steps": DP_STEPS, "rays": DP_RAYS, "losses": ld,
                "single_losses": l1, "digest": _digest_hex(dp, sd),
                "single_step_ms": statistics.median(t1[1:]),
                "dp_step_ms": statistics.median(td[1:]),
                "frame_rays": int(ro.shape[0]), "frame_equal": frame_equal,
                "params": sum(int(t.numel()) for _, t in
                              leaves_with_paths(sd.params))}
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()


def e3_rank(rank, store, base):
    """A rank of E3 (two gloo ranks on one card): writes e3_<rank>.json."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    try:
        rec = {"gloo_cuda": gloo_cuda_probe(torch, dist, timedelta)}
        rec.update(e3_frames(torch, rank))
        with open(os.path.join(base, f"e3_{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def gloo_cuda_probe(torch, dist, timedelta):
    """Which collectives gloo takes as CUDA tensors here (the port's
    collectives hand them to gloo as they are: parallel/collectives.py);
    on a group of its own. -> {op: true or the error, "torch": version}."""
    group = dist.new_group(backend="gloo", timeout=timedelta(seconds=60))
    dev = torch.device("cuda", 0)
    out = {}
    for name, fn in (
            ("all_reduce", lambda t: dist.all_reduce(t, group=group)),
            ("broadcast", lambda t: dist.broadcast(t, 0, group=group)),
            ("all_gather", lambda t: dist.all_gather(
                [torch.empty_like(t) for _ in range(2)], t, group=group))):
        try:
            fn(torch.ones(4, device=dev))
            torch.cuda.synchronize()
            out[name] = True
        except Exception as e:  # a probe: the answer is the error
            out[name] = f"{type(e).__name__}: {e}"[:300]
    dist.destroy_process_group(group)
    out["torch"] = torch.__version__
    return out


#: E3's own follower commands (beside frame_pipeline's CMD_*): set the
#: launch counts to 0, read them
E3_ZERO, E3_READ = 100, 101


def e3_frames(torch, rank):
    """E3 on one rank: the asset's sharded 512^2 frames (render_frame_dp)
    and interactive frames (InteractiveSession with the mesh; rank 1
    follows) at both hierarchies, rank 0 holding each against its
    single-device frame; on both ranks the launch counters set to 0 just
    before one sharded frame and read just after it, every kernel
    launched."""
    import dataclasses

    import numpy as np

    from sanerf_tpu_torch.apps.frame_pipeline import send_command
    from sanerf_tpu_torch.apps.interactive import InteractiveSession
    from sanerf_tpu_torch.data.rays import full_frame_rays
    from sanerf_tpu_torch.models import fields, renderer
    from sanerf_tpu_torch.models.asset import load_asset
    from sanerf_tpu_torch.models.sam import predictor as sam_mod
    from sanerf_tpu_torch.ops import fused_mlp_t as fm
    from sanerf_tpu_torch.ops import ray_kernels as rk
    from sanerf_tpu_torch.parallel import dp
    from sanerf_tpu_torch.utils.camera import fov_to_focal

    dev = dp.local_device("cuda")
    torch.cuda.set_device(dev)
    mesh = dp.make_mesh(2, dev)
    counters = [rk.ray_level0, rk.ray_level, fm.run_tmlp,
                fm.run_tmlp_composite]

    def zero():
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0

    def counts():
        torch.cuda.synchronize()
        return dict(zip(KERNELS, [c.launches for c in counters]))

    asset = os.path.join(ROOT, "assets", "serving_student")
    pose = np.asarray(SERVE_POSE, np.float32)
    focal = fov_to_focal(60.0, SIZE)
    intr = np.asarray([focal, focal, SIZE / 2, SIZE / 2], np.float32)
    mc, rc, p32 = load_asset(asset, device=dev)
    ps = fields.cast_params(p32, torch.bfloat16)
    ro, rd = full_frame_rays(pose, intr, SIZE, SIZE, device=dev)
    rec = {"rank": rank, "dp_render_launches": {}, "dp_render_ms": {},
           "single_render_ms": {}, "render_max_abs_err": {},
           "render_bitwise": {}, "sharded_frame_ms": {},
           "single_frame_ms": {}, "frame_u8_max_diff": {},
           "frame_depth_max_err": {}, "interactive_launches": {}}

    def timed(fn, n=DP_FRAMES):
        ts = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts)

    for h, steps in HIERARCHIES.items():
        model = fields.make_model(mc, dataclasses.replace(
            rc, num_steps=steps, max_ray_batch=SIZE * SIZE))
        fn = dp.make_dp_render(model, mesh)
        dp.render_frame_dp(model, mesh, fn, ps, ro, rd)  # warm-up
        zero()
        out = dp.render_frame_dp(model, mesh, fn, ps, ro, rd)
        rec["dp_render_launches"][h] = counts()
        check(all(v > 0 for v in rec["dp_render_launches"][h].values()),
              f"E3 {h}: a kernel was not launched: "
              f"{rec['dp_render_launches'][h]}")
        rec["dp_render_ms"][h] = timed(
            lambda: dp.render_frame_dp(model, mesh, fn, ps, ro, rd))
        if rank == 0:
            with torch.no_grad():
                ref = renderer.render_staged(model, ps, ro, rd)
            errs = {k: float((out[k].float() - ref[k].float()).abs().max())
                    for k in ("image", "depth", "weights_sum")}
            rec["render_max_abs_err"][h] = errs
            rec["render_bitwise"][h] = all(
                torch.equal(out[k], ref[k])
                for k in ("image", "depth", "weights_sum"))
            check(all(math.isfinite(v) and v <= PATH_TOL
                      for v in errs.values()),
                  f"E3 {h}: sharded frame against one rank's {errs}")
            with torch.no_grad():
                rec["single_render_ms"][h] = timed(
                    lambda: renderer.render_staged(model, ps, ro, rd))
        mesh.barrier()

    # the interactive frame: the asset with a seeded SAM head and decoder
    mcs, rcs, p32s = load_asset(asset, device=dev, with_sam=True, seed=0)
    pss = fields.cast_params(p32s, torch.bfloat16)
    sam_cfg = sam_mod.SamConfig()
    sam_params = fields.cast_params(sam_mod.init_params(
        sam_cfg, torch.Generator().manual_seed(1), dev))
    for h, steps in HIERARCHIES.items():
        model = fields.make_model(mcs, dataclasses.replace(
            rcs, num_steps=steps, max_ray_batch=SIZE * SIZE))

        def session(mesh_, sam=True):
            return InteractiveSession(
                None, model, pss, sam_mod.SamPredictor(
                    sam_cfg, sam_params, device=dev) if sam else None,
                H=SIZE, W=SIZE, device=dev, mesh=mesh_)

        # rank 1 follows without a SAM decoder (as the CLI's followers);
        # rank 0's E3_ZERO / E3_READ commands set its counts to 0 just
        # before the measured sharded frame and read them just after it
        sharded = session(mesh, sam=rank == 0)
        if rank != 0:
            got = {}

            def on_command(head):
                if head[0] == E3_ZERO:
                    zero()
                elif head[0] == E3_READ:
                    got.update(counts())
                else:
                    raise RuntimeError(f"E3: unexpected command {head}")

            sharded.follow(on_command)
            rec["interactive_launches"][h] = got
            check(got and all(v > 0 for v in got.values()),
                  f"E3 {h}: rank 1's sharded interactive frame did not "
                  f"launch every kernel: {got}")
            continue
        single = session(None)
        for s in (single, sharded):
            s.step(pose)
            s.points_3d.append(np.zeros(3, np.float32))
            s.step(pose)
        r1 = single.step(pose, pipelined=False)
        send_command(mesh, E3_ZERO)
        zero()
        r2 = sharded.step(pose, pipelined=False)
        rec["interactive_launches"][h] = counts()
        send_command(mesh, E3_READ)
        check(all(v > 0 for v in rec["interactive_launches"][h].values()),
              f"E3 {h}: rank 0's sharded interactive frame did not launch "
              f"every kernel: {rec['interactive_launches'][h]}")
        du8 = int(np.abs(r1.rgb_u8.astype(np.int32)
                         - r2.rgb_u8.astype(np.int32)).max())
        dd = float(((r1.depth - r2.depth).abs()
                    / (1.0 + r1.depth.abs())).max())
        rec["frame_u8_max_diff"][h], rec["frame_depth_max_err"][h] = du8, dd
        check(du8 <= 1 and dd <= 1e-4,
              f"E3 {h}: sharded interactive frame u8 {du8}, depth {dd}")
        check(r2.mask is not None and bool(torch.isfinite(r2.depth).all()),
              f"E3 {h}: sharded frame's mask or depth")
        rec["single_frame_ms"][h] = timed(
            lambda: single.step(pose, pipelined=False))
        rec["sharded_frame_ms"][h] = timed(
            lambda: sharded.step(pose, pipelined=False))
        sharded.close()
    return rec


# -- phase F: the asset pipeline (sanerf_tpu_torch/tools) ---------------------
#: F1: quality_gate at its defaults (each family's ModelConfig() with
#: prop_resolutions (128, 256), (128, 64, 32), 128^2, 24 views, 1,024 rays),
#: its 20,000 iterations cut to QG_ITERS. The other tools run the shipped
#: asset's shape (cp64@128, width 128, depth 3, sigma-cp32@128, proposal
#: nets w32 d2) and full-width teachers; only their iterations are cut
#: (TOOL_ITERS). Everything is written under build/chip_smoke_tools/, which
#: the phase deletes at its end; assets/ is read, and held unchanged
QG_ITERS = 300
TOOL_ITERS = {"redistill": 300, "finetune": 200, "mask": 200,
              "serve_finetune": 200, "import": 256, "distill_serving": 256}
#: F2: the shipped asset's held-out PSNR at (24, 16), bf16, through the JAX
#: package's XLA path on the CPU, bench.py:149-170 protocol
#: (`JAX_PLATFORMS=cpu python port_tools/jax_psnr_reference.py 24,16`);
#: eval_student's other two hierarchies are phase 4's and B1's constants
JAX_PSNR_24_16_BF16 = 21.256810493932115
#: F3: hierarchy_gate scores a checkpoint's params/ (as JAX's: ROADMAP C4),
#: F1 its EMA; on a copy whose params/ are F1's EMA weights its (128, 64,
#: 32) PSNR must be F1's within this
HGATE_TOL_DB = 0.05
#: F9: the reference-layout .pth's hash tables U(-2, 2)
#: (port_tools/hashgrid_params.py), the grid teacher grid_params.py's
#: quality recipe (94 MB of tables, over the grid budget: the plain path)
TOOL_SEED = 0
#: F9: the side of the frame each tool's output is rendered at
TOOLS_FRAME = 128
#: phase G: hw_parity at the JAX tool's defaults (4,096 rays, (32, 24));
#: two_stage_wall at its configurations and the ViT-H teacher at 1024^2,
#: its 20,000 / 5,000 iterations cut to TSW_ITERS
HW_PARITY_ARGV = ["--rays", "4096", "--steps", "32,24"]
TSW_ITERS = (100, 20)


def tools_phase(torch, np, dev, card):
    """Phase F: the asset pipeline of sanerf_tpu_torch/tools through each
    tool's `main` on the card, each step with the launch counters set to 0
    just before and read just after, its seconds and peak memory. -> the
    {"tools": ...} record; its "summary" lines are printed beside the
    card's name and power limit."""
    import dataclasses
    import hashlib

    from sanerf_tpu_torch.apps.interactive import InteractiveSession
    from sanerf_tpu_torch.config import (ModelConfig, RenderConfig,
                                         config_from_dict)
    from sanerf_tpu_torch.data.rays import full_frame_rays
    from sanerf_tpu_torch.models import fields, import_distill, renderer
    from sanerf_tpu_torch.models.asset import (expected_shapes, load_asset,
                                               load_mask_asset,
                                               params_from_jax)
    from sanerf_tpu_torch.models.sam import predictor as sam_mod
    from sanerf_tpu_torch.ops import fused_mlp_t as fm
    from sanerf_tpu_torch.ops import gather as ga
    from sanerf_tpu_torch.ops import hashgrid as hg
    from sanerf_tpu_torch.ops import ray_kernels as rk
    from sanerf_tpu_torch.tools import (distill_serving, eval_student,
                                        finetune_student, heldout_ring,
                                        hierarchy_gate, import_checkpoint,
                                        mask_asset, pack_asset, quality_gate,
                                        redistill_asset, serve_finetune)
    from sanerf_tpu_torch.train.checkpoints import CheckpointManager
    from sanerf_tpu_torch.train.metrics import PSNRMeter, SSIMMeter
    from sanerf_tpu_torch.train.trainer import Trainer
    from sanerf_tpu_torch.utils.camera import fov_to_focal

    sys.path.insert(0, os.path.join(ROOT, "port_tools"))
    from grid_params import CONFIGS
    from grid_params import make_flat as grid_flat
    from hashgrid_params import make_flat as hash_flat
    from hashgrid_params import reference_state_dict

    t_phase = time.perf_counter()
    base = os.path.join(ROOT, "build", "chip_smoke_tools")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    assets_dir = os.path.join(ROOT, "assets")

    def digest(path):
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    def read_json(path):
        with open(path) as f:
            return json.load(f)

    shipped = {f: digest(os.path.join(assets_dir, f))
               for f in sorted(os.listdir(assets_dir))}
    # the tools' asset: a copy of the shipped one
    asset = os.path.join(base, "asset", "serving_student")
    os.makedirs(os.path.dirname(asset))
    for f in shipped:
        shutil.copy(os.path.join(assets_dir, f), os.path.dirname(asset))
    counters = {"ray_level0": rk.ray_level0, "ray_level": rk.ray_level,
                "run_tmlp": fm.run_tmlp,
                "run_tmlp_composite": fm.run_tmlp_composite,
                "flatten3_nt": rk.flatten3_nt,
                "gather_rows": ga._GATHER_ROWS,
                "gather_rows_backward": ga._GATHER_ROWS_BACKWARD,
                "hash_grid_backward": hg._HASH_GRID_BACKWARD,
                "hash_grid_forward": hg._HASH_GRID_FORWARD}
    rec = {"card": card, "qg_iters": QG_ITERS, "iters": TOOL_ITERS}

    @contextlib.contextmanager
    def step(name):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        r = rec.setdefault(name, {})
        t = time.perf_counter()
        yield r
        torch.cuda.synchronize()
        r["seconds"] = time.perf_counter() - t
        r["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        r["launches"] = {k: c.launches for k, c in counters.items()}
        log(f"F {name}: {r}")

    def served(name, kernels=KERNELS):
        n = rec[name]["launches"]
        check(all(n[k] > 0 for k in kernels),
              f"F {name}: a served kernel was not launched: {n}")

    def finite(name, *values):
        check(all(math.isfinite(float(v)) for v in values),
              f"F {name}: not finite: {values}")

    # -- F1. quality_gate, both families -----------------------------------
    qg = os.path.join(base, "qg")
    for fam in ("mlp", "hashgrid"):
        argv = ["--families", fam, "--iters", str(QG_ITERS), "--workspace",
                qg]
        args = quality_gate.build_parser().parse_args(argv)
        cfg = quality_gate.family_config(fam, args)
        init = Trainer(fam, cfg.replace(workspace=os.path.join(
            base, "qg_init", fam)), fields.make_model(cfg.model, cfg.render),
            use_checkpoint="scratch", metrics=[PSNRMeter(), SSIMMeter()],
            device=dev)
        psnr0 = init.evaluate_one_epoch(heldout_ring(args.H),
                                        save_artifacts=False)["PSNRMeter"]
        del init
        with step(f"quality_gate {fam}") as r:
            (res,) = quality_gate.main(argv, device=dev)
        r.update(psnr=res["psnr"], ssim=res["ssim"], train_s=res["train_s"],
                 it_per_s=QG_ITERS / res["train_s"], psnr_untrained=psnr0)
        finite(f"quality_gate {fam}", res["psnr"], res["ssim"])
        check(res["psnr"] > psnr0,
              f"F1 {fam}: PSNR {res['psnr']} not above the untrained "
              f"model's {psnr0}")
        torch.cuda.empty_cache()
    served("quality_gate mlp")
    n = rec["quality_gate hashgrid"]["launches"]
    check(n["hash_grid_forward"] > 0 and n["hash_grid_backward"] > 0,
          f"F1 hashgrid: encode / table gradient not launched: {n}")

    # -- F2. eval_student on the shipped asset's params --------------------
    meta = read_json(asset + ".json")
    ws_asset = os.path.join(base, "ws_asset")
    _, _, p32 = load_asset(asset, device=dev)
    CheckpointManager(ws_asset, name="ngp").save(0, p32, ema_params=p32,
                                                 full=False)
    with open(os.path.join(ws_asset, "serving_meta.json"), "w") as f:
        json.dump({k: meta[k] for k in ("model_config", "render_config")}, f)
    del p32
    with step("eval_student asset") as r:
        res = eval_student.main([ws_asset], device=dev)
    jax_psnr = {(24, 16): JAX_PSNR_24_16_BF16,
                (32, 24): JAX_PSNR_RAGGED_BF16["32,24"],
                (128, 64, 32): JAX_PSNR_FULL_BF16}
    r["psnr"] = {",".join(map(str, x["num_steps"])): x["psnr"] for x in res}
    r["ssim"] = {",".join(map(str, x["num_steps"])): x["ssim"] for x in res}
    r["jax_psnr_db_bf16_cpu"] = {",".join(map(str, k)): v
                                 for k, v in jax_psnr.items()}
    for x in res:
        want = jax_psnr[tuple(x["num_steps"])]
        check(abs(x["psnr"] - want) <= PSNR_TOL_DB,
              f"F2 {x['num_steps']}: PSNR {x['psnr']} against JAX's {want}")
    served("eval_student asset")

    # -- F3. hierarchy_gate on F1's MLP checkpoint -------------------------
    ck = CheckpointManager(os.path.join(qg, "mlp"), name="mlp").resolve(
        "latest")
    flat, ck_meta = CheckpointManager.load_file(ck)
    ema_ck = os.path.join(base, "mlp_ema_as_params.npz")
    np.savez(ema_ck, **{"params/" + k[4:]: v for k, v in flat.items()
                        if k.startswith("ema/")})
    hargs = ["--views", "8", "--hierarchies", "128,64,32"]
    with step("hierarchy_gate") as r:
        res = hierarchy_gate.main([ck, *hargs, "32,24", "32,16"], device=dev)
    r["psnr"] = {",".join(map(str, x["num_steps"])): x["psnr"] for x in res}
    finite("hierarchy_gate", *r["psnr"].values())
    served("hierarchy_gate")
    with step("hierarchy_gate ema") as r:
        res = hierarchy_gate.main([ema_ck, *hargs], device=dev)
    r["psnr"] = {"128,64,32": res[0]["psnr"]}
    f1 = rec["quality_gate mlp"]["psnr"]
    check(abs(res[0]["psnr"] - f1) <= HGATE_TOL_DB,
          f"F3: hierarchy_gate on F1's EMA weights {res[0]['psnr']} "
          f"against F1's {f1}")
    del flat

    # -- F4. redistill_asset from the asset --------------------------------
    slim = os.path.join(base, "slim")
    with step("redistill_asset") as r:
        out = redistill_asset.main(
            ["--out_workspace", slim, "--teacher", "asset", "--iters",
             str(TOOL_ITERS["redistill"])], asset=asset, device=dev)
    r.update(render_psnr_vs_teacher=out["render_psnr_vs_teacher"],
             losses=out["losses"])
    finite("redistill_asset", out["render_psnr_vs_teacher"],
           *out["losses"].values())
    served("redistill_asset")
    smc = read_json(os.path.join(slim, "serving_meta.json"))["model_config"]
    shape = ("field_type", "mlp_field_width", "mlp_field_depth",
             "mlp_cp_rank", "mlp_cp_res", "mlp_sigma_cp_rank",
             "mlp_sigma_cp_res", "mlp_prop_width", "mlp_prop_depth")
    check(all(smc[k] == meta["model_config"][k] for k in shape),
          "F4: the student is not of the asset's shape")

    # -- F5. finetune_student, then eval_student ---------------------------
    with step("finetune_student") as r:
        out = finetune_student.main([slim, "--iters",
                                     str(TOOL_ITERS["finetune"])],
                                    device=dev)
    r.update(psnr=out["psnr"], ssim=out["ssim"])
    finite("finetune_student", out["psnr"], out["ssim"])
    with step("eval_student slim") as r:
        res = eval_student.main([slim], device=dev)
    r["psnr"] = {",".join(map(str, x["num_steps"])): x["psnr"] for x in res}
    finite("eval_student slim", *r["psnr"].values())
    served("eval_student slim")

    # -- F6. pack_asset, and the packed student served ---------------------
    packed = os.path.join(base, "serving_student")
    with step("pack_asset") as r:
        pack_asset.main([slim, "--out", packed], device=dev)
    with np.load(packed + ".npz") as a, np.load(asset + ".npz") as b:
        check({k: a[k].shape for k in a.files}
              == {k: b[k].shape for k in b.files},
              "F6: the packed npz's keys or shapes are not the asset's")
    mcs, rcs, ps32 = load_asset(packed, device=dev, with_sam=True, seed=0)
    sam_cfg = sam_mod.SamConfig()
    sess = InteractiveSession(
        None, fields.make_model(mcs, dataclasses.replace(
            rcs, num_steps=(32, 16), max_ray_batch=SIZE * SIZE)),
        fields.cast_params(ps32, torch.bfloat16),
        sam_mod.SamPredictor(sam_cfg, fields.cast_params(sam_mod.init_params(
            sam_cfg, torch.Generator().manual_seed(1), dev)), device=dev),
        H=SIZE, W=SIZE, device=dev)
    pose = np.asarray(SERVE_POSE, np.float32)
    sess.step(pose)
    sess.points_3d.append(np.zeros(3, np.float32))
    sess.step(pose)
    with step("packed interactive frame") as r:
        fr = sess.step(pose, pipelined=False)
    check(fr.rgb_u8.shape == (SIZE, SIZE, 3)
          and bool(torch.isfinite(fr.depth).all()) and fr.mask is not None,
          "F6: the packed student's interactive frame")
    served("packed interactive frame")
    del sess, ps32, fr
    torch.cuda.empty_cache()

    # -- F7. mask_asset on the packed asset --------------------------------
    with step("mask_asset") as r:
        out = mask_asset.main(["--iters", str(TOOL_ITERS["mask"]),
                               "--workspace", os.path.join(base, "mask_ws")],
                              asset=packed, device=dev)
    r.update(miou=out["held_out_miou"], miou_before=out["held_out_miou_before"])
    # the mask frames composite on the plain path (JAX's fast_comp is off
    # with return_mask, renderer.py:117): three of the four kernels
    served("mask_asset", KERNELS[:3])
    flat, _ = CheckpointManager.load_file(CheckpointManager(
        os.path.join(base, "mask_ws"), name="mask_asset").resolve("latest"))
    with np.load(packed + ".npz") as z:
        check(sorted(out["frozen"]) == sorted(k[7:] for k in z.files)
              and all(flat[k].tobytes() == z[k].tobytes() for k in z.files),
              "F7: the frozen leaves moved")
    mmc, _, mp = load_mask_asset(packed, device=dev)
    check(mmc.with_mask and "m_field_mlp" in mp, "F7: load_mask_asset")
    del flat, mp

    # -- F8. serve_finetune --pack on a copy of the packed asset -----------
    sf = os.path.join(base, "sf", "serving_student")
    os.makedirs(os.path.dirname(sf))
    for e in (".json", ".npz"):
        shutil.copy(packed + e, sf + e)
    before = digest(sf + ".npz")
    with step("serve_finetune") as r:
        out = serve_finetune.main(
            ["--steps", "32,16", "--iters", str(TOOL_ITERS["serve_finetune"]),
             "--pack", "--workspace", os.path.join(base, "sf_ws")],
            asset=sf, device=dev)
    rose = out["post"]["target"] > out["pre"]["target"]
    r.update(pre=out["pre"], post=out["post"], packed=rose)
    check((digest(sf + ".npz") != before) == rose,
          f"F8: repacked {digest(sf + '.npz') != before}, target PSNR "
          f"{out['pre']} -> {out['post']}")
    served("serve_finetune")

    # -- F9. import_checkpoint both ways; distill_serving ------------------
    focal = fov_to_focal(60.0, TOOLS_FRAME)
    ro, rd = full_frame_rays(pose, np.asarray(
        [focal, focal, TOOLS_FRAME / 2, TOOLS_FRAME / 2], np.float32),
        TOOLS_FRAME, TOOLS_FRAME, device=dev)

    def renders(name, model, params):
        """One TOOLS_FRAME^2 frame of a tool's output in its own counter
        window."""
        with step(name) as r:
            with torch.no_grad():
                img = renderer.render_staged(model, params, ro, rd)["image"]
        check(bool(torch.isfinite(img).all()), f"F9 {name}: not finite")
        r["image_min_mean_max"] = [float(img.min()), float(img.mean()),
                                   float(img.max())]
        return r

    hmodel = fields.make_model(ModelConfig(field_type="hashgrid"),
                               RenderConfig(bound=128.0, contract=True))
    hflat = hash_flat(expected_shapes(hmodel), TOOL_SEED)
    pth = os.path.join(base, "ngp_seeded.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in
                          reference_state_dict(hflat).items()}}, pth)
    with step("import_checkpoint hashgrid") as r:
        out = import_checkpoint.main([pth, "--workspace",
                                      os.path.join(base, "imp_hg"),
                                      "--keep_hashgrid"], device=dev)
    got, _ = CheckpointManager.load_file(out["checkpoint"])
    check(all(got[k].tobytes() == v.tobytes() for k, v in hflat.items()),
          "F9: the hash-grid import is not the .pth bit for bit")
    hp = params_from_jax(got, hmodel, dev)
    n = renders("import_checkpoint hashgrid frame", hmodel, hp)["launches"]
    check(n["hash_grid_forward"] > 0 and n["gather_rows"] == 0,
          f"F9: the hash-grid frame's encode: {n}")
    del got, hp
    with step("import_checkpoint mlp") as r:
        out = import_checkpoint.main(
            [pth, "--workspace", os.path.join(base, "imp_mlp"), "--iters",
             str(TOOL_ITERS["import"])], device=dev)
    r.update(render_psnr=out["render_psnr"], losses=out["losses"])
    finite("import_checkpoint mlp", out["render_psnr"],
           *out["losses"].values())
    check(r["launches"]["hash_grid_forward"] > 0,
          "F9: the teacher's targets launched no hash_grid_forward")
    smodel = fields.make_model(import_distill.student_config(hmodel.cfg),
                               hmodel.render_cfg)
    sp = params_from_jax(CheckpointManager.load_file(out["checkpoint"])[0],
                         smodel, dev)
    renders("import_checkpoint mlp frame", smodel, sp)
    served("import_checkpoint mlp frame")
    del hmodel, hflat, sp
    torch.cuda.empty_cache()

    from sanerf_tpu_torch.apps import main as cli

    recipe = CONFIGS["quality_recipe"]
    flags = ["--mlp_depth", str(recipe["mlp_field_depth"])]
    for k in ("cp_rank", "cp_res", "cp_levels", "vm_rank", "vm_res",
              "vm_levels", "sigma_cp_rank", "sigma_cp_res", "sigma_vm_rank",
              "sigma_vm_res"):
        flags += [f"--{k}", str(recipe[f"mlp_{k}"])]
    flags += ["--bound", "4", "--num_steps", "128", "64", "32"]
    gws = os.path.join(base, "grid_ws")
    gcfg = cli.config_from_args(cli.build_parser().parse_args(
        [".", "--workspace", gws, *flags]))
    gmodel = fields.make_model(gcfg.model, gcfg.render)
    check(all(getattr(gcfg.model, k) == v for k, v in recipe.items()),
          "F9: the CLI's flags do not build the quality recipe")
    gp = params_from_jax(grid_flat(expected_shapes(gmodel), TOOL_SEED),
                         gmodel, dev)
    CheckpointManager(gws, name="ngp").save(0, gp, ema_params=gp, full=False)
    del gp
    with step("distill_serving") as r:
        out = distill_serving.main(
            [".", "--workspace", gws, *flags, "--out_workspace",
             os.path.join(base, "grid_serving"), "--distill_iters",
             str(TOOL_ITERS["distill_serving"])], device=dev)
    r.update(render_psnr=out["render_psnr"], losses=out["losses"])
    finite("distill_serving", out["render_psnr"], *out["losses"].values())
    dmodel = fields.make_model(config_from_dict(
        ModelConfig, read_json(out["meta"])["model_config"]), gcfg.render)
    check(renderer.uses_kernels(dmodel), "F9: the served student is off "
          "the kernels")
    dp = params_from_jax(CheckpointManager.load_file(out["checkpoint"])[0],
                         dmodel, dev)
    renders("distill_serving frame", dmodel, dp)
    served("distill_serving frame")
    del dp, gmodel
    torch.cuda.empty_cache()

    after = {f: digest(os.path.join(assets_dir, f))
             for f in sorted(os.listdir(assets_dir))}
    check(after == shipped, "F: assets/ changed")
    shutil.rmtree(base, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_phase
    q = [rec[f"quality_gate {f}"] for f in ("mlp", "hashgrid")]
    e2 = rec["eval_student asset"]["psnr"]
    rec["summary"] = [
        *(f"tools quality_gate {f}: {x['it_per_s']:.1f} it/s, "
          f"{x['seconds']:.1f} s, {x['peak_gb']:.2f} GiB, PSNR "
          f"{x['psnr_untrained']:.2f} -> {x['psnr']:.2f} dB, SSIM "
          f"{x['ssim']:.4f} ({QG_ITERS} iters)"
          for f, x in zip(("mlp", "hashgrid"), q)),
        f"tools eval_student asset: PSNR {e2} (JAX "
        f"{rec['eval_student asset']['jax_psnr_db_bf16_cpu']})",
        f"tools redistill {rec['redistill_asset']['seconds']:.1f} s, "
        f"render_psnr {rec['redistill_asset']['render_psnr_vs_teacher']:.2f}"
        f"; finetune {rec['finetune_student']['seconds']:.1f} s, PSNR "
        f"{rec['finetune_student']['psnr']}; mask mIoU "
        f"{rec['mask_asset']['miou_before']:.4f} -> "
        f"{rec['mask_asset']['miou']:.4f}; serve_finetune "
        f"{rec['serve_finetune']['pre']} -> {rec['serve_finetune']['post']}",
        f"tools phase F: {rec['seconds']:.1f} s"]
    return rec


# -- phase G: the probes and the pipeline's wall clock (sanerf_tpu_torch/tools)

def probes_phase(torch, np, dev, card):
    """Phase G: hw_parity, probe_gather, kbench and two_stage_wall through
    each tool's `main` on the card, each step with the launch counters set
    to 0 just before and read just after, its seconds and peak memory. ->
    the {"probes": ...} record; its "summary" lines are printed beside the
    card's name and power limit."""
    from sanerf_tpu_torch.ops import fused_mlp_t as fm
    from sanerf_tpu_torch.ops import gather as ga
    from sanerf_tpu_torch.ops import hashgrid as hg
    from sanerf_tpu_torch.ops import ray_kernels as rk
    from sanerf_tpu_torch.tools import (hw_parity, kbench, probe_gather,
                                        two_stage_wall)

    t_phase = time.perf_counter()
    counters = {"ray_level0": rk.ray_level0, "ray_level": rk.ray_level,
                "run_tmlp": fm.run_tmlp,
                "run_tmlp_composite": fm.run_tmlp_composite,
                "flatten3_nt": rk.flatten3_nt,
                "gather_rows": ga._GATHER_ROWS,
                "gather_rows_backward": ga._GATHER_ROWS_BACKWARD,
                "hash_grid_backward": hg._HASH_GRID_BACKWARD,
                "hash_grid_forward": hg._HASH_GRID_FORWARD}
    rec = {"card": card, "hw_parity_argv": HW_PARITY_ARGV,
           "tsw_iters": TSW_ITERS}

    @contextlib.contextmanager
    def step(name):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        fm.run_tmlp_composite.packed_launches = 0
        r = rec.setdefault(name, {})
        t = time.perf_counter()
        yield r
        torch.cuda.synchronize()
        r["seconds"] = time.perf_counter() - t
        r["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        r["launches"] = {k: c.launches for k, c in counters.items()}
        r["launches"]["run_tmlp_composite packed"] = (
            fm.run_tmlp_composite.packed_launches)
        log(f"G {name}: {r}")

    # -- G1. hw_parity, plain and with every option --------------------------
    for name, extra, need in (
            ("hw_parity", [], KERNELS),
            ("hw_parity packed flatten", ["--packed", "--flatten"],
             KERNELS + ("flatten3_nt", "run_tmlp_composite packed"))):
        with step(name) as r:
            r["rc"] = hw_parity.main(HW_PARITY_ARGV + extra)
            r["shapes"] = hw_parity.main.results
        check(r["rc"] == 0 and all(x["ok"] for x in r["shapes"].values()),
              f"G {name}: a shape is off: {r['shapes']}")
        # each kernel in every shape's fast render
        check(all(r["launches"][k] > 0 for k in need)
              and all(x["launches"][k] > 0 for x in r["shapes"].values()
                      for k in need if k in x["launches"]),
              f"G {name}: a kernel was not launched: {r['launches']}, "
              f"{r['shapes']}")

    # -- G2. probe_gather ----------------------------------------------------
    with step("probe_gather") as r:
        r["probes"] = probe_gather.main([])
    check(all(p["bit_exact"] for p in r["probes"] if p["kernel"])
          and sum(p["kernel"] for p in r["probes"]) == 8,
          "G probe_gather: a kernel probe is not bit for bit")
    check(r["launches"]["gather_rows"] > 0, "G probe_gather: no launch")

    # -- G3. kbench -----------------------------------------------------------
    with step("kbench") as r:
        r["rows"] = kbench.main([])
        r["variant_launches"] = kbench.main.launches
    check(all(isinstance(v, float) and math.isfinite(v)
              for k, v in r["rows"].items() if k not in ("rays", "T")),
          f"G kbench: a variant failed: {r['rows']}")

    # -- G4. two_stage_wall, then --resume -------------------------------------
    ws = os.path.join(ROOT, "build", "chip_smoke_two_stage")
    shutil.rmtree(ws, ignore_errors=True)
    argv = ["--iters1", str(TSW_ITERS[0]), "--iters2", str(TSW_ITERS[1]),
            "--workspace", ws]
    with step("two_stage_wall") as r:
        r["json"] = two_stage_wall.main(argv)
    first = r["json"]
    check(list(first) == ["stage1_s", "stage1_iters", "stage2_s",
                          "stage2_iters", "stage2_it_s",
                          "teacher_ms_per_frame", "total_min",
                          "vs_v100_hours", "device"]
          and first["stage1_iters"] == TSW_ITERS[0]
          and first["stage2_iters"] == TSW_ITERS[1]
          and all(math.isfinite(first[k]) and first[k] > 0
                  for k in ("stage1_s", "stage2_s",
                            "teacher_ms_per_frame")),
          f"G two_stage_wall: {first}")
    with step("two_stage_wall resume") as r:
        r["json"] = two_stage_wall.main(argv + ["--resume"])
    check(r["json"]["stage1_s"] == first["stage1_s"]
          and r["json"]["stage2_s"] == first["stage2_s"],
          f"G two_stage_wall --resume did not reuse the stages: "
          f"{r['json']} after {first}")
    shutil.rmtree(ws, ignore_errors=True)

    rec["seconds"] = time.perf_counter() - t_phase
    kb = rec["kbench"]["rows"]
    pg = {p["name"]: p for p in rec["probe_gather"]["probes"]}
    rec["summary"] = [
        *(f"probes {n}: exit {rec[n]['rc']}, worst image / depth / "
          f"weights_sum errors "
          + " / ".join(f"{max(x['errors'][k] for x in rec[n]['shapes'].values()):.2e}"  # noqa: E501
                       for k in ("image", "depth", "weights_sum"))
          + f", {rec[n]['seconds']:.1f} s"
          for n in ("hw_parity", "hw_parity packed flatten")),
        "probes probe_gather: " + ", ".join(
            f"{n} {pg[n].get('m_rows_per_s', math.nan):.0f}" for n in
            ("xla_take", "pallas_dynloop", "pallas_take_small", "p_blk"))
        + " M rows/s",
        "probes kbench (ms): " + ", ".join(
            f"{k} {v if v is not None else math.nan:.3f}"
            for k, v in kb.items() if k not in ("rays", "T")),
        f"probes two_stage_wall {TSW_ITERS}: {first}",
        f"probes phase G: {rec['seconds']:.1f} s"]
    return rec


if __name__ == "__main__":
    main()
