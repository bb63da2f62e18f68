#!/bin/bash
# Mask quality evaluation (reference scripts/eval_mask.sh)
python -m sanerf_tpu_torch.apps.evaluation --gt_dir "$1" --result_dir "$2" --method ours
