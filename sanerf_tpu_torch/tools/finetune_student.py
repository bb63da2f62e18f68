"""Short RGB finetune of a serving-student workspace on the fixture
(JAX: tools/finetune_student.py).

Distillation fits the student to the teacher's field; a short finetune on
the fixture's training rings recovers part of what the field-matching
objective leaves behind. All of the student's params (field, tables,
heads, proposal nets) train with the stage-1 objective at a low lr on the
Trainer (the plain path; its evaluation renders on the kernels), starting
from the workspace's latest checkpoint (its EMA weights), and are saved
back as a later checkpoint step, where `eval_student` and `pack_asset`
take them. Prints the held-out ring's PSNR / SSIM as one JSON line.

    python -m sanerf_tpu_torch.tools.finetune_student /tmp/slim64 [--iters 3000]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from sanerf_tpu_torch.config import (Config, ModelConfig, RenderConfig,
                                     TrainConfig, config_from_dict)
from sanerf_tpu_torch.device import resolve_device
from sanerf_tpu_torch.models import fields
from sanerf_tpu_torch.tools import (epochs, heldout_ring, read_meta,
                                    training_rings)
from sanerf_tpu_torch.train.checkpoints import CheckpointManager
from sanerf_tpu_torch.train.metrics import PSNRMeter, SSIMMeter
from sanerf_tpu_torch.train.trainer import Trainer


def main(argv=None, *, device=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("workspace")
    ap.add_argument("--name", default="ngp")
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grid_lr_mult", type=float, default=10.0)
    ap.add_argument("--num_rays", type=int, default=1024)
    ap.add_argument("--H", type=int, default=128)
    ap.add_argument("--views", type=int, default=24)
    ap.add_argument("--distort", type=float, default=0.02)
    args = ap.parse_args(argv)
    dev = resolve_device(device)

    meta = read_meta(args.workspace)
    mc = config_from_dict(ModelConfig, meta["model_config"])
    rc = dataclasses.replace(
        config_from_dict(RenderConfig, meta["render_config"]),
        max_ray_batch=args.H * args.H)
    model = fields.make_model(mc, rc)
    template = fields.init_params(model, torch.Generator().manual_seed(0),
                                  dev)
    params, ema, _, ck_meta = CheckpointManager(
        args.workspace, name=args.name).load("latest", template,
                                             model_only=True)
    init = ema if ema is not None else params
    start_step = int(ck_meta.get("step", 0))

    tc = TrainConfig(iters=args.iters, lr=args.lr, num_rays=args.num_rays,
                     adaptive_num_rays=False, lambda_distort=args.distort,
                     grid_lr_mult=args.grid_lr_mult, eval_cnt=1, save_cnt=1)
    cfg = Config(workspace=args.workspace, render=rc, model=mc, train=tc)
    tr = Trainer(args.name, cfg, model, workspace=args.workspace,
                 use_checkpoint="scratch", init_params=init,
                 metrics=[PSNRMeter(), SSIMMeter()], device=dev)
    tr.global_step = start_step  # saved under a later step than the distill
    max_epoch, steps_per_epoch = epochs(args.iters)
    tr.train(training_rings(args.H, args.views), valid_dataset=None,
             max_epoch=max_epoch, steps_per_epoch=steps_per_epoch)
    res = tr.evaluate_one_epoch(heldout_ring(args.H))
    out = {"workspace": args.workspace,
           "finetune_iters": args.iters,
           "psnr": round(float(res["PSNRMeter"]), 3),
           "ssim": round(float(res["SSIMMeter"]), 4)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
