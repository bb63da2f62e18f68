"""Serving-hierarchy finetune of the packed asset
(JAX: tools/serve_finetune.py).

The asset is trained at the full (128, 64, 32) hierarchy and served at a
reduced one; the gap between the two is a tax of the sparser sampling.
This tool trains the asset's params briefly AT the target hierarchy
(`--steps`), so the density field adapts to the samples it is rendered
with (the reference serves the hierarchy it trained, main.py:79-80, and
has no such step). It reads `<asset>.{json,npz}` (the shipped asset unless
`main(..., asset=path)`), trains all params with the stage-1 objective on
the fixture's training rings (the Trainer: the plain path), and prints the
held-out ring's PSNR through the serving path (bf16 weights; on the card
the field and ray kernels) at the target hierarchy before, and at the
target and the full hierarchy after. `--pack` overwrites the asset in
place, and only when the target-hierarchy PSNR rose.

    python -m sanerf_tpu_torch.tools.serve_finetune --steps 32,16 --iters 2000 [--pack]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
from typing import Dict

import numpy as np
import torch

from sanerf_tpu_torch.config import (Config, ModelConfig, RenderConfig,
                                     TrainConfig, config_from_dict)
from sanerf_tpu_torch.device import resolve_device
from sanerf_tpu_torch.models import fields
from sanerf_tpu_torch.models.fields import NerfModel, Params
from sanerf_tpu_torch.tools import (ASSET, epochs, heldout_ring,
                                    ring_images, training_rings)
from sanerf_tpu_torch.train.checkpoints import flatten_tree, unflatten_like
from sanerf_tpu_torch.train.metrics import PSNRMeter, SSIMMeter
from sanerf_tpu_torch.train.trainer import Trainer
from sanerf_tpu_torch.train.tree import leaves_with_paths


def _overlay(model: NerfModel, flat: Dict[str, np.ndarray], device
             ) -> Params:
    """The model's seeded params with every `params/` entry of `flat` in
    place; each must be a leaf of the model, of its shape."""
    params = fields.init_params(model, torch.Generator().manual_seed(0),
                                device)
    tmpl = dict(leaves_with_paths(params))
    for k, v in flat.items():
        if k.startswith("params/"):
            k2 = k[len("params/"):]
            if k2 not in tmpl or tuple(tmpl[k2].shape) != v.shape:
                raise ValueError(f"{k}: not a leaf of the model's shape")
    return unflatten_like(params, flat, "params/")


def _eval_psnr(mc: ModelConfig, rc: RenderConfig, flat, steps, device
               ) -> float:
    """Held-out third-ring PSNR through the serving path (bf16)."""
    rc = dataclasses.replace(rc, num_steps=steps, max_ray_batch=128 * 128)
    model = fields.make_model(mc, rc)
    params = fields.cast_params(_overlay(model, flat, device),
                                torch.bfloat16)
    meter = PSNRMeter()
    for img, fr in ring_images(model, params, heldout_ring(), device):
        meter.update(img, fr["images"])
    return float(meter.measure())


def main(argv=None, *, asset: str = ASSET, device=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", default="32,16")
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--grid_lr_mult", type=float, default=10.0)
    ap.add_argument("--num_rays", type=int, default=2048)
    ap.add_argument("--H", type=int, default=128)
    ap.add_argument("--views", type=int, default=24)
    ap.add_argument("--distort", type=float, default=0.02)
    ap.add_argument("--workspace", default="/tmp/serve_finetune")
    ap.add_argument("--pack", action="store_true")
    ap.add_argument("--skip_pre", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    steps = tuple(int(s) for s in args.steps.split(","))

    with open(asset + ".json") as f:
        meta = json.load(f)
    mc = config_from_dict(ModelConfig, meta["model_config"])
    rc = config_from_dict(RenderConfig, meta["render_config"])
    with np.load(asset + ".npz") as z:
        flat = {k: z[k] for k in z.files}

    pre = {}
    if not args.skip_pre:
        pre["target"] = round(_eval_psnr(mc, rc, flat, steps, dev), 3)
        print(json.dumps({"pre": pre}), flush=True)

    # train AT the serving hierarchy
    rc_tr = dataclasses.replace(rc, num_steps=steps,
                                max_ray_batch=args.H * args.H)
    model = fields.make_model(mc, rc_tr)
    tc = TrainConfig(iters=args.iters, lr=args.lr, num_rays=args.num_rays,
                     adaptive_num_rays=False, lambda_distort=args.distort,
                     grid_lr_mult=args.grid_lr_mult, eval_cnt=1, save_cnt=1)
    cfg = Config(workspace=args.workspace, render=rc_tr, model=mc, train=tc)
    if os.path.isdir(args.workspace):
        shutil.rmtree(args.workspace)
    tr = Trainer("sf", cfg, model, workspace=args.workspace,
                 use_checkpoint="scratch",
                 init_params=_overlay(model, flat, dev),
                 metrics=[PSNRMeter(), SSIMMeter()], device=dev)
    max_epoch, steps_per_epoch = epochs(args.iters)
    tr.train(training_rings(args.H, args.views), valid_dataset=None,
             max_epoch=max_epoch, steps_per_epoch=steps_per_epoch)

    new_flat = {"params/" + k: v.astype(np.float32) for k, v in
                flatten_tree(tr.state.ema_params, "").items()}
    post = {
        "target": round(_eval_psnr(mc, rc, new_flat, steps, dev), 3),
        "full": round(_eval_psnr(mc, rc, new_flat, (128, 64, 32), dev), 3),
    }
    report = {"steps": list(steps), "iters": args.iters, "lr": args.lr,
              "pre": pre, "post": post}
    print(json.dumps(report), flush=True)

    if args.pack:
        improved = not pre or post["target"] > pre.get("target", -1)
        if not improved:
            print("no improvement at the target hierarchy; NOT packing")
            return report
        np.savez(asset + ".npz", **new_flat)
        meta.setdefault("provenance", {})["serve_finetune"] = report
        with open(asset + ".json", "w") as f:
            json.dump(meta, f, indent=1, default=str)
        print(f"packed {asset}.npz (finetuned at {steps})")
    return report


if __name__ == "__main__":
    main()
