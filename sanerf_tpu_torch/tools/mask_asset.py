"""Train the stage-3 mask head on the serving asset and ship it beside it
(JAX: tools/mask_asset.py).

Freezes every leaf of the asset (`assets/serving_student.*` unless
`main(..., asset=path)`), adds the stage-3 mask field (m_field_mlp +
mask_mlp, the reference's nerf/utils.py:941-1070 workload) with
`n_inst=5`, the textured fixture's labels (0 background, 1 floor, 2-4 the
spheres), trains it with `train/mask_trainer.py` on the fixture's training
rings (the plain path), scores the held-out ring's mIoU before and after
(`evaluate_mask`: renders on the field and ray kernels on the card), and
saves only the mask leaves to `<out>.npz` and `<out>.json`, which
`models/asset.py:load_mask_asset` overlays on the asset. `--out` defaults
to `<asset>_mask`. The trainer's own checkpoint (every leaf) goes to
`--workspace`, a flag of the port's (the JAX tool writes /tmp/mask_asset).

    python -m sanerf_tpu_torch.tools.mask_asset [--iters 1000]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from sanerf_tpu_torch.config import Config, MaskTrainConfig, TrainConfig
from sanerf_tpu_torch.device import resolve_device
from sanerf_tpu_torch.models import fields
from sanerf_tpu_torch.models.asset import load_asset
from sanerf_tpu_torch.tools import (ASSET, epochs, heldout_ring,
                                    training_rings)
from sanerf_tpu_torch.train.checkpoints import flatten_tree, unflatten_like
from sanerf_tpu_torch.train.mask_trainer import MaskTrainer
from sanerf_tpu_torch.train.tree import leaves_with_paths, map_with_path


def main(argv=None, *, asset: str = ASSET, device=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--num_rays", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--H", type=int, default=128)
    ap.add_argument("--views", type=int, default=24)
    ap.add_argument("--n_inst", type=int, default=5)
    ap.add_argument("--out", default=asset + "_mask")
    ap.add_argument("--workspace", default="/tmp/mask_asset")
    args = ap.parse_args(argv)
    dev = resolve_device(device)

    mc, rc, asset_params = load_asset(asset, device=dev)
    # the fixture protocol (quality_gate): bound 4, min_near 0.5
    rc = dataclasses.replace(rc, bound=4.0, min_near=0.5,
                             max_ray_batch=args.H * args.H)
    # sam_use_view_direction as JAX's loader sets it (bench.py:65)
    mc = dataclasses.replace(mc, with_sam=False, sam_use_view_direction=True,
                             with_mask=True, mask_mlp_type="default",
                             n_inst=args.n_inst)
    model = fields.make_model(mc, rc)
    params = fields.init_params(model, torch.Generator().manual_seed(0), dev)
    tmpl = dict(leaves_with_paths(params))
    flat = {k: v for k, v in flatten_tree(asset_params, "").items()
            if k in tmpl and tuple(tmpl[k].shape) == v.shape}
    loaded = set(flat)
    merged = unflatten_like(params, flat)
    # freeze everything the asset provided; train the new mask head only
    trainable = map_with_path(lambda path, _: path not in loaded, params)
    n_train = sum(1 for _, t in leaves_with_paths(trainable) if t)
    print(f"loaded {len(loaded)} asset leaves; training {n_train} mask leaves")

    cfg = Config(workspace=args.workspace, render=rc, model=mc,
                 train=TrainConfig(iters=args.iters, lr=args.lr,
                                   num_rays=args.num_rays,
                                   adaptive_num_rays=False,
                                   eval_cnt=1, save_cnt=1),
                 # label regularization is a patch smoothness prior; these
                 # batches are uniform random rays (collate_mask samples no
                 # patches), so its weight is 0 here (the reference applies
                 # it over 16x16 patches, utils.py:1028-1030)
                 mask=MaskTrainConfig(label_regularization_weight=0.0))
    eval_ds = heldout_ring(args.H)
    tr = MaskTrainer("mask_asset", cfg, model, workspace=cfg.workspace,
                     use_checkpoint="scratch", trainable=trainable,
                     init_params=merged, device=dev)
    miou0 = tr.evaluate_mask(eval_ds)
    max_epoch, steps_per_epoch = epochs(args.iters, per=250)
    tr.train(training_rings(args.H, args.views), max_epoch=max_epoch,
             steps_per_epoch=steps_per_epoch)
    miou1 = tr.evaluate_mask(eval_ds)
    print(f"held-out mIoU {miou0:.4f} -> {miou1:.4f}")

    # only the trained mask leaves: the RGB params stay in the asset
    out = {f"params/{k}": v for k, v in flatten_tree(tr.state.params,
                                                     "").items()
           if k not in loaded}
    np.savez(args.out + ".npz", **out)
    record = {"n_inst": args.n_inst, "mask_mlp_type": mc.mask_mlp_type,
              "held_out_miou": round(float(miou1), 4), "iters": args.iters,
              "model_config": dataclasses.asdict(mc)}
    with open(args.out + ".json", "w") as f:
        json.dump(record, f, indent=1)
    print(f"saved {args.out}.npz ({len(out)} leaves)")
    return {**record, "held_out_miou_before": float(miou0),
            "frozen": sorted(loaded)}


if __name__ == "__main__":
    main()
