"""Inference-hierarchy quality gate: held-out-ring PSNR of a trained
checkpoint under candidate `num_steps` hierarchies
(JAX: tools/hierarchy_gate.py).

The model is `ModelConfig(field_type, prop_resolutions=(128, 256))` with
the flags' width and factorized grids, rendered in float32 through
`render_staged` (on the card the field and ray kernels) on `--views` views
of the held-out ring at `--H`^2. One JSON line per hierarchy, then each
one's difference from the first.

As in JAX the weights are the checkpoint's `ema_params/` leaves where it
has them, else `params/`. Checkpoints of both frameworks keep the EMA
under `ema/`, so the gate scores the raw weights (ROADMAP queue C, C4).

    python -m sanerf_tpu_torch.tools.hierarchy_gate /path/ckpt.npz \
        --width 128 --hierarchies 128,64,32 48,32 32,24
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from sanerf_tpu_torch.config import ModelConfig, RenderConfig
from sanerf_tpu_torch.device import resolve_device
from sanerf_tpu_torch.models import fields
from sanerf_tpu_torch.tools import heldout_ring, ring_images
from sanerf_tpu_torch.train.checkpoints import CheckpointManager, unflatten_like
from sanerf_tpu_torch.train.metrics import PSNRMeter


def main(argv=None, *, device=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt")
    ap.add_argument("--field_type", default="mlp",
                    choices=["mlp", "hashgrid"])
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--cp_rank", type=int, default=0)
    ap.add_argument("--cp_res", type=int, default=256)
    ap.add_argument("--vm_rank", type=int, default=0)
    ap.add_argument("--vm_res", type=int, default=64)
    ap.add_argument("--H", type=int, default=128)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--min_near", type=float, default=0.5)
    ap.add_argument("--hierarchies", nargs="+",
                    default=["128,64,32", "48,32", "32,24"])
    args = ap.parse_args(argv)
    dev = resolve_device(device)

    mc = ModelConfig(field_type=args.field_type, prop_resolutions=(128, 256))
    if args.width is not None:
        mc = dataclasses.replace(mc, mlp_field_width=args.width)
    if args.cp_rank:
        mc = dataclasses.replace(mc, mlp_cp_rank=args.cp_rank,
                                 mlp_cp_res=args.cp_res)
    if args.vm_rank:
        mc = dataclasses.replace(mc, mlp_vm_rank=args.vm_rank,
                                 mlp_vm_res=args.vm_res)
    eval_ds = heldout_ring(args.H, args.views)
    flat, _ = CheckpointManager.load_file(args.ckpt)
    prefix = ("ema_params/" if any(k.startswith("ema_params/") for k in flat)
              else "params/")

    results = []
    for spec in args.hierarchies:
        steps = tuple(int(s) for s in spec.split(","))
        rc = RenderConfig(num_steps=steps, bound=4.0, contract=True,
                          min_near=args.min_near,
                          max_ray_batch=args.H * args.H)
        model = fields.make_model(mc, rc)
        params = unflatten_like(fields.init_params(
            model, torch.Generator().manual_seed(0), dev), flat, prefix)
        meter = PSNRMeter()
        t0 = time.time()
        for img, fr in ring_images(model, params, eval_ds, dev):
            meter.update(img.reshape(1, args.H, args.H, 3),
                         fr["images"].reshape(1, args.H, args.H, 3))
        r = {"num_steps": steps, "psnr": round(float(meter.measure()), 3),
             "eval_s": round(time.time() - t0, 1)}
        results.append(r)
        print(json.dumps(r), flush=True)
    base = results[0]["psnr"]
    for r in results[1:]:
        print(f"  {r['num_steps']}: {r['psnr'] - base:+.3f} dB vs "
              f"{results[0]['num_steps']}")
    return results


if __name__ == "__main__":
    main()
