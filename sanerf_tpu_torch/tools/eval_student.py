"""Held-out fixture PSNR of a serving-student workspace
(JAX: tools/eval_student.py).

Renders the quality gate's held-out third ring (textured fixture, radius
1.8, 8 views, 128^2) through the student's own serving path
(`render_staged`, bf16 weights: on the card the four field and ray
kernels) and prints PSNR / SSIM at (24, 16), (32, 24) and the workspace's
own hierarchy, one JSON line each: the bench.py:149-170 protocol.

    python -m sanerf_tpu_torch.tools.eval_student /tmp/serving_cponly [more...]
    (each directory holds serving_meta.json + checkpoints/ngp_*.npz)
"""

from __future__ import annotations

import dataclasses
import json
import sys

import torch

from sanerf_tpu_torch.config import ModelConfig, RenderConfig, config_from_dict
from sanerf_tpu_torch.device import resolve_device
from sanerf_tpu_torch.models import fields
from sanerf_tpu_torch.tools import heldout_ring, read_meta, ring_images
from sanerf_tpu_torch.train.checkpoints import CheckpointManager
from sanerf_tpu_torch.train.metrics import PSNRMeter, SSIMMeter

HIERARCHIES = ((24, 16), (32, 24), None)


def eval_workspace(ws: str, num_steps=None, bf16: bool = True, *,
                   device=None) -> dict:
    dev = resolve_device(device)
    meta = read_meta(ws)
    mc = config_from_dict(ModelConfig, meta["model_config"])
    rc = config_from_dict(RenderConfig, meta["render_config"])
    if num_steps is not None:
        rc = dataclasses.replace(rc, num_steps=tuple(num_steps))
    model = fields.make_model(mc, rc)
    template = fields.init_params(model, torch.Generator().manual_seed(0),
                                  dev)
    params, ema, _, _ = CheckpointManager(ws, name="ngp").load(
        "latest", template, model_only=True)
    params = ema if ema is not None else params
    if bf16:
        params = fields.cast_params(params, torch.bfloat16)

    ds = heldout_ring()
    psnr, ssim = PSNRMeter(), SSIMMeter()
    for img, fr in ring_images(model, params, ds, dev):
        psnr.update(img, fr["images"])
        ssim.update(img.reshape(ds.H, ds.W, 3),
                    fr["images"].reshape(ds.H, ds.W, 3))
    return {"workspace": ws, "num_steps": list(rc.num_steps),
            "psnr": round(float(psnr.measure()), 3),
            "ssim": round(float(ssim.measure()), 4)}


def main(argv=None, *, device=None) -> list:
    wss = list(sys.argv[1:] if argv is None else argv) or [
        "/tmp/serving_student"]
    resolve_device(device)
    results = []
    for ws in wss:
        for steps in HIERARCHIES:
            r = eval_workspace(ws, num_steps=steps, device=device)
            print(json.dumps(r), flush=True)
            results.append(r)
    return results


if __name__ == "__main__":
    main()
