"""Two-stage pipeline wall clock on the card with the REAL teacher shape
(JAX: tools/two_stage_wall.py).

The reference trains stage 1 (RGB, 20k iterations) and stage 2 (SAM
feature distillation, 5k iterations with a ViT-H teacher refreshed every
4th step) in about 1 h a scene on a V100 (its readme; scripts/run1.sh).
This tool measures the same pipeline end to end with the teacher at its
real computational shape: the full ViT-H encoder forward at 1024^2 on
seeded weights (`image_encoder.init_params(vit, Generator().manual_seed(7))`;
the encoder's cost does not depend on its weights, and nothing is
downloaded), cast to bf16 and run behind a `SamPredictor` as the CLI runs
its teacher. It prints one JSON line:

  {"stage1_s": ..., "stage1_iters": ..., "stage2_s": ..., "stage2_iters": ...,
   "stage2_it_s": ..., "teacher_ms_per_frame": ..., "total_min": ...,
   "vs_v100_hours": 1.0, "device": ...}

    python -m sanerf_tpu_torch.tools.two_stage_wall [--iters1 20000]
        [--iters2 5000] [--quick] [--resume] [--workspace DIR]

The kernels are built before the clock starts. Resumable across calls:
stage 1's seconds are stamped to <workspace>/s1_wall.json beside its
checkpoint, and with `--resume` a finished stage 1 is reused instead of
retrained (its stamp must name the same `--iters1`). Stage 2 saves a
checkpoint after each epoch and stamps its epochs and seconds so far to
<workspace>/s2_wall.json; with `--resume` an unfinished stage 2 restarts
from its newest checkpoint and its seconds are summed across the calls.
That is the one departure from the JAX tool, whose stage 2 runs in one
process: at 4 it/s its 5,000 steps outlast one call to the card. (A
resumed stage 2 starts with an empty teacher cache and a fresh host RNG.)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from sanerf_tpu_torch.config import (Config, ModelConfig, RenderConfig,
                                     TrainConfig)
from sanerf_tpu_torch.data.synthetic import SyntheticSphereDataset
from sanerf_tpu_torch.device import resolve_device
from sanerf_tpu_torch.models import fields
from sanerf_tpu_torch.models.sam import SamConfig, SamPredictor
from sanerf_tpu_torch.models.sam import image_encoder as ienc
from sanerf_tpu_torch.train import checkpoints as ckpt_lib
from sanerf_tpu_torch.train.distill import SamDistillTrainer
from sanerf_tpu_torch.train.trainer import Trainer
from sanerf_tpu_torch.train.tree import tree_map

#: the seed of the teacher's weights (the JAX tool's jax.random.key(7))
TEACHER_SEED = 7
#: stage 2's steps per epoch, as the JAX tool runs them (min(500, iters2))
EPOCH = 500


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters1", type=int, default=20000)
    ap.add_argument("--iters2", type=int, default=5000)
    ap.add_argument("--H", type=int, default=128)
    ap.add_argument("--views", type=int, default=24)
    ap.add_argument("--num_rays", type=int, default=4096)
    ap.add_argument("--online_resolution", type=int, default=512)
    ap.add_argument("--quick", action="store_true",
                    help="200/100 iters (pipeline smoke, not the headline)")
    ap.add_argument("--resume", action="store_true",
                    help="reuse a completed stage-1 checkpoint + wall stamp; "
                         "restart an unfinished stage 2 from its newest "
                         "checkpoint")
    ap.add_argument("--workspace",
                    default=os.path.join(tempfile.gettempdir(), "two_stage"))
    return ap


def teacher(sam_config: SamConfig, device) -> SamPredictor:
    """The ViT encoder on seeded weights, cast to bf16 on the device (as
    apps/main.py:build_sam_predictor casts the checkpoint's)."""
    enc = ienc.init_params(sam_config.vit,
                           torch.Generator().manual_seed(TEACHER_SEED))
    params = fields.cast_params(
        tree_map(lambda t: t.to(device), {"image_encoder": enc}),
        torch.bfloat16)
    return SamPredictor(sam_config, params, device=device)


def teacher_ms(pred: SamPredictor, resolution: int) -> float:
    """The teacher's ms a frame: the median of 5 `set_image` calls on a
    seeded uint8 frame, after one unmeasured (host clock around each
    synchronised call, as the JAX tool times a fetched forward)."""
    dummy = np.random.default_rng(0).integers(
        0, 255, (resolution, resolution, 3), dtype=np.uint8)
    sync = (torch.cuda.synchronize if pred.device.type == "cuda"
            else (lambda: None))
    pred.set_image(dummy)
    sync()
    times = []
    for _ in range(5):
        t = time.perf_counter()
        pred.set_image(dummy)
        sync()
        times.append(time.perf_counter() - t)
    return statistics.median(times) * 1000


def _read(path: str) -> Optional[Dict]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _write(path: str, rec: Dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rec, f)
    os.replace(tmp, path)


def main(argv=None, *, device=None,
         sam_config: Optional[SamConfig] = None) -> Dict:
    """-> the JSON line's record. `sam_config` replaces ViT-H (the CPU
    tests pass a tiny ViT); the CLI always runs ViT-H."""
    args = build_parser().parse_args(argv)
    if args.quick:
        args.iters1, args.iters2 = 200, 100
    dev = resolve_device(device)
    sam_config = sam_config or SamConfig()
    if dev.type == "cuda":
        from sanerf_tpu_torch.ops import _build

        _build.build_all()  # nvcc before the clock starts
    os.makedirs(args.workspace, exist_ok=True)

    rc = RenderConfig(num_steps=(128, 64, 32), bound=4.0, contract=True,
                      min_near=0.5, max_ray_batch=args.online_resolution ** 2)
    mc1 = ModelConfig(field_type="mlp", prop_resolutions=(128, 256))
    tc1 = TrainConfig(iters=args.iters1, num_rays=args.num_rays,
                      adaptive_num_rays=True, eval_cnt=1, save_cnt=1)
    ds = SyntheticSphereDataset(H=args.H, W=args.H, n_views=args.views,
                                scene="textured")

    # ---- stage 1 ----------------------------------------------------------
    cfg1 = Config(workspace=os.path.join(args.workspace, "s1"),
                  render=rc, model=mc1, train=tc1)
    model1 = fields.make_model(mc1, rc)
    stamp_path = os.path.join(args.workspace, "s1_wall.json")
    tr1 = Trainer("s1", cfg1, model1, workspace=cfg1.workspace,
                  use_checkpoint="latest_model" if args.resume else "scratch",
                  device=dev)
    ckpts = tr1.ckpt_mgr.list_checkpoints()
    stamp = _read(stamp_path)
    if args.resume and ckpts and stamp is not None:
        assert stamp["iters1"] == args.iters1, (
            f"stamped stage-1 ran {stamp['iters1']} iters, asked {args.iters1}")
        stage1_s = stamp["stage1_s"]
        print(f"[resume] stage 1 reused: {ckpts[-1]} ({stage1_s:.0f} s)")
    else:
        t0 = time.time()
        spe = min(500, args.iters1)
        tr1.train(ds, max_epoch=max(1, args.iters1 // spe),
                  steps_per_epoch=spe)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        stage1_s = time.time() - t0
        _write(stamp_path, {"stage1_s": stage1_s, "iters1": args.iters1})
    ckpt = tr1.ckpt_mgr.list_checkpoints()[-1]
    del tr1

    # ---- the REAL-shape teacher ------------------------------------------
    pred = teacher(sam_config, dev)
    t_ms = teacher_ms(pred, args.online_resolution)

    # ---- stage 2, an epoch at a time, stamped after each -----------------
    mc2 = dataclasses.replace(mc1, with_sam=True, sam_use_view_direction=True)
    model2 = fields.make_model(mc2, rc)
    params2 = fields.init_params(model2, torch.Generator().manual_seed(1),
                                 dev)
    merged, trainable = ckpt_lib.load_partial_and_freeze(ckpt, params2)
    cfg2 = Config(
        workspace=os.path.join(args.workspace, "s2"), render=rc, model=mc2,
        train=dataclasses.replace(tc1, iters=args.iters2, lr=5e-3),
        sam=dataclasses.replace(
            Config().sam, online_resolution=args.online_resolution),
    )
    s2_path = os.path.join(args.workspace, "s2_wall.json")
    spe2 = min(EPOCH, args.iters2)
    epochs2 = max(1, args.iters2 // spe2)
    s2 = _read(s2_path) if args.resume else None
    if s2 is not None:
        assert s2["iters2"] == args.iters2, (
            f"stamped stage-2 runs {s2['iters2']} iters, asked {args.iters2}")
    else:
        s2 = {"iters2": args.iters2, "epochs": epochs2, "epochs_done": 0,
              "stage2_s": 0.0, "calls": 0}
    s2["calls"] += 1
    tr2 = SamDistillTrainer(
        "s2", cfg2, model2, teacher=pred, workspace=cfg2.workspace,
        use_checkpoint="latest" if s2["epochs_done"] else "scratch",
        trainable=trainable, init_params=merged, device=dev)
    if s2["epochs_done"]:
        print(f"[resume] stage 2 from epoch {tr2.epoch} of {epochs2} "
              f"({s2['stage2_s']:.0f} s so far)")
        assert tr2.epoch == s2["epochs_done"], (
            f"stage 2's newest checkpoint is epoch {tr2.epoch}, its stamp "
            f"says {s2['epochs_done']}")
    while s2["epochs_done"] < epochs2:
        t0 = time.time()
        tr2.train(ds, max_epoch=1, steps_per_epoch=spe2)  # saves at its end
        if dev.type == "cuda":
            torch.cuda.synchronize()
        s2["stage2_s"] += time.time() - t0
        s2["epochs_done"] += 1
        _write(s2_path, s2)
    stage2_s = s2["stage2_s"]

    total_min = (stage1_s + stage2_s) / 60
    rec = {
        "stage1_s": round(stage1_s, 1),
        "stage1_iters": args.iters1,
        "stage2_s": round(stage2_s, 1),
        "stage2_iters": args.iters2,
        "stage2_it_s": round(args.iters2 / stage2_s, 2),
        "teacher_ms_per_frame": round(t_ms, 1),
        "total_min": round(total_min, 1),
        "vs_v100_hours": 1.0,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
