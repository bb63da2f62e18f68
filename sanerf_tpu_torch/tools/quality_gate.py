"""Field-family quality gate on the adversarial textured fixture
(JAX: tools/quality_gate.py).

Trains both field families (the Fourier-feature MLP and the
multiresolution hash grid) on the textured fixture's two training rings
(three occluding high-frequency spheres over a checkered floor,
data/synthetic.py:ray_textured_scene) with the stage-1 Trainer and scores
the held-out third ring (8 views). Synthetic data only: the numbers are
no parity evidence for real Mip-360 / LLFF scenes. Training runs the plain
path (the hash grid's lookups and their table gradients on `gather_rows`
and its backward on the card); the evaluation renders run on the field and
ray kernels for the MLP family.

    python -m sanerf_tpu_torch.tools.quality_gate --iters 20000 --H 128
    python -m sanerf_tpu_torch.tools.quality_gate --iters 200 --H 32  # quick

`--mlp_width` is the capacity gate: the field width the MLP family needs
at matched quality. `--resume` restores the workspace's latest checkpoint
before training, with the Trainer's restore (a factorized-grid checkpoint
written after a `--upsample_steps` milestone does not resume: ROADMAP C3).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

from sanerf_tpu_torch.config import Config, ModelConfig, RenderConfig, TrainConfig
from sanerf_tpu_torch.device import resolve_device
from sanerf_tpu_torch.models import fields
from sanerf_tpu_torch.tools import epochs, heldout_ring, training_rings
from sanerf_tpu_torch.train.metrics import PSNRMeter, SSIMMeter
from sanerf_tpu_torch.train.trainer import Trainer


def family_config(field_type: str, args,
                  mlp_width: Optional[int] = None) -> Config:
    """The Config `run_family` trains (JAX tools/quality_gate.py:48-81).

    min_near 0.5 is the fixture's geometry: the closest in-frustum content
    is more than 1.1 units from every ring camera. The reference gets the
    same guard from per-view sparse-depth near/far
    (colmap_provider.py:554-600); without it the inward rings admit
    near-plane billboards that fit the training views and score ~7 dB
    held out."""
    mlp = field_type == "mlp"
    rc = RenderConfig(num_steps=tuple(args.num_steps), bound=4.0,
                      contract=True, min_near=args.min_near,
                      max_ray_batch=args.H * args.H)
    mc = ModelConfig(field_type=field_type, prop_resolutions=(128, 256))
    if mlp_width is not None:
        mc = dataclasses.replace(mc, mlp_field_width=mlp_width)
    if args.mlp_depth is not None and mlp:
        # a TensoRF-style grid pairs with a shallow decoder; the 8-layer
        # chain is the pure-Fourier flagship's
        mc = dataclasses.replace(mc, mlp_field_depth=args.mlp_depth)
    if mlp and args.cp_rank:
        mc = dataclasses.replace(mc, mlp_cp_rank=args.cp_rank,
                                 mlp_cp_res=args.cp_res,
                                 mlp_cp_levels=args.cp_levels)
    if mlp and args.vm_rank:
        mc = dataclasses.replace(mc, mlp_vm_rank=args.vm_rank,
                                 mlp_vm_res=args.vm_res,
                                 mlp_vm_levels=args.vm_levels)
    if mlp and args.sigma_cp_rank:
        mc = dataclasses.replace(mc, mlp_sigma_cp_rank=args.sigma_cp_rank,
                                 mlp_sigma_cp_res=args.sigma_cp_res)
    if mlp and args.sigma_vm_rank:
        mc = dataclasses.replace(mc, mlp_sigma_vm_rank=args.sigma_vm_rank,
                                 mlp_sigma_vm_res=args.sigma_vm_res)
    tc = TrainConfig(iters=args.iters, num_rays=args.num_rays,
                     adaptive_num_rays=False, lambda_distort=args.distort,
                     lambda_tv=args.tv, lambda_l1_grid=args.l1,
                     grid_upsample_steps=tuple(args.upsample_steps),
                     grid_lr_mult=args.grid_lr_mult,
                     lr=args.lr, eval_cnt=1, save_cnt=args.save_cnt,
                     anneal_iters=args.anneal_iters,
                     use_native_loader=not args.no_native)
    name = field_type + (f"_w{mlp_width}" if mlp_width else "")
    if mlp:
        name += f"_d{args.mlp_depth}" if args.mlp_depth is not None else ""
        for tag, v in (("cp", args.cp_rank), ("vm", args.vm_rank),
                       ("scp", args.sigma_cp_rank),
                       ("svm", args.sigma_vm_rank)):
            name += f"_{tag}{v}" if v else ""
    return Config(workspace=f"{args.workspace}/{name}", render=rc, model=mc,
                  train=tc)


def run_family(field_type: str, args, mlp_width: Optional[int] = None, *,
               device=None) -> dict:
    dev = resolve_device(device)
    cfg = family_config(field_type, args, mlp_width)
    train_ds = training_rings(args.H, args.views)
    eval_ds = heldout_ring(args.H)
    model = fields.make_model(cfg.model, cfg.render)
    tr = Trainer(field_type, cfg, model, workspace=cfg.workspace,
                 use_checkpoint="latest" if args.resume else "scratch",
                 metrics=[PSNRMeter(), SSIMMeter()], device=dev)
    t0 = time.time()
    max_epoch, steps_per_epoch = epochs(args.iters)
    tr.train(train_ds, valid_dataset=None, max_epoch=max_epoch,
             steps_per_epoch=steps_per_epoch)
    wall = time.time() - t0
    res = tr.evaluate_one_epoch(eval_ds, save_artifacts=args.save_artifacts)
    mlp = field_type == "mlp"
    out = {"field": field_type, "width": mlp_width,
           "cp_rank": args.cp_rank if mlp else None,
           "vm_rank": args.vm_rank if mlp else None,
           "sigma_cp": args.sigma_cp_rank if mlp else None,
           "sigma_vm": args.sigma_vm_rank if mlp else None,
           "psnr": float(res["PSNRMeter"]),
           "ssim": round(float(res["SSIMMeter"]), 4),
           "train_s": round(wall, 1), "iters": args.iters}
    print(json.dumps(out), flush=True)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20000)
    ap.add_argument("--H", type=int, default=128)
    ap.add_argument("--views", type=int, default=24)
    ap.add_argument("--num_rays", type=int, default=1024)
    ap.add_argument("--min_near", type=float, default=0.5)
    # 5e-3: the 8-layer Fourier MLP diverges at the hash grid's 1e-2 (its
    # weights drift until the density field dies); hash tables take 1e-2
    # because each entry sees sparse gradients
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--distort", type=float, default=0.02)
    ap.add_argument("--num_steps", type=int, nargs="+", default=[128, 64, 32])
    ap.add_argument("--families", nargs="+", default=["mlp", "hashgrid"])
    ap.add_argument("--mlp_width", type=int, default=None)
    ap.add_argument("--mlp_depth", type=int, default=None,
                    help="field MLP depth override (mlp family)")
    ap.add_argument("--cp_rank", type=int, default=0,
                    help="CP line-grid rank for the mlp family (0 = off)")
    ap.add_argument("--cp_res", type=int, default=256)
    ap.add_argument("--cp_levels", type=int, default=1,
                    help="multi-res CP ladder levels (rank splits across)")
    ap.add_argument("--vm_rank", type=int, default=0,
                    help="VM plane-grid per-mode rank for the mlp family "
                         "(0 = off)")
    ap.add_argument("--vm_res", type=int, default=64)
    ap.add_argument("--vm_levels", type=int, default=1,
                    help="multi-res VM ladder levels (rank splits across)")
    ap.add_argument("--sigma_cp_rank", type=int, default=0,
                    help="direct-density CP grid rank (TensoRF §4.1)")
    ap.add_argument("--sigma_cp_res", type=int, default=256)
    ap.add_argument("--sigma_vm_rank", type=int, default=0,
                    help="direct-density VM grid per-mode rank")
    ap.add_argument("--sigma_vm_res", type=int, default=128)
    ap.add_argument("--grid_lr_mult", type=float, default=10.0,
                    help="lr multiplier for CP/VM grid tables")
    ap.add_argument("--upsample_steps", type=int, nargs="*", default=[],
                    help="grid_upsample_steps milestones (TensoRF "
                         "coarse-to-fine table upsampling)")
    ap.add_argument("--l1", type=float, default=0.0,
                    help="lambda_l1_grid (L1 sparsity on CP/VM tables)")
    ap.add_argument("--tv", type=float, default=0.0,
                    help="lambda_tv (reaches CP lines for the mlp family)")
    ap.add_argument("--anneal_iters", type=int, default=0,
                    help="coarse-to-fine encode annealing (BARF-style; "
                         "mlp family only, 0 = off)")
    ap.add_argument("--workspace", default="/tmp/quality_gate")
    ap.add_argument("--save_artifacts", action="store_true")
    ap.add_argument("--no_native", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the workspace's latest checkpoint")
    ap.add_argument("--save_cnt", type=int, default=1,
                    help="checkpoint count over the run (about the epoch "
                         "count for a save every epoch on long runs)")
    return ap


def main(argv=None, *, device=None) -> list:
    args = build_parser().parse_args(argv)
    resolve_device(device)
    results = [run_family(fam, args,
                          mlp_width=args.mlp_width if fam == "mlp" else None,
                          device=device)
               for fam in args.families]
    print("== quality gate ==")
    for r in results:
        print(f"  {r['field']:<10} psnr={r['psnr']:.2f} dB "
              f"({r['train_s']}s / {r['iters']} iters)")
    if len(results) == 2:
        delta = results[0]["psnr"] - results[1]["psnr"]
        print(f"  delta (first - second) = {delta:+.2f} dB")
    return results


if __name__ == "__main__":
    main()
