"""Import a reference Segment-Anything-NeRF `.pth` checkpoint
(JAX: tools/import_checkpoint.py).

Two steps, one command:
  1. `models/convert_nerf.py`: the reference state dict, key by key and
     bit for bit, into the hash-grid family's params;
  2. `models/import_distill.py`: the position-dependent parts (the hash
     grids and their MLPs) refitted into the MLP family, the heads of the
     same structure (view / samvit / mask MLPs) copied. The hash-grid
     family renders on the plain path (a `gather_rows` launch a table
     level); the student renders on the field and ray kernels.

The result is a workspace checkpoint (step 0), served with the CLI:

    python -m sanerf_tpu_torch.tools.import_checkpoint ngp.pth \
        --workspace trial_imported [--with_sam] [--with_mask --n_inst K]
    python -m sanerf_tpu_torch.apps.main <data> --workspace trial_imported \
        --test --gui [--with_sam ...]

The printed `render_psnr` is the student's frames against the teacher's
on an orbit. `--keep_hashgrid` saves the exact hash-grid conversion
instead, without distilling.
"""

from __future__ import annotations

import argparse
import json

import torch

from sanerf_tpu_torch.config import ModelConfig, RenderConfig
from sanerf_tpu_torch.device import resolve_device
from sanerf_tpu_torch.models import fields, import_distill
from sanerf_tpu_torch.models.convert_nerf import convert_nerf_checkpoint
from sanerf_tpu_torch.tools import jax_report
from sanerf_tpu_torch.train.checkpoints import CheckpointManager


def main(argv=None, *, device=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("pth", help="reference .pth checkpoint (torch)")
    ap.add_argument("--workspace", required=True)
    ap.add_argument("--name", default="ngp")
    ap.add_argument("--with_sam", action="store_true")
    ap.add_argument("--sam_use_view_direction", action="store_true")
    ap.add_argument("--with_mask", action="store_true")
    ap.add_argument("--mask_mlp_type", default="default")
    ap.add_argument("--n_inst", type=int, default=2)
    ap.add_argument("--bound", type=float, default=128.0)
    ap.add_argument("--no_contract", action="store_true")
    ap.add_argument("--iters", type=int, default=8000)
    ap.add_argument("--n_points", type=int, default=1 << 22)
    ap.add_argument("--batch", type=int, default=1 << 15)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--cp_rank", type=int, default=0,
                    help="give the student a CP line grid of this rank")
    ap.add_argument("--cp_res", type=int, default=256)
    ap.add_argument("--cp_levels", type=int, default=1)
    ap.add_argument("--vm_rank", type=int, default=0,
                    help="give the student a TensoRF-VM plane grid of "
                         "this per-mode rank")
    ap.add_argument("--vm_res", type=int, default=64)
    ap.add_argument("--vm_levels", type=int, default=1)
    ap.add_argument("--sigma_cp_rank", type=int, default=0,
                    help="direct-density CP grid rank for the student "
                         "(TensoRF §4.1; 0 = off)")
    ap.add_argument("--sigma_cp_res", type=int, default=256)
    ap.add_argument("--sigma_vm_rank", type=int, default=0)
    ap.add_argument("--sigma_vm_res", type=int, default=128)
    ap.add_argument("--mlp_depth", type=int, default=None,
                    help="student field-MLP depth override")
    ap.add_argument("--render_check", type=int, default=2,
                    help="orbit frames for the fidelity PSNR (0 = skip)")
    ap.add_argument("--keep_hashgrid", action="store_true",
                    help="save the exact hashgrid conversion, skip distill")
    args = ap.parse_args(argv)
    dev = resolve_device(device)

    rc = RenderConfig(bound=args.bound, contract=not args.no_contract)
    tc = ModelConfig(
        field_type="hashgrid",
        with_sam=args.with_sam,
        sam_use_view_direction=args.sam_use_view_direction,
        with_mask=args.with_mask,
        mask_mlp_type=args.mask_mlp_type,
        n_inst=args.n_inst,
    )
    teacher = fields.make_model(tc, rc)
    print(f"[import] converting {args.pth} (hashgrid family)")
    tparams = convert_nerf_checkpoint(args.pth, teacher, device=dev)
    mgr = CheckpointManager(args.workspace, name=args.name)

    if args.keep_hashgrid:
        path = mgr.save(0, tparams, ema_params=tparams, full=False)
        out = {"checkpoint": path, "family": "hashgrid"}
        print(json.dumps(out), flush=True)
        return out

    print(f"[import] distilling into the MLP family "
          f"({args.iters} iters, {args.n_points} points)")
    student = None
    if (args.cp_rank or args.vm_rank or args.sigma_cp_rank
            or args.sigma_vm_rank or args.mlp_depth is not None):
        student = fields.make_model(import_distill.student_config(
            tc, cp_rank=args.cp_rank, cp_res=args.cp_res,
            cp_levels=args.cp_levels,
            vm_rank=args.vm_rank, vm_res=args.vm_res,
            vm_levels=args.vm_levels,
            sigma_cp_rank=args.sigma_cp_rank, sigma_cp_res=args.sigma_cp_res,
            sigma_vm_rank=args.sigma_vm_rank, sigma_vm_res=args.sigma_vm_res,
            depth=args.mlp_depth), rc)
    _, sparams, report = import_distill.distill_to_mlp(
        teacher, tparams, torch.Generator(device=dev).manual_seed(0),
        n_points=args.n_points, batch=args.batch, iters=args.iters,
        lr=args.lr, render_check=args.render_check, student_model=student,
        device=dev)
    report = jax_report(report)
    path = mgr.save(0, sparams, ema_params=sparams, full=False)
    out = {"checkpoint": path, "family": "mlp",
           **{k: v for k, v in report.items() if k != "losses"}}
    out["losses"] = {k: round(v, 6) for k, v in report["losses"].items()}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
