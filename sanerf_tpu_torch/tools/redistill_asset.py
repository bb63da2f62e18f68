"""Re-distill the serving asset, or a quality-gate teacher, into a serving
student (JAX: tools/redistill_asset.py).

The teacher is the shipped asset (`--teacher asset`, the default: the one
trained artifact in the repository; `main(..., asset=path)` reads another
copy) or a `quality_gate` workspace (`qg_hashgrid` / `qg_mlp`, rebuilt
with that tool's exact configs so the checkpoint's shapes match). The
student is `import_distill.student_config` of the teacher at the flags'
grids and widths (by default the asset's own shape: cp64@128,
sigma-cp32@128), fitted by `import_distill.distill_to_mlp` (its targets'
hash lookups on `gather_rows` for a hash-grid teacher; its two fidelity
frames on the field and ray kernels), and written as step 0 of
`--out_workspace` with `serving_meta.json` (configs, teacher, report) for
`eval_student`, `finetune_student` and `pack_asset`.

    python -m sanerf_tpu_torch.tools.redistill_asset --out_workspace /tmp/slim64 \
        [--cp_rank 64 --cp_res 128] [--width 128] [--prop_depth 2]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from sanerf_tpu_torch.config import ModelConfig, RenderConfig
from sanerf_tpu_torch.device import resolve_device
from sanerf_tpu_torch.models import fields, import_distill
from sanerf_tpu_torch.models.asset import load_asset
from sanerf_tpu_torch.tools import ASSET, jax_report
from sanerf_tpu_torch.train.checkpoints import CheckpointManager


def main(argv=None, *, asset: str = ASSET, device=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out_workspace", required=True)
    ap.add_argument("--out_name", default="ngp")
    ap.add_argument("--teacher", default="asset",
                    choices=["asset", "qg_hashgrid", "qg_mlp"],
                    help="'asset' = the serving asset; 'qg_hashgrid' / "
                         "'qg_mlp' = a quality_gate workspace (its exact "
                         "fixture protocol configs)")
    ap.add_argument("--teacher_workspace", default="/tmp/qg20k/hashgrid")
    ap.add_argument("--teacher_name", default=None,
                    help="checkpoint prefix (default: the quality_gate "
                         "family name inferred from --teacher)")
    ap.add_argument("--cp_rank", type=int, default=64)
    ap.add_argument("--cp_res", type=int, default=128)
    ap.add_argument("--sigma_cp_rank", type=int, default=32)
    ap.add_argument("--sigma_cp_res", type=int, default=128)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--prop_width", type=int, default=None)
    ap.add_argument("--prop_depth", type=int, default=None)
    ap.add_argument("--iters", type=int, default=8000)
    ap.add_argument("--points", type=int, default=1 << 22)
    ap.add_argument("--batch", type=int, default=1 << 15)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(device)

    if args.teacher == "asset":
        mc, rc, tparams = load_asset(asset, device=dev)
        # JAX's loader (bench.py:65) turns sam_use_view_direction on: kept,
        # so that the configs written are JAX's (no weight depends on it
        # with the SAM head off)
        mc = dataclasses.replace(mc, with_sam=False,
                                 sam_use_view_direction=True)
        teacher = fields.make_model(mc, rc)
        teacher_src = ("assets/serving_student" if asset == ASSET
                       else asset)
    else:
        fam = "hashgrid" if args.teacher == "qg_hashgrid" else "mlp"
        mc = ModelConfig(field_type=fam, prop_resolutions=(128, 256))
        rc = RenderConfig(num_steps=(128, 64, 32), bound=4.0, contract=True,
                          min_near=0.5, max_ray_batch=65536)
        teacher = fields.make_model(mc, rc)
        template = fields.init_params(teacher, torch.Generator().manual_seed(
            0), dev)
        restored = CheckpointManager(
            args.teacher_workspace, name=args.teacher_name or fam).load(
            "latest", template, model_only=True)
        if restored is None:
            raise SystemExit(f"no checkpoint in {args.teacher_workspace}")
        params_t, ema_t, _, meta_t = restored
        tparams = ema_t if ema_t is not None else params_t
        teacher_src = (f"{args.teacher_workspace} "
                       f"(step {meta_t.get('step')})")
    print(f"[redistill] teacher = {args.teacher}: {teacher_src}")

    if args.teacher != "asset" and args.depth is None:
        args.depth = 3  # the measured-best serving decoder depth
    student = fields.make_model(import_distill.student_config(
        mc, cp_rank=args.cp_rank, cp_res=args.cp_res,
        sigma_cp_rank=args.sigma_cp_rank, sigma_cp_res=args.sigma_cp_res,
        depth=args.depth, width=args.width,
        prop_width=args.prop_width, prop_depth=args.prop_depth), rc)

    sm, sp, report = import_distill.distill_to_mlp(
        teacher, tparams, torch.Generator(device=dev).manual_seed(args.seed),
        n_points=args.points, batch=args.batch, iters=args.iters,
        lr=args.lr, student_model=student, render_check=2, device=dev)
    report = jax_report(report)
    path = CheckpointManager(args.out_workspace, name=args.out_name).save(
        0, sp, ema_params=sp, full=False)
    with open(os.path.join(args.out_workspace, "serving_meta.json"), "w") as f:
        json.dump({"model_config": dataclasses.asdict(sm.cfg),
                   "render_config": dataclasses.asdict(rc),
                   "teacher": teacher_src,
                   "report": {k: (v if not isinstance(v, dict) else
                                  {kk: round(float(vv), 6)
                                   for kk, vv in v.items()})
                              for k, v in report.items()}}, f, indent=1,
                  default=str)
    out = {"checkpoint": path,
           "render_psnr_vs_teacher": report.get("render_psnr"),
           "losses": {k: round(float(v), 6)
                      for k, v in report["losses"].items()}}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
