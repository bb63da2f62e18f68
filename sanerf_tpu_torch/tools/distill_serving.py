"""Serving distillation: a grid teacher checkpoint -> a fused-path student
(JAX: tools/distill_serving.py).

The hi-res grid recipe (scripts/train_rgb_grids.sh) trains the best
held-out quality, but its tables exceed `RenderConfig.grid_vmem_budget`,
so it renders on the plain path. This tool fits a serving student to it
(by default the same config with the tables stripped, the pure MLP
flagship; small tables within the budget with the `--serve_*` flags) with
`import_distill.distill_to_mlp` on a density-importance point set, and
saves a workspace checkpoint that renders on the field kernels, with
`serving_meta.json` for `pack_asset`.

Pass the flags the teacher was trained with (the checkpoint holds params
only; they are the CLI's, `apps/main.py:build_parser`), plus the serving
ones:

    python -m sanerf_tpu_torch.tools.distill_serving <data_or_dot> \
        --workspace trial_grids --mlp_depth 3 --cp_rank 96 --cp_res 2048 \
        --cp_levels 4 --vm_rank 32 --vm_res 1024 --vm_levels 4 \
        --sigma_cp_rank 96 --sigma_cp_res 2048 --out_workspace trial_serving \
        [--serve_depth 8] [--serve_cp_rank 16 --serve_cp_res 512] \
        [--distill_iters 8000]
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from sanerf_tpu_torch.apps.main import build_parser, config_from_args
from sanerf_tpu_torch.device import resolve_device
from sanerf_tpu_torch.models import fields, import_distill
from sanerf_tpu_torch.tools import jax_report
from sanerf_tpu_torch.train.checkpoints import CheckpointManager


def main(argv=None, *, device=None) -> dict:
    ap = build_parser()
    ap.add_argument("--out_workspace", required=True,
                    help="workspace for the serving checkpoint")
    ap.add_argument("--out_name", default="ngp")
    ap.add_argument("--teacher_name", default=None,
                    help="teacher checkpoint name prefix in the workspace "
                         "(default: --out_name; quality_gate workspaces "
                         "use the family name, e.g. 'mlp')")
    ap.add_argument("--distill_iters", type=int, default=8000)
    ap.add_argument("--distill_points", type=int, default=1 << 22)
    ap.add_argument("--distill_batch", type=int, default=1 << 15)
    ap.add_argument("--distill_lr", type=float, default=2e-3)
    ap.add_argument("--serve_depth", type=int, default=None,
                    help="serving field depth (default: teacher's)")
    ap.add_argument("--serve_cp_rank", type=int, default=0,
                    help="serving CP rank (default 0: tables stripped)")
    ap.add_argument("--serve_cp_res", type=int, default=512)
    ap.add_argument("--serve_cp_levels", type=int, default=1)
    ap.add_argument("--serve_vm_rank", type=int, default=0)
    ap.add_argument("--serve_vm_res", type=int, default=128)
    ap.add_argument("--serve_vm_levels", type=int, default=1)
    ap.add_argument("--serve_sigma_cp_rank", type=int, default=0)
    ap.add_argument("--serve_sigma_cp_res", type=int, default=512)
    ap.add_argument("--serve_width", type=int, default=None,
                    help="serving field MLP width (default: teacher's)")
    ap.add_argument("--serve_prop_width", type=int, default=None,
                    help="serving proposal-net width")
    ap.add_argument("--serve_prop_depth", type=int, default=None)
    ap.add_argument("--render_check", type=int, default=2,
                    help="orbit frames for the fidelity PSNR (0 = skip)")
    args = ap.parse_args(argv)
    dev = resolve_device(device)

    cfg = config_from_args(args)
    teacher = fields.make_model(cfg.model, cfg.render)
    template = fields.init_params(teacher, torch.Generator().manual_seed(0),
                                  dev)
    restored = CheckpointManager(
        args.workspace, name=args.teacher_name or args.out_name).load(
        args.ckpt, template, model_only=True)
    if restored is None:
        raise SystemExit(f"no checkpoint in {args.workspace} "
                         f"(mode={args.ckpt})")
    params, ema, _, meta = restored
    tparams = ema if ema is not None else params
    print(f"[serve] teacher step {meta.get('step')} | grid tables "
          f"{teacher.grid_table_bytes / 2**20:.1f} MiB "
          f"(budget {cfg.render.grid_vmem_budget / 2**20:.1f})")

    student = fields.make_model(import_distill.student_config(
        cfg.model,
        cp_rank=args.serve_cp_rank, cp_res=args.serve_cp_res,
        cp_levels=args.serve_cp_levels,
        vm_rank=args.serve_vm_rank, vm_res=args.serve_vm_res,
        vm_levels=args.serve_vm_levels,
        sigma_cp_rank=args.serve_sigma_cp_rank,
        sigma_cp_res=args.serve_sigma_cp_res,
        depth=args.serve_depth, width=args.serve_width,
        prop_width=args.serve_prop_width,
        prop_depth=args.serve_prop_depth), cfg.render)
    if student.grid_table_bytes > cfg.render.grid_vmem_budget:
        raise SystemExit("the serving student still exceeds the grid budget "
                         f"({student.grid_table_bytes / 2**20:.1f} MiB)")

    sm, sp, report = import_distill.distill_to_mlp(
        teacher, tparams, torch.Generator(device=dev).manual_seed(args.seed),
        n_points=args.distill_points, batch=args.distill_batch,
        iters=args.distill_iters, lr=args.distill_lr,
        student_model=student, render_check=args.render_check, device=dev)
    report = jax_report(report)
    path = CheckpointManager(args.out_workspace, name=args.out_name).save(
        0, sp, ema_params=sp, full=False)
    out = {"checkpoint": path, "family": "mlp-serving",
           **{k: v for k, v in report.items() if k != "losses"}}
    out["losses"] = {k: round(float(v), 6)
                     for k, v in report["losses"].items()}
    # everything a server needs to rebuild the student alone
    meta_path = os.path.join(args.out_workspace, "serving_meta.json")
    with open(meta_path, "w") as f:
        json.dump({
            "model_config": dataclasses.asdict(sm.cfg),
            "render_config": dataclasses.asdict(cfg.render),
            "teacher_step": meta.get("step"),
            "report": {k: v for k, v in out.items() if k != "checkpoint"},
        }, f, indent=1, default=str)
    out["meta"] = meta_path
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
