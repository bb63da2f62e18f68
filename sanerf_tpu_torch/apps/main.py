"""CLI entry point: `python -m sanerf_tpu_torch.apps.main <path> [flags]`
(JAX: sanerf_tpu/apps/main.py).

The JAX CLI's flags, names and defaults, parsed into the typed Config,
and its dispatch to the three workloads: stage 1 (`Trainer`, then the
PSNR / SSIM / LPIPS evaluation of the val split), stage 2 (`--with_sam`:
`SamDistillTrainer` with SAM's ViT-H teacher from `--sam_ckpt`, cast to
bf16), stage 3 (`--with_mask`: `MaskTrainer`, then its mIoU); `--test`
renders the test split (and scores it where it has images), and with
`--gui` opens the viewer on the checkpoint instead (apps/gui.py:
`launch_gui`; headless frames where dearpygui does not import); `--gui`
without `--test` trains as if it were not there, as in the JAX CLI.
Stages 2 and 3 take the previous stage's weights through `--init_ckpt`,
frozen (`checkpoints.load_partial_and_freeze`). Runs on the CUDA card;
`main(argv, device="cpu")` and `run(cfg, device="cpu")` run the plain
versions on the CPU (the JAX CLI has no device flag). Not in the port:
`--n_devices > 1` (ROADMAP.md, A6) raises NotImplementedError;
`--write_video` needs imageio, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

from sanerf_tpu_torch.config import (
    Config, DataConfig, MaskTrainConfig, ModelConfig, RenderConfig,
    SamTrainConfig, TrainConfig,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="sanerf_tpu_torch")
    p.add_argument("path", type=str)
    p.add_argument("--workspace", type=str, default="workspace")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt", type=str, default="latest")

    p.add_argument("--with_sam", action="store_true")
    p.add_argument("--init_ckpt", type=str, default="")
    p.add_argument("--sam_ckpt", type=str, default="./pretrained/sam_vit_h_4b8939.pth")
    p.add_argument("--online_resolution", type=int, default=512)
    p.add_argument("--sam_use_view_direction", action="store_true")
    p.add_argument("--cache_size", type=int, default=256)
    p.add_argument("--cache_interval", type=int, default=4)

    p.add_argument("--save_cnt", type=int, default=20)
    p.add_argument("--eval_cnt", type=int, default=5)
    p.add_argument("--test", action="store_true")
    p.add_argument("--camera_traj", type=str, default="interp",
                   choices=["interp", "circle"])

    p.add_argument("--train_split", type=str, default="train",
                   choices=["train", "trainval", "all"])
    p.add_argument("--test_split", type=str, default="val",
                   choices=["train", "val", "test"])
    p.add_argument("--random_image_batch", action="store_true")
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--bound", type=float, default=128.0)
    p.add_argument("--scale", type=float, default=-1)
    p.add_argument("--offset", type=float, nargs="*", default=[0, 0, 0])
    p.add_argument("--enable_cam_near_far", action="store_true")
    p.add_argument("--enable_cam_center", action="store_true")
    p.add_argument("--min_near", type=float, default=0.2)

    p.add_argument("--iters", type=int, default=20000)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--num_steps", type=int, nargs="*", default=[128, 64, 32])
    p.add_argument("--infer_num_steps", type=int, nargs="*", default=None,
                   help="inference-only sample counts for --test/--gui "
                   "(e.g. 64 32 32). The proposal hierarchy needs fewer "
                   "levels at inference than training; quality-gated on "
                   "trained models (see docs)")
    p.add_argument("--contract", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--background", type=str, default="last_sample",
                   choices=["white", "random", "last_sample"])
    p.add_argument("--max_ray_batch", type=int, default=4096 * 16)
    p.add_argument("--num_rays", type=int, default=4096)
    p.add_argument("--adaptive_num_rays", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--num_points", type=int, default=2**18)
    p.add_argument("--n_devices", type=int, default=1,
                   help="data-parallel devices (only 1 in the port: "
                   "ROADMAP.md, A6)")

    p.add_argument("--lambda_entropy", type=float, default=0)
    p.add_argument("--lambda_tv", type=float, default=0)
    p.add_argument("--lambda_l1_grid", type=float, default=0,
                   help="L1 sparsity on CP/VM tables (TensoRF; mlp family)")
    p.add_argument("--grid_upsample_steps", type=int, nargs="*", default=[],
                   help="global steps at which CP/VM tables double in "
                        "resolution (TensoRF coarse-to-fine; tables start "
                        "at final_res >> N)")
    p.add_argument("--lambda_wd", type=float, default=0)
    p.add_argument("--lambda_proposal", type=float, default=1)
    p.add_argument("--lambda_distort", type=float, default=0.02)

    p.add_argument("--with_mask", action="store_true")
    p.add_argument("--mask_mlp_type", type=str, default="default",
                   choices=["default", "lightweight_mask", "adaptive"])
    p.add_argument("--adaptive_mlp_type", type=str, default="density",
                   choices=["density", "rgb", "sam"])
    p.add_argument("--n_inst", type=int, default=2)
    p.add_argument("--redundant_instance", type=int, default=0)
    p.add_argument("--sum_after_mlp", action="store_true")
    p.add_argument("--label_regularization_weight", type=float, default=0.0)
    p.add_argument("--patch_size", type=int, default=1)
    p.add_argument("--mask_folder_name", type=str, default=None)
    p.add_argument("--incoherent_uncertainty_weight", type=float, default=1)
    p.add_argument("--rgb_similarity_loss_weight", type=float, default=0)
    p.add_argument("--rgb_similarity_threshold", type=float, default=0.3)
    p.add_argument("--epsilon", type=float, default=1e-6)
    p.add_argument("--rgb_similarity_exp_weight", type=float, default=10)
    p.add_argument("--rgb_similarity_num_sample", type=int, default=1)
    p.add_argument("--rgb_similarity_iter", type=int, default=-1)
    p.add_argument("--rgb_similarity_use_pred_logistics", action="store_true")
    p.add_argument("--mixed_sampling", action="store_true")
    p.add_argument("--local_sample_patch_size", type=int, default=16)
    p.add_argument("--num_local_sample", type=int, default=2)
    p.add_argument("--error_map", action="store_true")
    p.add_argument("--error_map_size", type=int, default=128)
    p.add_argument("--use_dynamic_incoherent", action="store_true")
    p.add_argument("--incoherent_update_iter", type=int, default=50)
    p.add_argument("--incoherent_downsample_scale", type=int, default=1)
    p.add_argument("--use_multi_res", action="store_true")
    p.add_argument("--multi_res_update_iter", type=int, default=100)
    p.add_argument("--max_multi_res_level", type=int, default=2)

    p.add_argument("--val_type", type=str, default="default",
                   choices=["default", "val_all", "val_split"])
    p.add_argument("--render_mask_type", type=str, default="heatmap",
                   choices=["mask", "composition", "heatmap"])
    p.add_argument("--render_mask_instance_id", type=int, default=0)
    p.add_argument("--return_extra", action="store_true")

    p.add_argument("--gui", action="store_true")
    p.add_argument("--W", type=int, default=512)
    p.add_argument("--H", type=int, default=512)
    p.add_argument("--radius", type=float, default=0.5)
    p.add_argument("--fovy", type=float, default=60)
    p.add_argument("--max_spp", type=int, default=1)

    p.add_argument("--data_type", type=str, default="mip",
                   choices=["mip", "lerf", "llff", "3dfront", "ctr", "pano", "lift"])
    p.add_argument("--scene_name", type=str, default="garden")
    p.add_argument("--object_name", type=str, default="table_whole")

    # the JAX package's extensions
    p.add_argument("--field_type", type=str, default="mlp",
                   choices=["mlp", "hashgrid"])
    p.add_argument("--mlp_width", type=int, default=None,
                   help="MLP-family field width (default: the quality-gated"
                        " ModelConfig value)")
    p.add_argument("--mlp_depth", type=int, default=None,
                   help="MLP-family field depth (TensoRF pairs big grids"
                        " with a shallow 2-layer decoder)")
    p.add_argument("--cp_rank", type=int, default=0,
                   help="CP line-grid rank for the mlp family (0 = off)")
    p.add_argument("--cp_res", type=int, default=256)
    p.add_argument("--cp_levels", type=int, default=1,
                   help="multi-res CP ladder levels (rank splits across)")
    p.add_argument("--vm_rank", type=int, default=0,
                   help="TensoRF-VM plane-grid per-mode rank for the mlp"
                        " family (0 = off)")
    p.add_argument("--vm_res", type=int, default=64)
    p.add_argument("--vm_levels", type=int, default=1,
                   help="multi-res VM ladder levels (rank splits across)")
    p.add_argument("--sigma_cp_rank", type=int, default=0,
                   help="DIRECT-density CP grid rank (TensoRF §4.1: the "
                        "component sum adds straight into the density "
                        "logit; 0 = off)")
    p.add_argument("--sigma_cp_res", type=int, default=256)
    p.add_argument("--sigma_vm_rank", type=int, default=0,
                   help="DIRECT-density VM grid per-mode rank (0 = off)")
    p.add_argument("--sigma_vm_res", type=int, default=128)
    p.add_argument("--grid_lr_mult", type=float, default=10.0,
                   help="lr multiplier for CP/VM grid tables "
                        "(TensoRF's grid-vs-net split)")
    p.add_argument("--anneal_iters", type=int, default=0,
                   help="coarse-to-fine encode annealing over this many "
                        "steps (BARF-style; mlp family only, 0 = off)")
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--write_video", action="store_true")
    return p


def config_from_args(args) -> Config:
    num_steps = tuple(args.num_steps)
    if args.test and args.infer_num_steps:
        num_steps = tuple(args.infer_num_steps)
    render = RenderConfig(
        num_steps=num_steps, bound=args.bound, contract=args.contract,
        min_near=args.min_near, background=args.background,
        max_ray_batch=args.max_ray_batch,
    )
    model = ModelConfig(
        field_type=args.field_type,
        with_sam=args.with_sam, sam_use_view_direction=args.sam_use_view_direction,
        sum_after_mlp=args.sum_after_mlp,
        with_mask=args.with_mask, mask_mlp_type=args.mask_mlp_type,
        adaptive_mlp_type=args.adaptive_mlp_type, n_inst=args.n_inst,
        redundant_instance=args.redundant_instance,
        grid_desired_resolution=int(2048 * (2.0 if args.contract else args.bound)),
    )
    if args.mlp_width is not None:
        model = dataclasses.replace(model, mlp_field_width=args.mlp_width)
    if args.mlp_depth is not None:
        model = dataclasses.replace(model, mlp_field_depth=args.mlp_depth)
    if args.cp_rank or args.vm_rank or args.sigma_cp_rank or args.sigma_vm_rank:
        model = dataclasses.replace(model, mlp_cp_rank=args.cp_rank,
                            mlp_cp_res=args.cp_res,
                            mlp_cp_levels=args.cp_levels,
                            mlp_vm_rank=args.vm_rank,
                            mlp_vm_res=args.vm_res,
                            mlp_vm_levels=args.vm_levels,
                            mlp_sigma_cp_rank=args.sigma_cp_rank,
                            mlp_sigma_cp_res=args.sigma_cp_res,
                            mlp_sigma_vm_rank=args.sigma_vm_rank,
                            mlp_sigma_vm_res=args.sigma_vm_res)
    # the MLP field family trains best with a gentler schedule than the
    # hash-grid recipe's lr=1e-2 (which diverges on deep 8x256 MLPs); scale
    # the default unless the user overrode --lr
    lr = args.lr
    warmup = 0
    if args.field_type == "mlp" and args.lr == 1e-2:
        lr, warmup = 2.5e-3, 500
    train = TrainConfig(
        iters=args.iters, lr=lr, lr_warmup_steps=warmup, num_rays=args.num_rays,
        adaptive_num_rays=args.adaptive_num_rays, num_points=args.num_points,
        lambda_entropy=args.lambda_entropy, lambda_tv=args.lambda_tv,
        lambda_l1_grid=args.lambda_l1_grid,
        grid_upsample_steps=tuple(args.grid_upsample_steps),
        lambda_wd=args.lambda_wd, lambda_proposal=args.lambda_proposal,
        lambda_distort=args.lambda_distort, save_cnt=args.save_cnt,
        eval_cnt=args.eval_cnt, n_devices=args.n_devices,
        grid_lr_mult=args.grid_lr_mult, anneal_iters=args.anneal_iters,
    )
    sam = SamTrainConfig(
        online_resolution=args.online_resolution, cache_size=args.cache_size,
        cache_interval=args.cache_interval, sam_ckpt=args.sam_ckpt,
    )
    mask = MaskTrainConfig(
        label_regularization_weight=args.label_regularization_weight,
        patch_size=args.patch_size,
        incoherent_uncertainty_weight=args.incoherent_uncertainty_weight,
        rgb_similarity_loss_weight=args.rgb_similarity_loss_weight,
        rgb_similarity_threshold=args.rgb_similarity_threshold,
        epsilon=args.epsilon,
        rgb_similarity_exp_weight=args.rgb_similarity_exp_weight,
        rgb_similarity_num_sample=args.rgb_similarity_num_sample,
        rgb_similarity_iter=args.rgb_similarity_iter,
        rgb_similarity_use_pred_logistics=args.rgb_similarity_use_pred_logistics,
        mixed_sampling=args.mixed_sampling,
        local_sample_patch_size=args.local_sample_patch_size,
        num_local_sample=args.num_local_sample, error_map=args.error_map,
        error_map_size=args.error_map_size,
        use_dynamic_incoherent=args.use_dynamic_incoherent,
        incoherent_update_iter=args.incoherent_update_iter,
        incoherent_downsample_scale=args.incoherent_downsample_scale,
        use_multi_res=args.use_multi_res,
        multi_res_update_iter=args.multi_res_update_iter,
        max_multi_res_level=args.max_multi_res_level,
        mask_folder_name=args.mask_folder_name,
    )
    data = DataConfig(
        path=args.path, data_type=args.data_type, train_split=args.train_split,
        test_split=args.test_split, val_type=args.val_type,
        downscale=args.downscale, scale=args.scale, offset=tuple(args.offset),
        enable_cam_near_far=args.enable_cam_near_far,
        enable_cam_center=args.enable_cam_center,
        random_image_batch=args.random_image_batch,
        camera_traj=args.camera_traj, scene_name=args.scene_name,
        object_name=args.object_name,
    )
    return Config(
        workspace=args.workspace, seed=args.seed, ckpt=args.ckpt,
        init_ckpt=args.init_ckpt, test=args.test, gui=args.gui,
        render_mask_type=args.render_mask_type,
        render_mask_instance_id=args.render_mask_instance_id,
        use_wandb=args.use_wandb,
        render=render, model=model, train=train, sam=sam, mask=mask, data=data,
    )


def build_sam_predictor(cfg: Config, device=None):
    """SAM (ViT-H) from `cfg.sam.sam_ckpt`, its weights cast to bf16, on
    `device`; None, with a warning, when the file is not there."""
    import torch

    from sanerf_tpu_torch.device import resolve_device
    from sanerf_tpu_torch.models.fields import cast_params
    from sanerf_tpu_torch.models.sam import SamPredictor, convert_checkpoint
    from sanerf_tpu_torch.train.tree import tree_map

    path = cfg.sam.sam_ckpt
    if not os.path.exists(path):
        print(f"[WARN] SAM checkpoint {path} not found; teacher disabled")
        return None
    dev = resolve_device(device)
    sam_cfg, params = convert_checkpoint(path, "vit_h")
    params = cast_params(tree_map(lambda t: t.to(dev), params),
                         torch.bfloat16)
    return SamPredictor(sam_cfg, params, device=dev)


def run(cfg: Config, write_video: bool = False, return_extra: bool = False,
        device=None):
    """The workload `cfg` asks for (module docstring) -> its trainer."""
    import torch

    from sanerf_tpu_torch.data.provider import SceneDataset
    from sanerf_tpu_torch.device import resolve_device
    from sanerf_tpu_torch.models import fields
    from sanerf_tpu_torch.train import checkpoints as ckpt_lib
    from sanerf_tpu_torch.train.distill import SamDistillTrainer
    from sanerf_tpu_torch.train.mask_trainer import MaskTrainer
    from sanerf_tpu_torch.train.metrics import (LPIPSMeter, MeanIoUMeter,
                                                PSNRMeter, SSIMMeter)
    from sanerf_tpu_torch.train.trainer import Trainer

    if cfg.train.n_devices > 1:
        raise NotImplementedError(
            "--n_devices > 1: data-parallel training is not in the port "
            "(ROADMAP.md, A6)")
    dev = resolve_device(device)
    model = fields.make_model(cfg.model, cfg.render)

    # the cross-stage hand-off
    init_params, trainable = None, None
    if (cfg.model.with_sam or cfg.model.with_mask) and cfg.init_ckpt:
        init_params, trainable = ckpt_lib.load_partial_and_freeze(
            cfg.init_ckpt, fields.init_params(
                model, torch.Generator().manual_seed(cfg.seed), dev))

    sam_predictor = (build_sam_predictor(cfg, dev) if cfg.model.with_sam
                     else None)
    kw = dict(workspace=cfg.workspace, use_checkpoint=cfg.ckpt, device=dev)

    if cfg.test:
        trainer = Trainer("ngp", cfg, model, **kw)
        if cfg.use_wandb:
            trainer.enable_wandb()
        if cfg.gui:
            from sanerf_tpu_torch.apps.gui import launch_gui

            launch_gui(cfg, trainer, sam_predictor)
            return trainer
        test_ds = SceneDataset(cfg, cfg.data.test_split)
        if cfg.data.test_split != "test":
            trainer.metrics = (
                [MeanIoUMeter()] if cfg.model.with_mask
                else [PSNRMeter(), SSIMMeter(), LPIPSMeter()])
            if test_ds.images is not None:
                trainer.evaluate_one_epoch(test_ds)
        trainer.test(test_ds, write_video=write_video,
                     return_extra=return_extra)
        return trainer

    train_ds = SceneDataset(cfg, cfg.data.train_split)
    valid_ds = SceneDataset(cfg, "val")
    max_epoch = int(np.ceil(cfg.train.iters / len(train_ds)))
    kw.update(trainable=trainable, init_params=init_params)
    if cfg.model.with_mask:
        trainer = MaskTrainer("ngp", cfg, model, **kw)
        if cfg.use_wandb:
            trainer.enable_wandb()
        trainer.train(train_ds, valid_ds, max_epoch)
        trainer.evaluate_mask(valid_ds)
    elif cfg.model.with_sam:
        trainer = SamDistillTrainer("ngp", cfg, model, teacher=sam_predictor,
                                    **kw)
        if cfg.use_wandb:
            trainer.enable_wandb()
        trainer.train(train_ds, valid_ds, max_epoch)
    else:
        del kw["trainable"], kw["init_params"]
        trainer = Trainer("ngp", cfg, model, **kw)
        if cfg.use_wandb:
            trainer.enable_wandb()
        trainer.train(train_ds, valid_ds, max_epoch)
        trainer.metrics = [PSNRMeter(), SSIMMeter(), LPIPSMeter()]
        trainer.evaluate_one_epoch(valid_ds)
    return trainer


def main(argv=None, device=None):
    """Parse `argv` (sys.argv by default) and run it on `device` (the CUDA
    card by default) -> the trainer."""
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    np.random.seed(cfg.seed)
    return run(cfg, write_video=args.write_video,
               return_extra=args.return_extra, device=device)


if __name__ == "__main__":
    main()
