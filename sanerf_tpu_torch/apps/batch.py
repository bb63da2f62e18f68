"""Batch drivers: loop over scenes and objects and run the pipeline
(JAX: sanerf_tpu/apps/batch.py).

    python -m sanerf_tpu_torch.apps.batch {train-rgb, train-sam, train-mask,
        eval-rgb, eval-feat, eval-mask, generate-mask} [--scenes ...]

One subcommand per stage of the reference's batch scripts. The scenes come
from `--scenes` or the scene registry (scene_list.json: {data_type:
[scene, ...]}), the objects of stage 3 from scenes_metadata_v2.json; each
run is the CLI's `run` in this process, on `device` (the CUDA card by
default). Stage 3's iterations grow with the number of valid labelled
views (`mask_iters_heuristic`).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List

from sanerf_tpu_torch.apps.main import build_parser, config_from_args, run


def load_scene_list(path: str, data_type: str) -> List[str]:
    """scene_list.json: {data_type: [scene, ...]} (or a plain list)."""
    with open(path) as f:
        registry = json.load(f)
    return registry.get(data_type, registry if isinstance(registry, list)
                        else [])


def mask_iters_heuristic(valid_json: str, base: int = 250,
                         per_view: int = 10, cap: int = 1000) -> int:
    """Stage 3's iterations: base + per_view a valid labelled view, at
    most cap; base without a valid.json."""
    if not os.path.exists(valid_json):
        return base
    with open(valid_json) as f:
        valid = json.load(f)
    n = sum(1 for v in valid.values() if v)
    return min(cap, base + per_view * n)


def _run_for_scene(scene: str, data_root: str, extra_flags: List[str],
                   device=None):
    argv = [os.path.join(data_root, scene)] + extra_flags
    cfg = config_from_args(build_parser().parse_args(argv))
    return run(cfg, device=device)


def _last_checkpoint(rgb_ws: str) -> str:
    d = os.path.join(rgb_ws, "checkpoints")
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(".npz") and "best" not in f)[-1]


def cmd_train_rgb(args, scenes, device=None):
    for scene in scenes:
        _run_for_scene(scene, args.data_root, [
            "--workspace", os.path.join(args.out_root, f"{scene}_rgb"),
            "--data_type", args.data_type, "--iters", str(args.iters),
            "--scene_name", scene, "--enable_cam_center",
            "--random_image_batch"], device)


def cmd_train_sam(args, scenes, device=None):
    for scene in scenes:
        ckpt = _last_checkpoint(os.path.join(args.out_root, f"{scene}_rgb"))
        _run_for_scene(scene, args.data_root, [
            "--workspace", os.path.join(args.out_root, f"{scene}_sam"),
            "--data_type", args.data_type, "--with_sam",
            "--sam_use_view_direction", "--iters", "5000",
            "--init_ckpt", ckpt, "--scene_name", scene], device)


def cmd_train_mask(args, scenes, device=None):
    with open(args.metadata) as f:
        metadata = json.load(f)
    for scene in scenes:
        objects = list(metadata.get(scene, {}).keys()) or [args.object_name]
        ckpt = _last_checkpoint(os.path.join(args.out_root, f"{scene}_rgb"))
        for obj in objects:
            mask_dir = os.path.join(args.data_root, scene, obj)
            iters = mask_iters_heuristic(os.path.join(mask_dir, "valid.json"))
            _run_for_scene(scene, args.data_root, [
                "--workspace",
                os.path.join(args.out_root, f"{scene}_{obj}_mask"),
                "--data_type", args.data_type, "--with_mask",
                "--init_ckpt", ckpt, "--iters", str(iters),
                "--mask_folder_name", obj, "--scene_name", scene,
                "--object_name", obj, "--error_map", "--mixed_sampling"],
                device)


def cmd_eval(args, scenes, kind: str, device=None):
    for scene in scenes:
        suffix = {"rgb": "_rgb", "feat": "_sam",
                  "mask": f"_{args.object_name}_mask"}[kind]
        flags = [
            "--workspace", os.path.join(args.out_root, f"{scene}{suffix}"),
            "--data_type", args.data_type, "--test", "--scene_name", scene,
            "--val_type", "val_split",
        ]
        if kind == "feat":
            flags += ["--with_sam", "--sam_use_view_direction"]
        if kind == "mask":
            flags += ["--with_mask", "--mask_folder_name", args.object_name,
                      "--object_name", args.object_name]
        _run_for_scene(scene, args.data_root, flags, device)


def build_batch_parser() -> argparse.ArgumentParser:
    """The batch runner's own flags (`build_parser` is the CLI's)."""
    p = argparse.ArgumentParser()
    p.add_argument("command", choices=["train-rgb", "train-sam", "train-mask",
                                       "eval-rgb", "eval-feat", "eval-mask",
                                       "generate-mask"])
    p.add_argument("--scene_list", default="scene_list.json")
    p.add_argument("--metadata", default="scenes_metadata_v2.json")
    p.add_argument("--data_type", default="mip")
    p.add_argument("--data_root", default="data")
    p.add_argument("--out_root", default="trials")
    p.add_argument("--iters", type=int, default=20000)
    p.add_argument("--object_name", default="table_whole")
    p.add_argument("--scenes", nargs="*", default=None)
    return p


def main(argv=None, device=None):
    args = build_batch_parser().parse_args(argv)

    scenes = args.scenes or load_scene_list(args.scene_list, args.data_type)
    if args.command == "train-rgb":
        cmd_train_rgb(args, scenes, device)
    elif args.command == "train-sam":
        cmd_train_sam(args, scenes, device)
    elif args.command == "train-mask":
        cmd_train_mask(args, scenes, device)
    elif args.command.startswith("eval-"):
        cmd_eval(args, scenes, args.command.split("-")[1], device)
    elif args.command == "generate-mask":
        from sanerf_tpu_torch.apps import sam_project

        for scene in scenes:
            sam_project.main([
                os.path.join(args.data_root, scene), "--scene_name", scene,
                "--object_name", args.object_name,
                "--workspace", os.path.join(args.out_root, f"{scene}_sam"),
            ], device)


if __name__ == "__main__":
    main()
