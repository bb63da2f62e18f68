"""Mask labels from 3D prompt points: per-view SAM masks for stage 3
(JAX: sanerf_tpu/apps/sam_project.py).

Given hand-picked 3D points of an object (scenes_metadata.json), for every
view of a dataset:

1. project the points through the camera (`project_to_2d`);
2. drop the points the rendered depth occludes (|z - depth| over
   `depth_threshold`; the depth read at the truncated pixel);
3. prompt SAM, on the view's image (`set_image`, the ViT teacher) or on
   the NeRF's rendered feature map (`use_nerf_feature`: a render at
   lr_h = max(4, int(H / 1024 * 64)) square with the intrinsics scaled,
   then `set_features`);
4. write `<frame>_masks.npy` (1 / 0, or -1 everywhere for a view with too
   few visible points), an overlay PNG, and `valid.json`, the visibility
   of each view.

The output directory is what stage 3 reads (`--mask_folder_name`). The
renders go through `Trainer.render_pose`, which takes the CUDA kernels on
the card.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from sanerf_tpu_torch.apps.interactive import overlay_mask_and_points
from sanerf_tpu_torch.config import Config
from sanerf_tpu_torch.train.trainer import save_png


def project_to_2d(points_w: np.ndarray, pose: np.ndarray,
                  intrinsics: np.ndarray, H: int, W: int):
    """World points -> (xy [P, 2] pixels, z [P] depth along the view,
    on_screen [P] bool)."""
    fx, fy, cx, cy = intrinsics
    cam = (points_w - pose[:3, 3]) @ pose[:3, :3]  # R^T (p - t)
    z = -cam[:, 2]
    safe = np.maximum(z, 1e-6)
    x = cam[:, 0] / safe * fx + cx - 0.5
    y = -cam[:, 1] / safe * fy + cy - 0.5
    on = (z > 1e-6) & (x >= 0) & (x < W) & (y >= 0) & (y < H)
    return np.stack([x, y], -1), z, on


def project_to_3d(px: np.ndarray, depth: np.ndarray, pose: np.ndarray,
                  intrinsics: np.ndarray) -> np.ndarray:
    """Pixels [P, 2] and their depths [P] -> world points [P, 3]."""
    fx, fy, cx, cy = intrinsics
    d = np.stack([(px[:, 0] + 0.5 - cx) / fx, -(px[:, 1] + 0.5 - cy) / fy,
                  -np.ones(len(px))], -1)
    return pose[:3, 3] + (d @ pose[:3, :3].T) * depth[:, None]


def generate_masks(cfg: Config, dataset, points_3d: np.ndarray,
                   sam_predictor, out_dir: str, *,
                   negative_points: Optional[np.ndarray] = None,
                   trainer=None, use_nerf_feature: bool = False,
                   depth_threshold: float = 0.05,
                   min_visible: int = 1) -> Dict[str, bool]:
    """The projection and prompting loop over every view of `dataset`
    (module docstring); `trainer` renders the depth for the occlusion test
    and, with `use_nerf_feature`, the feature map. -> valid.json's map."""
    os.makedirs(out_dir, exist_ok=True)
    valid: Dict[str, bool] = {}
    H, W = dataset.H, dataset.W

    for idx in range(len(dataset)):
        frame = dataset.frame(idx)
        name = frame.get("name", f"{idx:04d}")
        pose = frame["pose"]

        depth_map = None
        if trainer is not None:
            out = trainer.render_pose(pose, dataset.intrinsics, H, W)
            depth_map = out["depth"].reshape(H, W)

        xy, z, on = project_to_2d(points_3d, pose, dataset.intrinsics, H, W)
        keep = on.copy()
        if depth_map is not None:
            for k in range(len(xy)):
                if not on[k]:
                    continue
                d = depth_map[int(xy[k, 1]), int(xy[k, 0])]
                if abs(z[k] - d) > depth_threshold:  # occluded
                    keep[k] = False
        pts = xy[keep]
        labels = np.ones(len(pts), np.int32)
        if negative_points is not None and len(negative_points):
            nxy, _, non = project_to_2d(negative_points, pose,
                                        dataset.intrinsics, H, W)
            pts = np.concatenate([pts, nxy[non]])
            labels = np.concatenate([labels,
                                     np.zeros(int(non.sum()), np.int32)])

        valid[name] = int(keep.sum()) >= min_visible
        if not valid[name]:
            np.save(os.path.join(out_dir, f"{name}_masks.npy"),
                    np.full((H, W), -1, np.int64))
            continue

        if use_nerf_feature and trainer is not None:
            lr_h = max(4, int(H / 1024 * 64))
            intr_lr = dataset.intrinsics * (lr_h / H)
            intr_lr[2:] = lr_h / 2
            feat_out = trainer.render_pose(pose, intr_lr, lr_h, lr_h,
                                           return_feats=True)
            feats = feat_out["samvit"].reshape(lr_h, lr_h, -1)
            sam_predictor.set_features(feats, H, W)
        else:
            img = (np.clip(frame["images"].reshape(H, W, -1)[..., :3], 0, 1)
                   * 255).astype(np.uint8)
            sam_predictor.set_image(img)

        masks, _, _ = sam_predictor.predict(pts, labels,
                                            multimask_output=False)
        mask = masks[0]
        np.save(os.path.join(out_dir, f"{name}_masks.npy"),
                np.where(mask, 1, 0).astype(np.int64))
        if "images" in frame:
            _save_overlay(os.path.join(out_dir, f"{name}_overlay.png"),
                          frame["images"].reshape(H, W, -1)[..., :3], mask,
                          pts)

    with open(os.path.join(out_dir, "valid.json"), "w") as f:
        json.dump(valid, f, indent=1)
    return valid


def _save_overlay(path, rgb, mask, pts):
    save_png(path, overlay_mask_and_points(rgb.astype(np.float32), mask,
                                           pts))


def load_scene_metadata(path: str, scene: str, obj: str):
    """The positive and negative 3D prompt points of `obj` in
    scenes_metadata.json ({scene: {obj: entry}} or {obj: entry})."""
    with open(path) as f:
        meta = json.load(f)
    entry = meta[scene][obj] if isinstance(meta.get(scene), dict) else meta[obj]
    pts = np.asarray(entry.get("points", entry.get("positive_points", [])),
                     np.float32)
    neg = np.asarray(entry.get("negative_points", []), np.float32)
    return pts, neg


def main(argv=None, device=None):
    """python -m sanerf_tpu_torch.apps.sam_project <scene> [CLI flags]
    [--scenes_metadata M] [--mask_out D] [--use_nerf_feature]: the labels
    of `--object_name` for the train split, from the workspace's
    checkpoint and `--sam_ckpt`; on `device` (the CUDA card by default)."""
    from sanerf_tpu_torch.apps.main import (build_parser, build_sam_predictor,
                                            config_from_args)
    from sanerf_tpu_torch.data.provider import SceneDataset
    from sanerf_tpu_torch.models import fields
    from sanerf_tpu_torch.train.trainer import Trainer

    p = build_parser()
    p.add_argument("--scenes_metadata", type=str,
                   default="scenes_metadata.json")
    p.add_argument("--mask_out", type=str, default=None)
    p.add_argument("--use_nerf_feature", action="store_true")
    p.add_argument("--sam_type", type=str, default="vit_h",
                   choices=["vit_h", "vit_l", "vit_b"])
    args = p.parse_args(argv)
    cfg = config_from_args(args)

    model = fields.make_model(cfg.model, cfg.render)
    trainer = Trainer("ngp", cfg, model, workspace=cfg.workspace,
                      use_checkpoint=cfg.ckpt, device=device)
    sam = build_sam_predictor(cfg, trainer.device)
    ds = SceneDataset(cfg, "train")
    pts, neg = load_scene_metadata(args.scenes_metadata,
                                   cfg.data.scene_name, cfg.data.object_name)
    out_dir = args.mask_out or os.path.join(cfg.data.path,
                                            cfg.data.object_name)
    return generate_masks(cfg, ds, pts, sam, out_dir, negative_points=neg,
                          trainer=trainer,
                          use_nerf_feature=args.use_nerf_feature)


if __name__ == "__main__":
    main()
