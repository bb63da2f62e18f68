"""Scene dataset provider (JAX: sanerf_tpu/data/provider.py): COLMAP /
transforms.json / LIFT / pano scenes, their pose pipeline, splits, test
trajectories and the three workloads' collates, all host-side numpy, as
in the JAX package; the trainers move batches to the device.

- flavours (`--data_type`): `mip` = a COLMAP model (binary or text) under
  sparse/0, sparse, colmap_sparse or colmap/sparse/0 with images[_<ds>]/;
  `llff` / `3dfront` / `ctr` / `lerf` = transforms.json (`lerf` fixes
  per-view near/far to [0.01, 8]); `lift` = metadata.json quaternions or
  pose/*.txt; `pano` = images/ + pose/*.txt + intrinsic/intrinsic_color.txt;
- poses: the OpenCV -> OpenGL flip, centring (on the sparse points, or the
  cameras with enable_cam_center), auto-scale to max |t| = 1 (or `scale`),
  `offset`; per-view near/far from the sparse depths
  (enable_cam_near_far); the AABB from the points' 1st / 99th percentiles;
- splits: train / every-16th val (`default`), `val_all`, `val_split` from
  scenes_test_view.json; `test` is a `circle` or slerp `interp` trajectory;
- `<name>_masks.npy` per view (label maps, or [K, H, W] stacks) with
  valid.json, and their incoherent maps;
- collates: `collate_train` (random image, random pixels, or rays from 8
  images with random_image_batch), `collate_sam` (an augmented square
  camera and its low-res feature rays), `collate_mask` (global rays,
  multi-res and error-map sampling, local patches at incoherent hotspots),
  `frame`, `update_error_map`.

Images are read by utils/image.py (PNG without OpenCV; other formats
through PIL where it imports).
"""

from __future__ import annotations

import json
import os
from glob import glob
from typing import Dict, List, Optional

import numpy as np

from sanerf_tpu_torch.config import Config
from sanerf_tpu_torch.data import colmap_utils
from sanerf_tpu_torch.data.rays import get_incoherent_mask, sample_rays
from sanerf_tpu_torch.utils import camera as cam_util
from sanerf_tpu_torch.utils.image import load_image as _load_image
from sanerf_tpu_torch.utils.image import resize


class SceneDataset:
    """One split of one scene."""

    def __init__(self, cfg: Config, split: str = "train"):
        self.cfg = cfg
        self.dc = cfg.data
        self.split = split
        self.training = split in ("train", "trainval", "all")

        self.poses: np.ndarray = None  # [M, 4, 4] OpenGL c2w
        self.images: Optional[np.ndarray] = None  # [M, H, W, 3/4] float32 [0,1]
        self.intrinsics: np.ndarray = None  # [4]
        self.names: List[str] = []
        self.cam_near_far: Optional[np.ndarray] = None  # [M, 2]
        self.pts_aabb: Optional[np.ndarray] = None
        self.masks: Optional[np.ndarray] = None  # [M, H, W] int labels
        self.incoherent_masks: Optional[np.ndarray] = None
        self.error_map: Optional[np.ndarray] = None  # [M, S*S]

        loader = {
            "mip": self._load_colmap,
            "llff": self._load_transforms,
            "3dfront": self._load_transforms,
            "lerf": self._load_transforms,
            "lift": self._load_lift,
            "pano": self._load_pano,
            "ctr": self._load_transforms,
        }[self.dc.data_type]
        loader()
        self._apply_split()
        if self.cfg.mask.error_map and self.training:
            S = self.cfg.mask.error_map_size
            self.error_map = np.ones((len(self.poses), S * S), np.float32) * 0.1
        self.multi_res_level = 0  # raised by the trainer (use_multi_res)

    # -- loaders --------------------------------------------------------------

    def _finalize_poses(self, poses: np.ndarray, pts3d: Optional[np.ndarray]):
        poses, pts3d = cam_util.center_poses(
            poses, pts3d, self.dc.enable_cam_center
        )
        if self.dc.scale == -1:
            poses, pts3d, self.scale = cam_util.auto_scale_poses(poses, pts3d)
        else:
            self.scale = self.dc.scale
            poses[:, :3, 3] *= self.scale
            if pts3d is not None:
                pts3d = pts3d * self.scale
        poses[:, :3, 3] += np.asarray(self.dc.offset, np.float32)
        if pts3d is not None and len(pts3d):
            mn, mx = np.percentile(pts3d, 1, 0), np.percentile(pts3d, 99, 0)
            self.pts_aabb = np.concatenate([mn, mx]).astype(np.float32)
        return poses, pts3d

    def _load_colmap(self):
        root = self.dc.path
        sparse = None
        for cand in ("sparse/0", "sparse", "colmap_sparse", "colmap/sparse/0"):
            if os.path.isdir(os.path.join(root, cand)):
                sparse = os.path.join(root, cand)
                break
        if sparse is None:
            raise FileNotFoundError(f"no COLMAP sparse model under {root}")
        cams, images, pts3d, _, id_map = colmap_utils.read_model(sparse)

        img_dir = None
        ds = self.dc.downscale
        for cand in ([f"images_{ds}"] if ds > 1 else []) + ["images", "image"]:
            if os.path.isdir(os.path.join(root, cand)):
                img_dir = os.path.join(root, cand)
                pre_scaled = cand.startswith("images_")
                break
        if img_dir is None:
            raise FileNotFoundError(f"no images dir under {root}")

        keys = sorted(images.keys(), key=lambda k: images[k].name)
        poses, names, depths_nf = [], [], []
        per_view_pts = []
        for k in keys:
            im = images[k]
            if not os.path.exists(os.path.join(img_dir, os.path.basename(im.name))):
                continue  # missing-image filtering (colmap_provider.py:467-471)
            c2w = im.cam_to_world().astype(np.float32)
            poses.append(cam_util.nerf_matrix_to_ngp(c2w, scale=1.0))
            names.append(os.path.basename(im.name))
            valid = im.point3d_ids >= 0
            rows = [id_map[i] for i in im.point3d_ids[valid] if i in id_map]
            per_view_pts.append(np.asarray(rows, np.int64))
        poses = np.stack(poses)

        cam = cams[images[keys[0]].camera_id]
        eff_ds = 1 if pre_scaled else ds
        self.intrinsics = np.array(
            [cam.fx / eff_ds, cam.fy / eff_ds, cam.cx / eff_ds, cam.cy / eff_ds],
            np.float32,
        )
        # nerf_matrix_to_ngp flips the camera's y/z axes (OpenCV -> OpenGL
        # convention), a per-camera basis change; world points are untouched
        poses, pts3d = self._finalize_poses(poses, pts3d.astype(np.float32))
        self.poses = poses
        self.names = names

        # per-view near/far from sparse depths (colmap_provider.py:554-600)
        if self.dc.enable_cam_near_far and len(pts3d):
            nf = []
            for i, rows in enumerate(per_view_pts):
                if len(rows) == 0:
                    nf.append([0.05, 1000.0])
                    continue
                w2c_R = poses[i, :3, :3].T
                cam_pts = (pts3d[rows] - poses[i, :3, 3]) @ w2c_R.T
                depth = -cam_pts[:, 2]  # OpenGL forward = -z
                depth = depth[depth > 0]
                if len(depth) == 0:
                    nf.append([0.05, 1000.0])
                else:
                    nf.append([
                        max(float(np.percentile(depth, 1)) * 0.5, 0.05),
                        float(np.percentile(depth, 99)) * 50.0,
                    ])
            self.cam_near_far = np.asarray(nf, np.float32)

        self._load_images(img_dir, 1 if pre_scaled else ds)
        self._maybe_load_masks()

    def _load_transforms(self):
        root = self.dc.path
        tf_path = None
        for cand in (f"transforms_{self.split}.json", "transforms.json",
                     "transforms_train.json"):
            if os.path.exists(os.path.join(root, cand)):
                tf_path = os.path.join(root, cand)
                break
        if tf_path is None:
            raise FileNotFoundError(f"no transforms json under {root}")
        with open(tf_path) as f:
            meta = json.load(f)

        frames = meta["frames"]
        poses, names, paths = [], [], []
        for fr in frames:
            m = np.asarray(fr["transform_matrix"], np.float32)
            poses.append(m)  # transforms.json is already OpenGL c2w
            fp = fr["file_path"]
            if not os.path.splitext(fp)[1]:
                fp = fp + ".png"
            paths.append(os.path.join(root, fp))
            names.append(os.path.splitext(os.path.basename(fp))[0])
        poses = np.stack(poses)
        poses, _ = self._finalize_poses(poses, None)
        self.poses = poses
        self.names = names

        ds = self.dc.downscale
        img0 = _load_image(paths[0], ds)
        H, W = img0.shape[:2]
        if "fl_x" in meta:
            fx, fy = meta["fl_x"] / ds, meta.get("fl_y", meta["fl_x"]) / ds
            cx, cy = meta.get("cx", W * ds / 2) / ds, meta.get("cy", H * ds / 2) / ds
        elif "camera_angle_x" in meta:
            fx = fy = 0.5 * W / np.tan(0.5 * meta["camera_angle_x"])
            cx, cy = W / 2, H / 2
        else:
            raise ValueError("transforms.json missing intrinsics")
        self.intrinsics = np.array([fx, fy, cx, cy], np.float32)
        imgs = [img0] + [_load_image(p, ds) for p in paths[1:]]
        self.images = (np.stack(imgs).astype(np.float32) / 255.0)
        self.H, self.W = H, W
        if self.dc.data_type == "lerf" and self.split != "test":
            # LERF fixes per-view near/far to [0.01, 8] for every train/val
            # camera (lerf_provider.py:117)
            self.cam_near_far = np.tile(
                np.asarray([[0.01, 8.0]], np.float32), (len(self.poses), 1))
        self._maybe_load_masks()

    def _load_lift(self):
        """LIFT-style layout: metadata.json quaternions or pose/*.txt +
        intrinsic txt (colmap_provider.py:268-354)."""
        root = self.dc.path
        meta_path = os.path.join(root, "metadata.json")
        poses, names, paths = [], [], []
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            for name, fr in sorted(meta.items()):
                q = np.asarray(fr["quaternion"], np.float64)
                t = np.asarray(fr["translation"], np.float64)
                m = np.eye(4, dtype=np.float32)
                m[:3, :3] = colmap_utils.qvec2rotmat(q)
                m[:3, 3] = t
                poses.append(cam_util.nerf_matrix_to_ngp(m))
                names.append(name)
                paths.append(os.path.join(root, "rgb", name + ".png"))
        else:
            for pf in sorted(glob(os.path.join(root, "pose", "*.txt"))):
                m = np.loadtxt(pf).reshape(4, 4).astype(np.float32)
                poses.append(cam_util.nerf_matrix_to_ngp(m))
                name = os.path.splitext(os.path.basename(pf))[0]
                names.append(name)
                paths.append(os.path.join(root, "rgb", name + ".png"))
        poses = np.stack(poses)
        poses, _ = self._finalize_poses(poses, None)
        self.poses = poses
        self.names = names

        intr_path = os.path.join(root, "intrinsics.txt")
        ds = self.dc.downscale
        img0 = _load_image(paths[0], ds)
        self.H, self.W = img0.shape[:2]
        if os.path.exists(intr_path):
            K = np.loadtxt(intr_path).reshape(-1)
            if K.size >= 9:
                K = K[:9].reshape(3, 3)
                self.intrinsics = np.array(
                    [K[0, 0] / ds, K[1, 1] / ds, K[0, 2] / ds, K[1, 2] / ds], np.float32
                )
            else:
                f = K[0] / ds
                self.intrinsics = np.array([f, f, self.W / 2, self.H / 2], np.float32)
        else:
            f = 0.5 * self.W / np.tan(np.deg2rad(30.0))
            self.intrinsics = np.array([f, f, self.W / 2, self.H / 2], np.float32)
        imgs = [img0] + [_load_image(p, ds) for p in paths[1:]]
        self.images = np.stack(imgs).astype(np.float32) / 255.0
        self._maybe_load_masks()

    def _load_pano(self):
        """Pano layout (colmap_provider.py:357-423): images[_<ds>]/ +
        pose/<name>.txt 4x4 c2w matrices with the y/z columns negated
        in-place (OpenCV -> OpenGL), and a single shared
        intrinsic/intrinsic_color.txt matrix ([fx, fy, cx, cy] from its
        diagonal and second-to-last column). AABB estimated from camera
        centers (not sparse points — there is no COLMAP model here)."""
        root = self.dc.path
        ds = self.dc.downscale
        img_dir = os.path.join(root, f"images_{ds}")
        if not os.path.isdir(img_dir):
            img_dir = os.path.join(root, "images")
        names = sorted(os.listdir(img_dir))

        intr_file = os.path.join(root, "intrinsic", "intrinsic_color.txt")
        K = np.loadtxt(intr_file, dtype=np.float64)
        intr = np.array([K[0, 0], K[1, 1], K[0, -2], K[1, -2]], np.float32)

        poses, keep = [], []
        for name in names:
            pf = os.path.join(root, "pose", os.path.splitext(name)[0] + ".txt")
            ip = os.path.join(img_dir, name)
            if not (os.path.exists(pf) and os.path.exists(ip)):
                continue
            m = np.loadtxt(pf).reshape(4, 4).astype(np.float32)
            m[:, 1:3] = -m[:, 1:3]  # colmap_provider.py:384
            poses.append(m)
            keep.append(name)
        poses = np.stack(poses)
        cam_pts = poses[:, :3, 3].copy()
        poses, cam_pts = self._finalize_poses(poses, cam_pts)
        # reference estimates the AABB from the (centered, scaled) camera
        # centers' min/max (colmap_provider.py:409)
        self.pts_aabb = np.concatenate(
            [cam_pts.min(0), cam_pts.max(0)]).astype(np.float32)
        self.poses = poses
        self.names = keep
        img0 = _load_image(os.path.join(img_dir, keep[0]), 1)
        self.H, self.W = img0.shape[:2]
        self.intrinsics = intr
        self.images = np.stack(
            [img0] + [_load_image(os.path.join(img_dir, n), 1)
                      for n in keep[1:]]
        ).astype(np.float32) / 255.0
        self._maybe_load_masks()

    def _load_images(self, img_dir: str, ds: int):
        imgs = [
            _load_image(os.path.join(img_dir, n), ds) for n in self.names
        ]
        self.images = np.stack(imgs).astype(np.float32) / 255.0
        self.H, self.W = self.images.shape[1:3]

    def _maybe_load_masks(self):
        """Per-object instance masks `<name>_masks.npy` + valid.json filter
        (colmap_provider.py:752-844)."""
        mf = self.cfg.mask.mask_folder_name
        if not (self.cfg.model.with_mask and mf):
            return
        mask_dir = os.path.join(self.dc.path, mf)
        if not os.path.isdir(mask_dir):
            mask_dir = mf  # absolute path
        valid_names = None
        vj = os.path.join(mask_dir, "valid.json")
        if os.path.exists(vj):
            with open(vj) as f:
                valid = json.load(f)
            valid_names = {k for k, v in valid.items() if v}
        masks = []
        for name in self.names:
            p = os.path.join(mask_dir, f"{name}_masks.npy")
            if os.path.exists(p) and (valid_names is None or name in valid_names):
                m = np.load(p)
                if m.ndim == 3:  # [K, H, W] binary stack -> labels
                    lab = np.full(m.shape[1:], -1, np.int64)
                    for k in range(m.shape[0]):
                        lab[m[k] > 0] = k
                    m = lab
                masks.append(m.astype(np.int64))
            else:
                masks.append(np.full((self.H, self.W), -1, np.int64))  # zero-fill
        self.masks = np.stack(masks)
        self.incoherent_masks = np.stack(
            [get_incoherent_mask((m >= 0).astype(np.float32),
                                 sfact=max(1, self.cfg.mask.incoherent_downsample_scale))
             for m in self.masks]
        )

    # -- splits & trajectories -------------------------------------------------

    def _apply_split(self):
        M = len(self.poses)
        if self.split == "test":
            # synthesized trajectory (colmap_provider.py:608-654)
            if self.dc.camera_traj == "circle":
                radius = float(np.linalg.norm(self.poses[:, :3, 3], axis=-1).mean())
                self.poses = cam_util.circle_poses(radius=radius, n=100)
            else:
                rng = np.random.default_rng(self.cfg.seed)
                anchors = self.poses[rng.choice(M, size=min(5, M), replace=False)]
                self.poses = cam_util.interp_poses(anchors, n_per_segment=20)
            self.images = None
            self.masks = None
            self.names = [f"{i:04d}" for i in range(len(self.poses))]
            return
        if self.split in ("train", "trainval", "all"):
            if self.split == "all" or self.cfg.data.val_type == "val_all":
                idx = np.arange(M)
            else:
                idx = np.asarray([i for i in range(M) if i % 16 != 0] or [0])
                if self.split == "trainval":
                    idx = np.arange(M)
        else:  # val
            if self.cfg.data.val_type == "val_all":
                idx = np.arange(M)
            elif self.cfg.data.val_type == "val_split":
                idx = self._val_split_indices()
            else:
                idx = np.asarray([i for i in range(M) if i % 16 == 0] or [0])
        self._select(idx)

    def _val_split_indices(self):
        """Held-out eval views from scenes_test_view.json
        (colmap_provider.py:672-684)."""
        p = os.path.join(self.dc.path, "scenes_test_view.json")
        if not os.path.exists(p):
            p = "scenes_test_view.json"
        if os.path.exists(p):
            with open(p) as f:
                registry = json.load(f)
            wanted = set(registry.get(self.dc.scene_name, []))
            idx = [i for i, n in enumerate(self.names) if os.path.splitext(n)[0] in wanted or n in wanted]
            if idx:
                return np.asarray(idx)
        return np.asarray([i for i in range(len(self.poses)) if i % 16 == 0] or [0])

    def _select(self, idx: np.ndarray):
        self.poses = self.poses[idx]
        self.names = [self.names[i] for i in idx]
        if self.images is not None:
            self.images = self.images[idx]
        if self.cam_near_far is not None:
            self.cam_near_far = self.cam_near_far[idx]
        if self.masks is not None:
            self.masks = self.masks[idx]
            self.incoherent_masks = self.incoherent_masks[idx]

    # -- collates ----------------------------------------------------------------

    def __len__(self):
        return len(self.poses)

    def collate_train(self, rng: np.random.Generator, num_rays: int) -> Dict:
        """Stage-1 RGB batch: random image, random pixels."""
        if self.dc.random_image_batch:
            # rays from all images (colmap_provider random_image_batch)
            per = max(1, num_rays // 8)
            parts, gts, cnfs = [], [], []
            idxs = rng.integers(0, len(self.poses), 8)
            for i in idxs:
                rb = sample_rays(self.poses[i], self.intrinsics, self.H, self.W,
                                 N=per, rng=rng)
                parts.append(rb)
                gts.append(self.images[i].reshape(-1, self.images.shape[-1])[rb.inds])
                if self.cam_near_far is not None:
                    cnfs.append(np.broadcast_to(self.cam_near_far[i], (per, 2)))
            batch = {
                "rays_o": np.concatenate([p.rays_o for p in parts]),
                "rays_d": np.concatenate([p.rays_d for p in parts]),
                "images": np.concatenate(gts),
                "index": idxs[0],
                "H": self.H, "W": self.W,
            }
            if cnfs:
                batch["cam_near_far"] = np.concatenate(cnfs)
            return batch
        i = int(rng.integers(0, len(self.poses)))
        rb = sample_rays(self.poses[i], self.intrinsics, self.H, self.W,
                         N=num_rays, rng=rng)
        batch = {
            "rays_o": rb.rays_o,
            "rays_d": rb.rays_d,
            "images": self.images[i].reshape(-1, self.images.shape[-1])[rb.inds],
            "index": i,
            "H": self.H, "W": self.W,
        }
        if self.cam_near_far is not None:
            batch["cam_near_far"] = np.broadcast_to(
                self.cam_near_far[i], (num_rays if num_rays > 0 else self.H * self.W, 2)
            ).copy()
        return batch

    def collate_sam(self, rng: np.random.Generator,
                    index: Optional[int] = None) -> Dict:
        """Stage-2 distillation frame: augmented square camera (random fovy
        50-70 deg at train, fixed 60 at eval; colmap_provider.py:989-1015) +
        low-res feature rays with the 64/1024 SAM scale (1187-1196).
        `index` pins the pose — the fixed-view eval protocol (the reference
        evaluates fixed val views, utils.py:1122-1241)."""
        sc = self.cfg.sam
        res = sc.online_resolution
        i = int(rng.integers(0, len(self.poses))) if index is None else index
        pose = self.poses[i]
        if self.training and sc.pose_jittering and len(self.poses) > 1:
            # slerp between two random train poses (lerf_provider.py:261-278)
            j = int(rng.integers(0, len(self.poses)))
            t = float(rng.uniform(0.2, 0.8))
            qa = cam_util.rotmat_to_quat(self.poses[i][:3, :3])
            qb = cam_util.rotmat_to_quat(self.poses[j][:3, :3])
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = cam_util.quat_to_rotmat(cam_util.slerp_quat(qa, qb, t))
            pose[:3, 3] = (1 - t) * self.poses[i][:3, 3] + t * self.poses[j][:3, 3]
        if self.training:
            fovy = float(rng.uniform(*sc.fovy_range))
        else:
            fovy = sc.eval_fovy
        f = cam_util.fov_to_focal(fovy, res)
        intr = np.array([f, f, res / 2, res / 2], np.float32)
        rb = sample_rays(pose, intr, res, res, N=-1)
        # low-res feature rays: 64px per 1024 input (utils.py:1094 comment)
        lr = int(res / 1024 * 64)
        intr_lr = intr * (lr / res)
        intr_lr[2:] = lr / 2
        rb_lr = sample_rays(pose, intr_lr, lr, lr, N=-1)
        batch = {
            "rays_o": rb.rays_o, "rays_d": rb.rays_d,
            "rays_o_lr": rb_lr.rays_o, "rays_d_lr": rb_lr.rays_d,
            "H": res, "W": res, "h": lr, "w": lr, "index": i,
        }
        if self.cam_near_far is not None:
            batch["cam_near_far"] = self.cam_near_far[i : i + 1]
        return batch

    def collate_mask(self, rng: np.random.Generator, num_rays: int) -> Dict:
        """Stage-3 mask batch: global random rays + optional local patches
        at incoherent/error hotspots (mixed sampling,
        colmap_provider.py:1047-1070)."""
        mc = self.cfg.mask
        i = int(rng.integers(0, len(self.poses)))
        # multi-resolution schedule (colmap_provider.py:940-962): early
        # training samples a coarse pixel grid; the trainer raises the level
        stride = 1
        if mc.use_multi_res:
            stride = 2 ** max(0, mc.max_multi_res_level - self.multi_res_level)
        if stride > 1:
            Hs, Ws = self.H // stride, self.W // stride
            sub = rng.integers(0, Hs * Ws, num_rays)
            ys, xs = np.divmod(sub, Ws)
            coords = np.stack([ys * stride, xs * stride], -1)
            rb = sample_rays(self.poses[i], self.intrinsics, self.H, self.W,
                             coords=coords, rng=rng)
        else:
            rb = sample_rays(self.poses[i], self.intrinsics, self.H, self.W,
                         N=num_rays, rng=rng,
                         importance_map=self.error_map[i] if self.error_map is not None else None,
                         importance_size=mc.error_map_size)
        parts = [rb]
        if mc.mixed_sampling:
            imap = None
            if self.incoherent_masks is not None:
                S = mc.error_map_size
                imap = resize(self.incoherent_masks[i].astype(np.float32),
                              (S, S), "linear").reshape(-1)
                imap = imap + 1e-3
            for _ in range(mc.num_local_sample):
                parts.append(
                    sample_rays(
                        self.poses[i], self.intrinsics, self.H, self.W,
                        N=mc.local_sample_patch_size**2,
                        patch_size=mc.local_sample_patch_size,
                        importance_map=imap, patch_from_map=imap is not None,
                        importance_size=mc.error_map_size, rng=rng,
                    )
                )
        inds = np.concatenate([p.inds for p in parts])
        batch = {
            "rays_o": np.concatenate([p.rays_o for p in parts]),
            "rays_d": np.concatenate([p.rays_d for p in parts]),
            "inds": inds,
            "inds_coarse": np.concatenate([p.inds_coarse for p in parts]),
            "index": i,
            "H": self.H, "W": self.W,
        }
        if self.masks is not None:
            batch["masks"] = self.masks[i].reshape(-1)[inds]
            batch["incoherent_masks"] = self.incoherent_masks[i].reshape(-1)[inds]
        if self.images is not None:
            batch["images"] = self.images[i].reshape(-1, self.images.shape[-1])[inds]
        if self.error_map is not None:
            batch["error_maps"] = self.error_map[i][batch["inds_coarse"]]
        if self.cam_near_far is not None:
            batch["cam_near_far"] = np.broadcast_to(
                self.cam_near_far[i], (len(inds), 2)
            ).copy()
        return batch

    def frame(self, idx: int) -> Dict:
        rb = sample_rays(self.poses[idx], self.intrinsics, self.H, self.W, N=-1)
        out = {
            "rays_o": rb.rays_o, "rays_d": rb.rays_d,
            "H": self.H, "W": self.W, "index": idx,
            "pose": self.poses[idx],
            "name": self.names[idx] if self.names else f"{idx:04d}",
        }
        if self.images is not None:
            out["images"] = self.images[idx].reshape(-1, self.images.shape[-1])
        if self.masks is not None:
            out["masks"] = self.masks[idx].reshape(-1)
        if self.cam_near_far is not None:
            out["cam_near_far"] = self.cam_near_far[idx : idx + 1]
        return out

    def update_error_map(self, index: int, inds_coarse: np.ndarray, error: np.ndarray):
        """EMA error-map update (utils.py:1002-1017)."""
        em = self.error_map[index]
        em[inds_coarse] = 0.1 * em[inds_coarse] + 0.9 * error
