"""Scene files from the synthetic fixture, for driving the CLI
(`sanerf_tpu_torch.apps.main`) end to end without a downloaded scene.

- `write_transforms_scene(ds, root)`: `<root>/r_<i>.png` (8-bit RGB,
  truncated as the JAX suite's CLI test writes them) and a transforms.json
  with `camera_angle_x` (read by `--data_type llff`);
- `write_colmap_scene(ds, root, pts3d)`: the same images under
  `<root>/images/` and the same cameras as a binary COLMAP model under
  `<root>/sparse/0` (PINHOLE; each image sees the points) (read by
  `--data_type mip`);
- `write_masks(root, folder, names, labels)`: `<name>_masks.npy` label
  maps and a valid.json (`--mask_folder_name`).

numpy and the standard library only (PNGs through the trainer's writer).
Called by chip_smoke.py's `cli` phase and tests/test_torch_cli.py.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

from sanerf_tpu_torch.data import colmap_utils
from sanerf_tpu_torch.train.trainer import save_png


def _png(path: str, img: np.ndarray) -> None:
    save_png(path, (img * 255).astype(np.uint8))


def write_transforms_scene(ds, root: str) -> str:
    os.makedirs(root, exist_ok=True)
    frames = []
    for i in range(len(ds)):
        _png(os.path.join(root, f"r_{i}.png"), ds.images[i])
        frames.append({"file_path": f"r_{i}",
                       "transform_matrix": ds.poses[i].tolist()})
    angle = 2 * np.arctan(0.5 * ds.W / ds.intrinsics[0])
    with open(os.path.join(root, "transforms.json"), "w") as f:
        json.dump({"camera_angle_x": float(angle), "frames": frames}, f)
    return root


def write_colmap_scene(ds, root: str, pts3d: np.ndarray) -> str:
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    fx, fy, cx, cy = (float(v) for v in ds.intrinsics)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, ds.W, ds.H))  # PINHOLE
        f.write(struct.pack("<4d", fx, fy, cx, cy))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(ds)))
        for i, pose in enumerate(ds.poses):
            cv = pose.astype(np.float64).copy()
            cv[:3, 1:3] *= -1  # OpenGL -> OpenCV camera axes
            w2c = np.linalg.inv(cv)
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<4d", *colmap_utils.rotmat2qvec(w2c[:3, :3])))
            f.write(struct.pack("<3d", *w2c[:3, 3]))
            f.write(struct.pack("<i", 1))
            f.write(f"r_{i}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", len(pts3d)))
            for j in range(len(pts3d)):
                f.write(struct.pack("<2d", 0.0, 0.0))
                f.write(struct.pack("<q", j))
            _png(os.path.join(root, "images", f"r_{i}.png"), ds.images[i])
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(pts3d)))
        for j, p in enumerate(pts3d):
            f.write(struct.pack("<Q", j))
            f.write(struct.pack("<3d", *p))
            f.write(struct.pack("<3B", 128, 128, 128))
            f.write(struct.pack("<d", 0.5))
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<ii", 1, 0))
    return root


def write_masks(root: str, folder: str, names, labels) -> str:
    """labels [M, H, W] int (-1 unlabelled) saved as `<name>_masks.npy`
    under root/folder, all marked valid."""
    d = os.path.join(root, folder)
    os.makedirs(d, exist_ok=True)
    for name, lab in zip(names, labels):
        np.save(os.path.join(d, f"{name}_masks.npy"), lab.astype(np.int64))
    with open(os.path.join(d, "valid.json"), "w") as f:
        json.dump({n: True for n in names}, f)
    return d
