"""COLMAP sparse-reconstruction readers (cameras / images / points3D);
the JAX package's sanerf_tpu/data/colmap_utils.py, kept as the port's
own copy (numpy only).

Implements the documented COLMAP binary and text formats
(https://colmap.github.io/format.html), providing the same capability as
the reference's nerf/colmap_utils.py (itself derived from COLMAP's own
scripts): `read_cameras_{binary,text}`, `read_images_{binary,text}`,
`read_points3d_{binary,text}`, and quaternion helpers.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

# camera model id -> (name, num_params) per the COLMAP spec
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    @property
    def fx(self):
        return self.params[0]

    @property
    def fy(self):
        return self.params[0] if self.model.startswith("SIMPLE") else self.params[1]

    @property
    def cx(self):
        return self.params[1] if self.model.startswith("SIMPLE") else self.params[2]

    @property
    def cy(self):
        return self.params[2] if self.model.startswith("SIMPLE") else self.params[3]


@dataclass
class Image:
    id: int
    qvec: np.ndarray  # [4] (w, x, y, z) world->cam rotation
    tvec: np.ndarray  # [3]
    camera_id: int
    name: str
    xys: np.ndarray  # [P, 2]
    point3d_ids: np.ndarray  # [P]

    def rotmat(self) -> np.ndarray:
        return qvec2rotmat(self.qvec)

    def world_to_cam(self) -> np.ndarray:
        m = np.eye(4, dtype=np.float64)
        m[:3, :3] = self.rotmat()
        m[:3, 3] = self.tvec
        return m

    def cam_to_world(self) -> np.ndarray:
        return np.linalg.inv(self.world_to_cam())


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    K = (
        np.array(
            [
                [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
                [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
                [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
                [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
                 R[0, 0] + R[1, 1] + R[2, 2]],
            ]
        )
        / 3.0
    )
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def _read(fh, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, fh.read(size))


def read_cameras_binary(path: str) -> Dict[int, Camera]:
    cams = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(fh, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(fh, f"<{n_params}d"))
            cams[cam_id] = Camera(cam_id, name, int(w), int(h), params)
    return cams


def read_images_binary(path: str) -> Dict[int, Image]:
    images = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            img_id = _read(fh, "<i")[0]
            qvec = np.array(_read(fh, "<4d"))
            tvec = np.array(_read(fh, "<3d"))
            cam_id = _read(fh, "<i")[0]
            name = b""
            while True:
                c = fh.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(fh, "<Q")
            rec = np.frombuffer(
                fh.read(24 * n_pts),
                dtype=np.dtype([("x", "<f8"), ("y", "<f8"), ("id", "<i8")]),
            )
            xys = np.stack([rec["x"], rec["y"]], axis=-1) if n_pts else np.zeros((0, 2))
            ids = rec["id"].copy()
            images[img_id] = Image(
                img_id, qvec, tvec, cam_id, name.decode(), xys, ids
            )
    return images


def read_points3d_binary(path: str) -> Tuple[np.ndarray, np.ndarray, Dict[int, int]]:
    """Returns (xyz [P,3], rgb [P,3] uint8, id->row index map)."""
    xyzs, rgbs, id_map = [], [], {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for row in range(n):
            pid = _read(fh, "<Q")[0]
            xyz = _read(fh, "<3d")
            rgb = _read(fh, "<3B")
            _err = _read(fh, "<d")
            (track_len,) = _read(fh, "<Q")
            fh.read(8 * track_len)  # (image_id, point2d_idx) pairs
            xyzs.append(xyz)
            rgbs.append(rgb)
            id_map[pid] = row
    return (
        np.asarray(xyzs, np.float64).reshape(-1, 3),
        np.asarray(rgbs, np.uint8).reshape(-1, 3),
        id_map,
    )


# -- text-format fallbacks ----------------------------------------------------


def read_cameras_text(path: str) -> Dict[int, Camera]:
    cams = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            cam_id, model = int(parts[0]), parts[1]
            w, h = int(parts[2]), int(parts[3])
            params = np.array([float(p) for p in parts[4:]])
            cams[cam_id] = Camera(cam_id, model, w, h, params)
    return cams


def read_images_text(path: str) -> Dict[int, Image]:
    images = {}
    with open(path) as fh:
        lines = [l for l in fh if not l.startswith("#") and l.strip()]
    for meta, pts in zip(lines[0::2], lines[1::2]):
        parts = meta.split()
        img_id = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        vals = pts.split()
        xys = np.array(vals, dtype=np.float64).reshape(-1, 3)[:, :2] if vals else np.zeros((0, 2))
        ids = (
            np.array(vals[2::3], dtype=np.int64) if vals else np.zeros((0,), np.int64)
        )
        images[img_id] = Image(img_id, qvec, tvec, cam_id, name, xys, ids)
    return images


def read_points3d_text(path: str):
    xyzs, rgbs, id_map = [], [], {}
    with open(path) as fh:
        row = 0
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            id_map[int(parts[0])] = row
            xyzs.append([float(p) for p in parts[1:4]])
            rgbs.append([int(p) for p in parts[4:7]])
            row += 1
    return (
        np.asarray(xyzs, np.float64).reshape(-1, 3),
        np.asarray(rgbs, np.uint8).reshape(-1, 3),
        id_map,
    )


def read_model(sparse_dir: str):
    """Auto-detect binary vs text model files."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cams = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
        images = read_images_binary(os.path.join(sparse_dir, "images.bin"))
        pts, rgb, id_map = read_points3d_binary(os.path.join(sparse_dir, "points3D.bin"))
    else:
        cams = read_cameras_text(os.path.join(sparse_dir, "cameras.txt"))
        images = read_images_text(os.path.join(sparse_dir, "images.txt"))
        pts, rgb, id_map = read_points3d_text(os.path.join(sparse_dir, "points3D.txt"))
    return cams, images, pts, rgb, id_map
