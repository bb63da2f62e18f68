"""Camera/pose math (numpy; JAX package: sanerf_tpu/utils/camera.py; the
viewer's orbit camera since its port). cam2world matrices follow the OpenGL
convention (x right, y up, camera looks along -z); the dataset pipeline
flips COLMAP's (OpenCV) cameras into it, centres and scales the scene; the
test trajectories are a circle or a slerp through train poses."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def normalize(v: np.ndarray, eps: float = 1e-20) -> np.ndarray:
    return v / (np.linalg.norm(v, axis=-1, keepdims=True) + eps)


def look_at(campos: np.ndarray, target: np.ndarray,
            up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """OpenGL-convention c2w rotation looking from campos to target."""
    forward = normalize(campos - target)
    right = normalize(np.cross(np.asarray(up, np.float32), forward))
    up_v = normalize(np.cross(forward, right))
    return np.stack([right, up_v, forward], axis=-1)


def circle_poses(radius: float = 2.0, height: float = 0.0, n: int = 100,
                 target=(0.0, 0.0, 0.0)) -> np.ndarray:
    """[n, 4, 4] poses on a circle around `target`, looking at it."""
    target = np.asarray(target, np.float32)
    poses = []
    for theta in np.linspace(0, 2 * np.pi, n, endpoint=False):
        campos = np.array(
            [radius * np.cos(theta), height, radius * np.sin(theta)], np.float32
        ) + target
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = look_at(campos, target)
        pose[:3, 3] = campos
        poses.append(pose)
    return np.stack(poses)


def fov_to_focal(fov_deg: float, pixels: int) -> float:
    return 0.5 * pixels / np.tan(0.5 * np.deg2rad(fov_deg))


def nerf_matrix_to_ngp(pose: np.ndarray, scale: float = 1.0,
                       offset=(0.0, 0.0, 0.0)) -> np.ndarray:
    """COLMAP/NeRF (OpenCV-ish) c2w -> the renderer's OpenGL convention with
    scene scale/offset applied (colmap_provider.py:28-36 semantics: flip y/z
    columns, scale+offset translation)."""
    out = pose.astype(np.float32).copy()
    out[:3, 1] *= -1
    out[:3, 2] *= -1
    out[:3, 3] = out[:3, 3] * scale + np.asarray(offset, np.float32)
    return out


def center_poses(poses: np.ndarray, pts3d: Optional[np.ndarray] = None,
                 enable_cam_center: bool = False) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Recenter the scene at the camera/point centroid
    (colmap_provider.py:50-74): subtract the centroid from all camera
    positions (and sparse points when given)."""
    if pts3d is None or enable_cam_center:
        center = poses[:, :3, 3].mean(0)
    else:
        center = pts3d.mean(0)
    poses = poses.copy()
    poses[:, :3, 3] -= center
    if pts3d is not None:
        pts3d = pts3d - center
    return poses, pts3d


def auto_scale_poses(poses: np.ndarray, pts3d: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, Optional[np.ndarray], float]:
    """Scale camera positions to fit a unit-ish radius
    (colmap_provider.py:528-533: scale = 1 / max |t|)."""
    radius = np.abs(poses[:, :3, 3]).max()
    scale = 1.0 / max(radius, 1e-8)
    poses = poses.copy()
    poses[:, :3, 3] *= scale
    if pts3d is not None:
        pts3d = pts3d * scale
    return poses, pts3d, scale


def slerp_quat(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        return normalize(q0 + t * (q1 - q0))
    th = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    w = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    if w < 1e-8:
        # fall back via largest diagonal
        i = int(np.argmax([R[0, 0], R[1, 1], R[2, 2]]))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1e-12, 1 + R[i, i] - R[j, j] - R[k, k])) * 2
        q = np.zeros(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = s / 4
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
        return normalize(q)
    return normalize(
        np.array([w, (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
                  (R[1, 0] - R[0, 1]) / (4 * w)])
    )


def quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )


def interp_poses(anchors: np.ndarray, n_per_segment: int = 20) -> np.ndarray:
    """Slerp+lerp interpolated trajectory through anchor poses
    (colmap_provider.py:639-654)."""
    out = []
    for a, b in zip(anchors[:-1], anchors[1:]):
        qa, qb = rotmat_to_quat(a[:3, :3]), rotmat_to_quat(b[:3, :3])
        for t in np.linspace(0, 1, n_per_segment, endpoint=False):
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = quat_to_rotmat(slerp_quat(qa, qb, float(t)))
            pose[:3, 3] = (1 - t) * a[:3, 3] + t * b[:3, 3]
            out.append(pose)
    return np.stack(out)


class OrbitCamera:
    """The viewer's orbit camera: orbit / pan / zoom around a centre ->
    an OpenGL cam2world pose and pinhole intrinsics."""

    def __init__(self, W: int, H: int, r: float = 2.0, fovy: float = 60.0):
        self.W, self.H = W, H
        self.radius = r
        self.fovy = fovy
        self.center = np.zeros(3, np.float32)
        self.rot = np.eye(3, dtype=np.float32)

    @property
    def pose(self) -> np.ndarray:
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = self.rot
        pose[:3, 3] = self.center + self.rot @ np.array(
            [0, 0, self.radius], np.float32)
        return pose

    @property
    def intrinsics(self) -> np.ndarray:
        focal = fov_to_focal(self.fovy, self.H)
        return np.array([focal, focal, self.W / 2, self.H / 2], np.float32)

    def orbit(self, dx: float, dy: float):
        side = self.rot[:, 0]
        up = np.array([0.0, 1.0, 0.0], np.float32)
        rot_y = _axis_angle(up, -dx * 0.005)
        rot_x = _axis_angle(side, -dy * 0.005)
        self.rot = rot_y @ rot_x @ self.rot

    def scale(self, delta: float):
        self.radius *= 1.1 ** -delta

    def pan(self, dx: float, dy: float, dz: float = 0.0):
        self.center += 0.0005 * self.rot @ np.array([dx, -dy, dz], np.float32)


def _axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rodrigues' rotation about `axis` by `angle` radians, float32."""
    axis = normalize(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]], np.float32)
    return (np.eye(3, dtype=np.float32) + np.sin(angle) * K
            + (1 - np.cos(angle)) * K @ K)
