"""Procedural fixtures, numpy only: the twin of the JAX package's
`SyntheticSphereDataset` (sanerf_tpu/data/synthetic.py), which the port
cannot import (it reaches jax through its rays module).

Two scenes, ray-traced in closed form and seen from two interleaved camera
rings: "sphere" (the default, as in the JAX package), a Lambertian sphere
on a white background; "textured", three mutually occluding spheres with
high-frequency procedural textures over a fine-checkered floor. Same poses,
intrinsics, images, instance masks and per-view near/far as the JAX
fixture.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from sanerf_tpu_torch.data.rays import sample_rays
from sanerf_tpu_torch.utils.camera import circle_poses, fov_to_focal


def ray_sphere_shade(rays_o, rays_d, center=(0.0, 0.0, 0.0),
                     radius: float = 0.5, light=(0.577, 0.577, 0.577),
                     albedo=(0.8, 0.3, 0.2), bg: float = 1.0):
    """Closed-form Lambertian sphere -> (rgb [N, 3], depth [N]); depth is t
    along the unnormalized ray, 0 where it misses."""
    c = np.asarray(center, np.float32)
    oc = rays_o - c
    dnorm = np.linalg.norm(rays_d, axis=-1)
    d = rays_d / dnorm[:, None]
    b = np.sum(oc * d, -1)
    disc = b * b - (np.sum(oc * oc, -1) - radius * radius)
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    hit &= t > 0
    p = rays_o + d * t[:, None]
    n = (p - c) / radius
    lam = np.clip(n @ np.asarray(light, np.float32), 0.1, 1.0)
    rgb = np.where(hit[:, None], lam[:, None] * np.asarray(albedo, np.float32),
                   bg).astype(np.float32)
    depth = np.where(hit, t / dnorm, 0.0).astype(np.float32)
    return rgb, depth


def _sphere_hit(rays_o, d, center, radius):
    """t of the near intersection along unit dirs d (inf = miss)."""
    oc = rays_o - np.asarray(center, np.float32)
    b = np.sum(oc * d, -1)
    disc = b * b - (np.sum(oc * oc, -1) - radius * radius)
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    return np.where((disc > 0) & (t > 1e-4), t, np.inf)


def ray_textured_scene(rays_o, rays_d, bg: float = 1.0,
                       light=(0.577, 0.577, 0.577)):
    """-> (rgb [N, 3], depth [N], instance [N]: 0 bg, 1 floor, 2..4 spheres)."""
    spheres = [
        ((0.0, 0.0, 0.0), 0.5),
        ((0.55, -0.15, 0.35), 0.3),
        ((-0.5, -0.25, -0.3), 0.35),
    ]
    dnorm = np.linalg.norm(rays_d, axis=-1)
    d = rays_d / dnorm[:, None]
    N = rays_o.shape[0]
    best_t = np.full(N, np.inf, np.float32)
    best_id = np.zeros(N, np.int64)

    # floor plane y = -0.62, bounded extent
    dy = d[:, 1]
    t_pl = np.where(np.abs(dy) > 1e-6, (-0.62 - rays_o[:, 1]) / dy, np.inf)
    p_pl = rays_o + d * t_pl[:, None]
    ok = (t_pl > 1e-4) & (np.abs(p_pl[:, 0]) < 2.2) & (np.abs(p_pl[:, 2]) < 2.2)
    t_pl = np.where(ok, t_pl, np.inf)
    best_t, best_id = np.where(t_pl < best_t, t_pl, best_t), np.where(
        t_pl < best_t, 1, best_id)

    for k, (c, r) in enumerate(spheres):
        t = _sphere_hit(rays_o, d, c, r)
        hit = t < best_t
        best_t = np.where(hit, t, best_t)
        best_id = np.where(hit, k + 2, best_id)

    p = rays_o + d * best_t[:, None]
    rgb = np.full((N, 3), bg, np.float32)
    L = np.asarray(light, np.float32)

    m = best_id == 1
    if m.any():
        cx = np.floor(p[m, 0] * 6.0) + np.floor(p[m, 2] * 6.0)
        check = (cx % 2 == 0).astype(np.float32)
        albedo = np.stack([0.15 + 0.7 * check,
                           0.2 + 0.5 * check,
                           0.25 + 0.35 * check], -1)
        rgb[m] = albedo
        rgb[m] *= max(L[1], 0.35)

    texs = [
        lambda q: np.stack([0.5 + 0.45 * np.sin(24.0 * q[:, 0] + 2.0 * q[:, 1]),
                            0.5 + 0.45 * np.sin(24.0 * q[:, 1]),
                            0.5 + 0.45 * np.sin(24.0 * q[:, 2] + 1.0)], -1),
        lambda q: np.where(
            ((np.floor(q[:, 0] * 14) + np.floor(q[:, 1] * 14)
              + np.floor(q[:, 2] * 14)) % 2 == 0)[:, None],
            np.asarray([0.85, 0.25, 0.2], np.float32),
            np.asarray([0.95, 0.9, 0.85], np.float32)),
        lambda q: np.stack([0.3 + 0.3 * np.cos(20 * q[:, 0]) * np.cos(20 * q[:, 1]),
                            0.6 + 0.35 * np.cos(20 * q[:, 1]) * np.cos(20 * q[:, 2]),
                            0.35 + 0.25 * np.cos(20 * q[:, 0] + 20 * q[:, 2])], -1),
    ]
    for k, (c, r) in enumerate(spheres):
        m = best_id == k + 2
        if not m.any():
            continue
        n = (p[m] - np.asarray(c, np.float32)) / r
        lam = np.clip(n @ L, 0.15, 1.0)
        rgb[m] = np.clip(texs[k](p[m]), 0.0, 1.0) * lam[:, None]

    depth = np.where(np.isfinite(best_t), best_t / dnorm, 0.0).astype(np.float32)
    return np.clip(rgb, 0.0, 1.0), depth, best_id


@dataclass
class SyntheticSphereDataset:
    """Views of the sphere or the textured scene on two interleaved
    rings."""

    H: int = 64
    W: int = 64
    n_views: int = 16
    radius: float = 2.0
    fovy: float = 50.0
    training: bool = True
    scene: str = "sphere"  # "sphere" | "textured"
    poses: np.ndarray = field(init=False)
    intrinsics: np.ndarray = field(init=False)
    images: np.ndarray = field(init=False)
    depths: np.ndarray = field(init=False)
    instances: np.ndarray = field(init=False)

    def __post_init__(self):
        if self.scene not in ("sphere", "textured"):
            raise NotImplementedError(
                f"scene must be 'sphere' or 'textured', got {self.scene!r}")
        lo = circle_poses(radius=self.radius, height=0.5,
                          n=(self.n_views + 1) // 2)
        hi = circle_poses(radius=self.radius * 0.75, height=1.1,
                          n=self.n_views // 2)
        poses = np.empty((self.n_views, 4, 4), np.float32)
        poses[0::2] = lo
        poses[1::2] = hi
        self.poses = poses
        f = fov_to_focal(self.fovy, self.H)
        self.intrinsics = np.array([f, f, self.W / 2, self.H / 2], np.float32)
        imgs, deps, insts = [], [], []
        for pose in self.poses:
            rb = sample_rays(pose, self.intrinsics, self.H, self.W, N=-1)
            rgb, depth, inst = self._shade(rb.rays_o, rb.rays_d)
            imgs.append(rgb.reshape(self.H, self.W, 3))
            deps.append(depth.reshape(self.H, self.W))
            insts.append(inst.reshape(self.H, self.W))
        self.images = np.stack(imgs)
        self.depths = np.stack(deps)
        self.instances = np.stack(insts)
        # per-view near/far from the exact depths
        nf = []
        for dep in self.depths:
            hit = dep[dep > 0]
            near = 0.9 * float(hit.min()) if hit.size else 0.05
            far = 1.25 * float(hit.max()) if hit.size else 10.0
            nf.append([near, far])
        self.cam_near_far = np.asarray(nf, np.float32)

    def _shade(self, rays_o, rays_d):
        """-> (rgb, depth, instance: textured 0 bg, 1 floor, 2..4 spheres;
        sphere 1 on the sphere, 0 elsewhere)."""
        if self.scene == "textured":
            return ray_textured_scene(rays_o, rays_d)
        rgb, depth = ray_sphere_shade(rays_o, rays_d)
        return rgb, depth, (depth > 0).astype(np.int64)

    def __len__(self):
        return self.n_views

    def frame(self, idx: int) -> Dict:
        rb = sample_rays(self.poses[idx], self.intrinsics, self.H, self.W, N=-1)
        return {
            "rays_o": rb.rays_o,
            "rays_d": rb.rays_d,
            "images": self.images[idx].reshape(-1, 3),
            "masks": self.instances[idx].reshape(-1).astype(np.int64),
            "cam_near_far": self.cam_near_far[idx: idx + 1],
            "index": idx,
            "H": self.H,
            "W": self.W,
            "pose": self.poses[idx],
            "name": f"{idx:04d}",
        }

    def collate_train(self, rng: np.random.Generator, num_rays: int) -> Dict:
        """One training batch (JAX: synthetic.py:207-221): a view drawn
        from `rng`, num_rays uniform pixels of it, their colors, and the
        view's near/far."""
        idx = int(rng.integers(0, self.n_views))
        rb = sample_rays(self.poses[idx], self.intrinsics, self.H, self.W,
                         N=num_rays, rng=rng)
        return {
            "rays_o": rb.rays_o,
            "rays_d": rb.rays_d,
            "images": self.images[idx].reshape(-1, 3)[rb.inds],
            "cam_near_far": self.cam_near_far[idx: idx + 1],
            "index": idx,
            "H": self.H,
            "W": self.W,
        }

    @property
    def masks(self) -> np.ndarray:
        """Instance labels of every pixel (the `_shade` labels)."""
        return self.instances.astype(np.int64)

    @property
    def error_map(self):
        return None

    def collate_sam(self, rng: np.random.Generator,
                    index: Optional[int] = None) -> Dict:
        """A stage-2 batch (JAX: synthetic.py:239-256): a view drawn from
        `rng` (or `index`), all its rays, and the low-res feature rays at
        SAM's 64-per-1024 scale (at least 4 x 4)."""
        i = int(rng.integers(0, self.n_views)) if index is None else index
        rb = sample_rays(self.poses[i], self.intrinsics, self.H, self.W, N=-1)
        lr = max(4, int(self.H / 1024 * 64))
        intr_lr = self.intrinsics * (lr / self.H)
        intr_lr[2:] = lr / 2
        rb_lr = sample_rays(self.poses[i], intr_lr, lr, lr, N=-1)
        return {"rays_o": rb.rays_o, "rays_d": rb.rays_d,
                "rays_o_lr": rb_lr.rays_o, "rays_d_lr": rb_lr.rays_d,
                "H": self.H, "W": self.W, "h": lr, "w": lr, "index": i}

    def collate_mask(self, rng: np.random.Generator, num_rays: int) -> Dict:
        """A stage-3 batch (JAX: synthetic.py:258-267): num_rays uniform
        pixels of a view with their labels."""
        i = int(rng.integers(0, self.n_views))
        rb = sample_rays(self.poses[i], self.intrinsics, self.H, self.W,
                         N=num_rays, rng=rng)
        return {"rays_o": rb.rays_o, "rays_d": rb.rays_d,
                "masks": self.masks[i].reshape(-1)[rb.inds],
                "cam_near_far": self.cam_near_far[i: i + 1],
                "inds": rb.inds, "inds_coarse": rb.inds_coarse,
                "index": i, "H": self.H, "W": self.W}
