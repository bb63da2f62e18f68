"""Ray generation (JAX: sanerf_tpu/data/rays.py).

Conventions: pixel centers at +0.5; directions x = (i - cx) / fx,
y = -(j - cy) / fy, z = -1 (OpenGL, not normalized, so composited t is
metric depth); rotated by c2w; origin = translation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch

from sanerf_tpu_torch.device import resolve_device


@dataclass
class RayBatch:
    rays_o: np.ndarray  # [N, 3]
    rays_d: np.ndarray  # [N, 3]
    inds: np.ndarray  # [N] flat pixel indices
    i: np.ndarray  # [N] pixel column
    j: np.ndarray  # [N] pixel row
    inds_coarse: np.ndarray  # [N] indices into the coarse map


def sample_rays(pose: np.ndarray, intrinsics: np.ndarray, H: int, W: int,
                N: int = -1, *, rng: Optional[np.random.Generator] = None,
                coords: Optional[np.ndarray] = None, patch_size: int = 1,
                importance_map: Optional[np.ndarray] = None,
                importance_size: int = 128, patch_from_map: bool = False,
                coarse_size: int = 128) -> RayBatch:
    """N rays of one camera, numpy (JAX: sanerf_tpu/data/rays.py:46-135);
    the same `rng` state draws the same pixels as the JAX package. Modes:
      - `coords` [N, 2] (row, column): exactly those pixels;
      - N <= 0: every pixel in scanline order;
      - patch_size > 1: N // p^2 random p x p patches, or with
        `patch_from_map` one patch around a cell drawn from
        `importance_map`;
      - `importance_map` ([S*S] weights, S = importance_size): N cells
        drawn without replacement, each with a uniform pixel inside it;
        `inds_coarse` are those cells;
      - else N uniform pixels, with replacement.
    Every other mode gives `inds_coarse` on a coarse_size^2 map."""
    rng = rng or np.random.default_rng()
    inds_coarse = None
    if coords is not None:
        inds = coords[:, 0] * W + coords[:, 1]
    elif N <= 0:
        inds = np.arange(H * W)
    elif patch_size > 1:
        if importance_map is not None and patch_from_map:
            p = importance_map / importance_map.sum()
            c = rng.choice(importance_map.size, p=p)
            cx_, cy_ = c // importance_size, c % importance_size
            sx, sy = H / importance_size, W / importance_size
            x0 = int(np.clip(cx_ * sx - patch_size // 2, 0,
                             H - patch_size - 1))
            y0 = int(np.clip(cy_ * sy - patch_size // 2, 0,
                             W - patch_size - 1))
            xs0, ys0 = np.array([x0]), np.array([y0])
        else:
            num_patch = N // (patch_size ** 2)
            xs0 = rng.integers(0, H - patch_size, num_patch)
            ys0 = rng.integers(0, W - patch_size, num_patch)
        pi, pj = np.meshgrid(np.arange(patch_size), np.arange(patch_size),
                             indexing="ij")
        off = np.stack([pi.ravel(), pj.ravel()], -1)
        xy = (np.stack([xs0, ys0], -1)[:, None, :] + off[None]).reshape(-1, 2)
        inds = xy[:, 0] * W + xy[:, 1]
    elif importance_map is not None:
        p = importance_map.astype(np.float64)
        p = p / p.sum()
        inds_coarse = rng.choice(p.size, size=N, replace=False, p=p)
        ix, iy = inds_coarse // importance_size, inds_coarse % importance_size
        sx, sy = H / importance_size, W / importance_size
        ix = np.minimum((ix * sx + rng.random(N) * sx).astype(np.int64), H - 1)
        iy = np.minimum((iy * sy + rng.random(N) * sy).astype(np.int64), W - 1)
        inds = ix * W + iy
    else:
        inds = rng.integers(0, H * W, N)

    jj, ii = np.divmod(inds, W)
    i = ii.astype(np.float32) + 0.5
    j = jj.astype(np.float32) + 0.5
    fx, fy, cx, cy = np.asarray(intrinsics, np.float32)
    dirs = np.stack([(i - cx) / fx, -(j - cy) / fy, -np.ones_like(i)],
                    axis=-1).astype(np.float32)
    rays_d = dirs @ pose[:3, :3].T
    rays_o = np.broadcast_to(pose[:3, 3], rays_d.shape)
    if inds_coarse is None:
        inds_coarse = ((jj * (coarse_size / H)).astype(np.int64) * coarse_size
                       + (ii * (coarse_size / W)).astype(np.int64))
    return RayBatch(rays_o=rays_o.astype(np.float32),
                    rays_d=rays_d.astype(np.float32),
                    inds=inds.astype(np.int64), i=ii.astype(np.int64),
                    j=jj.astype(np.int64), inds_coarse=inds_coarse)


def full_frame_rays(pose: Union[np.ndarray, torch.Tensor],
                    intrinsics: Union[np.ndarray, torch.Tensor],
                    H: int, W: int,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All H*W rays for a pose, built on `device`, scanline order.
    Returns (rays_o [HW, 3], rays_d [HW, 3]) float32."""
    dev = resolve_device(device)
    pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
    intr = torch.as_tensor(intrinsics, dtype=torch.float32, device=dev)
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(W, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij")
    xs = (i.reshape(-1) - cx) / fx
    ys = -(j.reshape(-1) - cy) / fy
    dirs = torch.stack([xs, ys, -torch.ones_like(xs)], dim=-1)
    rays_d = dirs @ pose[:3, :3].T
    rays_o = pose[:3, 3].expand_as(rays_d).contiguous()
    return rays_o, rays_d
