"""Interactive 3D segmentation session (JAX: sanerf_tpu/apps/interactive.py).

Per frame the stored 3D clicks reproject through the current camera with
screen-bounds and depth-occlusion tests, the surviving 2D points prompt
the SAM decoder on the low-res rendered feature map, and the mask and the
point markers overlay the RGB frame: all of it in
`frame_pipeline._frame_program`, pipelined by `FramePipeline`. The host
keeps the 3D point list: a click lifts its pixel to 3D through the
displayed frame's depth (p = o + d * depth) and toggles it in the list.
Runs on the CUDA card unless `device` says otherwise. With a `mesh`
(parallel/dp.py) every frame renders sharded over its ranks: rank 0 runs
the session and ends with `close`, the other ranks run `follow`; a
downscale whose frame's ray count does not divide the mesh is refused
(FramePipeline), as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sanerf_tpu_torch.apps.frame_pipeline import (CMD_FRAME, CMD_STOP,
                                                  FramePipeline, recv_command,
                                                  send_command)
from sanerf_tpu_torch.device import resolve_device
from sanerf_tpu_torch.models.fields import NerfModel, Params
from sanerf_tpu_torch.utils.camera import fov_to_focal


@dataclass
class FrameResult:
    rgb_u8: np.ndarray  # [H, W, 3] u8 display image (mode + overlays)
    depth: Any  # [H/ds, W/ds] device tensor of the displayed frame
    mask: Optional[Any] = None  # [H/ds, W/ds] bool device tensor
    points_2d: Optional[np.ndarray] = None  # [P, 2] full-res (x, y), host
    _rgb_f32: Optional[np.ndarray] = None

    @property
    def rgb(self) -> np.ndarray:
        """[H, W, 3] float32 display image, converted on first access."""
        if self._rgb_f32 is None:
            self._rgb_f32 = self.rgb_u8.astype(np.float32) / 255.0
        return self._rgb_f32

    @property
    def composed(self) -> np.ndarray:  # alias of rgb (overlay included)
        return self.rgb


def _resize_u8(u8: np.ndarray, H: int, W: int, device) -> np.ndarray:
    """Bilinear upscale of a u8 frame [h, w, 3] to [H, W, 3] on the device
    (half-pixel centres, as OpenCV's INTER_LINEAR)."""
    x = torch.from_numpy(u8).to(device).permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(H, W), mode="bilinear", align_corners=False)
    y = torch.clamp(torch.round(y), 0, 255).to(torch.uint8)
    return y[0].permute(1, 2, 0).cpu().numpy()


class InteractiveSession:
    def __init__(self, cfg, model: NerfModel, params: Params,
                 sam_predictor=None, H: int = 512, W: int = 512,
                 fetch_format: str = "yuv420", device=None, mesh=None):
        self.mesh = mesh  # frames render sharded over its ranks
        self.device = resolve_device(mesh.device if mesh is not None
                                     else device)
        self.cfg = cfg
        self.model = model
        self.params = params
        self.sam = sam_predictor
        self.fetch_format = fetch_format
        self.H, self.W = H, W
        # low-res feature map: 64 per 1024 of render resolution
        self.h = max(4, int(H / 1024 * 64))
        self.w = max(4, int(W / 1024 * 64))
        self.points_3d: List[np.ndarray] = []  # persistent click memory
        self._pipes = {}  # (H, W) -> FramePipeline, one per downscale
        # depth + pose of the frame the user is looking at
        self._last_depth = None
        self._last_pose = None
        self._last_ds = 1

    @property
    def dispatch_count(self) -> int:
        return sum(p.dispatch_count for p in self._pipes.values())

    def _pipe(self, Hs: int, Ws: int) -> FramePipeline:
        pipe = self._pipes.get((Hs, Ws))
        if pipe is None:
            sam_cfg = None if self.sam is None else self.sam.cfg
            sam_params = None if self.sam is None else self.sam.params
            pipe = FramePipeline(self.model, self.params, sam_cfg, sam_params,
                                 Hs, Ws, self.h, self.w,
                                 fetch_format=self.fetch_format,
                                 device=self.device, mesh=self.mesh)
            self._pipes[(Hs, Ws)] = pipe
        pipe.params = self.params  # updated params flow through
        return pipe

    # -- the followers (ranks past 0 of a mesh) -----------------------------

    def follow(self, on_command=None) -> None:
        """A follower's loop: its rows of every frame rank 0 renders, and
        other commands passed to `on_command(header)`, until CMD_STOP."""
        while True:
            head = recv_command(self.mesh)
            if head[0] == CMD_STOP:
                return
            if head[0] == CMD_FRAME:
                self._pipe(head[1], head[2]).follow_frame(head)
            elif on_command is not None:
                on_command(head)
            else:
                raise RuntimeError(f"unexpected command {head}")

    def close(self) -> None:
        """Rank 0: end the followers' loops."""
        if self.mesh is not None and self.mesh.rank == 0:
            send_command(self.mesh, CMD_STOP)

    # -- 3D point memory ----------------------------------------------------

    def toggle_point(self, px: float, py: float, pose: np.ndarray,
                     depth: np.ndarray, pixel_radius: float = 8.0,
                     depth_scale: int = 1):
        """Click at pixel (px, py): remove the point whose reprojection lies
        within `pixel_radius`, else lift the pixel to 3D through `depth`
        (at 1/depth_scale resolution) and toggle it (0.01 world distance)."""
        intr = self.intrinsics_for(pose)
        if self.points_3d:
            pts2d_all = self._project_all(pose, intr)
            d2 = np.hypot(pts2d_all[:, 0] - px, pts2d_all[:, 1] - py)
            k = int(np.argmin(d2)) if len(d2) else -1
            if k >= 0 and d2[k] < pixel_radius:
                self.points_3d.pop(k)
                return
        depth = np.asarray(depth)
        j = int(np.clip(py / depth_scale, 0, depth.shape[0] - 1))
        i = int(np.clip(px / depth_scale, 0, depth.shape[1] - 1))
        d = float(depth[j, i])
        if d <= 0:
            return
        fx, fy, cx, cy = intr
        direction = np.array(
            [(px + 0.5 - cx) / fx, -(py + 0.5 - cy) / fy, -1.0], np.float32)
        world = pose[:3, 3] + (pose[:3, :3] @ direction) * d
        for k, p in enumerate(self.points_3d):
            if np.linalg.norm(p - world) < 0.01:
                self.points_3d.pop(k)
                return
        self.points_3d.append(world)

    def _project_all(self, pose: np.ndarray, intrinsics: np.ndarray
                     ) -> np.ndarray:
        """Reproject all 3D points (no occlusion test) -> [P, 2]."""
        fx, fy, cx, cy = intrinsics
        pts = np.stack(self.points_3d)
        cam = (pts - pose[:3, 3]) @ pose[:3, :3]
        z = np.maximum(-cam[:, 2], 1e-6)
        x = cam[:, 0] / z * fx + cx - 0.5
        y = -cam[:, 1] / z * fy + cy - 0.5
        return np.stack([x, y], -1)

    def intrinsics_for(self, pose) -> np.ndarray:
        f = fov_to_focal(60.0, self.H)
        return np.array([f, f, self.W / 2, self.H / 2], np.float32)

    # -- the frame loop -----------------------------------------------------

    def step(self, pose: np.ndarray, intrinsics: Optional[np.ndarray] = None,
             click: Optional[Tuple[float, float]] = None,
             downscale: int = 1, aabb=None, bg_color: float = 1.0,
             mode: str = "image", generator: Optional[torch.Generator] = None,
             spp: int = 0, pipelined: bool = True) -> FrameResult:
        """One interactive frame. `mode`: 'image' or 'depth'; `generator`
        turns on perturbed sampling; `spp`: frames already accumulated (0
        restarts); `pipelined=False` returns the frame it enqueues."""
        intr = (np.asarray(intrinsics, np.float32) if intrinsics is not None
                else self.intrinsics_for(pose))
        ds = max(1, int(downscale))
        Hs, Ws = max(1, self.H // ds), max(1, self.W // ds)
        intr_ds = intr / ds
        pipe = self._pipe(Hs, Ws)

        if click is not None:
            # lift through the displayed frame's depth and pose; the first
            # click with no frame yet renders one
            if (self._last_depth is None
                    or tuple(self._last_depth.shape) != (Hs, Ws)):
                p3, act = pipe.pad_points(self.points_3d)
                out = pipe.render_sync(pose, intr_ds, p3, act, aabb=aabb,
                                       bg_color=bg_color, mode=mode)
                self._last_depth = out[1]
                self._last_pose = pipe.last_pose
            self.toggle_point(click[0], click[1],
                              np.asarray(self._last_pose, np.float32),
                              self._last_depth.cpu().numpy(),
                              depth_scale=ds)

        p3, act = pipe.pad_points(self.points_3d)
        # a click frame returns at once: the pipelined one predates it
        render = (pipe.render if pipelined and click is None
                  else pipe.render_sync)
        u8, depth_dev, mask_dev, pts2d, valid = render(
            pose, intr_ds, p3, act, aabb=aabb, bg_color=bg_color, spp=spp,
            generator=generator, mode=mode, perturb=generator is not None)
        self._last_depth = depth_dev
        self._last_pose = pipe.last_pose
        self._last_ds = ds

        if ds > 1:
            u8 = _resize_u8(u8, self.H, self.W, self.device)

        pts = np.zeros((0, 2), np.float32)
        mask = None
        if self.points_3d:
            pts = np.asarray(pts2d)[np.asarray(valid).astype(bool)] * ds
            mask = mask_dev
        return FrameResult(rgb_u8=u8, depth=depth_dev, mask=mask,
                           points_2d=pts)


def overlay_mask_and_points(rgb: np.ndarray, mask: Optional[np.ndarray],
                            pts2d: np.ndarray) -> np.ndarray:
    """Host-side overlay for offline tools (JAX apps/interactive.py:227,
    the reference's utils.py:1396-1399): the mask's pixels blended half
    way to blue, a 5 x 5 red square at each 2D point (clipped at the
    image's top and left edges as numpy slicing clips them); the
    interactive path draws its overlays on the card
    (frame_pipeline._frame_program)."""
    out = rgb.copy()
    if mask is not None:
        m = np.asarray(mask)
        color = np.array([0.2, 0.5, 1.0], np.float32)
        out[m] = 0.5 * out[m] + 0.5 * color
    for x, y in np.asarray(pts2d).reshape(-1, 2):
        j, i = int(y), int(x)
        out[max(0, j - 2):j + 3, max(0, i - 2):i + 3] = [1.0, 0.2, 0.2]
    return out
