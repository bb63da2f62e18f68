"""The interactive segmentation frame and its pipelined loop
(JAX: sanerf_tpu/apps/frame_pipeline.py).

`_frame_program` computes one frame on the device: rays from the pose, the
RGB + depth render, spp accumulation, reprojection of the stored 3D clicks
with the depth-occlusion test, the low-res SAM feature render, the SAM
prompt decode, the display mode, the mask and point overlays, and the
display transport (rgb8, or BT.601 yuv420 planes with the reprojected
points packed behind them in one u8 buffer). The host uploads a pose and
fetches u8 pixels.

`FramePipeline` keeps up to `depth` frames in flight: each frame's pixels
are copied into a pinned host buffer with `copy_(non_blocking=True)` right
after the frame is enqueued, and a CUDA event marks the copy's end; a
frame is fetched (its event waited on) only once `depth` newer frames are
enqueued. On the CPU the copy is synchronous.

With a `mesh` (parallel/dp.py; JAX: the frame program's shard_map, apps/
frame_pipeline.py:158-183, 323-338) every rank renders its contiguous rows
of the same frame, RGB and feature render alike, and the rows are gathered
in rank order; rank 0 then runs the SAM decode, the overlays and the
packing. Rank 0 broadcasts each frame's inputs (a command header and the
packed vector); the other ranks run a follower loop (`follow`, or
`InteractiveSession.follow`) until rank 0 sends CMD_STOP (`close`). The
header says whether the frame renders features, so a follower needs no
SAM decoder.

The host-side I420 decode is numpy (no OpenCV).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sanerf_tpu_torch.data.rays import full_frame_rays
from sanerf_tpu_torch.device import resolve_device
from sanerf_tpu_torch.models import renderer
from sanerf_tpu_torch.models.fields import KernelNets, NerfModel
from sanerf_tpu_torch.models.sam.common import const_row
from sanerf_tpu_torch.models.sam.predictor import SamConfig, decode_fused
from sanerf_tpu_torch.parallel import dp
from sanerf_tpu_torch.parallel.collectives import all_gather, broadcast

#: occlusion tolerance for reprojected 3D points
OCCLUSION_EPS = 0.05
#: the commands rank 0 sends its followers: a header of HEADER int64
#: [cmd, H, W, mode (1: depth), perturb, use_aabb, seed, arg]; a frame's
#: arg is 1 where it renders the SAM features
CMD_STOP, CMD_FRAME, CMD_TRAIN, CMD_SAVE = 0, 1, 2, 3
HEADER = 8


def send_command(mesh, cmd: int, *fields: int) -> None:
    """Rank 0: broadcast a command header to the followers."""
    head = [cmd, *fields] + [0] * (HEADER - 1 - len(fields))
    broadcast(mesh, torch.tensor(head, dtype=torch.int64,
                                 device=mesh.device))


def recv_command(mesh) -> list:
    """A follower: the next command header from rank 0."""
    head = torch.zeros(HEADER, dtype=torch.int64, device=mesh.device)
    return [int(v) for v in broadcast(mesh, head).cpu()]


def _rgb_to_yuv420(disp: torch.Tensor):
    """[H, W, 3] float display (0..1) -> (Y [H, W] u8, CbCr [H/2, W/2, 2]
    u8): BT.601 limited range (Y 16-235), 2x2 mean chroma subsampling."""
    rgb = torch.clamp(disp, 0.0, 1.0) * 255.0
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 16.0 + 0.256788 * r + 0.504129 * g + 0.097906 * b
    cb = 128.0 - 0.148223 * r - 0.290993 * g + 0.439216 * b
    cr = 128.0 + 0.439216 * r - 0.367788 * g - 0.071427 * b
    H, W = y.shape
    cbcr = torch.stack([cb, cr], dim=-1)
    cbcr = cbcr.reshape(H // 2, 2, W // 2, 2, 2).mean(dim=(1, 3))

    def to_u8(a):
        return torch.clamp(torch.round(a), 0.0, 255.0).to(torch.uint8)

    return to_u8(y), to_u8(cbcr)


def yuv420_to_rgb8(y: np.ndarray, cbcr: np.ndarray) -> np.ndarray:
    """Host-side inverse of `_rgb_to_yuv420` in numpy: (Y [H, W] u8,
    CbCr [H/2, W/2, 2] u8) -> [H, W, 3] u8, nearest-neighbour chroma."""
    yf = 1.164383 * (y.astype(np.float32) - 16.0)
    cb = (cbcr[..., 0].astype(np.float32) - 128.0).repeat(2, 0).repeat(2, 1)
    cr = (cbcr[..., 1].astype(np.float32) - 128.0).repeat(2, 0).repeat(2, 1)
    r = yf + 1.596027 * cr
    g = yf - 0.391762 * cb - 0.812968 * cr
    b = yf + 2.017232 * cb
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)


def _pack_display(disp: torch.Tensor, pts2d: torch.Tensor,
                  valid: torch.Tensor, W: int) -> torch.Tensor:
    """One u8 buffer with all the host needs of a frame: the I420 planes
    (rows 0 .. 3H/2) and metadata rows holding the reprojected points
    (float32 bytes) and their validity flags."""
    y, cbcr = _rgb_to_yuv420(disp)
    H = y.shape[0]
    cb = cbcr[..., 0].reshape(H // 4, W)
    cr = cbcr[..., 1].reshape(H // 4, W)
    pb = pts2d.float().contiguous().view(torch.uint8).reshape(-1)  # [K*8]
    vb = valid.to(torch.uint8)
    n = pb.numel() + vb.numel()
    rows = -(-n // W)
    meta = torch.cat([pb, vb, pb.new_zeros(rows * W - n)]).reshape(rows, W)
    return torch.cat([y, cb, cr, meta], dim=0)


def unpack_display(buf: np.ndarray, H: int, W: int, K: int):
    """Host-side inverse of `_pack_display`:
    -> (rgb u8 [H, W, 3], pts2d f32 [K, 2], valid bool [K])."""
    q = H // 4
    meta = np.ascontiguousarray(buf[H + 2 * q:]).reshape(-1)[:K * 8 + K]
    pts2d = np.frombuffer(meta[:K * 8].tobytes(), np.float32).reshape(
        K, 2).copy()
    valid = meta[K * 8:] > 0
    cbcr = np.stack([buf[H:H + q].reshape(H // 2, W // 2),
                     buf[H + q:H + 2 * q].reshape(H // 2, W // 2)], -1)
    return yuv420_to_rgb8(buf[:H], cbcr), pts2d, valid


def project_points_device(points3d, active, pose, intr, depth, H: int,
                          W: int):
    """Reproject the 3D click memory [K, 3] through the camera, with the
    screen-bounds and depth-occlusion tests, on the device.
    -> (pts2d [K, 2] (x, y), valid [K] bool)."""
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    R, t = pose[:3, :3], pose[:3, 3]
    cam = (points3d - t) @ R  # world-to-camera on row vectors
    z = -cam[:, 2]  # depth along the view (OpenGL)
    safe_z = torch.clamp(z, min=1e-6)
    x = cam[:, 0] / safe_z * fx + cx - 0.5
    y = -cam[:, 1] / safe_z * fy + cy - 0.5
    on_screen = (z > 1e-6) & (x >= 0) & (x < W) & (y >= 0) & (y < H)
    ix = torch.clamp(torch.round(x).to(torch.int32), 0, W - 1).long()
    iy = torch.clamp(torch.round(y).to(torch.int32), 0, H - 1).long()
    d = depth[iy, ix]
    valid = on_screen & ((z - d).abs() <= OCCLUSION_EPS) & (active > 0)
    return torch.stack([x, y], dim=-1), valid


def _jitter(model: NerfModel, n: int, generator: torch.Generator, device):
    return [torch.rand((n, T + 1), generator=generator, device=device)
            for T in model.render_cfg.num_steps]


def _render_rows(model: NerfModel, params, rays_o, rays_d, generator,
                 mesh, keys, **kw):
    """run_rays on the frame's rays, or on a mesh on this rank's rows,
    their `keys` outputs gathered in rank order into one [N, sum of
    widths] tensor per call. -> {key: [N, width] or [N]}."""
    if mesh is not None:
        per = rays_o.shape[0] // mesh.size
        sl = slice(mesh.rank * per, (mesh.rank + 1) * per)
        rays_o, rays_d = rays_o[sl], rays_d[sl]
    jit = (None if generator is None
           else _jitter(model, rays_o.shape[0], generator, rays_o.device))
    out = renderer.run_rays(model, params, rays_o, rays_d, jit, **kw)
    if mesh is None:
        return {k: out[k] for k in keys}
    cols = [out[k].reshape(out[k].shape[0], -1).float() for k in keys]
    got = all_gather(mesh, torch.cat(cols, dim=1))
    res, head = {}, 0
    for k, c in zip(keys, cols):
        part = got[:, head:head + c.shape[1]].to(out[k].dtype)
        res[k] = part.reshape((got.shape[0],) + tuple(out[k].shape[1:]))
        head += c.shape[1]
    return res


def _frame_program(model: NerfModel, params, sam_cfg: Optional[SamConfig],
                   sam_params, packed: torch.Tensor, acc: torch.Tensor,
                   generator: Optional[torch.Generator], *,
                   hw: Tuple[int, int], feat_hw: Tuple[int, int],
                   input_hw: Tuple[int, int], mode: str, perturb: bool,
                   with_overlay: bool, use_aabb: bool = False,
                   fetch_format: str = "rgb8",
                   nets: Optional[KernelNets] = None, mesh=None,
                   with_feats: Optional[bool] = None):
    """One interactive frame on packed's device.

    packed [28 + 4K] float32: pose (16) | intr (4) | points3d (3K) |
    active (K) | aabb (6) | bg (1) | spp (1). acc [H, W, 3]: running sum of
    raw frames (spp). With `perturb`, `generator` draws the stratified
    jitter (of this rank's rows on a mesh). The feature render runs where
    `with_feats` (by default where there is a `sam_cfg`; a follower takes
    rank 0's word and needs none). -> (pix, depth [H, W], mask [H, W] bool
    or None, acc_new, pts2d [K, 2], valid [K]); on a mesh's ranks past 0,
    None once the renders are gathered."""
    H, W = hw
    K = (packed.shape[0] - 28) // 4
    pose = packed[:16].reshape(4, 4)
    intr = packed[16:20]
    points3d = packed[20:20 + 3 * K].reshape(K, 3)
    points_active = packed[20 + 3 * K:20 + 4 * K]
    aabb = packed[20 + 4 * K:26 + 4 * K] if use_aabb else None
    bg_color = packed[26 + 4 * K]
    spp = packed[27 + 4 * K]
    dev = packed.device
    rays_o, rays_d = full_frame_rays(pose, intr, H, W, device=dev)
    out = _render_rows(model, params, rays_o, rays_d,
                       generator if perturb else None, mesh,
                       ("image", "depth"), bg_color=bg_color, aabb=aabb,
                       nets=nets)
    lead = mesh is None or mesh.rank == 0
    img = out["image"].reshape(H, W, 3)
    depth = out["depth"].reshape(H, W)

    # spp accumulation: acc holds the sum of raw frames; spp == 0 restarts
    live = (spp > 0).float()
    acc_new = acc * live + img
    disp = acc_new / (spp + 1)

    pts2d, valid = (project_points_device(points3d, points_active, pose,
                                          intr, depth, H, W)
                    if lead else (None, None))

    mask = None
    if with_feats is None:
        with_feats = sam_cfg is not None
    if with_feats:
        h, w = feat_hw
        # feature intrinsics from the render intrinsics (downscale-invariant)
        intr_lr = torch.stack([intr[0] * h / H, intr[1] * w / W,
                               torch.full_like(intr[0], w / 2.0),
                               torch.full_like(intr[0], h / 2.0)])
        ro_lr, rd_lr = full_frame_rays(pose, intr_lr, h, w, device=dev)
        feat = _render_rows(model, params, ro_lr, rd_lr, None, mesh,
                            ("samvit",), return_feats=True, aabb=aabb,
                            nets=nets)
        if not lead:
            return None
        fv = feat["samvit"].reshape(h, w, -1)
        labels = torch.where(valid, 1, -1).to(torch.int64)[None]  # [1, K]
        masks, _ = decode_fused(sam_cfg, sam_params, fv, pts2d[None], labels,
                                feat_hw=feat_hw, out_hw=hw, input_hw=input_hw)
        mask = masks[0, 0] & valid.any()
    if not lead:
        return None

    if mode == "depth":
        dnorm = depth / torch.clamp(depth.max(), min=1e-6)
        disp = dnorm[..., None].expand(H, W, 3)

    if with_overlay:
        if mask is not None:
            overlay = const_row([0.2, 0.45, 0.9], dev)
            disp = torch.where(mask[..., None], 0.5 * disp + 0.5 * overlay,
                               disp)
        # red 5x5 click markers
        ii = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
        jj = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
        px = pts2d[:, 0][:, None, None]
        py = pts2d[:, 1][:, None, None]
        marker = ((ii - px).abs() <= 2) & ((jj - py).abs() <= 2) \
            & valid[:, None, None]
        disp = torch.where(marker.any(dim=0)[..., None],
                           const_row([1.0, 0.2, 0.2], dev), disp)

    if fetch_format == "yuv420":
        pix = _pack_display(disp, pts2d, valid, W)
    else:
        pix = (torch.clamp(disp, 0.0, 1.0) * 255.0).to(torch.uint8)
    return pix, depth, mask, acc_new, pts2d, valid


class FramePipeline:
    """Pipelined interactive frame loop over `_frame_program`.

    pipeline = FramePipeline(model, params, sam_cfg, sam_params, H, W, h, w)
    frame = pipeline.render(pose, intr, points3d, active, ...)

    `render` enqueues the new frame and returns the oldest in flight once
    `depth` frames are queued (during the fill the oldest repeats);
    `render_sync` returns the frame it enqueues. Both return
    (u8 [H, W, 3] numpy, depth [H, W] (device), mask [H, W] (device) or
    None, pts2d [K, 2], valid [K]). Runs on the CUDA card unless `device`
    says otherwise. With a `mesh` the frame renders sharded over its ranks
    (module docstring): rank 0 calls render / render_sync and, at the end,
    `close`; the other ranks call `follow`. The frame's and the feature
    map's ray counts must divide the mesh."""

    def __init__(self, model, params, sam_cfg, sam_params, H, W, h=32, w=32,
                 max_points: int = 8, overlay: bool = True,
                 fetch_format: str = "rgb8", depth: int = 2, device=None,
                 mesh=None):
        if mesh is not None:
            n = mesh.size
            if H * W % n or h * w % n:
                raise ValueError(
                    f"frame {H}x{W} / feature {h}x{w} ray counts must "
                    f"divide the {n}-rank mesh")
            device = mesh.device
        self.mesh = mesh
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.sam_cfg = sam_cfg
        self.sam_params = sam_params
        self.hw = (H, W)
        self.feat_hw = (h, w)
        grid = 64 if sam_cfg is None else sam_cfg.prompt.image_embedding_size[0]
        scale = grid / max(h, w)
        self.input_hw = (int(round(h * scale)) * 16,
                         int(round(w * scale)) * 16)
        self.max_points = max_points
        self.overlay = overlay
        # the packed 4:2:0 buffer needs I420-tileable sizes (H % 4, W % 2)
        self.fetch_format = (fetch_format if fetch_format == "rgb8"
                             or (H % 4 == 0 and W % 2 == 0) else "rgb8")
        self.depth = max(1, int(depth))
        # oldest first: [device tuple, host copies, event, fetched|None, pose]
        self._pending = []
        self._acc = torch.zeros((H, W, 3), dtype=torch.float32,
                                device=self.device)
        self._nets = None
        self._nets_of = None
        self.dispatch_count = 0
        self.last_pose = None  # pose of the frame last returned

    def _kernel_nets(self):
        """The weights packed for the kernels, rebuilt when `params` is
        replaced."""
        if not renderer.uses_kernels(self.model):
            return None
        if self._nets_of is not self.params:
            self._nets = KernelNets(self.model, self.params)
            self._nets_of = self.params
        return self._nets

    def pad_points(self, points3d, active_count=None):
        """Host 3D point list -> padded ([K, 3] f32, [K] i32) host arrays."""
        k = self.max_points
        p = np.zeros((k, 3), np.float32)
        a = np.zeros((k,), np.int32)
        n = 0 if points3d is None else min(len(points3d), k)
        if n:
            p[:n] = np.asarray(points3d, np.float32)[:n]
            a[:n] = 1
        return p, a

    def _program(self, packed_dev, generator, mode, perturb, use_aabb,
                 with_feats=None):
        return _frame_program(
            self.model, self.params, self.sam_cfg, self.sam_params,
            packed_dev, self._acc, generator, hw=self.hw,
            feat_hw=self.feat_hw, input_hw=self.input_hw, mode=mode,
            perturb=perturb, with_overlay=self.overlay, use_aabb=use_aabb,
            fetch_format=self.fetch_format, nets=self._kernel_nets(),
            mesh=self.mesh, with_feats=with_feats)

    def follow_frame(self, head) -> None:
        """A follower's part of the frame whose header rank 0 sent."""
        _, H, W, mode, perturb, use_aabb, seed, feats = head
        if (H, W) != self.hw:
            raise RuntimeError(f"a {H}x{W} frame for a {self.hw} pipeline")
        packed = broadcast(self.mesh, torch.zeros(
            28 + 4 * self.max_points, dtype=torch.float32,
            device=self.device))
        gen = (dp.rank_generator(seed, self.mesh, self.device) if perturb
               else None)
        self.dispatch_count += 1
        self._program(packed, gen, ("image", "depth")[mode], bool(perturb),
                      bool(use_aabb), bool(feats))

    def follow(self) -> None:
        """A follower's loop: this pipeline's frames until CMD_STOP."""
        while True:
            head = recv_command(self.mesh)
            if head[0] == CMD_STOP:
                return
            if head[0] != CMD_FRAME:
                raise RuntimeError(f"unexpected command {head}")
            self.follow_frame(head)

    def close(self) -> None:
        """Rank 0: end the followers' loops."""
        if self.mesh is not None and self.mesh.rank == 0:
            send_command(self.mesh, CMD_STOP)

    def _dispatch(self, pose, intr, points3d, active, aabb, bg_color, spp,
                  generator, mode, perturb):
        self.dispatch_count += 1
        K = self.max_points
        packed = np.zeros((28 + 4 * K,), np.float32)
        packed[:16] = np.asarray(pose, np.float32).reshape(-1)
        packed[16:20] = np.asarray(intr, np.float32)
        if points3d is not None:
            packed[20:20 + 3 * K] = np.asarray(points3d, np.float32).reshape(-1)
        if active is not None:
            packed[20 + 3 * K:20 + 4 * K] = np.asarray(active, np.float32)
        if aabb is not None:
            packed[20 + 4 * K:26 + 4 * K] = np.asarray(aabb, np.float32)
        packed[26 + 4 * K] = bg_color
        packed[27 + 4 * K] = spp
        packed_dev = torch.from_numpy(packed).to(self.device,
                                                 non_blocking=True)
        if self.mesh is not None:
            # the followers' header and inputs; each rank's jitter from
            # its own generator, seeded from the caller's
            seed = (int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                      device=generator.device))
                    if perturb else 0)
            send_command(self.mesh, CMD_FRAME, *self.hw,
                         int(mode == "depth"), int(perturb),
                         int(aabb is not None), seed,
                         int(self.sam_cfg is not None))
            broadcast(self.mesh, packed_dev)
            if perturb:
                generator = dp.rank_generator(seed, self.mesh, self.device)
        pix, depth, mask, self._acc, pts2d, valid = self._program(
            packed_dev, generator, mode, perturb, aabb is not None)
        return pix, depth, mask, pts2d, valid

    def _start_fetch(self, frame, pose):
        """Queue the device-to-host copies of the display outputs right
        behind the frame, into pinned buffers, and mark their end with an
        event. -> the in-flight entry."""
        pix, depth, mask, pts2d, valid = frame
        arrs = ((pix,) if self.fetch_format == "yuv420"
                else (pix, pts2d, valid))
        cuda = self.device.type == "cuda"
        host = tuple(torch.empty(a.shape, dtype=a.dtype, pin_memory=cuda)
                     for a in arrs)
        for h, a in zip(host, arrs):
            h.copy_(a, non_blocking=cuda)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record()
        return [frame, host, event, None, np.asarray(pose, np.float32).copy()]

    def _fetch(self, entry):
        """Wait for the entry's copies and return its host tuple; the
        decode runs once per entry (the fill repeats the oldest frame)."""
        if entry[3] is None:
            frame, host, event = entry[0], entry[1], entry[2]
            if event is not None:
                event.synchronize()
            _, depth, mask, pts2d, valid = frame
            if self.fetch_format == "yuv420":
                H, W = self.hw
                u8, pts2d, valid = unpack_display(host[0].numpy(), H, W,
                                                  self.max_points)
            else:
                u8, pts2d, valid = (h.numpy() for h in host)
            entry[3] = (u8, depth, mask, pts2d, valid)
        self.last_pose = entry[4]
        return entry[3]

    def render(self, pose, intr, points3d=None, active=None, aabb=None,
               bg_color=1.0, spp=0, generator=None, mode="image",
               perturb=False):
        """Pipelined: enqueue this frame, return the oldest in flight."""
        new = self._dispatch(pose, intr, points3d, active, aabb, bg_color,
                             spp, generator, mode, perturb)
        self._pending.append(self._start_fetch(new, pose))
        if len(self._pending) > self.depth:
            return self._fetch(self._pending.pop(0))
        return self._fetch(self._pending[0])

    def render_sync(self, pose, intr, points3d=None, active=None, aabb=None,
                    bg_color=1.0, spp=0, generator=None, mode="image",
                    perturb=False):
        """Enqueue this frame and return it."""
        self._pending = []
        new = self._dispatch(pose, intr, points3d, active, aabb, bg_color,
                             spp, generator, mode, perturb)
        return self._fetch(self._start_fetch(new, pose))

    def flush(self):
        if self._pending:
            out = self._fetch(self._pending[-1])
            self._pending = []
            return out
        return None
