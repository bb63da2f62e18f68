"""Trainer: the stage-1 experiment loop (JAX: sanerf_tpu/train/trainer.py:
39-466).

A host loop around train/state.py's step: it draws a batch
(`dataset.collate_train`) and the step's random numbers, flips the
proposal-update schedule, keeps per-epoch means of the metrics (device
sums, fetched once an epoch), writes JSONL logs (tensorboardX and wandb
opt-in), evaluates each `eval_interval` epochs with the EMA weights through
`render_staged` (for the MLP family the fast path on the CUDA kernels, in
float32), saves checkpoints on the `save_interval` cadence, resamples the
factorized tables on the `grid_upsample_steps` schedule, and restores by
mode (`latest | latest_model | best | scratch | <path>`). Training itself
runs the plain path with autograd. A dataset of images without per-view
near/far draws its batches from the native ray loader
(data/native_loader.py), or, where it does not build, from its numpy
collate (logged).

With `n_devices > 1` the trainer is one rank of a data-parallel group
(parallel/dp.py; the default process group must be up: `apps/main.py`'s
`--n_devices` launches the ranks): every rank collates the same global
batch from the same seed and steps on its slice with its own draws, the
gradients are averaged, evaluation and test frames render sharded, and
rank 0 alone writes logs, metrics, checkpoints and images; the other ranks
wait at a barrier before they read a checkpoint, and the replicas are
checked equal at every save (their digests logged) and restore. The
native loader draws the global batch as the collate does: the same seed
on every rank, and its batches are a function of the seed and their
number, whichever of its threads draws them.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from sanerf_tpu_torch.config import Config
from sanerf_tpu_torch.data.native_loader import NativeRaySampler
from sanerf_tpu_torch.data.rays import full_frame_rays
from sanerf_tpu_torch.device import resolve_device
from sanerf_tpu_torch.models import fields, renderer
from sanerf_tpu_torch.models.fields import NerfModel
from sanerf_tpu_torch.parallel import dp
from sanerf_tpu_torch.parallel.collectives import broadcast_object
from sanerf_tpu_torch.train import checkpoints as ckpt_lib
from sanerf_tpu_torch.train import state as state_lib
from sanerf_tpu_torch.train.metrics import PSNRMeter
from sanerf_tpu_torch.train.tree import leaves_with_paths


class Trainer:
    def __init__(self, name: str, cfg: Config, model: NerfModel,
                 workspace: Optional[str] = None,
                 metrics: Optional[List] = None,
                 use_checkpoint: str = "latest", trainable=None,
                 init_params=None, device=None):
        self.name = name
        self.cfg = cfg
        self.model = model
        self.mesh = None  # the data-parallel group (n_devices > 1)
        if cfg.train.n_devices > 1:
            self.mesh = dp.make_mesh(cfg.train.n_devices, device)
            self.device = self.mesh.device
        else:
            self.device = resolve_device(device)
        self.is_main = self.mesh is None or self.mesh.rank == 0
        self.metrics = metrics or [PSNRMeter()]
        self.workspace = workspace or cfg.workspace
        self.global_step = 0
        self.epoch = 0
        self.stats = {"results": [], "best_result": None, "checkpoints": []}
        self.rng = np.random.default_rng(cfg.seed)
        # per rank: the jitter and background of its rays (the seed itself
        # on one device and on rank 0); shared: the regularizer's points
        self.generator = dp.rank_generator(cfg.seed, self.mesh, self.device)
        self._shared_generator = None
        if self.mesh is not None:
            self._shared_generator = torch.Generator(
                device=self.device).manual_seed(cfg.seed + 0x7FFFFFFF)
        os.makedirs(self.workspace, exist_ok=True)
        self.log_path = os.path.join(self.workspace, f"log_{name}.txt")
        self.metrics_path = os.path.join(self.workspace,
                                         f"metrics_{name}.jsonl")
        self.writer = None  # tensorboardX, opt-in (enable_tensorboard)
        self._wandb = None  # opt-in (enable_wandb)
        self.ckpt_mgr = ckpt_lib.CheckpointManager(
            self.workspace, name, max_keep=cfg.train.max_keep_ckpt)
        if init_params is None:
            init_params = fields.init_params(
                model, torch.Generator().manual_seed(cfg.seed), self.device)
        self.state = state_lib.create_train_state(
            model, cfg.train, params=init_params, trainable=trainable)
        self.trainable = trainable
        self._train_step = state_lib.make_rgb_train_step(model, cfg.train,
                                                         trainable)
        if self.mesh is not None:
            self.state = dp.replicate_state(self.state, self.mesh)
            self._train_step = dp.make_dp_train_step(model, cfg.train,
                                                     self.mesh, trainable)
        if use_checkpoint != "scratch":
            self.load_checkpoint(use_checkpoint)
        n = sum(int(t.numel()) for _, t in
                leaves_with_paths(self.state.params))
        self.log(f"[INFO] Trainer {name} | workspace {self.workspace} | "
                 f"params {n:,} | {self.device}"
                 + ("" if self.mesh is None else
                    f" | {self.mesh.size} ranks ({self.mesh.backend})"))

    # -- infrastructure -----------------------------------------------------

    def log(self, msg: str):
        """Printed and appended to the log (rank 0 alone)."""
        if not self.is_main:
            return
        print(msg, flush=True)
        with open(self.log_path, "a") as f:
            f.write(msg + "\n")

    def log_metrics(self, scalars: Dict, prefix: str = "train"):
        """One JSONL record, and the opt-in tensorboard / wandb sinks
        (rank 0 alone)."""
        if not self.is_main:
            return
        rec = {"step": self.global_step, "epoch": self.epoch,
               **{k: float(v) for k, v in scalars.items()}}
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.writer is not None:
            for k, v in scalars.items():
                self.writer.add_scalar(f"{prefix}/{k}", float(v),
                                       self.global_step)
        if self._wandb is not None:
            self._wandb.log({f"{prefix}/{k}": float(v)
                             for k, v in scalars.items()},
                            step=self.global_step)

    def enable_tensorboard(self):
        if not self.is_main:
            return None
        try:
            from tensorboardX import SummaryWriter

            self.writer = SummaryWriter(os.path.join(self.workspace, "run"))
        except ImportError:
            self.log("[WARN] tensorboardX unavailable")
        return self.writer

    def enable_wandb(self, project: str = "sanerf_tpu",
                     name: Optional[str] = None):
        """wandb logging when the package, a login and the network are
        there; otherwise a warning, and the JSONL log stays (rank 0
        alone)."""
        if not self.is_main:
            return None
        try:
            import wandb

            self._wandb = wandb.init(project=project, name=name or self.name,
                                     dir=self.workspace)
        except Exception as e:  # no package / no network / no API key
            self._wandb = None
            self.log(f"[WARN] wandb unavailable ({type(e).__name__}); "
                     "continuing with JSONL logging")
        return self._wandb

    def _batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The arrays of a host batch on the device; scalars (H, W, index)
        stay on the host."""
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items() if isinstance(v, np.ndarray)}

    # -- training -----------------------------------------------------------

    def train(self, train_dataset, valid_dataset=None, max_epoch: int = 1,
              steps_per_epoch: Optional[int] = None):
        tc = self.cfg.train
        steps_per_epoch = steps_per_epoch or len(train_dataset)
        eval_interval = max(1, max_epoch // max(1, tc.eval_cnt))
        save_interval = max(1, max_epoch // max(1, tc.save_cnt))
        num_rays = self._global_rays(state_lib.adaptive_num_rays(
            tc, self.cfg.render.num_steps[-1]))
        sampler, native = train_dataset, None
        if (tc.use_native_loader
                and getattr(train_dataset, "images", None) is not None
                and getattr(train_dataset, "cam_near_far", None) is None):
            try:
                native = NativeRaySampler(
                    train_dataset.poses, train_dataset.intrinsics,
                    train_dataset.images, num_rays, seed=self.cfg.seed,
                    prefetch_depth=6, n_threads=4)
                sampler = native
            except Exception as e:  # no toolchain: the numpy collate
                self.log(f"[INFO] native loader unavailable ({e}); using "
                         "numpy collate")
        self.log(f"[INFO] train: {max_epoch} epochs x {steps_per_epoch} "
                 f"steps, num_rays={num_rays}, eval every {eval_interval}, "
                 f"save every {save_interval}"
                 + (" [native loader]" if native else ""))
        self._maybe_resize_grids()
        for _ in range(self.epoch, max_epoch):
            self.epoch += 1
            self._maybe_resize_grids()
            t0 = time.time()
            acc, last = None, None
            for _ in range(steps_per_epoch):
                aux = self.train_step(sampler, num_rays)
                acc = aux if acc is None else {k: acc[k] + v
                                               for k, v in aux.items()}
                last = aux
            if last is None:
                continue
            # epoch means, fetched once (lr: its last value)
            aux = {k: float(v) / steps_per_epoch for k, v in acc.items()}
            aux["lr"] = float(last["lr"])
            dt = time.time() - t0
            aux["it_per_s"] = steps_per_epoch / dt
            self.log_metrics(aux)
            self.log(f"[epoch {self.epoch}] step {self.global_step} "
                     f"loss={aux['loss']:.6f} psnr={aux['psnr']:.2f} "
                     f"lr={aux['lr']:.2e} ({aux['it_per_s']:.1f} it/s)")
            if valid_dataset is not None and self.epoch % eval_interval == 0:
                self.evaluate_one_epoch(valid_dataset)
            if self.epoch % save_interval == 0:
                self.save_checkpoint(full=True)
        if native is not None:
            native.close()
        self.save_checkpoint(full=True)

    def _global_rays(self, num_rays: int) -> int:
        """num_rays rounded up to a multiple of the mesh's size."""
        if self.mesh is None:
            return num_rays
        n = self.mesh.size
        return max(n, -(-num_rays // n) * n)

    def train_step(self, sampler, num_rays: int) -> Dict:
        """One step on a batch of `sampler.collate_train` and fresh draws
        from `self.generator`, on the proposal schedule -> its aux. On a
        mesh the batch is global (num_rays rounded up to the mesh) and this
        rank steps on its slice."""
        self.global_step += 1
        if self.mesh is None:
            batch = self._batch(sampler.collate_train(self.rng, num_rays))
        else:
            batch = dp.shard_batch(sampler.collate_train(
                self.rng, self._global_rays(num_rays)), self.mesh)
        draws = state_lib.draw_step(
            self.model, self.cfg.train, batch["rays_o"].shape[0],
            self.generator, self.device, shared=self._shared_generator)
        up = state_lib.update_proposal_now(self.cfg.train, self.global_step)
        self.state, aux = self._train_step(self.state, batch, draws,
                                           update_proposal=up)
        return aux

    def _maybe_resize_grids(self):
        """The factorized tables' coarse-to-fine schedule: at an epoch
        boundary, resample them to their target at this step when they are
        not there (the state is the tables' shapes: resume needs no
        bookkeeping)."""
        tc = self.cfg.train
        if not tc.grid_upsample_steps or not self.model.is_mlp_field:
            return
        targets = state_lib.grid_upsample_targets(tc, self.model.cfg,
                                                  self.global_step)
        current = fields.grid_resolutions(self.state.params)
        if all(current.get(k) == v for k, v in targets.items()):
            return
        self.state = state_lib.resize_grid_state(
            self.model, tc, self.state, targets, trainable=self.trainable)
        self.log(f"[grid] tables resized to {targets} at step "
                 f"{self.global_step} (optimizer reset; lr restarts)")

    # -- evaluation ---------------------------------------------------------

    def eval_params(self):
        """The EMA weights."""
        return self.state.ema_params

    def _render(self, params, frame: Dict, **kw) -> Dict[str, torch.Tensor]:
        """A whole frame with `render_staged`; on a mesh sharded over its
        ranks (dp.render_frame_dp) unless the frame has a per-ray
        near/far, which every rank then renders whole, as in JAX."""
        cnf = frame.get("cam_near_far")
        ro = torch.as_tensor(frame["rays_o"], device=self.device)
        rd = torch.as_tensor(frame["rays_d"], device=self.device)
        cnf = None if cnf is None else torch.as_tensor(cnf,
                                                       device=self.device)
        if self.mesh is not None and (cnf is None or cnf.shape[0] == 1):
            return dp.render_frame_dp(
                self.model, self.mesh,
                dp.make_dp_render(self.model, self.mesh, **kw), params, ro,
                rd, cnf)
        with torch.no_grad():
            return renderer.render_staged(self.model, params, ro, rd,
                                          cam_near_far=cnf, **kw)

    def evaluate_one_epoch(self, dataset,
                           save_artifacts: bool = True) -> Dict:
        """Every view of `dataset` with the EMA weights: the meters, and
        per view the prediction, ground truth and error images, the depth
        (and SAM features where rendered); a better first meter saves the
        best checkpoint."""
        for m in self.metrics:
            m.clear()
        params = self.eval_params()
        out_dir = os.path.join(self.workspace, "validation")
        os.makedirs(out_dir, exist_ok=True)
        for idx in range(len(dataset)):
            frame = dataset.frame(idx)
            out = self._render(params, frame)
            H, W = frame["H"], frame["W"]
            pred = out["image"].float().cpu().numpy().reshape(H, W, 3)
            gt = np.asarray(frame["images"]).reshape(H, W, -1)[..., :3]
            for m in self.metrics:
                m.update(pred, gt)
            if save_artifacts and self.is_main:
                stem = os.path.join(out_dir, f"ep{self.epoch:04d}_{idx:03d}")
                save_png(stem + ".png", pred)
                save_png(stem + "_gt.png", gt)
                err = np.abs(pred - gt).mean(-1)
                save_png(stem + "_error.png",
                         np.repeat(err[..., None] / max(err.max(), 1e-6), 3,
                                   -1))
                np.save(stem + "_depth.npy",
                        out["depth"].float().cpu().numpy().reshape(H, W))
                if "samvit" in out:
                    np.save(stem + "_feature.npy",
                            out["samvit"].float().cpu().numpy())
        results = {type(m).__name__: m.measure() for m in self.metrics}
        self.stats["results"].append(results)
        primary = self.metrics[0].measure()
        if (self.stats["best_result"] is None
                or primary > self.stats["best_result"]):
            self.stats["best_result"] = primary
            if self.is_main:
                self.ckpt_mgr.save(self.global_step, self.eval_params(),
                                   stats=self.stats, best=True, full=False)
        self.log(f"[eval epoch {self.epoch}] "
                 + " | ".join(m.report() for m in self.metrics))
        return results

    def test(self, dataset, out_dir: Optional[str] = None,
             write_video: bool = False, return_extra: bool = False):
        """Offline renders: per frame an RGB png, the depth, with the mask
        head the logits and their visualization, with the SAM head and
        `return_extra` the features; a pose_dir.json manifest; an mp4 with
        `write_video` (needs imageio). On a mesh every rank renders its
        share of each frame and rank 0 writes."""
        out_dir = out_dir or os.path.join(self.workspace, "results")
        os.makedirs(out_dir, exist_ok=True)
        params = self.eval_params()
        mc = self.cfg.model
        pose_dir, frames_rgb = {}, []
        for idx in range(len(dataset)):
            frame = dataset.frame(idx)
            out = self._render(params, frame, return_mask=mc.with_mask,
                               return_feats=mc.with_sam and return_extra)
            if not self.is_main:
                continue
            H, W = frame["H"], frame["W"]
            name = frame.get("name", f"{idx:04d}")
            pred = out["image"].float().cpu().numpy().reshape(H, W, 3)
            save_png(os.path.join(out_dir, f"{name}_rgb.png"), pred)
            np.save(os.path.join(out_dir, f"{name}_depth.npy"),
                    out["depth"].float().cpu().numpy().reshape(H, W))
            if mc.with_mask:
                logits = out["instance_mask_logits"].float().cpu().numpy()
                logits = logits.reshape(H, W, -1)
                np.save(os.path.join(out_dir, f"{name}_mask.npy"), logits)
                save_png(os.path.join(out_dir, f"{name}_maskvis.png"),
                         render_mask_visualization(
                             pred, logits, self.cfg.render_mask_type,
                             instance_id=self.cfg.render_mask_instance_id))
            if mc.with_sam and return_extra and "samvit" in out:
                np.save(os.path.join(out_dir, f"{name}_sam.npy"),
                        out["samvit"].float().cpu().numpy())
            if "pose" in frame:
                pose_dir[name] = np.asarray(frame["pose"]).tolist()
            frames_rgb.append((pred * 255).astype(np.uint8))
        if not self.is_main:
            return
        with open(os.path.join(out_dir, "pose_dir.json"), "w") as f:
            json.dump(pose_dir, f)
        if write_video and frames_rgb:
            import imageio

            imageio.mimwrite(os.path.join(out_dir, "rgb.mp4"), frames_rgb,
                             fps=24, quality=8, macro_block_size=1)
        self.log(f"[test] wrote {len(frames_rgb)} frames to {out_dir}")

    def render_pose(self, pose: np.ndarray, intrinsics: np.ndarray, H: int,
                    W: int, **kwargs) -> Dict[str, np.ndarray]:
        """One frame from an explicit camera, with the EMA weights."""
        ro, rd = full_frame_rays(pose, intrinsics, H, W, device=self.device)
        with torch.no_grad():
            out = renderer.render_staged(self.model, self.eval_params(), ro,
                                         rd, **kwargs)
        return {k: v.float().cpu().numpy() for k, v in out.items()}

    # -- checkpoints --------------------------------------------------------

    def save_checkpoint(self, full: bool = True):
        """Rank 0 writes. On a mesh the replicas are first checked equal
        (their digests logged) and every rank meets at a barrier after."""
        if self.mesh is not None:
            digests = self._check_replicas("at the save")
            self.log(f"[ckpt] replica digests ({self.mesh.size} ranks): "
                     + " ".join(d.hex()[:16] for d in digests))
        if self.is_main:
            path = self.ckpt_mgr.save(
                self.global_step, self.state.params, self.state.ema_params,
                self.state.opt_state if full else None,
                stats={**self.stats, "epoch": self.epoch}, full=full)
            self.log(f"[ckpt] saved {path}")
        if self.mesh is not None:
            self.mesh.barrier()

    def load_checkpoint(self, mode: str = "latest",
                        model_only: bool = False) -> bool:
        """Restore by mode. `latest_model` (or model_only) restores the
        weights and EMA only: the optimizer, step and epoch start fresh.
        On a mesh every rank reads the same file after a barrier (rank 0
        has finished writing), and the replicas are checked equal."""
        model_only = model_only or mode == "latest_model"
        if self.mesh is not None:
            self.mesh.barrier()
            # a rank's list of files is its own: take rank 0's choice
            mode = self._rank0_path(mode)
        restored = self.ckpt_mgr.load(mode, self.state.params,
                                      self.state.opt_state,
                                      model_only=model_only)
        if restored is None:
            if mode not in ("latest", "latest_model", "best"):
                self.log(f"[ckpt] {mode} not found; starting fresh")
            return False
        params, ema, opt_state, meta = restored
        if model_only:
            self.state = state_lib.TrainState(params, ema,
                                              self.state.opt_state,
                                              self.state.step)
            self._check_replicas(f"restored {mode}")
            self.log(f"[ckpt] restored model weights only (mode={mode})")
            return True
        self.global_step = int(meta.get("step", 0))
        self.state = state_lib.TrainState(
            params, ema,
            opt_state if opt_state is not None else self.state.opt_state,
            self.global_step)
        self.epoch = int(meta.get("stats", {}).get("epoch", 0))
        if meta.get("stats"):
            self.stats.update(meta["stats"])
        self._check_replicas(f"restored {mode}")
        self.log(f"[ckpt] restored step {self.global_step} (mode={mode})")
        return True

    def _rank0_path(self, mode: str) -> str:
        """On a mesh: the file rank 0 resolves `mode` to, on every rank
        (the mode itself where rank 0 finds none)."""
        path = self.ckpt_mgr.resolve(mode) if self.is_main else None
        return broadcast_object(self.mesh, path) or mode

    def _check_replicas(self, what: str):
        if self.mesh is not None:
            return dp.check_replicas(self.state, self.mesh, what)


def render_mask_visualization(rgb: np.ndarray, logits: np.ndarray,
                              mode: str = "heatmap",
                              instance_id: int = 0) -> np.ndarray:
    """`mask`: the binary argmax mask; `composition`: that mask blended
    over the RGB; `heatmap`: the chosen instance's softmax probability."""
    if mode == "mask":
        m = (np.argmax(logits, -1) == instance_id).astype(np.float32)
        return np.repeat(m[..., None], 3, -1)
    if mode == "composition":
        m = np.argmax(logits, -1) == instance_id
        out = rgb.copy()
        out[m] = 0.5 * out[m] + 0.5 * np.array([0.2, 0.5, 1.0], np.float32)
        return out
    e = np.exp(logits - logits.max(-1, keepdims=True))
    p = (e / e.sum(-1, keepdims=True))[..., instance_id]
    heat = np.stack([p, 0.2 * p, 1.0 - p], -1)
    return 0.5 * rgb + 0.5 * heat


def save_png(path: str, img: np.ndarray) -> None:
    """An [H, W, 3] image, float in [0, 1] or uint8, as an 8-bit RGB PNG
    (zlib, no imaging package)."""
    a = (img if img.dtype == np.uint8
         else (np.clip(img, 0, 1) * 255).astype(np.uint8))
    H, W = a.shape[:2]
    raw = b"".join(b"\x00" + a[r].tobytes() for r in range(H))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))
