"""Stage 2: SAM feature distillation into the NeRF (JAX:
sanerf_tpu/train/distill.py).

1. every `cache_interval`-th step (and until the cache is full) renders a
   fresh camera-augmented frame (staged, no gradient; the field kernels on
   the fast path), runs the frozen teacher (SAM's ViT image encoder, or
   any callable) on the uint8 render and keeps {batch, teacher features}
   in a ring buffer (`Cache`); the other steps replay a cached pair;
2. every step renders the student's low-res feature map (the plain path,
   autograd; the proposal nets frozen) and takes the MSE against the
   teacher's features after a bilinear resize to their grid
   (`jax.image.resize` semantics: antialiased when it shrinks);
3. the RGB / geometry backbone stays frozen through the hand-off's
   `trainable` mask: only the SAM field and head train.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from sanerf_tpu_torch.config import Config
from sanerf_tpu_torch.models.fields import NerfModel, Params
from sanerf_tpu_torch.models.renderer import run_rays
from sanerf_tpu_torch.models.sam.predictor import resize_bilinear
from sanerf_tpu_torch.train import state as state_lib
from sanerf_tpu_torch.train.state import Optimizer, TrainState
from sanerf_tpu_torch.train.trainer import Trainer


class Cache:
    """Fixed-size ring buffer with a random get."""

    def __init__(self, size: int):
        self.size = size
        self.data: List = []
        self.ptr = 0

    def full(self) -> bool:
        return len(self.data) >= self.size

    def insert(self, item):
        if self.size <= 0:
            return
        if len(self.data) < self.size:
            self.data.append(item)
        else:
            self.data[self.ptr] = item
            self.ptr = (self.ptr + 1) % self.size

    def get(self, rng: np.random.Generator):
        return self.data[int(rng.integers(0, len(self.data)))]


def feature_mse(pred: torch.Tensor, gt: torch.Tensor, h: int, w: int
                ) -> torch.Tensor:
    """MSE of the student's [h * w, C] features, resized bilinearly to the
    teacher's [gh, gw, C] grid, against it."""
    p = pred.reshape(h, w, -1).permute(2, 0, 1)
    p = resize_bilinear(p, tuple(gt.shape[:2])).permute(1, 2, 0)
    return ((p - gt) ** 2).mean()


def sam_loss_fn(model: NerfModel, params: Params,
                batch: Dict[str, torch.Tensor], gt_samvit: torch.Tensor,
                h: int, w: int):
    """THE stage-2 loss (JAX distill.py:66-120) -> (loss, aux). The
    student's rays are not jittered (the JAX step renders unperturbed)."""
    out = run_rays(model, params, batch["rays_o_lr"], batch["rays_d_lr"],
                   None, training=True, return_feats=True,
                   update_proposal=False,
                   cam_near_far=batch.get("cam_near_far"))
    loss = feature_mse(out["samvit"], gt_samvit, h, w)
    return loss, {"loss": loss.detach()}


def sam_step_body(model: NerfModel, cfg: Config, opt: Optimizer,
                  state: TrainState, batch: Dict[str, torch.Tensor],
                  gt_samvit: torch.Tensor, h: int, w: int):
    """One stage-2 step: gradients of sam_loss_fn, the optimizer, the EMA.
    -> (new state, aux)."""
    _, aux, grads = state_lib.value_and_grads(
        lambda p: sam_loss_fn(model, p, batch, gt_samvit, h, w),
        state.params, opt.trainable)
    return state_lib.apply_update(cfg.train, opt, state, grads), aux


class SamDistillTrainer(Trainer):
    """Stage-2 trainer: frozen backbone, SAM feature field distilled from
    `teacher` (a SamPredictor with an image encoder, or a callable
    uint8 [H, W, 3] -> [64, 64, 256])."""

    def __init__(self, name, cfg: Config, model: NerfModel, teacher=None,
                 **kw):
        super().__init__(name, cfg, model, **kw)
        self.teacher = teacher
        self.cache = Cache(cfg.sam.cache_size)
        self._opt = state_lib.make_optimizer(cfg.train, self.trainable)

    def teacher_features(self, image_uint8: np.ndarray) -> torch.Tensor:
        """uint8 [H, W, 3] -> the teacher's [64, 64, 256] on the device."""
        if callable(self.teacher) and not hasattr(self.teacher, "set_image"):
            return torch.as_tensor(np.asarray(self.teacher(image_uint8)),
                                   dtype=torch.float32, device=self.device)
        self.teacher.set_image(image_uint8)
        return self.teacher.features[0].float()

    def _fresh_teacher_target(self, batch: Dict) -> torch.Tensor:
        """The augmented frame rendered with the live weights (staged, no
        gradient), then the teacher on its uint8 image."""
        H, W = batch["H"], batch["W"]
        out = self._render(self.state.params, batch)
        rgb = out["image"].float().cpu().numpy().reshape(H, W, 3)
        image = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        return self.teacher_features(image)

    def train(self, train_dataset, valid_dataset=None, max_epoch: int = 1,
              steps_per_epoch: Optional[int] = None):
        steps_per_epoch = steps_per_epoch or len(train_dataset)
        sc = self.cfg.sam
        for _ in range(max_epoch):
            self.epoch += 1
            t0 = time.time()
            loss_sum = None
            for _ in range(steps_per_epoch):
                self.global_step += 1
                use_cache = (sc.cache_size > 0 and self.cache.full()
                             and self.global_step % sc.cache_interval != 0)
                if use_cache:
                    batch, gt = self.cache.get(self.rng)
                else:
                    batch = train_dataset.collate_sam(self.rng)
                    gt = self._fresh_teacher_target(batch)
                    if sc.cache_size > 0:
                        self.cache.insert((batch, gt))
                self.state, aux = sam_step_body(
                    self.model, self.cfg, self._opt, self.state,
                    self._batch(batch), gt, batch["h"], batch["w"])
                loss_sum = (aux["loss"] if loss_sum is None
                            else loss_sum + aux["loss"])
            if loss_sum is None:
                continue
            loss = float(loss_sum) / steps_per_epoch
            dt = time.time() - t0
            self.log(f"[sam epoch {self.epoch}] step {self.global_step} "
                     f"feat_mse={loss:.5f} ({steps_per_epoch / dt:.1f} it/s)")
            self.log_metrics({"feat_mse": loss,
                              "it_per_s": steps_per_epoch / dt})
        self.save_checkpoint(full=True)

    @torch.no_grad()
    def eval_feature_mse(self, dataset, n_frames: int = 4) -> float:
        """Teacher-vs-student feature MSE on the first n_frames views with
        their poses pinned (the eval fovy on an eval dataset): comparable
        across runs and checkpoints."""
        errs = []
        for idx in range(min(n_frames, len(dataset))):
            batch = dataset.collate_sam(self.rng, index=idx)
            gt = self._fresh_teacher_target(batch)
            out = run_rays(
                self.model, self.eval_params(),
                torch.as_tensor(batch["rays_o_lr"], device=self.device),
                torch.as_tensor(batch["rays_d_lr"], device=self.device),
                return_feats=True)
            errs.append(float(feature_mse(out["samvit"], gt, batch["h"],
                                          batch["w"])))
        return float(np.mean(errs))
