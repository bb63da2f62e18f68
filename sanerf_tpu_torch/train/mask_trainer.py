"""Stage 3: the per-object instance mask field (JAX:
sanerf_tpu/train/mask_trainer.py).

A step renders the batch with the mask head (the plain path, autograd),
takes the softmax cross-entropy over the labelled global rays (label -1
ignored), down-weights incoherent pixels (incoherent_uncertainty_weight <
1), adds the depth-weighted label regularization and, after
`rgb_similarity_iter` with mixed sampling, the RGB-similarity loss over
the local patches; it returns the error signal of the error-map EMA. The
backbone (and a SAM head) stay frozen through the stage hand-off's
`trainable` mask; only the mask head trains. The rendered masks refresh
the incoherent maps (`use_dynamic_incoherent`) and can replace the labels
(`update_ground_truth`).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from sanerf_tpu_torch.config import Config
from sanerf_tpu_torch.data.rays import get_incoherent_mask
from sanerf_tpu_torch.models.fields import NerfModel, Params
from sanerf_tpu_torch.models.renderer import run_rays
from sanerf_tpu_torch.ops.losses import (label_regularization,
                                         rgb_similarity_loss)
from sanerf_tpu_torch.train import state as state_lib
from sanerf_tpu_torch.train.metrics import MeanIoUMeter
from sanerf_tpu_torch.train.state import Optimizer, TrainState
from sanerf_tpu_torch.train.trainer import Trainer


def mask_loss_fn(model: NerfModel, cfg: Config, params: Params,
                 batch: Dict[str, torch.Tensor], num_global: int,
                 use_similarity: bool, gumbel: Optional[torch.Tensor]):
    """THE stage-3 loss (JAX mask_trainer.py:56-140) -> (loss, aux: ce,
    loss, pred [num_global] argmax labels, error [num_global]). `gumbel`
    [S, P] is the similarity anchors' noise (S local patches of P
    pixels)."""
    mc = cfg.mask
    n_inst = model.cfg.n_inst
    out = run_rays(model, params, batch["rays_o"], batch["rays_d"], None,
                   training=True, return_mask=True,
                   cam_near_far=batch.get("cam_near_far"))
    logits = out["instance_mask_logits"]
    probs = torch.clamp(torch.softmax(logits, dim=-1), mc.epsilon,
                        1 - mc.epsilon)
    gt = batch["masks"]
    g_probs, g_gt = probs[:num_global], gt[:num_global]
    labeled = g_gt != -1
    onehot = torch.nn.functional.one_hot(torch.clamp(g_gt, min=0),
                                         n_inst).to(probs.dtype)
    nll = -torch.log((onehot * g_probs).sum(dim=-1))
    nll = torch.where(labeled, nll, torch.zeros_like(nll))
    if mc.incoherent_uncertainty_weight < 1 and "incoherent_masks" in batch:
        inc = batch["incoherent_masks"][:num_global]
        nll = (1 - inc + mc.incoherent_uncertainty_weight * inc) * nll
    loss = nll.sum() / torch.clamp(labeled.sum(), min=1)
    aux = {"ce": loss.detach()}
    if mc.label_regularization_weight > 0:
        loss = loss + mc.label_regularization_weight * label_regularization(
            out["depth"][:num_global].detach(), g_probs, mc.patch_size,
            n_inst)
    if use_similarity and mc.mixed_sampling:
        P = mc.local_sample_patch_size ** 2
        S = (gt.shape[0] - num_global) // P
        inc = batch.get("error_maps", batch.get("incoherent_masks"))
        sim = rgb_similarity_loss(
            gumbel, out["image"][num_global:].reshape(S, P, 3).detach(),
            probs[num_global:].reshape(S, P, -1),
            inc[num_global:].reshape(S, P),
            threshold=mc.rgb_similarity_threshold,
            exp_weight=mc.rgb_similarity_exp_weight, epsilon=mc.epsilon,
            num_sample=mc.rgb_similarity_num_sample,
            redundant_instance=model.cfg.redundant_instance,
            use_pred_logistics=mc.rgb_similarity_use_pred_logistics)
        loss = loss + mc.rgb_similarity_loss_weight * sim
    with torch.no_grad():
        # the error signal of the error-map EMA (JAX :122-128)
        gt_onehot = torch.nn.functional.one_hot(
            torch.clamp(g_gt, min=0), probs.shape[-1]).to(probs.dtype)
        cos = (g_probs * gt_onehot).sum(dim=-1) / (
            torch.linalg.norm(g_probs, dim=-1)
            * torch.clamp(torch.linalg.norm(gt_onehot, dim=-1), min=1e-8))
        error = torch.exp(-mc.rgb_similarity_exp_weight * cos - mc.epsilon)
    aux.update({"loss": loss.detach(),
                "pred": logits[:num_global].detach().argmax(dim=-1),
                "error": error})
    return loss, aux


def mask_step_body(model: NerfModel, cfg: Config, opt: Optimizer,
                   state: TrainState, batch: Dict[str, torch.Tensor],
                   num_global: int, use_similarity: bool,
                   gumbel: Optional[torch.Tensor] = None):
    """One stage-3 step: gradients of mask_loss_fn, the optimizer, the
    EMA. -> (new state, aux)."""
    _, aux, grads = state_lib.value_and_grads(
        lambda p: mask_loss_fn(model, cfg, p, batch, num_global,
                               use_similarity, gumbel),
        state.params, opt.trainable)
    return state_lib.apply_update(cfg.train, opt, state, grads), aux


def draw_gumbel(cfg: Config, n_rays: int, num_global: int,
                generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise [S, P] for the batch's local patches."""
    P = cfg.mask.local_sample_patch_size ** 2
    u = torch.rand(((n_rays - num_global) // P, P), generator=generator,
                   device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


class MaskTrainer(Trainer):
    """Stage-3 trainer: the mask field, with the self-training refreshes."""

    def __init__(self, name, cfg: Config, model: NerfModel, **kw):
        kw.setdefault("metrics", [MeanIoUMeter()])
        super().__init__(name, cfg, model, **kw)
        self._opt = state_lib.make_optimizer(cfg.train, self.trainable)

    def _mask_frame(self, frame: Dict, params=None) -> np.ndarray:
        """Argmax labels [H * W] of a frame rendered with the mask head."""
        out = self._render(self.eval_params() if params is None else params,
                           frame, return_mask=True)
        return out["instance_mask_logits"].argmax(dim=-1).cpu().numpy()

    def train(self, train_dataset, valid_dataset=None, max_epoch: int = 1,
              steps_per_epoch: Optional[int] = None):
        steps_per_epoch = steps_per_epoch or len(train_dataset)
        mc = self.cfg.mask
        num_rays = self.cfg.train.num_rays
        for _ in range(max_epoch):
            self.epoch += 1
            t0 = time.time()
            miou = MeanIoUMeter()
            loss_sum = None
            for _ in range(steps_per_epoch):
                self.global_step += 1
                if mc.use_multi_res and hasattr(train_dataset,
                                                "multi_res_level"):
                    train_dataset.multi_res_level = min(
                        mc.max_multi_res_level,
                        self.global_step // max(1, mc.multi_res_update_iter))
                if (mc.use_dynamic_incoherent
                        and self.global_step % max(
                            1, mc.incoherent_update_iter) == 0
                        and getattr(train_dataset, "masks", None) is not None):
                    self.update_incoherent_masks(train_dataset)
                host = train_dataset.collate_mask(self.rng, num_rays)
                use_sim = (mc.rgb_similarity_loss_weight > 0
                           and self.global_step > mc.rgb_similarity_iter >= 0)
                gumbel = (draw_gumbel(self.cfg, len(host["masks"]), num_rays,
                                      self.generator, self.device)
                          if use_sim and mc.mixed_sampling else None)
                self.state, aux = mask_step_body(
                    self.model, self.cfg, self._opt, self.state,
                    self._batch(host), num_rays, use_sim, gumbel)
                if train_dataset.error_map is not None:
                    train_dataset.update_error_map(
                        host["index"], host["inds_coarse"][:num_rays],
                        aux["error"].cpu().numpy())
                miou.update(aux["pred"][:num_rays].cpu().numpy(),
                            host["masks"][:num_rays])
                loss_sum = (aux["loss"] if loss_sum is None
                            else loss_sum + aux["loss"])
            if loss_sum is None:
                continue
            dt = time.time() - t0
            loss = float(loss_sum) / steps_per_epoch
            self.log(f"[mask epoch {self.epoch}] step {self.global_step} "
                     f"loss={loss:.4f} train_mIoU={miou.measure():.4f} "
                     f"({steps_per_epoch / dt:.1f} it/s)")
            self.log_metrics({"mask_loss": loss,
                              "train_miou": miou.measure(),
                              "it_per_s": steps_per_epoch / dt})
            if valid_dataset is not None:
                self.evaluate_mask(valid_dataset)
        self.save_checkpoint(full=True)

    def evaluate_mask(self, dataset, n_frames: Optional[int] = None
                      ) -> float:
        """Full-frame mIoU on the views of `dataset` (all, or the first
        n_frames) that have labels."""
        meter = MeanIoUMeter()
        n = min(n_frames or len(dataset), len(dataset))
        for idx in range(n):
            frame = dataset.frame(idx)
            if "masks" not in frame:
                continue
            meter.update(self._mask_frame(frame), frame["masks"])
        self.log(f"[mask eval] {meter.report()}")
        return meter.measure()

    def render_train_masks(self, dataset, n_frames: Optional[int] = None
                           ) -> np.ndarray:
        """Predicted labels [n, H, W] of the first n_frames views."""
        n = min(n_frames or len(dataset), len(dataset))
        out = []
        for idx in range(n):
            frame = dataset.frame(idx)
            out.append(self._mask_frame(frame).reshape(frame["H"],
                                                       frame["W"]))
        return np.stack(out)

    def update_ground_truth(self, dataset, n_frames: Optional[int] = None):
        """Replace the dataset's labels with the model's own renders."""
        rendered = self.render_train_masks(dataset, n_frames)
        dataset.masks[:len(rendered)] = rendered.astype(dataset.masks.dtype)

    def update_incoherent_masks(self, dataset, n_frames: int = 4):
        """Recompute the incoherent maps of a rotating subset of views from
        their rendered masks (rendered without per-view near/far, as the
        JAX package does)."""
        if dataset.incoherent_masks is None:
            return
        n = len(dataset)
        start = (self.global_step // max(
            1, self.cfg.mask.incoherent_update_iter) * n_frames) % n
        for idx in [(start + k) % n for k in range(min(n_frames, n))]:
            frame = dict(dataset.frame(idx))
            frame.pop("cam_near_far", None)
            pred = self._mask_frame(frame).reshape(frame["H"], frame["W"])
            dataset.incoherent_masks[idx] = get_incoherent_mask(
                (pred > 0).astype(np.float32),
                sfact=max(1, self.cfg.mask.incoherent_downsample_scale))
