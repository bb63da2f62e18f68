"""Train state: Adam, the EMA, freeze masks and the stage-1 step
(JAX: sanerf_tpu/train/state.py:35-296).

The arithmetic is optax's, as the JAX package's `make_optimizer` chains it:
  1. the global-norm clip over the trainable gradients: g stays where the
     norm is below `grad_clip`, else g / norm * grad_clip (no epsilon, as
     optax.clip_by_global_norm; torch's clip_grad_norm_ divides by
     norm + 1e-6);
  2. Adam (b1 0.9, b2 0.999, `adam_eps` outside the root, moments
     (1 - b) g^k + b m, bias corrections 1 - b^count with the count after
     its increment);
  3. times -lr, the schedule evaluated at the count BEFORE the increment;
  4. the factorized tables (GRID_LR_KEYS) times `grid_lr_mult`, after Adam;
  5. p + update.
Frozen leaves (a `trainable` mask of False) carry no moments, get no
gradient and no update. The schedule restarts with the optimizer (its count
is the optimizer's, not the step's): `resize_grid_state` re-inits it.
With eps = 1e-15 the first step is +-lr on every gradient that is not 0,
so a gradient within rounding of 0 can move a parameter by 2 lr between
two frameworks: the tests hold the optimizer and the gradients apart.

The regularizer gradients (TV, weight decay, L1 of the tables) are added to
autograd's before the optimizer, as the reference adds them to `.grad`.

Randomness enters as one `StepDraws` a step: the per-level jitter, the
random background, the TV sample points (`draw_step` makes them from a
torch.Generator; the tests build them from the JAX package's keys).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sanerf_tpu_torch.config import ModelConfig, TrainConfig
from sanerf_tpu_torch.models import fields
from sanerf_tpu_torch.models.fields import NerfModel, Params
from sanerf_tpu_torch.models.renderer import run_rays
from sanerf_tpu_torch.ops.losses import entropy_loss
from sanerf_tpu_torch.train.tree import (leaves_with_paths, map_with_path,
                                         tree_map)

#: factorized tables that train at grid_lr_mult x the lr (TensoRF's split;
#: hash tables keep the single lr)
GRID_LR_KEYS = ("cp_lines", "vm_planes", "vm_lines",
                "sigma_cp_lines", "sigma_vm_planes", "sigma_vm_lines")
B1, B2 = 0.9, 0.999
#: the TV regularizer's sample points a step (JAX state.py:117)
TV_POINTS = 4096


@dataclass
class AdamState:
    count: int  # updates taken since init
    mu: Params  # first moments; None at frozen leaves
    nu: Params  # second moments; None at frozen leaves


@dataclass
class TrainState:
    params: Params
    ema_params: Params
    opt_state: AdamState
    step: int


@dataclass
class StepDraws:
    """A step's random numbers: jitter [N, T_l + 1] per level (uniform
    [0, 1)), bg [N, 3] for the "random" background (else None), tv_points
    [TV_POINTS, 3] in the unit cube for the hash grid's TV (else None)."""

    jitter: List[torch.Tensor]
    bg: Optional[torch.Tensor] = None
    tv_points: Optional[torch.Tensor] = None


def lr_schedule(cfg: TrainConfig, step: int) -> float:
    """lr 0.1^min(step / iters, 1), times min(1, (step + 1) / warm-up)
    with a warm-up, in float32 as the JAX schedule."""
    f32 = np.float32
    frac = np.minimum(f32(step) / f32(cfg.iters), f32(1.0))
    lr = f32(cfg.lr) * np.power(f32(0.1), frac)
    if cfg.lr_warmup_steps > 0:
        lr = lr * np.minimum(f32(1.0),
                             f32(step + 1) / f32(cfg.lr_warmup_steps))
    return float(f32(lr))


def all_trainable(params: Params) -> Params:
    return tree_map(lambda _: True, params)


class Optimizer:
    """optax's adam chain of JAX `make_optimizer` (module docstring)."""

    def __init__(self, cfg: TrainConfig, trainable: Optional[Params] = None):
        self.cfg = cfg
        self.trainable = trainable

    def _on(self, params: Params) -> Params:
        return (all_trainable(params) if self.trainable is None
                else self.trainable)

    def init(self, params: Params) -> AdamState:
        zeros = lambda p, on: torch.zeros_like(p) if on else None  # noqa
        on = self._on(params)
        return AdamState(0, tree_map(zeros, params, on),
                         tree_map(zeros, params, on))

    @torch.no_grad()
    def update(self, grads: Params, state: AdamState, params: Params,
               lr: Optional[float] = None) -> Tuple[Params, AdamState]:
        """-> (new params, new state); grads None at frozen leaves. A
        given `lr` is a constant schedule in place of `lr_schedule`."""
        cfg = self.cfg
        live = [g for _, g in leaves_with_paths(grads)]
        clip = None
        if cfg.grad_clip > 0 and live:
            norm = torch.sqrt(sum((g * g).sum() for g in live))
            clip = (norm, norm < cfg.grad_clip)
        count = state.count + 1
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(B1) ** f32(count))
        bc2 = float(f32(1.0) - f32(B2) ** f32(count))
        neg_lr = -(lr_schedule(cfg, state.count) if lr is None else lr)
        mult = cfg.grid_lr_mult

        def step(path, p, g, m, v):
            if g is None:
                return p, None, None
            if clip is not None:
                g = torch.where(clip[1], g, g / clip[0] * cfg.grad_clip)
            m = (1 - B1) * g + B1 * m
            v = (1 - B2) * (g * g) + B2 * v
            u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.adam_eps) * neg_lr
            if mult != 1.0 and path.split("/")[0] in GRID_LR_KEYS:
                u = mult * u
            return p + u, m, v

        out = map_with_path(step, params, grads, state.mu, state.nu)
        pick = lambda k: tree_map(lambda t: t[k], out)  # noqa: E731
        return pick(0), AdamState(count, pick(1), pick(2))


def make_optimizer(cfg: TrainConfig,
                   trainable: Optional[Params] = None) -> Optimizer:
    return Optimizer(cfg, trainable)


def _clone(params: Params) -> Params:
    return tree_map(lambda t: t.detach().clone(), params)


def create_train_state(model: NerfModel, cfg: TrainConfig,
                       generator: Optional[torch.Generator] = None,
                       params: Optional[Params] = None,
                       trainable: Optional[Params] = None,
                       device=None) -> TrainState:
    """A fresh state: `params` copied (or drawn from `generator` on
    `device`), the EMA a second copy, the optimizer's moments zero."""
    if params is None:
        params = fields.init_params(model, generator, device)
    params = _clone(params)
    return TrainState(params=params, ema_params=_clone(params),
                      opt_state=make_optimizer(cfg, trainable).init(params),
                      step=0)


def grid_upsample_targets(cfg: TrainConfig, mc: ModelConfig,
                          step: int) -> Dict[str, int]:
    """Target resolution of each factorized table family at `step`: the
    configured resolution halved once a milestone of grid_upsample_steps
    still ahead, at least 8."""
    down = sum(1 for m in cfg.grid_upsample_steps if step < m)
    t = {}
    for key, rank, res in (("cp", mc.mlp_cp_rank, mc.mlp_cp_res),
                           ("vm", mc.mlp_vm_rank, mc.mlp_vm_res),
                           ("sigma_cp", mc.mlp_sigma_cp_rank,
                            mc.mlp_sigma_cp_res),
                           ("sigma_vm", mc.mlp_sigma_vm_rank,
                            mc.mlp_sigma_vm_res)):
        if rank > 0:
            t[key] = max(8, res >> down)
    return t


def resize_grid_state(model: NerfModel, cfg: TrainConfig, state: TrainState,
                      targets: Dict[str, int],
                      trainable: Optional[Params] = None) -> TrainState:
    """The tables of params and EMA resampled to `targets`, the optimizer
    re-initialised for the new shapes (its schedule restarts, TensoRF's lr
    reset); the step goes on."""
    new_p = fields.resize_grid_tables(model, state.params, targets)
    new_e = fields.resize_grid_tables(model, state.ema_params, targets)
    return TrainState(new_p, new_e,
                      make_optimizer(cfg, trainable).init(new_p), state.step)


def _ema_update(ema: Params, params: Params, decay: float) -> Params:
    return tree_map(lambda e, p: decay * e + (1.0 - decay) * p, ema, params)


def _add_into(grads: Params, contrib: Params) -> None:
    for k, g in contrib.items():
        grads[k] = tree_map(lambda a, b: a if a is None else a + b,
                            grads[k], g)


@torch.no_grad()
def _apply_regularizer_grads(model: NerfModel, cfg: TrainConfig,
                             params: Params, grads: Params,
                             tv_points: Optional[torch.Tensor]) -> Params:
    """Adds the TV / weight-decay / L1 gradient terms (0 by default)."""
    if cfg.lambda_tv > 0:
        _add_into(grads, fields.apply_total_variation(model, params,
                                                      tv_points,
                                                      cfg.lambda_tv))
    if cfg.lambda_wd > 0:
        _add_into(grads, fields.apply_weight_decay(model, params,
                                                   cfg.lambda_wd))
    if cfg.lambda_l1_grid > 0:
        _add_into(grads, fields.apply_l1_sparsity(model, params,
                                                  cfg.lambda_l1_grid))
    return grads


def rgb_loss_fn(model: NerfModel, cfg: TrainConfig, params: Params,
                batch: Dict[str, torch.Tensor], gt_rgb: torch.Tensor, bg,
                jitter: List[torch.Tensor], update_proposal: bool,
                enc_alpha: Optional[torch.Tensor] = None):
    """THE stage-1 loss (JAX state.py:134-169): MSE of the image, plus
    lambda_proposal x proposal loss, lambda_distort x distortion loss and
    lambda_entropy x the opacity entropy. -> (loss, aux of detached
    scalars)."""
    if enc_alpha is not None:
        params = {**params, "enc_alpha": enc_alpha}
    out = run_rays(model, params, batch["rays_o"], batch["rays_d"], jitter,
                   training=True, bg_color=bg,
                   cam_near_far=batch.get("cam_near_far"),
                   update_proposal=update_proposal)
    loss_rgb = ((out["image"] - gt_rgb) ** 2).mean()
    loss = loss_rgb
    if cfg.lambda_proposal > 0:
        loss = loss + cfg.lambda_proposal * out["proposal_loss"]
    if cfg.lambda_distort > 0:
        loss = loss + cfg.lambda_distort * out["distort_loss"]
    if cfg.lambda_entropy > 0:
        loss = loss + cfg.lambda_entropy * entropy_loss(out["weights_sum"])
    aux = {"loss": loss, "loss_rgb": loss_rgb,
           "proposal_loss": out["proposal_loss"],
           "distort_loss": out["distort_loss"],
           "psnr": -10.0 * torch.log10(loss_rgb + 1e-12)}
    return loss, {k: torch.as_tensor(v).detach() for k, v in aux.items()}


def step_inputs(model: NerfModel, cfg: TrainConfig, step: int,
                batch: Dict[str, torch.Tensor], draws: StepDraws):
    """-> (gt_rgb, bg, enc_alpha) of a step: the background (ones unless
    "random"), the ground truth blended over it where it has alpha, the
    annealing progress min(step / anneal_iters, 1) for the MLP family."""
    gt = batch["images"]
    bg = draws.bg if draws.bg is not None else 1.0
    gt_rgb = (gt[..., :3] * gt[..., 3:] + bg * (1.0 - gt[..., 3:])
              if gt.shape[-1] == 4 else gt)
    enc_alpha = None
    if cfg.anneal_iters > 0 and model.is_mlp_field:
        enc_alpha = torch.tensor(
            float(np.minimum(np.float32(step) / np.float32(cfg.anneal_iters),
                             np.float32(1.0))), device=gt.device)
    return gt_rgb, bg, enc_alpha


def value_and_grads(loss_fn, params: Params,
                    trainable: Optional[Params] = None):
    """-> (loss, aux, grads) of `loss_fn(params) -> (loss, aux)`:
    autograd's gradient at every trainable leaf (zeros where the loss does
    not reach it, None at frozen leaves)."""
    on = all_trainable(params) if trainable is None else trainable
    live = map_with_path(
        lambda _, p, t: p.detach().requires_grad_(True) if t else p,
        params, on)
    loss, aux = loss_fn(live)
    req = [(k, p) for k, p in leaves_with_paths(live) if p.requires_grad]
    got = dict(zip((k for k, _ in req), torch.autograd.grad(
        loss, [p for _, p in req], allow_unused=True)))

    def grad_of(path, p, t):
        if not t:
            return None
        g = got[path]
        return torch.zeros_like(p) if g is None else g

    return loss.detach(), aux, map_with_path(grad_of, live, on)


def loss_and_grads(model: NerfModel, cfg: TrainConfig, params: Params,
                   batch: Dict[str, torch.Tensor], draws: StepDraws,
                   step: int, update_proposal: bool,
                   trainable: Optional[Params] = None):
    """-> (loss, aux, grads) of rgb_loss_fn at `params` (value_and_grads)."""
    gt_rgb, bg, enc_alpha = step_inputs(model, cfg, step, batch, draws)
    return value_and_grads(
        lambda p: rgb_loss_fn(model, cfg, p, batch, gt_rgb, bg,
                              draws.jitter, update_proposal, enc_alpha),
        params, trainable)


def apply_update(cfg: TrainConfig, opt: Optimizer, state: TrainState,
                 grads: Params) -> TrainState:
    """The optimizer on `grads`, then the EMA; the step goes on by one."""
    params, opt_state = opt.update(grads, state.opt_state, state.params)
    with torch.no_grad():
        ema = _ema_update(state.ema_params, params, cfg.ema_decay)
    return TrainState(params, ema, opt_state, state.step + 1)


def rgb_step_body(model: NerfModel, cfg: TrainConfig, opt: Optimizer,
                  state: TrainState, batch: Dict[str, torch.Tensor],
                  draws: StepDraws, update_proposal: bool = True,
                  mesh=None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One stage-1 step (JAX state.py:205-248): gradients, regularizer
    terms, the optimizer, the EMA. -> (new state, aux). With a `mesh`
    (parallel/dp.py) `batch` and `draws` are this rank's shard and its own
    draws; the gradients and aux are averaged over the ranks before the
    regularizer terms, whose `draws.tv_points` every rank draws alike, so
    that every rank applies the same update."""
    _, aux, grads = loss_and_grads(model, cfg, state.params, batch, draws,
                                   state.step, update_proposal,
                                   opt.trainable)
    if mesh is not None:
        # imported here: the parallel package imports this module
        from sanerf_tpu_torch.parallel import collectives

        grads, aux = collectives.all_reduce_mean(mesh, [grads, aux])
    grads = _apply_regularizer_grads(model, cfg, state.params, grads,
                                     draws.tv_points)
    aux["lr"] = lr_schedule(cfg, state.step)
    return apply_update(cfg, opt, state, grads), aux


def make_rgb_train_step(model: NerfModel, cfg: TrainConfig,
                        trainable: Optional[Params] = None):
    """step(state, batch, draws, update_proposal) -> (state, aux)."""
    opt = make_optimizer(cfg, trainable)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             draws: StepDraws, update_proposal: bool = True):
        return rgb_step_body(model, cfg, opt, state, batch, draws,
                             update_proposal)

    return step


def draw_step(model: NerfModel, cfg: TrainConfig, n_rays: int,
              generator: torch.Generator, device=None,
              shared: Optional[torch.Generator] = None) -> StepDraws:
    """A step's StepDraws from `generator` (on `device`); the TV points
    from `shared` where given (a data-parallel step: alike on every
    rank)."""
    def rand(*shape, gen=generator):
        return torch.rand(shape, generator=gen, device=device)

    jitter = [rand(n_rays, T + 1) for T in model.render_cfg.num_steps]
    bg = rand(n_rays, 3) if model.render_cfg.background == "random" else None
    tv = (rand(TV_POINTS, 3, gen=shared or generator)
          if cfg.lambda_tv > 0 and not model.is_mlp_field else None)
    return StepDraws(jitter, bg, tv)


def update_proposal_now(cfg: TrainConfig, step: int) -> bool:
    """The proposal nets update every step up to prop_warmup_steps, then
    every prop_update_every-th."""
    return step <= cfg.prop_warmup_steps or step % cfg.prop_update_every == 0


def adaptive_num_rays(cfg: TrainConfig, num_steps_last: int) -> int:
    """The fixed point of the reference's adaptive ray count: num_points
    final-level samples a step."""
    if not cfg.adaptive_num_rays:
        return cfg.num_rays
    return max(1, cfg.num_points // num_steps_last)

