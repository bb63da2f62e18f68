"""Import distillation: a hash-grid checkpoint -> the MLP field family
(JAX: sanerf_tpu/models/import_distill.py).

The reference's field is an instant-ngp hash grid. Its checkpoint renders
in this package on the plain path only (every table lookup a
`gather_rows` launch); `distill_to_mlp` fits an MLP-family student to it
once, and the student renders through the served field kernels. Heads of
identical structure (view_mlp, samvit_mlp + samvit_norm, mask_mlp) are
copied; the position-dependent functions (field, proposal nets, the SAM
and mask fields) are fitted on a pool of points:

1. `build_targets`: a mixture of points (`draw_targets`: half in the
   unit cube, a third across the contracted domain, the rest a gaussian
   at the origin) through the teacher; the emptiest third of the pool is
   replaced by jittered twins (0.03 N(0, 1)) of the densest third; the
   pool is shuffled and evaluated again, in chunks without gradients;
2. the fit: density matched as log1p(sigma) under each family's own
   activation (`_log_density`: the teacher's sigma capped at e^12, logits
   clipped at +-30), features by MSE; optax's chain of
   `clip_by_global_norm(1)` and Adam (eps 1e-15) at lr for the nets and
   10 lr for the factorized tables (`distill_optimizer`), over epochs of shuffled
   batches;
3. `report["render_psnr"]`: student frames against teacher frames on an
   orbit (`render_staged`: the student on the CUDA kernels).

Random draws are explicit (`TargetDraws`, `DistillDraws`) and come from a
`torch.Generator`, so a caller can feed draws made elsewhere.

    student_model, student_params, report = distill_to_mlp(
        teacher_model, teacher_params, generator)
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from sanerf_tpu_torch.config import ModelConfig, TrainConfig
from sanerf_tpu_torch.device import resolve_device
from sanerf_tpu_torch.models import fields, renderer
from sanerf_tpu_torch.models.fields import NerfModel, Params
from sanerf_tpu_torch.ops import hashgrid
from sanerf_tpu_torch.ops.freq import freq_encode
from sanerf_tpu_torch.train.state import GRID_LR_KEYS, Optimizer
from sanerf_tpu_torch.train.tree import leaves_with_paths, map_with_path

# density is matched in log1p(sigma) space (the two families decode it
# under different activations); e^12 already saturates alpha at any step
_SIGMA_CAP = float(np.exp(12.0))
_LOGIT_CLIP = 30.0  # pre-activation guard against exp overflow


def student_config(teacher_cfg: ModelConfig, cp_rank: int = 0,
                   cp_res: int = 256, cp_levels: int = 1, vm_rank: int = 0,
                   vm_res: int = 64, vm_levels: int = 1,
                   sigma_cp_rank: int = 0, sigma_cp_res: int = 256,
                   sigma_vm_rank: int = 0, sigma_vm_res: int = 128,
                   depth: Optional[int] = None,
                   width: Optional[int] = None,
                   prop_width: Optional[int] = None,
                   prop_depth: Optional[int] = None) -> ModelConfig:
    """The MLP-family twin of a teacher config: the same heads and feature
    widths, the field family flipped to "mlp", with CP / VM feature tables
    (`cp_rank`, `vm_rank` > 0) and direct-density tables (`sigma_*_rank`
    > 0) as asked; `depth`, `width`, `prop_width`, `prop_depth` override
    the field's and the proposal nets' shape. An MLP-family teacher keeps
    its head widths and has its tables swapped."""

    def _extras(cfg):
        if depth is not None:
            cfg = dataclasses.replace(cfg, mlp_field_depth=depth)
        if width is not None:
            cfg = dataclasses.replace(cfg, mlp_field_width=width)
        if prop_width is not None:
            cfg = dataclasses.replace(cfg, mlp_prop_width=prop_width)
        if prop_depth is not None:
            cfg = dataclasses.replace(cfg, mlp_prop_depth=prop_depth)
        return cfg

    tables = dict(
        mlp_cp_rank=cp_rank, mlp_cp_res=cp_res, mlp_cp_levels=cp_levels,
        mlp_vm_rank=vm_rank, mlp_vm_res=vm_res, mlp_vm_levels=vm_levels,
        mlp_sigma_cp_rank=sigma_cp_rank, mlp_sigma_cp_res=sigma_cp_res,
        mlp_sigma_vm_rank=sigma_vm_rank, mlp_sigma_vm_res=sigma_vm_res)
    if teacher_cfg.field_type == "mlp":
        return _extras(dataclasses.replace(teacher_cfg, **tables))
    # the mask-feature width follows the teacher's m_grid output
    mask_dim = {"default": 128, "lightweight_mask": 32}.get(
        teacher_cfg.mask_mlp_type, teacher_cfg.mlp_mask_feat_dim)
    return _extras(dataclasses.replace(
        teacher_cfg, field_type="mlp", **tables,
        mlp_sam_feat_dim=(teacher_cfg.s_grid_num_levels
                          * teacher_cfg.s_grid_level_dim),
        mlp_mask_feat_dim=mask_dim))


# -- draws ---------------------------------------------------------------------

@dataclass
class TargetDraws:
    """build_targets' random numbers: `points` [n, 3] (the mixture of
    `_sample_points`), `noise` [n // 3, 3] N(0, 1) (the jitter of the
    dense twins), `perm` [n] (the shuffle)."""

    points: torch.Tensor
    noise: torch.Tensor
    perm: torch.Tensor


@dataclass
class DistillDraws:
    """distill_to_mlp's random numbers: the targets', and one permutation
    [n] of the pool per epoch."""

    targets: TargetDraws
    perms: List[torch.Tensor]


def _sample_points(generator: torch.Generator, n: int, bound: float
                   ) -> torch.Tensor:
    """[n, 3] on the generator's device: n // 2 uniform in [-1, 1]^3,
    n // 3 uniform in [-bound, bound]^3, the rest 0.4 N(0, 1) clipped to
    the bound."""
    dev = generator.device
    n1, n2 = n // 2, n // 3
    u = lambda m, lo, hi: lo + (hi - lo) * torch.rand(  # noqa: E731
        (m, 3), generator=generator, device=dev)
    c = torch.clamp(0.4 * torch.randn((n - n1 - n2, 3), generator=generator,
                                      device=dev), -bound, bound)
    return torch.cat([u(n1, -1.0, 1.0), u(n2, -bound, bound), c], dim=0)


def draw_targets(generator: torch.Generator, n: int, bound: float
                 ) -> TargetDraws:
    points = _sample_points(generator, n, bound)
    noise = torch.randn((n // 3, 3), generator=generator,
                        device=generator.device)
    return TargetDraws(points, noise,
                       torch.randperm(n, generator=generator,
                                      device=generator.device))


# -- the two families' position functions --------------------------------------

def _teacher_field(model: NerfModel, params: Params, x: torch.Tensor
                   ) -> torch.Tensor:
    """[N, 1 + geo] raw field outputs (column 0 the density logit)."""
    if model.is_mlp_field:  # an MLP-family (grid) teacher
        return _student_field(model, params, x)
    h = hashgrid.hash_encode(x, params["grid"], model.grid_spec, model.bound)
    return fields.apply_mlp(params["grid_mlp"], h)[0]


def _teacher_prop(model: NerfModel, params: Params, i: int, x: torch.Tensor
                  ) -> torch.Tensor:
    if model.is_mlp_field:
        return _student_prop(model, params, i, x)
    p = params["prop"][i]
    h = hashgrid.hash_encode(x, p["grid"], model.prop_specs[i], model.bound)
    return fields.apply_mlp(p["mlp"], h)[0][..., :1]


def _student_field(model: NerfModel, params: Params, x: torch.Tensor
                   ) -> torch.Tensor:
    """The served field function: the skip MLP over the position features,
    the direct-density tables added into the logit."""
    h = fields.position_features(model, params, x)
    f, _ = fields.apply_skip_mlp(params["grid_mlp"], h,
                                 (model.cfg.mlp_field_depth // 2,))
    sg = fields.sigma_grid_logit(model, params, x)
    if sg is not None:
        f = torch.cat([f[..., :1] + sg.to(f.dtype)[..., None], f[..., 1:]],
                      dim=-1)
    return f


def _student_prop(model: NerfModel, params: Params, i: int,
                  x: torch.Tensor) -> torch.Tensor:
    h = freq_encode(x * (math.pi / model.bound), model.cfg.mlp_prop_enc_freqs)
    return fields.apply_mlp(params["prop"][i]["mlp"], h)[0][..., :1]


def _log_density(f0: torch.Tensor, mlp_family: bool) -> torch.Tensor:
    """log1p(sigma) under the family's activation; the hash grid's sigma
    capped at _SIGMA_CAP."""
    f0 = torch.clamp(f0, -_LOGIT_CLIP, _LOGIT_CLIP)
    if mlp_family:
        sigma = torch.logaddexp(f0 - 1.0, torch.zeros_like(f0))  # softplus
    else:
        sigma = torch.clamp(torch.exp(f0), max=_SIGMA_CAP)
    return torch.log1p(sigma)


def _match_loss(student: torch.Tensor, target: torch.Tensor,
                teacher_mlp: bool = False) -> torch.Tensor:
    """log-density MSE (column 0, the student decoded as the MLP family,
    the target under the teacher's own activation) + feature MSE."""
    loss = torch.mean((_log_density(student[..., 0], True)
                       - _log_density(target[..., 0], teacher_mlp)) ** 2)
    if student.shape[-1] > 1:
        loss = loss + torch.mean((student[..., 1:] - target[..., 1:]) ** 2)
    return loss


# -- targets -------------------------------------------------------------------

@torch.no_grad()
def _eval_chunked(fn, x: torch.Tensor, chunk: int) -> torch.Tensor:
    return torch.cat([fn(x[i:i + chunk]) for i in range(0, x.shape[0],
                                                         chunk)], dim=0)


def build_targets(teacher_model: NerfModel, teacher_params: Params,
                  draws: TargetDraws, chunk: int = 1 << 18
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (points [n, 3], {"field", "prop<i>"[, "sam"][, "mask"]: the
    teacher's outputs there}) (module docstring, step 1)."""
    tm, tp, c = teacher_model, teacher_params, teacher_model.cfg
    x = draws.points
    n = x.shape[0]
    f0 = _eval_chunked(lambda q: _teacher_field(tm, tp, q), x, chunk)[:, 0]
    order = torch.argsort(f0, stable=True)
    n_rep = n // 3
    dense = x[order[n - n_rep:]]
    jit_pts = torch.clamp(dense + 0.03 * draws.noise, -tm.bound, tm.bound)
    x = x.clone()
    x[order[:n_rep]] = jit_pts
    x = x[draws.perm]

    targets = {"field": _eval_chunked(
        lambda q: _teacher_field(tm, tp, q), x, chunk)}
    for i in range(len(c.prop_resolutions)):
        targets[f"prop{i}"] = _eval_chunked(
            lambda q, i=i: _teacher_prop(tm, tp, i, q), x, chunk)
    if c.with_sam and "s_grid" in tp:
        targets["sam"] = _eval_chunked(lambda q: hashgrid.hash_encode(
            q, tp["s_grid"], tm.s_grid_spec, tm.bound), x, chunk)
    elif c.with_sam and "s_field_mlp" in tp:
        targets["sam"] = _eval_chunked(lambda q: fields.apply_mlp(
            tp["s_field_mlp"], fields.position_features(tm, tp, q))[0],
            x, chunk)
    if c.with_mask and "m_grid" in tp:
        targets["mask"] = _eval_chunked(lambda q: hashgrid.hash_encode(
            q, tp["m_grid"], tm.m_grid_spec, tm.bound), x, chunk)
    elif c.with_mask and "m_field_mlp" in tp:
        targets["mask"] = _eval_chunked(lambda q: fields.apply_mlp(
            tp["m_field_mlp"], fields.position_features(tm, tp, q))[0],
            x, chunk)
    return x, targets


# -- the optimizer -------------------------------------------------------------

def param_labels(tree: Params) -> Dict[str, str]:
    """{path: "lines" for the factorized tables (GRID_LR_KEYS), else
    "rest"} of every leaf."""
    return {k: "lines" if k.split("/")[0] in GRID_LR_KEYS else "rest"
            for k, _ in leaves_with_paths(tree)}


def distill_optimizer() -> Optimizer:
    """optax.chain(clip_by_global_norm(1.0), multi_transform({"lines":
    adam(10 lr, eps=1e-15), "rest": adam(lr, eps=1e-15)}, labels)): the
    trainer's Adam, its lr given to each `update` (a constant schedule)."""
    return Optimizer(TrainConfig(grad_clip=1.0, adam_eps=1e-15,
                                 grid_lr_mult=10.0))


# -- the fit -------------------------------------------------------------------

def _fit_losses(student_model: NerfModel, p: Params, xb: torch.Tensor,
                tb: Dict[str, torch.Tensor], teacher_mlp: bool
                ) -> Dict[str, torch.Tensor]:
    sm = student_model
    losses = {"field": _match_loss(_student_field(sm, p, xb), tb["field"],
                                   teacher_mlp)}
    for i in range(len(sm.cfg.prop_resolutions)):
        losses[f"prop{i}"] = _match_loss(_student_prop(sm, p, i, xb),
                                         tb[f"prop{i}"], teacher_mlp)
    for name, head in (("sam", "s_field_mlp"), ("mask", "m_field_mlp")):
        if name in tb:
            out = fields.apply_mlp(p[head],
                                   fields.position_features(sm, p, xb))[0]
            losses[name] = torch.mean((out - tb[name]) ** 2)
    return losses


def fit_student(student_model: NerfModel, student: Params, x: torch.Tensor,
                targets: Dict[str, torch.Tensor], perms: List[torch.Tensor],
                batch: int, lr: float, teacher_mlp: bool
                ) -> Tuple[Params, Dict[str, float], List[float]]:
    """The fit (module docstring, step 2): one epoch per permutation of the
    pool, its first (n // batch) * batch points in batches -> (the student
    with its fitted leaves, the last step's losses, every step's total).
    The fitted leaves: grid_mlp, prop, the factorized tables, and the SAM
    and mask fields where there are targets for them."""
    keys = ["grid_mlp", "prop"] + [k for k in GRID_LR_KEYS if k in student]
    keys += ["s_field_mlp"] if "sam" in targets else []
    keys += ["m_field_mlp"] if "mask" in targets else []
    train_tree = {k: map_with_path(lambda _, t: t.detach().clone(),
                                   student[k]) for k in keys}
    opt = distill_optimizer()
    opt_state = opt.init(train_tree)
    steps = x.shape[0] // batch
    history, last = [], {}
    for perm in perms:
        for idx in perm[:steps * batch].reshape(steps, batch):
            live = map_with_path(
                lambda _, t: t.detach().requires_grad_(True), train_tree)
            p = dict(student)
            p.update(live)
            losses = _fit_losses(student_model, p, x[idx],
                                 {k: v[idx] for k, v in targets.items()},
                                 teacher_mlp)
            total = sum(losses.values())
            leaves = leaves_with_paths(live)
            got = dict(zip((k for k, _ in leaves), torch.autograd.grad(
                total, [t for _, t in leaves], allow_unused=True)))
            grads = map_with_path(
                lambda k, t: torch.zeros_like(t) if got[k] is None
                else got[k], live)
            train_tree, opt_state = opt.update(grads, opt_state, train_tree,
                                               lr=lr)
            history.append(total.detach())
            last = {k: v.detach() for k, v in losses.items()}
    student = dict(student)
    student.update(train_tree)
    return (student, {k: float(v) for k, v in last.items()},
            torch.stack(history).cpu().tolist() if history else [])


def distill_to_mlp(teacher_model: NerfModel, teacher_params: Params,
                   generator: Optional[torch.Generator] = None,
                   n_points: int = 1 << 22, batch: int = 1 << 15,
                   iters: int = 8000, lr: float = 2e-3,
                   student_model: Optional[NerfModel] = None,
                   render_check: int = 2, render_hw: int = 128, *,
                   init_params: Optional[Params] = None,
                   draws: Optional[DistillDraws] = None, device=None
                   ) -> Tuple[NerfModel, Params, Dict[str, Any]]:
    """Fit an MLP-family student to the teacher (module docstring) ->
    (student model, params, report). The student defaults to
    `student_config(teacher)` (an MLP-family teacher: its own config with
    the tables stripped). `generator` (seed 0 on `device` by default)
    makes `draws` and, seeded by its initial seed, the student's initial
    params, unless they are given. report: "losses" (each of the last
    step), "loss_history" (every step's total), "copied_heads", "iters",
    "render_psnr" (with `render_check` frames of `render_hw`^2)."""
    dev = resolve_device(device)
    teacher_mlp = teacher_model.is_mlp_field
    if student_model is None:
        student_model = fields.make_model(
            student_config(teacher_model.cfg), teacher_model.render_cfg)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    batch = min(batch, n_points)
    steps_per_epoch = n_points // batch
    n_epochs = max(1, iters // steps_per_epoch)
    if draws is None:
        draws = DistillDraws(
            draw_targets(generator, n_points, teacher_model.bound),
            [torch.randperm(n_points, generator=generator,
                            device=generator.device)
             for _ in range(n_epochs)])
    x, targets = build_targets(teacher_model, teacher_params,
                               TargetDraws(*(t.to(dev) for t in (
                                   draws.targets.points, draws.targets.noise,
                                   draws.targets.perm))))

    student = dict(init_params if init_params is not None else
                   fields.init_params(student_model, torch.Generator(
                       ).manual_seed(generator.initial_seed()), dev))
    copied = []
    for name in ("view_mlp", "samvit_mlp", "samvit_norm", "mask_mlp"):
        if name in teacher_params:
            student[name] = teacher_params[name]
            copied.append(name)

    student, last, history = fit_student(
        student_model, student, x, targets, [q.to(dev) for q in draws.perms],
        batch, lr, teacher_mlp)
    report: Dict[str, Any] = {
        "losses": last,
        "loss_history": history,
        "copied_heads": copied,
        "iters": n_epochs * steps_per_epoch,
    }
    if render_check:
        report["render_psnr"] = _render_fidelity(
            teacher_model, teacher_params, student_model, student,
            n_frames=render_check, hw=render_hw, device=dev)
    return student_model, student, report


# -- fidelity on rendered frames -----------------------------------------------

@torch.no_grad()
def _render_fidelity(tm: NerfModel, tp: Params, sm: NerfModel, sp: Params,
                     n_frames: int, hw: int, device=None) -> float:
    """PSNR of student frames against teacher frames on an orbit."""
    dev = resolve_device(device)
    mses = []
    for i in range(n_frames):
        ang = 2.0 * np.pi * i / max(n_frames, 1)
        pose = _orbit_pose(ang, radius=2.0, height=0.6)
        f = 0.5 * hw / np.tan(0.5 * np.deg2rad(60.0))
        rays_o, rays_d = _frame_rays(pose, f, hw, dev)
        imgs = [renderer.render_staged(m, p, rays_o, rays_d, chunk=hw * hw)[
            "image"].float().cpu().numpy() for m, p in ((tm, tp), (sm, sp))]
        mses.append(float(np.mean((imgs[0] - imgs[1]) ** 2)))
    mse = max(float(np.mean(mses)), 1e-10)
    return float(-10.0 * np.log10(mse))


def _orbit_pose(ang: float, radius: float, height: float) -> np.ndarray:
    eye = np.array([radius * np.cos(ang), height, radius * np.sin(ang)])
    fwd = -eye / np.linalg.norm(eye)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    up2 = np.cross(right, fwd)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = (
        right, up2, -fwd, eye)
    return pose


def _frame_rays(pose: np.ndarray, focal: float, hw: int, device=None):
    """(rays_o, rays_d) [hw^2, 3] float32 of a pinhole frame."""
    i, j = np.meshgrid(np.arange(hw) + 0.5, np.arange(hw) + 0.5,
                       indexing="xy")
    dirs = np.stack([(i - hw / 2) / focal, -(j - hw / 2) / focal,
                     -np.ones_like(i)], axis=-1).reshape(-1, 3)
    rays_d = dirs @ pose[:3, :3].T
    rays_o = np.broadcast_to(pose[:3, 3], rays_d.shape)
    dev = resolve_device(device)
    return (torch.tensor(np.asarray(rays_o, np.float32), device=dev),
            torch.tensor(np.asarray(rays_d, np.float32), device=dev))
