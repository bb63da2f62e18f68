"""Volume renderer: proposal-network hierarchical sampling + compositing
(JAX: sanerf_tpu/models/renderer.py:50-409, 463-569).

`run_rays` has the two paths of the JAX renderer:
  - the fast path (`RenderConfig.use_fused_mlp`, default): per level the
    ray-geometry kernel (ray_level0 / ray_level), proposal densities through
    run_tmlp, then at the final level
      - the pure-RGB frame: field + alpha composite + view head in one
        run_tmlp_composite launch (`packed_epilogue` feeds it the ray
        kernel's packed ts/dl rows);
      - `return_feats`: the field through run_tmlp, weights from the
        deltas, the composite and the view head as plain ops, and the SAM
        feature head (composite-then-head) on the point-major coordinates;
      - `return_mask`: the same field query, then the mask field and the
        mask head (default or `lightweight_mask`) per point, composited
        with the weights;
    with `flatten_kernel` the [3, N, T] coordinates reach the MLP kernels
    through the flatten3_nt kernel instead of a reshape;
  - the plain path (`use_fused_mlp=False`, the hash-grid family, MLP
    fields whose grid tables exceed `RenderConfig.grid_vmem_budget`, and
    every `training=True` batch, which autograd differentiates):
    uniform_bins / sample_pdf, point-major coordinates, the plain
    field and compositing. It is the oracle the fast path is held against,
    and it serves the hash-grid family, whose encoder gathers its table
    rows through the kernel of ops/gather.py.

Randomness enters as tensors: `jitter` is a list of uniform [0, 1) draws,
one [N, T_l + 1] per level (the JAX renderer's `jax.random.uniform` draws,
renderer.py:153-162); None renders unperturbed.

With `training=True` (JAX renderer.py:181-183, 206-207, 272-274, 333-341)
the resampled bins are detached, the proposal densities too unless
`update_proposal`, and a pure-RGB model's results gain `weights`,
`num_points`, `proposal_loss` (0 without `update_proposal`) and
`distort_loss`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from sanerf_tpu_torch.models import fields
from sanerf_tpu_torch.models.fields import KernelNets, NerfModel, Params
from sanerf_tpu_torch.ops import (composite, compute_weights,
                                  compute_weights_from_deltas, contract,
                                  near_far_from_aabb, sample_pdf, spacing_fn,
                                  spacing_fn_inv, uniform_bins)
from sanerf_tpu_torch.ops.losses import distort_loss, proposal_loss
from sanerf_tpu_torch.ops.ray_kernels import (flatten3_nt, pick_pack_q,
                                              ray_level, ray_level0)
from sanerf_tpu_torch.ops.sh import sh_encode

_KEEP = ("image", "depth", "weights_sum")


def default_aabb(model: NerfModel, device) -> torch.Tensor:
    b = float(model.render_cfg.bound)
    # fill kernels, not a copy from host memory (which waits for the card)
    return torch.cat([torch.full((3,), -b, device=device),
                      torch.full((3,), b, device=device)])


def saves_intermediates(model: NerfModel) -> bool:
    """The adaptive mask head reads the backbone's intermediate
    activations (JAX renderer.py:103)."""
    mc = model.cfg
    return mc.with_mask and mc.mask_mlp_type == "adaptive"


def uses_kernels(model: NerfModel) -> bool:
    """Whether run_rays takes the fast path: the JAX predicate of
    renderer.py:106-116. The MLP family only, not with the adaptive mask
    head (its intermediates); a model with grid tables only with
    `cp_fused` and tables within `grid_vmem_budget`
    (NerfModel.grid_table_bytes), so that one config takes the same path
    on both sides; larger tables take the plain path."""
    cfg, mc = model.render_cfg, model.cfg
    has_grids = (mc.mlp_cp_rank > 0 or mc.mlp_vm_rank > 0
                 or model.has_sigma_grid)
    skip_ok = mc.mlp_field_depth // 2 != mc.mlp_field_depth - 1
    return (model.is_mlp_field and cfg.use_fused_mlp and skip_ok
            and not saves_intermediates(model)
            and (not has_grids
                 or (cfg.cp_fused
                     and model.grid_table_bytes <= cfg.grid_vmem_budget)))


def run_rays(model: NerfModel, params: Params, rays_o: torch.Tensor,
             rays_d: torch.Tensor,
             jitter: Optional[Sequence[torch.Tensor]] = None, *,
             bg_color=1.0, cam_near_far: Optional[torch.Tensor] = None,
             aabb: Optional[torch.Tensor] = None, return_feats: bool = False,
             return_mask: bool = False,
             nets: Optional[KernelNets] = None, training: bool = False,
             update_proposal: bool = True) -> Dict[str, torch.Tensor]:
    """Render a ray batch: rays_o, rays_d [N, 3]; bg_color scalar or
    [N, 3]; cam_near_far [N, 2] or [1, 2]; aabb [6]. Returns image [N, 3],
    depth [N], weights_sum [N]; samvit [N, sam_feat_dim] with
    `return_feats` (needs the SAM head); instance_mask_logits
    [N, mask_out_dim] with `return_mask` (needs the mask head); with
    `training`, the training outputs of the module docstring."""
    cfg, mc = model.render_cfg, model.cfg
    if return_feats and not mc.with_sam:
        raise ValueError("return_feats needs a model with the SAM head")
    if return_mask and not mc.with_mask:
        raise ValueError("return_mask needs a model with the mask head")
    N = rays_o.shape[0]
    dev = rays_o.device
    if aabb is None:
        aabb = default_aabb(model, dev)
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, cfg.min_near)
    if cam_near_far is not None:
        nears = torch.maximum(nears, cam_near_far[:, :1])
        fars = torch.minimum(fars, cam_near_far[:, 1:2])
    s_nears, s_fars = spacing_fn(nears), spacing_fn(fars)
    perturb = jitter is not None
    opaque = cfg.background == "last_sample"
    fast = uses_kernels(model) and not training
    save_inter = saves_intermediates(model)
    # the pure-RGB frame fuses the final level into the composite kernel
    # (JAX renderer.py:117-120: not with sum_after_mlp, whose view MLP runs
    # per sample)
    fast_epi = (fast and not mc.sum_after_mlp and not return_feats
                and not return_mask)
    if fast:
        nets = nets or KernelNets(model, params)
        rays8 = torch.cat([rays_o, rays_d, s_nears, s_fars],
                          dim=1).float().contiguous()

    dirs_ray = rays_d / rays_d.norm(dim=-1, keepdim=True)
    T_last = cfg.num_steps[-1]
    bins = weights = None
    all_bins, all_weights = [], []
    last_level = len(cfg.num_steps) - 1
    for level, T in enumerate(cfg.num_steps):
        last = level == last_level
        if fast:
            pq = 0
            if last and fast_epi and cfg.packed_epilogue:
                pq = pick_pack_q(T, N)
                pq = 0 if pq <= 1 else pq
            if level == 0:
                jit = None if not perturb else (jitter[0] - 0.5) / T
                bins, rays_t, dl, x3, *packed = ray_level0(
                    rays8, T, cfg.contract, jitter=jit, pack_q=pq)
            else:
                jit = None if not perturb else (jitter[level] - 0.5) / (T + 1)
                bins, rays_t, dl, x3, *packed = ray_level(
                    rays8, weights, bins, T, cfg.contract,
                    uniform_prev=level == 1 and not perturb, jitter=jit,
                    pack_q=pq)
            xyzs_T = (flatten3_nt(x3) if cfg.flatten_kernel
                      else x3.reshape(3, N * T))
            if not last:
                sigmas = fields.density(model, params, None, proposal=level,
                                        fast=True, x_T=xyzs_T, nets=nets)
                weights = compute_weights_from_deltas(
                    dl, sigmas.reshape(N, T), opaque_background=opaque)
                continue
            if fast_epi:
                if cfg.view_in_kernel or pq:
                    # the packed composite runs only with the view head
                    # in the kernel (JAX renderer.py:215)
                    if mc.sh_degree > 4:
                        raise NotImplementedError(
                            f"sh_degree={mc.sh_degree} with the view head "
                            f"in the composite kernel: the kernels of both "
                            f"packages evaluate SH degrees 1-4 (the JAX "
                            f"package raises here too); "
                            f"RenderConfig(view_in_kernel=False) renders it")
                    _, depth, weights_sum, image = fields.field_composite_T(
                        model, params, xyzs_T, packed[1] if pq else dl,
                        packed[0] if pq else rays_t, opaque=opaque,
                        rays8=rays8, with_view=True, nets=nets,
                        pack_q=pq or 1, T=T)
                else:
                    gsum, depth, weights_sum = fields.field_composite_T(
                        model, params, xyzs_T, dl, rays_t, opaque=opaque,
                        with_view=False, nets=nets)
                    f_image = torch.cat(
                        [gsum[:, 1:1 + mc.geom_feat_dim],
                         weights_sum[:, None]
                         * sh_encode(dirs_ray, mc.sh_degree)], dim=-1)
                    rgb_logits, _ = fields.apply_mlp(params["view_mlp"],
                                                     f_image)
                    image = torch.sigmoid(rgb_logits)
                break
            # features / masks / sum_after_mlp: the field through
            # run_tmlp, then per-point heads on the point-major coordinates
            xyzs = xyzs_T.T
            per_point = return_mask or mc.sum_after_mlp
            if per_point:
                dirs = dirs_ray[:, None, :].expand(N, T, 3).reshape(N * T, 3)
                outputs = fields.forward(model, params, None, dirs,
                                         fast=True, x_T=xyzs_T, nets=nets)
                sigmas = outputs["sigma"]
            else:
                fT = fields.field_forward_T(model, params, xyzs_T,
                                            transposed=True, nets=nets)
                sigmas = fields.density_activation(model, fT[0])
            weights = compute_weights_from_deltas(
                dl, sigmas.reshape(N, T), opaque_background=opaque)
            if per_point:
                weights_sum, depth, f_image = composite(
                    weights, rays_t, outputs["color"].reshape(N, T, -1))
            else:
                g_sum = (fT[1:1 + mc.geom_feat_dim].reshape(-1, N, T)
                         * weights[None]).sum(dim=-1).T
                weights_sum = weights.sum(dim=-1)
                depth = (weights * rays_t).sum(dim=-1)
                f_image = torch.cat(
                    [g_sum, weights_sum[:, None]
                     * sh_encode(dirs_ray, mc.sh_degree)], dim=-1)
            break

        jit = None if not perturb else jitter[level]
        if level == 0:
            bins = uniform_bins(N, T, jit, device=dev)
        else:
            bins = sample_pdf(bins, weights, T + 1, jit).detach()
        real_bins = spacing_fn_inv(s_nears * (1.0 - bins) + s_fars * bins)
        rays_t = (real_bins[:, 1:] + real_bins[:, :-1]) / 2.0
        xyzs = (rays_o[:, None, :] + rays_d[:, None, :] * rays_t[..., None]
                ).reshape(N * T, 3)
        if cfg.contract:
            xyzs = contract(xyzs)
        if not last:
            sigmas = fields.density(model, params, xyzs, proposal=level)
            if not update_proposal:
                sigmas = sigmas.detach()
        else:
            dirs = dirs_ray[:, None, :].expand(N, T, 3).reshape(N * T, 3)
            outputs = fields.forward(model, params, xyzs, dirs,
                                     save_intermediates=save_inter)
            sigmas = outputs["sigma"]
        weights = compute_weights(real_bins, sigmas.reshape(N, T),
                                  opaque_background=opaque)
        if training:
            all_bins.append(bins)
            all_weights.append(weights)
        if last:
            weights_sum, depth, f_image = composite(
                weights, rays_t, outputs["color"].reshape(N, T, -1))

    view_inter = []
    if mc.sum_after_mlp:
        # per-sample view MLP, then the composite (JAX renderer.py:324-328)
        f_colors, view_inter = fields.apply_mlp(
            params["view_mlp"], outputs["color"], save_inter)
        image = torch.sigmoid((weights[..., None]
                               * f_colors.reshape(N, T_last, -1)).sum(-2))
    elif not fast_epi:
        rgb_logits, view_inter = fields.apply_mlp(params["view_mlp"], f_image,
                                                  save_inter)
        image = torch.sigmoid(rgb_logits)
    bg = (float(bg_color) if isinstance(bg_color, (int, float))
          else torch.as_tensor(bg_color, dtype=torch.float32, device=dev))
    image = image + (1.0 - weights_sum)[..., None] * bg
    results = {"weights_sum": weights_sum, "depth": depth, "image": image}
    if training and not mc.with_mask and not mc.with_sam:
        results["num_points"] = N * cfg.num_steps[-1]
        results["weights"] = weights
        results["proposal_loss"] = (proposal_loss(all_bins, all_weights)
                                    if update_proposal
                                    else torch.zeros((), device=dev))
        results["distort_loss"] = distort_loss(bins, weights)

    T = T_last
    sam_inter = []
    if mc.with_sam and (return_feats or (
            return_mask and save_inter and mc.adaptive_mlp_type == "sam")):
        features = fields.sam_features(model, params, xyzs)
        if mc.sum_after_mlp:
            # per-point head, then the composite (JAX renderer.py:356-363)
            mid = f_colors if mc.sam_use_view_direction else \
                outputs["geo_feat"].to(f_colors.dtype)
            f = torch.cat([features.to(f_colors.dtype), mid, f_colors],
                          dim=-1)
            samvit_out, sam_inter = fields.apply_samvit_head(
                model, params, f, save_inter)
            samvit = (weights[..., None]
                      * samvit_out.reshape(N, T, -1)).sum(dim=-2)
        else:
            # composite-then-head (JAX renderer.py:364-377): one MLP a ray
            f_sam = (weights[..., None]
                     * features.reshape(N, T, -1)).sum(dim=-2)
            if mc.sam_use_view_direction:
                mid = f_image
            else:
                mid = f_image[:, :mc.geom_feat_dim]
            f = torch.cat([f_sam, mid, image, depth[..., None]], dim=-1)
            samvit, sam_inter = fields.apply_samvit_head(model, params, f,
                                                         save_inter)
        if return_feats:
            results["samvit"] = samvit
    if return_mask:
        # per-point mask logits, composited (JAX renderer.py:379-388)
        m_feats = (None if save_inter
                   else fields.mask_grid_features(model, params, xyzs))
        point_masks = _mask_head(model, params, m_feats, outputs["geo_feat"],
                                 outputs["color"], outputs=outputs,
                                 view_inter=view_inter, sam_inter=sam_inter)
        # the weights, geometry and colours reach the mask loss detached
        # (JAX renderer.py:385-386, 405-412): it trains the mask head only
        results["instance_mask_logits"] = (
            weights.detach()[..., None]
            * point_masks.reshape(N, T, -1)).sum(dim=-2)
    return results


def _mask_head(model: NerfModel, params: Params,
               m_feats: Optional[torch.Tensor], geo_feat: torch.Tensor,
               colors: Optional[torch.Tensor] = None, *,
               outputs: Optional[Dict] = None, view_inter=(), sam_inter=()
               ) -> torch.Tensor:
    """Per-point mask logits [P, mask_out_dim] (JAX renderer.py:393-451):
    the default head takes [m_feats, geo_feat] through the LeakyReLU
    `mask_mlp` with no skips, `lightweight_mask` takes [m_feats, colors]
    (the [geo_feat, sh(d)] color feature) through the ReLU `mask_mlp`;
    `adaptive` is a ladder of linears (no activation between them) over the
    detached grid_output and grid_mlp activations of `outputs`, then the
    view MLP's (`rgb`) or the samvit head's (`sam`) activations."""
    mc = model.cfg
    mm = params["mask_mlp"]
    if mc.mask_mlp_type == "lightweight_mask":
        m = torch.cat([m_feats, colors.detach().to(m_feats.dtype)], dim=-1)
        out, _ = fields.apply_mlp(mm, m)
        return out
    if mc.mask_mlp_type == "default":
        m = torch.cat([m_feats, geo_feat.detach().to(m_feats.dtype)],
                      dim=-1)
        out, _ = fields.apply_skip_mlp(mm, m, ())
        return out
    gi = outputs["grid_mlp_inter"]
    lin = fields.apply_linear

    def cat(*xs):
        return torch.cat(xs, dim=-1)

    if mc.adaptive_mlp_type in ("rgb", "density"):
        m = lin(mm[0], outputs["grid_output"].detach())
        m = lin(mm[1], cat(gi[0], m))
        m = lin(mm[2], cat(gi[1], m))
        m = lin(mm[3], cat(gi[-1], m))
        if mc.adaptive_mlp_type == "density":
            return lin(mm[5], lin(mm[4], m))
        m = lin(mm[4], cat(view_inter[0], m))
        m = lin(mm[5], cat(view_inter[1], m))
        return lin(mm[7], lin(mm[6], m))
    if mc.adaptive_mlp_type == "sam":
        m = lin(mm[0], gi[0])
        m = lin(mm[1], cat(gi[1], m))
        m = lin(mm[2], cat(gi[-1], m))
        m = lin(mm[3], cat(sam_inter[0], m))
        m = lin(mm[4], cat(sam_inter[1], m))
        m = lin(mm[5], cat(sam_inter[2], m))
        return lin(mm[6], cat(sam_inter[3], m))
    raise ValueError(mc.adaptive_mlp_type)


#: The renderer's entry point (the JAX package jits run_rays under this name).
render_rays = run_rays


def render_frame(model: NerfModel, params: Params, rays_o: torch.Tensor,
                 rays_d: torch.Tensor, *, chunk: int = 65536,
                 bg_color=1.0, aabb: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 nets: Optional[KernelNets] = None,
                 return_feats: bool = False, return_mask: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """Whole-frame inference as a loop over ray chunks of `chunk` rays.
    With `generator`, every chunk draws its own stratified jitter. `nets`
    (the weights packed for the kernels) can be built once by the caller
    and reused across frames. Keeps image, depth, weights_sum, and samvit /
    instance_mask_logits when asked for."""
    N = rays_o.shape[0]
    keep = _KEEP + (("samvit",) if return_feats else ()) + (
        ("instance_mask_logits",) if return_mask else ())
    if nets is None and uses_kernels(model):
        nets = KernelNets(model, params)
    outs = []
    for head in range(0, N, chunk):
        o, d = rays_o[head:head + chunk], rays_d[head:head + chunk]
        jitter = None
        if generator is not None:
            jitter = [torch.rand((o.shape[0], T + 1), generator=generator,
                                 device=o.device)
                      for T in model.render_cfg.num_steps]
        out = run_rays(model, params, o, d, jitter, bg_color=bg_color,
                       aabb=aabb, nets=nets, return_feats=return_feats,
                       return_mask=return_mask)
        outs.append({k: out[k] for k in keep})
    if len(outs) == 1:
        return outs[0]
    return {k: torch.cat([o[k] for o in outs], dim=0) for k in keep}


def render_staged(model: NerfModel, params: Params, rays_o: torch.Tensor,
                  rays_d: torch.Tensor,
                  jitter: Optional[Sequence[torch.Tensor]] = None, *,
                  cam_near_far: Optional[torch.Tensor] = None,
                  chunk: Optional[int] = None, **kwargs
                  ) -> Dict[str, torch.Tensor]:
    """Chunked whole-image inference; a shared near/far ([1, 2])
    broadcasts, a per-ray one ([N, 2]) is cut with the rays."""
    N = rays_o.shape[0]
    chunk = chunk or model.render_cfg.max_ray_batch
    if N <= chunk:
        return run_rays(model, params, rays_o, rays_d, jitter,
                        cam_near_far=cam_near_far, **kwargs)
    if uses_kernels(model) and "nets" not in kwargs:
        kwargs["nets"] = KernelNets(model, params)
    outs = []
    for head in range(0, N, chunk):
        sl = slice(head, head + chunk)
        cnf = cam_near_far
        if cnf is not None and cnf.shape[0] > 1:
            cnf = cnf[sl]
        jit = None if jitter is None else [j[sl] for j in jitter]
        outs.append(run_rays(model, params, rays_o[sl], rays_d[sl], jit,
                             cam_near_far=cnf, **kwargs))
    return {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}
