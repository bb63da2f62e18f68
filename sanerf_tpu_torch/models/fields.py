"""NeRF fields of the MLP and hash-grid families
(JAX: sanerf_tpu/models/fields.py).

Parameters are nested dicts of tensors with the JAX package's names
(`grid_mlp`, `view_mlp`, `prop[i]["mlp"]`, the MLP family's factorized
grids `cp_lines`, `vm_planes` / `vm_lines` (each a table, or a list of
levels for a ladder), `sigma_cp_lines`, `sigma_vm_planes` /
`sigma_vm_lines`, its heads `s_field_mlp`, `m_field_mlp`, the hash-grid
family's
tables `grid`, `prop[i]["grid"]`, `s_grid`, `m_grid`, and the heads
`samvit_mlp` / `samvit_norm` and `mask_mlp`); weights are stored
[in, out]. The plain functions (`apply_mlp`, `position_features`,
`forward`, `density`, `sam_features`, `mask_grid_features`,
`apply_samvit_head`, ...) mirror the JAX XLA path; the hash-grid family's
encoder gathers its table rows through the kernel of ops/gather.py;
`field_forward_T`, `field_composite_T` and `density(fast=True)` go through
the kernels of ops/fused_mlp_t.py (MLP family only, inference). Training
takes the plain functions with autograd; `apply_total_variation`,
`apply_weight_decay` and `apply_l1_sparsity` give the regularizers'
gradient contributions, `grid_resolutions` / `resize_grid_tables` the
factorized tables' coarse-to-fine schedule. The training step injects
`params["enc_alpha"]` (a scalar in [0, 1], not a trainable leaf): the MLP
family's plain encode then opens coarse-to-fine (Fourier bands by BARF's
window, ladder levels by the same window over levels); nothing else
injects it, so inference always runs the full encode.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from sanerf_tpu_torch.config import HashGridConfig, ModelConfig, RenderConfig
from sanerf_tpu_torch.ops import cpgrid, hashgrid, vmgrid
from sanerf_tpu_torch.ops.activation import shifted_softplus, trunc_exp
from sanerf_tpu_torch.ops.freq import (anneal_band_weights, freq_encode,
                                      freq_output_dim)
from sanerf_tpu_torch.ops.fused_mlp_t import (TransposedFieldMLP, ViewMLP,
                                              run_tmlp, run_tmlp_composite)
from sanerf_tpu_torch.ops.sh import sh_encode, sh_output_dim

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# MLP primitives
# ---------------------------------------------------------------------------


def init_linear(g: torch.Generator, d_in: int, d_out: int, bias: bool,
                device=None) -> Params:
    """torch nn.Linear's default init: U(-1/sqrt(d_in), 1/sqrt(d_in))."""
    bound = 1.0 / d_in ** 0.5

    def u(*shape):
        return (torch.rand(shape, generator=g) * 2.0 - 1.0) * bound

    p = {"w": u(d_in, d_out).to(device)}
    if bias:
        p["b"] = u(d_out).to(device)
    return p


def init_mlp(g, d_in: int, d_out: int, d_hidden: int, n_layers: int,
             bias: bool, skip_layers: Sequence[int] = (),
             device=None) -> List[Params]:
    """Layer l takes d_hidden inputs (d_in at l = 0, d_hidden + d_in at a
    skip layer) and gives d_hidden outputs (d_out at the last)."""
    layers = []
    for l in range(n_layers):
        fin = d_in if l == 0 else (d_hidden + d_in if l in skip_layers
                                   else d_hidden)
        fout = d_out if l == n_layers - 1 else d_hidden
        layers.append(init_linear(g, fin, fout, bias, device))
    return layers


def apply_linear(p: Params, x: torch.Tensor, hidden: bool = False
                 ) -> torch.Tensor:
    """Product in the weight dtype with float32 accumulation; hidden layers
    emit the weight dtype, final layers float32. A bias is added to the
    product in the output dtype and the sum cast to it again."""
    w = p["w"]
    out_dt = w.dtype if hidden else torch.float32
    y = (x.to(w.dtype).float() @ w.float()).to(out_dt)
    if "b" in p:
        y = (y + p["b"]).to(out_dt)
    return y


def cast_params(params: Params, dtype=torch.bfloat16) -> Params:
    """Cast every floating tensor of a param tree (inference only)."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [cast_params(v, dtype) for v in params]
    if torch.is_tensor(params) and params.is_floating_point():
        return params.to(dtype)
    return params


def apply_mlp(layers: Sequence[Params], x: torch.Tensor
              ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """ReLU MLP over the last axis."""
    n = len(layers)
    for l, p in enumerate(layers):
        x = apply_linear(p, x, hidden=l != n - 1)
        if l != n - 1:
            x = torch.relu(x)
    return x, []


def apply_skip_mlp(layers: Sequence[Params], x: torch.Tensor,
                   skip_layers: Sequence[int]
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """LeakyReLU(0.01) MLP with the input concatenated after the hidden
    activation at each skip layer."""
    x_in = x
    n = len(layers)
    for l, p in enumerate(layers):
        if l in skip_layers:
            x = torch.cat([x, x_in.to(x.dtype)], dim=-1)
        x = apply_linear(p, x, hidden=l != n - 1)
        if l != n - 1:
            x = F.leaky_relu(x, negative_slope=0.01)
    return x, []


def apply_layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5
                    ) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return p["w"] * (x - mu) * torch.rsqrt(var + eps) + p["b"]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NerfModel:
    """Static model specification; the hash-grid family's grid specs are
    resolved here (None / () for the MLP family)."""

    cfg: ModelConfig
    render_cfg: RenderConfig
    grid_spec: Optional[hashgrid.HashGridSpec] = None
    prop_specs: Tuple[hashgrid.HashGridSpec, ...] = ()
    s_grid_spec: Optional[hashgrid.HashGridSpec] = None
    m_grid_spec: Optional[hashgrid.HashGridSpec] = None

    @property
    def is_mlp_field(self) -> bool:
        return self.cfg.field_type == "mlp"

    @property
    def bound(self) -> float:
        return self.render_cfg.grid_bound

    @property
    def has_sigma_grid(self) -> bool:
        """Direct-density tables (sigma-CP or sigma-VM) whose component sum
        adds to the density logit."""
        return self.is_mlp_field and (self.cfg.mlp_sigma_cp_rank > 0
                                      or self.cfg.mlp_sigma_vm_rank > 0)

    @property
    def grid_table_bytes(self) -> int:
        """Bytes of the factorized tables in bf16, from the config alone
        (JAX: fields.py:201-227). run_rays takes the fast path for a model
        with grids only when this is within RenderConfig.grid_vmem_budget,
        as the JAX package does, so one config takes one path on both."""
        c = self.cfg
        if not self.is_mlp_field:
            return 0
        total = 0
        if c.mlp_cp_rank > 0:
            k = max(1, c.mlp_cp_rank // c.mlp_cp_levels)
            for r in cpgrid.level_resolutions(c.mlp_cp_res, c.mlp_cp_levels):
                total += 3 * r * k
        if c.mlp_vm_rank > 0:
            k = max(1, c.mlp_vm_rank // c.mlp_vm_levels)
            for r in cpgrid.level_resolutions(c.mlp_vm_res, c.mlp_vm_levels):
                total += 3 * (r * r + r) * k
        if c.mlp_sigma_cp_rank > 0:
            total += 3 * c.mlp_sigma_cp_res * c.mlp_sigma_cp_rank
        if c.mlp_sigma_vm_rank > 0:
            total += (3 * (c.mlp_sigma_vm_res ** 2 + c.mlp_sigma_vm_res)
                      * c.mlp_sigma_vm_rank)
        return 2 * total

    @property
    def grid_out_dim(self) -> int:
        """Width of the positional feature feeding grid_mlp."""
        if self.is_mlp_field:
            return (freq_output_dim(3, self.cfg.mlp_enc_freqs)
                    + self.cfg.mlp_cp_rank + 3 * self.cfg.mlp_vm_rank)
        return self.grid_spec.output_dim

    @property
    def prop_in_dim(self) -> int:
        if self.is_mlp_field:
            return freq_output_dim(3, self.cfg.mlp_prop_enc_freqs)
        return self.prop_specs[0].output_dim

    @property
    def view_in_dim(self) -> int:
        return sh_output_dim(self.cfg.sh_degree)

    @property
    def color_dim(self) -> int:
        return self.cfg.geom_feat_dim + self.view_in_dim

    @property
    def s_feat_dim(self) -> int:
        """Per-point SAM field feature width."""
        if self.is_mlp_field:
            return self.cfg.mlp_sam_feat_dim
        return self.s_grid_spec.output_dim

    @property
    def m_feat_dim(self) -> int:
        """Per-point mask field feature width."""
        if self.is_mlp_field:
            return self.cfg.mlp_mask_feat_dim
        return self.m_grid_spec.output_dim

    @property
    def samvit_in_dim(self) -> int:
        """[f_sam, f_image | geo_feat sum, image, depth] (composite-then-
        head; the port has no sum_after_mlp)."""
        c = self.cfg
        per = self.color_dim if c.sam_use_view_direction else c.geom_feat_dim
        return self.s_feat_dim + per + 3 + 1

    def mask_out_dim(self) -> int:
        return self.cfg.n_inst + self.cfg.redundant_instance


def make_model(cfg: ModelConfig, render_cfg: RenderConfig) -> NerfModel:
    """The port serves the MLP family with its factorized grids (CP and VM,
    single levels or ladders, sigma-CP and sigma-VM) and the hash-grid
    family (JAX: fields.py:283-365), each with the composite-then-head SAM
    feature head and the default or `lightweight_mask` mask head; every
    other family or head raises NotImplementedError."""
    if cfg.field_type not in ("mlp", "hashgrid"):
        raise NotImplementedError(f"field_type={cfg.field_type!r}")
    if cfg.with_mask and cfg.mask_mlp_type not in ("default",
                                                   "lightweight_mask"):
        raise NotImplementedError(
            f"mask_mlp_type={cfg.mask_mlp_type!r} is not in the port yet")
    if cfg.sum_after_mlp:
        raise NotImplementedError("sum_after_mlp is not in the port yet")
    if cfg.field_type == "mlp":
        return NerfModel(cfg=cfg, render_cfg=render_cfg)

    def spec(num_levels, level_dim, log2_hashmap, desired):
        return hashgrid.build_spec(HashGridConfig(
            input_dim=3, num_levels=num_levels, level_dim=level_dim,
            log2_hashmap_size=log2_hashmap, desired_resolution=desired))

    m_grid = None
    if cfg.with_mask:
        # the reference's fixed mask grids (network.py:125-142)
        m_grid = (spec(16, 8, 19, 512) if cfg.mask_mlp_type == "default"
                  else spec(16, 2, 10, 256))
    return NerfModel(
        cfg=cfg, render_cfg=render_cfg,
        grid_spec=spec(cfg.grid_num_levels, cfg.grid_level_dim,
                       cfg.grid_log2_hashmap, cfg.grid_desired_resolution),
        prop_specs=tuple(spec(cfg.prop_num_levels, cfg.prop_level_dim,
                              cfg.prop_log2_hashmap, res)
                         for res in cfg.prop_resolutions),
        s_grid_spec=(spec(cfg.s_grid_num_levels, cfg.s_grid_level_dim,
                          cfg.s_grid_log2_hashmap,
                          cfg.s_grid_desired_resolution)
                     if cfg.with_sam else None),
        m_grid_spec=m_grid)


def init_params(model: NerfModel, generator: torch.Generator,
                device=None) -> Params:
    """Random parameters of every head the model has (JAX:
    fields.py:init_params, :368-510), float32, drawn from `generator` on
    the CPU and moved to `device`; hash tables U(-1e-4, 1e-4), factorized
    tables 0.2 N(0, 1), ladders as lists of levels coarse -> fine. The
    draws differ from JAX's for the same seed; tests carry JAX's weights
    across with models/asset.py:params_from_jax instead."""
    c, g = model.cfg, generator
    dev = torch.device("cpu") if device is None else device
    view = init_mlp(g, model.color_dim, 3, c.view_mlp_hidden,
                    c.view_mlp_layers, False, (), dev)
    if model.is_mlp_field:
        params: Params = {
            "grid_mlp": init_mlp(g, model.grid_out_dim, 1 + c.geom_feat_dim,
                                 c.mlp_field_width, c.mlp_field_depth, False,
                                 (c.mlp_field_depth // 2,), dev),
            "view_mlp": view,
            "prop": [{"mlp": init_mlp(g, model.prop_in_dim, 1,
                                      c.mlp_prop_width, c.mlp_prop_depth,
                                      False, (), dev)}
                     for _ in c.prop_resolutions],
        }

        def lines(res, rank):
            return 0.2 * torch.randn(3, res, rank, generator=g).to(dev)

        if c.mlp_cp_rank > 0:
            params["cp_lines"] = (
                lines(c.mlp_cp_res, c.mlp_cp_rank) if c.mlp_cp_levels == 1
                else [lines(r, c.mlp_cp_rank // c.mlp_cp_levels)
                      for r in cpgrid.level_resolutions(c.mlp_cp_res,
                                                        c.mlp_cp_levels)])
        if c.mlp_vm_rank > 0:
            params["vm_planes"], params["vm_lines"] = (
                vmgrid.init_vm(g, c.mlp_vm_res, c.mlp_vm_rank, device=dev)
                if c.mlp_vm_levels == 1 else
                vmgrid.init_vm_multi(g, c.mlp_vm_res, c.mlp_vm_rank,
                                     c.mlp_vm_levels, device=dev))
        if c.mlp_sigma_cp_rank > 0:
            params["sigma_cp_lines"] = lines(c.mlp_sigma_cp_res,
                                             c.mlp_sigma_cp_rank)
        if c.mlp_sigma_vm_rank > 0:
            params["sigma_vm_planes"], params["sigma_vm_lines"] = (
                vmgrid.init_vm(g, c.mlp_sigma_vm_res, c.mlp_sigma_vm_rank,
                               device=dev))
        if c.with_sam:
            params["s_field_mlp"] = init_mlp(
                g, model.grid_out_dim, model.s_feat_dim, c.mlp_sam_width,
                c.mlp_sam_depth, False, (), dev)
        if c.with_mask:
            params["m_field_mlp"] = init_mlp(
                g, model.grid_out_dim, model.m_feat_dim, c.mlp_mask_width,
                c.mlp_mask_depth, False, (), dev)
    else:
        params = {
            "grid": hashgrid.init_params(g, model.grid_spec, device=dev),
            "grid_mlp": init_mlp(g, model.grid_out_dim, 1 + c.geom_feat_dim,
                                 c.grid_mlp_hidden, c.grid_mlp_layers, False,
                                 (), dev),
            "view_mlp": view,
            "prop": [{"grid": hashgrid.init_params(g, spec, device=dev),
                      "mlp": init_mlp(g, spec.output_dim, 1,
                                      c.prop_mlp_hidden, c.prop_mlp_layers,
                                      False, (), dev)}
                     for spec in model.prop_specs],
        }
        if c.with_sam:
            params["s_grid"] = hashgrid.init_params(g, model.s_grid_spec,
                                                    device=dev)
        if c.with_mask:
            params["m_grid"] = hashgrid.init_params(g, model.m_grid_spec,
                                                    device=dev)
    if c.with_sam:
        params["samvit_mlp"] = init_mlp(
            g, model.samvit_in_dim, c.sam_feat_dim, c.samvit_mlp_hidden,
            c.samvit_mlp_layers, True, c.samvit_skip_layers, dev)
        params["samvit_norm"] = {
            "w": torch.ones(c.sam_feat_dim, device=dev),
            "b": torch.zeros(c.sam_feat_dim, device=dev)}
    if c.with_mask:
        params["mask_mlp"] = init_mlp(g, *mask_mlp_dims(model), 3, False, (),
                                      dev)
    return params


def mask_mlp_dims(model: NerfModel) -> Tuple[int, int, int]:
    """(d_in, d_out, d_hidden) of `mask_mlp`: the default head takes
    [m_feats, geo_feat] through 256 x 3; `lightweight_mask` takes
    [m_feats, colors] through 64 x 3 (JAX: fields.py:464-482, sized by the
    actual input)."""
    c = model.cfg
    if c.mask_mlp_type == "lightweight_mask":
        return model.m_feat_dim + model.color_dim, model.mask_out_dim(), 64
    return model.m_feat_dim + c.geom_feat_dim, model.mask_out_dim(), 256


def density_activation(model: NerfModel, f0: torch.Tensor) -> torch.Tensor:
    """shifted softplus for the MLP family, trunc_exp for the hash-grid
    family (JAX: fields.py:518-526)."""
    if model.is_mlp_field:
        return shifted_softplus(f0)
    return trunc_exp(f0)


def position_features(model: NerfModel, params: Params, x: torch.Tensor,
                      dtype=None) -> torch.Tensor:
    """Fourier bands of x * pi / bound, then the CP line features (each
    level of a ladder, coarse -> fine), then the VM features (JAX:
    fields.py:529-588, the gather lookups); annealed by
    params["enc_alpha"] when the training step injects it."""
    alpha = params.get("enc_alpha")
    bw = (anneal_band_weights(alpha, model.cfg.mlp_enc_freqs)
          if alpha is not None else None)
    h = freq_encode(x * (math.pi / model.bound), model.cfg.mlp_enc_freqs,
                    out_dtype=dtype, band_weights=bw)
    if model.cfg.mlp_cp_rank > 0:
        cl = params["cp_lines"]
        cp = (cpgrid.line_features_multi(
                  cl, x, model.bound,
                  level_weights=(cpgrid.anneal_level_weights(alpha, len(cl))
                                 if alpha is not None else None))
              if isinstance(cl, (list, tuple))
              else cpgrid.line_features(cl, x, model.bound))
        h = torch.cat([h, cp.to(h.dtype)], dim=-1)
    if model.cfg.mlp_vm_rank > 0:
        planes, lines = params["vm_planes"], params["vm_lines"]
        vm = (vmgrid.vm_features_multi(
                  planes, lines, x, model.bound,
                  level_weights=(cpgrid.anneal_level_weights(alpha,
                                                             len(planes))
                                 if alpha is not None else None))
              if isinstance(planes, (list, tuple))
              else vmgrid.vm_features_gather(planes, lines, x, model.bound))
        h = torch.cat([h, vm.to(h.dtype)], dim=-1)
    return h


def sigma_grid_logit(model: NerfModel, params: Params,
                     x: torch.Tensor) -> Optional[torch.Tensor]:
    """Sum of the sigma-CP and sigma-VM components (direct density), [N]
    float32 (JAX: fields.py:591-624)."""
    if not model.is_mlp_field:
        return None
    c = model.cfg
    out = None
    if c.mlp_sigma_cp_rank > 0 and "sigma_cp_lines" in params:
        out = cpgrid.line_features(params["sigma_cp_lines"], x,
                                   model.bound).sum(dim=-1)
    if c.mlp_sigma_vm_rank > 0 and "sigma_vm_planes" in params:
        s = vmgrid.vm_features_gather(params["sigma_vm_planes"],
                                      params["sigma_vm_lines"], x,
                                      model.bound).sum(dim=-1)
        out = s if out is None else out + s
    return out


def common_forward(model: NerfModel, params: Params, x: torch.Tensor):
    """encode -> grid_mlp -> (sigma, geo_feat, grid_output)."""
    if model.is_mlp_field:
        grid_output = position_features(
            model, params, x, dtype=params["grid_mlp"][0]["w"].dtype)
        f, _ = apply_skip_mlp(params["grid_mlp"], grid_output,
                              (model.cfg.mlp_field_depth // 2,))
    else:
        grid_output = hashgrid.hash_encode(x, params["grid"], model.grid_spec,
                                           model.bound)
        f, _ = apply_mlp(params["grid_mlp"], grid_output)
    logit = f[..., 0]
    sg = sigma_grid_logit(model, params, x)
    if sg is not None:
        logit = logit + sg.to(logit.dtype)
    return density_activation(model, logit), f[..., 1:], grid_output


def forward(model: NerfModel, params: Params, x: Optional[torch.Tensor],
            d: torch.Tensor, fast: bool = False,
            x_T: Optional[torch.Tensor] = None,
            nets: Optional["KernelNets"] = None) -> Dict[str, torch.Tensor]:
    """Final-level field query: sigma, geo_feat and the raw
    [geo_feat, sh(d)] color feature (the view MLP runs after compositing).
    `fast` runs the MLP family's field chain through run_tmlp (on x_T
    [3, P] when given) and leaves grid_output out."""
    if fast and model.is_mlp_field:
        fT = field_forward_T(model, params, x if x_T is None else x_T,
                             transposed=x_T is not None, nets=nets)
        sigma = density_activation(model, fT[0])
        geo_feat = fT[1:1 + model.cfg.geom_feat_dim].T
        grid_output = None
    else:
        sigma, geo_feat, grid_output = common_forward(model, params, x)
    sh = sh_encode(d, model.cfg.sh_degree)
    return {"sigma": sigma, "geo_feat": geo_feat,
            "color": torch.cat([geo_feat, sh], dim=-1),
            "grid_output": grid_output}


class KernelNets:
    """The model's chains packed once for the fused kernels: the proposal
    nets, the field (with every grid table: CP and VM levels, sigma-CP,
    sigma-VM) and the view head."""

    def __init__(self, model: NerfModel, params: Params):
        c = model.cfg
        self.props = [TransposedFieldMLP(p["mlp"], c.mlp_prop_enc_freqs,
                                         model.bound)
                      for p in params["prop"]]
        self.field = TransposedFieldMLP(
            params["grid_mlp"], c.mlp_enc_freqs, model.bound,
            (c.mlp_field_depth // 2,), leaky=True,
            cp_lines=params.get("cp_lines"),
            sigma_cp_lines=params.get("sigma_cp_lines"),
            vm_planes=params.get("vm_planes"),
            vm_lines=params.get("vm_lines"),
            sigma_vm_planes=params.get("sigma_vm_planes"),
            sigma_vm_lines=params.get("sigma_vm_lines"))
        self.view = ViewMLP(params["view_mlp"], 1 + c.geom_feat_dim,
                            c.sh_degree)


def field_forward_T(model: NerfModel, params: Params, x: torch.Tensor,
                    transposed: bool,
                    nets: Optional[KernelNets] = None) -> torch.Tensor:
    """Fused field chain -> [16, P] (row 0 raw density logit, rows 1:16
    geo features)."""
    nets = nets or KernelNets(model, params)
    return run_tmlp(x, nets.field, transposed=transposed)


def field_composite_T(model: NerfModel, params: Params, xT, dl, ts,
                      opaque: bool, rays8=None, with_view: bool = False,
                      nets: Optional[KernelNets] = None, pack_q: int = 1,
                      T: Optional[int] = None):
    """Final-level field query + composite in one kernel -> (gsum [N, 16],
    depth [N], weights_sum [N]) and rgb [N, 3] with `with_view`. With
    pack_q > 1, dl/ts are the ray kernels' packed [N/q, q*T, 1] rows."""
    nets = nets or KernelNets(model, params)
    return run_tmlp_composite(xT, dl, ts, nets.field, opaque=opaque,
                              view=nets.view if with_view else None,
                              rays8=rays8 if with_view else None,
                              pack_q=pack_q, T=T)


def density(model: NerfModel, params: Params, x: Optional[torch.Tensor],
            proposal: int = -1, fast: bool = False,
            x_T: Optional[torch.Tensor] = None,
            nets: Optional[KernelNets] = None) -> torch.Tensor:
    """Density-only query; 0 <= proposal < n_props routes to a proposal
    net. `fast` runs the MLP family's proposal chain through run_tmlp on
    x_T [3, P]."""
    if 0 <= proposal < len(model.cfg.prop_resolutions):
        p = params["prop"][proposal]
        if fast and model.is_mlp_field:
            nets = nets or KernelNets(model, params)
            fT = run_tmlp(x if x_T is None else x_T, nets.props[proposal],
                          transposed=x_T is not None)
            return density_activation(model, fT[0])
        if model.is_mlp_field:
            alpha = params.get("enc_alpha")
            h = freq_encode(x * (math.pi / model.bound),
                            model.cfg.mlp_prop_enc_freqs,
                            out_dtype=p["mlp"][0]["w"].dtype,
                            band_weights=(anneal_band_weights(
                                alpha, model.cfg.mlp_prop_enc_freqs)
                                if alpha is not None else None))
        else:
            h = hashgrid.hash_encode(x, p["grid"], model.prop_specs[proposal],
                                     model.bound)
        f, _ = apply_mlp(p["mlp"], h)
        return density_activation(model, f[..., 0])
    sigma, _, _ = common_forward(model, params, x)
    return sigma


def sam_features(model: NerfModel, params: Params, x: torch.Tensor
                 ) -> torch.Tensor:
    """Per-point SAM field feature [P, s_feat_dim]: the positional feature
    through the ReLU `s_field_mlp`, or the `s_grid` encode of the hash-grid
    family."""
    if not model.is_mlp_field:
        return hashgrid.hash_encode(x, params["s_grid"], model.s_grid_spec,
                                    model.bound)
    h = position_features(model, params, x,
                          dtype=params["s_field_mlp"][0]["w"].dtype)
    out, _ = apply_mlp(params["s_field_mlp"], h)
    return out


def mask_grid_features(model: NerfModel, params: Params, x: torch.Tensor
                       ) -> torch.Tensor:
    """Per-point mask field feature [P, m_feat_dim]: the float32 positional
    feature through the ReLU `m_field_mlp`, or the `m_grid` encode of the
    hash-grid family."""
    if not model.is_mlp_field:
        return hashgrid.hash_encode(x, params["m_grid"], model.m_grid_spec,
                                    model.bound)
    h = position_features(model, params, x)
    out, _ = apply_mlp(params["m_field_mlp"], h)
    return out


def apply_samvit_head(model: NerfModel, params: Params, f: torch.Tensor
                      ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """LeakyReLU skip MLP (biased) + LayerNorm(eps 1e-5)."""
    out, inter = apply_skip_mlp(params["samvit_mlp"], f,
                                model.cfg.samvit_skip_layers)
    return apply_layernorm(params["samvit_norm"], out, eps=1e-5), inter


# ---------------------------------------------------------------------------
# training: regularizer gradients and the tables' coarse-to-fine schedule
# (JAX: fields.py:802-945)
# ---------------------------------------------------------------------------


#: the factorized tables' parameter names
GRID_TABLES = ("cp_lines", "vm_planes", "vm_lines", "sigma_cp_lines",
               "sigma_vm_planes", "sigma_vm_lines")


def _each(t, fn):
    """fn over a table, or over each level of a ladder."""
    return [fn(l) for l in t] if isinstance(t, (list, tuple)) else fn(t)


def apply_total_variation(model: NerfModel, params: Params,
                          x01: torch.Tensor, weight: float) -> Params:
    """TV gradient contributions {param name: gradient}: 1-D TV on CP
    lines and VM / sigma lines, 2-D TV on VM / sigma planes (MLP family);
    for the hash-grid family the active grid's TV at the points x01
    (s_grid with the SAM head, m_grid with the mask head, else grid)."""
    c = model.cfg
    if model.is_mlp_field:
        g: Params = {}
        tv1 = lambda t: cpgrid.grad_total_variation(t, weight)  # noqa: E731
        tv2 = lambda t: vmgrid.grad_total_variation_planes(  # noqa: E731
            t, weight)
        if c.mlp_cp_rank > 0 and "cp_lines" in params:
            g["cp_lines"] = _each(params["cp_lines"], tv1)
        if c.mlp_vm_rank > 0 and "vm_planes" in params:
            g["vm_planes"] = _each(params["vm_planes"], tv2)
            g["vm_lines"] = _each(params["vm_lines"], tv1)
        if "sigma_cp_lines" in params:
            g["sigma_cp_lines"] = tv1(params["sigma_cp_lines"])
        if "sigma_vm_planes" in params:
            g["sigma_vm_planes"] = tv2(params["sigma_vm_planes"])
            g["sigma_vm_lines"] = tv1(params["sigma_vm_lines"])
        return g
    name, spec = _active_grid(model)
    return {name: hashgrid.grad_total_variation(x01, params[name], spec,
                                                weight)}


def _active_grid(model: NerfModel):
    """(param name, spec) of the hash grid the regularizers act on."""
    c = model.cfg
    if c.with_sam:
        return "s_grid", model.s_grid_spec
    if c.with_mask and model.m_grid_spec is not None:
        return "m_grid", model.m_grid_spec
    return "grid", model.grid_spec


def apply_weight_decay(model: NerfModel, params: Params,
                       weight: float) -> Params:
    """Level-meaned weight-decay gradient of the active hash grid; none
    for the MLP family."""
    if model.is_mlp_field:
        return {}
    name, spec = _active_grid(model)
    return {name: hashgrid.grad_weight_decay(params[name], spec, weight)}


def apply_l1_sparsity(model: NerfModel, params: Params,
                      weight: float) -> Params:
    """Gradient of weight * mean|table| of each factorized table (TensoRF
    §5.1): weight * sign(t) / t.numel(); none for the hash-grid family."""
    c = model.cfg
    if not model.is_mlp_field:
        return {}
    g: Params = {}
    for name in GRID_TABLES:
        if name not in params:
            continue
        if name == "cp_lines" and c.mlp_cp_rank <= 0:
            continue
        if name in ("vm_planes", "vm_lines") and c.mlp_vm_rank <= 0:
            continue
        g[name] = _each(params[name],
                        lambda t: (weight / t.numel()) * torch.sign(t))
    return g


def grid_resolutions(params: Params) -> Dict[str, int]:
    """Finest-level resolution of each factorized table family present:
    keys "cp", "vm", "sigma_cp", "sigma_vm"."""
    top = lambda t: t[-1] if isinstance(t, (list, tuple)) else t  # noqa
    out: Dict[str, int] = {}
    for key, name in (("cp", "cp_lines"), ("vm", "vm_planes"),
                      ("sigma_cp", "sigma_cp_lines"),
                      ("sigma_vm", "sigma_vm_planes")):
        if name in params:
            out[key] = top(params[name]).shape[1]
    return out


def resize_grid_tables(model: NerfModel, params: Params,
                       targets: Dict[str, int]) -> Params:
    """Linear resample of every factorized table so that its finest level
    reaches targets[key] (keys of grid_resolutions; absent keys untouched);
    a ladder recomputes its levels' resolutions for the new top."""
    p = dict(params)
    cp_res = targets.get("cp")
    if cp_res is not None and "cp_lines" in p:
        cl = p["cp_lines"]
        p["cp_lines"] = (
            [cpgrid.linresize(l, r) for l, r in
             zip(cl, cpgrid.level_resolutions(cp_res, len(cl)))]
            if isinstance(cl, (list, tuple)) else cpgrid.linresize(cl, cp_res))
    vm_res = targets.get("vm")
    if vm_res is not None and "vm_planes" in p:
        vp, vl = p["vm_planes"], p["vm_lines"]
        if isinstance(vp, (list, tuple)):
            pairs = [vmgrid.resize_vm(a, b, r) for a, b, r in
                     zip(vp, vl, cpgrid.level_resolutions(vm_res, len(vp)))]
            p["vm_planes"] = [a for a, _ in pairs]
            p["vm_lines"] = [b for _, b in pairs]
        else:
            p["vm_planes"], p["vm_lines"] = vmgrid.resize_vm(vp, vl, vm_res)
    if targets.get("sigma_cp") is not None and "sigma_cp_lines" in p:
        p["sigma_cp_lines"] = cpgrid.linresize(p["sigma_cp_lines"],
                                               targets["sigma_cp"])
    if targets.get("sigma_vm") is not None and "sigma_vm_planes" in p:
        p["sigma_vm_planes"], p["sigma_vm_lines"] = vmgrid.resize_vm(
            p["sigma_vm_planes"], p["sigma_vm_lines"], targets["sigma_vm"])
    return p
