"""NeRF field of the MLP family, inference only
(JAX: sanerf_tpu/models/fields.py).

Parameters are nested dicts of tensors with the JAX package's names
(`grid_mlp`, `view_mlp`, `prop[i]["mlp"]`, `cp_lines`, `sigma_cp_lines`,
the SAM feature head `s_field_mlp` / `samvit_mlp` / `samvit_norm`, the
default mask head `m_field_mlp` / `mask_mlp`); weights are stored
[in, out]. The plain functions (`apply_mlp`, `position_features`,
`forward`, `density`, `sam_features`, `mask_grid_features`,
`apply_samvit_head`, ...) mirror the JAX XLA path; `field_forward_T`,
`field_composite_T` and `density(fast=True)` go through the kernels of
ops/fused_mlp_t.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from sanerf_tpu_torch.config import ModelConfig, RenderConfig
from sanerf_tpu_torch.ops import cpgrid
from sanerf_tpu_torch.ops.activation import shifted_softplus
from sanerf_tpu_torch.ops.freq import freq_encode, freq_output_dim
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
    """Static model specification."""

    cfg: ModelConfig
    render_cfg: RenderConfig

    @property
    def bound(self) -> float:
        return self.render_cfg.grid_bound

    @property
    def has_sigma_grid(self) -> bool:
        return self.cfg.mlp_sigma_cp_rank > 0

    @property
    def grid_out_dim(self) -> int:
        return freq_output_dim(3, self.cfg.mlp_enc_freqs) + self.cfg.mlp_cp_rank

    @property
    def prop_in_dim(self) -> int:
        return freq_output_dim(3, self.cfg.mlp_prop_enc_freqs)

    @property
    def view_in_dim(self) -> int:
        return sh_output_dim(self.cfg.sh_degree)

    @property
    def color_dim(self) -> int:
        return self.cfg.geom_feat_dim + self.view_in_dim

    @property
    def s_feat_dim(self) -> int:
        """Per-point SAM field feature width."""
        return self.cfg.mlp_sam_feat_dim

    @property
    def m_feat_dim(self) -> int:
        """Per-point mask field feature width."""
        return self.cfg.mlp_mask_feat_dim

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
    """The port serves the MLP family with single-level CP and sigma-CP
    grids, the composite-then-head SAM feature head and the default mask
    head; every other family, grid or head raises NotImplementedError."""
    if cfg.field_type != "mlp":
        raise NotImplementedError(
            f"field_type={cfg.field_type!r}: the port has the MLP family only")
    if cfg.mlp_vm_rank > 0 or cfg.mlp_sigma_vm_rank > 0:
        raise NotImplementedError("VM grids are not in the port yet")
    if cfg.mlp_cp_rank > 0 and cfg.mlp_cp_levels != 1:
        raise NotImplementedError("multi-level CP grids are not in the port yet")
    if cfg.with_mask and cfg.mask_mlp_type != "default":
        raise NotImplementedError(
            f"mask_mlp_type={cfg.mask_mlp_type!r} is not in the port yet")
    if cfg.sum_after_mlp:
        raise NotImplementedError("sum_after_mlp is not in the port yet")
    return NerfModel(cfg=cfg, render_cfg=render_cfg)


def init_params(model: NerfModel, generator: torch.Generator,
                device=None) -> Params:
    """Random parameters of every head the model has (JAX:
    fields.py:init_params, :415-424, :451-474), float32, drawn from
    `generator` on the CPU and moved to `device`. The draws differ from
    JAX's for the same seed; tests carry JAX's weights across with
    models/asset.py:params_from_jax instead."""
    c, g = model.cfg, generator
    dev = torch.device("cpu") if device is None else device
    params: Params = {
        "grid_mlp": init_mlp(g, model.grid_out_dim, 1 + c.geom_feat_dim,
                             c.mlp_field_width, c.mlp_field_depth, False,
                             (c.mlp_field_depth // 2,), dev),
        "view_mlp": init_mlp(g, model.color_dim, 3, c.view_mlp_hidden,
                             c.view_mlp_layers, False, (), dev),
        "prop": [{"mlp": init_mlp(g, model.prop_in_dim, 1, c.mlp_prop_width,
                                  c.mlp_prop_depth, False, (), dev)}
                 for _ in c.prop_resolutions],
    }
    if c.mlp_cp_rank > 0:
        params["cp_lines"] = 0.2 * torch.randn(
            3, c.mlp_cp_res, c.mlp_cp_rank, generator=g).to(dev)
    if c.mlp_sigma_cp_rank > 0:
        params["sigma_cp_lines"] = 0.2 * torch.randn(
            3, c.mlp_sigma_cp_res, c.mlp_sigma_cp_rank, generator=g).to(dev)
    if c.with_sam:
        params["s_field_mlp"] = init_mlp(
            g, model.grid_out_dim, model.s_feat_dim, c.mlp_sam_width,
            c.mlp_sam_depth, False, (), dev)
        params["samvit_mlp"] = init_mlp(
            g, model.samvit_in_dim, c.sam_feat_dim, c.samvit_mlp_hidden,
            c.samvit_mlp_layers, True, c.samvit_skip_layers, dev)
        params["samvit_norm"] = {
            "w": torch.ones(c.sam_feat_dim, device=dev),
            "b": torch.zeros(c.sam_feat_dim, device=dev)}
    if c.with_mask:
        params["m_field_mlp"] = init_mlp(
            g, model.grid_out_dim, model.m_feat_dim, c.mlp_mask_width,
            c.mlp_mask_depth, False, (), dev)
        params["mask_mlp"] = init_mlp(
            g, model.m_feat_dim + c.geom_feat_dim, model.mask_out_dim(), 256,
            3, False, (), dev)
    return params


def density_activation(model: NerfModel, f0: torch.Tensor) -> torch.Tensor:
    return shifted_softplus(f0)


def position_features(model: NerfModel, params: Params, x: torch.Tensor,
                      dtype=None) -> torch.Tensor:
    """Fourier bands of x * pi / bound, then the CP line features."""
    h = freq_encode(x * (math.pi / model.bound), model.cfg.mlp_enc_freqs,
                    out_dtype=dtype)
    if model.cfg.mlp_cp_rank > 0:
        cp = cpgrid.line_features(params["cp_lines"], x, model.bound)
        h = torch.cat([h, cp.to(h.dtype)], dim=-1)
    return h


def sigma_grid_logit(model: NerfModel, params: Params,
                     x: torch.Tensor) -> Optional[torch.Tensor]:
    """Sum of the sigma-CP components (direct density), [N] float32."""
    if not model.has_sigma_grid or "sigma_cp_lines" not in params:
        return None
    return cpgrid.line_features(params["sigma_cp_lines"], x,
                                model.bound).sum(dim=-1)


def common_forward(model: NerfModel, params: Params, x: torch.Tensor):
    """encode -> grid_mlp -> (sigma, geo_feat, grid_output)."""
    grid_output = position_features(model, params, x,
                                    dtype=params["grid_mlp"][0]["w"].dtype)
    f, _ = apply_skip_mlp(params["grid_mlp"], grid_output,
                          (model.cfg.mlp_field_depth // 2,))
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
    `fast` runs the field chain through run_tmlp (on x_T [3, P] when given)
    and leaves grid_output out."""
    if fast:
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
    nets, the field (with its CP and sigma-CP tables) and the view head."""

    def __init__(self, model: NerfModel, params: Params):
        c = model.cfg
        self.props = [TransposedFieldMLP(p["mlp"], c.mlp_prop_enc_freqs,
                                         model.bound)
                      for p in params["prop"]]
        self.field = TransposedFieldMLP(
            params["grid_mlp"], c.mlp_enc_freqs, model.bound,
            (c.mlp_field_depth // 2,), leaky=True,
            cp_lines=params.get("cp_lines"),
            sigma_cp_lines=params.get("sigma_cp_lines"))
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
    net. `fast` runs the proposal chain through run_tmlp on x_T [3, P]."""
    if 0 <= proposal < len(model.cfg.prop_resolutions):
        p = params["prop"][proposal]
        if fast:
            nets = nets or KernelNets(model, params)
            fT = run_tmlp(x if x_T is None else x_T, nets.props[proposal],
                          transposed=x_T is not None)
            return density_activation(model, fT[0])
        h = freq_encode(x * (math.pi / model.bound),
                        model.cfg.mlp_prop_enc_freqs,
                        out_dtype=p["mlp"][0]["w"].dtype)
        f, _ = apply_mlp(p["mlp"], h)
        return density_activation(model, f[..., 0])
    sigma, _, _ = common_forward(model, params, x)
    return sigma


def sam_features(model: NerfModel, params: Params, x: torch.Tensor
                 ) -> torch.Tensor:
    """Per-point SAM field feature [P, s_feat_dim]: the positional feature
    through the ReLU `s_field_mlp`."""
    h = position_features(model, params, x,
                          dtype=params["s_field_mlp"][0]["w"].dtype)
    out, _ = apply_mlp(params["s_field_mlp"], h)
    return out


def mask_grid_features(model: NerfModel, params: Params, x: torch.Tensor
                       ) -> torch.Tensor:
    """Per-point mask field feature [P, m_feat_dim]: the float32 positional
    feature through the ReLU `m_field_mlp`."""
    h = position_features(model, params, x)
    out, _ = apply_mlp(params["m_field_mlp"], h)
    return out


def apply_samvit_head(model: NerfModel, params: Params, f: torch.Tensor
                      ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """LeakyReLU skip MLP (biased) + LayerNorm(eps 1e-5)."""
    out, inter = apply_skip_mlp(params["samvit_mlp"], f,
                                model.cfg.samvit_skip_layers)
    return apply_layernorm(params["samvit_norm"], out, eps=1e-5), inter
