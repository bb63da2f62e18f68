"""Weights carried across from the JAX package.

The JAX checkpoints and serving assets are flat npz files whose keys are
'/'-joined tree paths under `params/` (sanerf_tpu/train/checkpoints.py:
flatten_tree), weights stored [in, out]. `params_from_jax` turns such a
dict into the port's parameter tree, for both field families (the MLP
family's factorized tables `cp_lines`, `vm_planes`, `vm_lines`,
`sigma_cp_lines`, `sigma_vm_planes`, `sigma_vm_lines`, a ladder's levels as
`cp_lines/<i>`, `vm_planes/<i>`, `vm_lines/<i>`; the hash-grid family's
tables `grid`, `prop/<i>/grid`, `s_grid`, `m_grid`); the tests use it to
give both frameworks identical weights.

Three ways to load the shipped asset:
  - `load_asset(path)`: the RGB field as shipped;
  - `load_asset(path, with_sam=True)`: the interactive frame's model, the
    asset plus a SAM feature head (`with_sam`, `sam_use_view_direction`)
    drawn from a seeded generator, as bench.py serves it (the asset ships
    no SAM head);
  - `load_mask_asset(path)`: the asset with the mask head of
    `<path>_mask.npz` overlaid (`with_mask`, `n_inst` of `<path>_mask.json`),
    the model the mask mIoU is scored on.
Each fails on any key of the files it reads that the model does not map.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sanerf_tpu_torch.config import ModelConfig, RenderConfig, config_from_dict
from sanerf_tpu_torch.device import resolve_device
from sanerf_tpu_torch.models.fields import (NerfModel, Params, init_params,
                                            make_model, mask_mlp_shapes)
from sanerf_tpu_torch.ops.cpgrid import level_resolutions

_LAYER = re.compile(
    r"^(grid_mlp|view_mlp|s_field_mlp|m_field_mlp|mask_mlp)/(\d+)/w$")
_BIASED = re.compile(r"^(samvit_mlp)/(\d+)/(w|b)$")
_PROP = re.compile(r"^prop/(\d+)/mlp/(\d+)/w$")
_PROP_GRID = re.compile(r"^prop/(\d+)/grid$")
_NORM = re.compile(r"^samvit_norm/(w|b)$")
#: table name -> its rank: [3, R, K] lines, [3, R, R, K] planes, hash
#: tables [rows, level_dim]
_TABLES = {"cp_lines": 3, "sigma_cp_lines": 3, "vm_planes": 4, "vm_lines": 3,
           "sigma_vm_planes": 4, "sigma_vm_lines": 3, "grid": 2, "s_grid": 2,
           "m_grid": 2}
#: the levels of a ladder, flattened by index (train/checkpoints.py)
_LEVEL = re.compile(r"^(cp_lines|vm_planes|vm_lines)/(\d+)$")


def _mlp_shapes(out, name, d_in, d_out, d_hidden, n_layers, skip=(),
                bias=False):
    for l in range(n_layers):
        i = d_in if l == 0 else (d_hidden + d_in if l in skip else d_hidden)
        o = d_out if l == n_layers - 1 else d_hidden
        out[f"{name}/{l}/w"] = (i, o)
        if bias:
            out[f"{name}/{l}/b"] = (o,)


def _table(spec) -> Tuple[int, int]:
    return (spec.total_params, spec.level_dim)


def _ladder(rank: int, res: int, levels: int):
    """[(path suffix, resolution)] of a grid's levels: one table at `res`,
    or the levels of a ladder (fields.init_params), '/<i>' each."""
    if rank <= 0:
        return []
    if levels == 1:
        return [("", res)]
    return [(f"/{i}", r) for i, r in enumerate(level_resolutions(res,
                                                                 levels))]


def expected_shapes(model: NerfModel) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the model, path -> shape."""
    c = model.cfg
    out: Dict[str, Tuple[int, ...]] = {}
    geo = 1 + c.geom_feat_dim
    if model.is_mlp_field:
        D = c.mlp_field_depth
        _mlp_shapes(out, "grid_mlp", model.grid_out_dim, geo,
                    c.mlp_field_width, D, (D // 2,))
        for i in range(len(c.prop_resolutions)):
            _mlp_shapes(out, f"prop/{i}/mlp", model.prop_in_dim, 1,
                        c.mlp_prop_width, c.mlp_prop_depth)
        for i, r in _ladder(c.mlp_cp_rank, c.mlp_cp_res, c.mlp_cp_levels):
            out["cp_lines" + i] = (3, r, c.mlp_cp_rank // c.mlp_cp_levels)
        for i, r in _ladder(c.mlp_vm_rank, c.mlp_vm_res, c.mlp_vm_levels):
            k = c.mlp_vm_rank // c.mlp_vm_levels
            out["vm_planes" + i] = (3, r, r, k)
            out["vm_lines" + i] = (3, r, k)
        if c.mlp_sigma_cp_rank > 0:
            out["sigma_cp_lines"] = (3, c.mlp_sigma_cp_res,
                                     c.mlp_sigma_cp_rank)
        if c.mlp_sigma_vm_rank > 0:
            r, k = c.mlp_sigma_vm_res, c.mlp_sigma_vm_rank
            out["sigma_vm_planes"] = (3, r, r, k)
            out["sigma_vm_lines"] = (3, r, k)
        if c.with_sam:
            _mlp_shapes(out, "s_field_mlp", model.grid_out_dim,
                        model.s_feat_dim, c.mlp_sam_width, c.mlp_sam_depth)
        if c.with_mask and c.mask_mlp_type != "adaptive":
            _mlp_shapes(out, "m_field_mlp", model.grid_out_dim,
                        model.m_feat_dim, c.mlp_mask_width, c.mlp_mask_depth)
    else:
        out["grid"] = _table(model.grid_spec)
        _mlp_shapes(out, "grid_mlp", model.grid_out_dim, geo,
                    c.grid_mlp_hidden, c.grid_mlp_layers)
        for i, spec in enumerate(model.prop_specs):
            out[f"prop/{i}/grid"] = _table(spec)
            _mlp_shapes(out, f"prop/{i}/mlp", spec.output_dim, 1,
                        c.prop_mlp_hidden, c.prop_mlp_layers)
        if c.with_sam:
            out["s_grid"] = _table(model.s_grid_spec)
        if c.with_mask and model.m_grid_spec is not None:
            out["m_grid"] = _table(model.m_grid_spec)
    _mlp_shapes(out, "view_mlp", model.color_dim, 3, c.view_mlp_hidden,
                c.view_mlp_layers)
    if c.with_sam:
        _mlp_shapes(out, "samvit_mlp", model.samvit_in_dim, c.sam_feat_dim,
                    c.samvit_mlp_hidden, c.samvit_mlp_layers,
                    c.samvit_skip_layers, bias=True)
        out["samvit_norm/w"] = out["samvit_norm/b"] = (c.sam_feat_dim,)
    if c.with_mask:
        for l, shape in enumerate(mask_mlp_shapes(model)):
            out[f"mask_mlp/{l}/w"] = shape
    return out


def params_from_jax(flat: Dict[str, np.ndarray],
                    model: Optional[NerfModel] = None,
                    device=None, prefix: str = "params/") -> Params:
    """Map the `params/...` entries of a JAX flat dict (an asset, or a
    checkpoint of train/checkpoints.py) onto the port's parameter tree
    (float32 tensors); `prefix="ema/"` takes a checkpoint's EMA weights
    instead. Keys outside the prefix (EMA shadows, the optimizer,
    metadata) are skipped. Raises ValueError on any key under the prefix
    that the port does not map; with `model`, also on a shape mismatch or
    a missing key."""
    dev = torch.device("cpu") if device is None else resolve_device(device)
    shapes = expected_shapes(model) if model is not None else None
    layers: Dict[Tuple[str, int], Dict[int, Dict[str, torch.Tensor]]] = {}
    prop_grids: Dict[int, torch.Tensor] = {}
    levels: Dict[str, Dict[int, torch.Tensor]] = {}
    params: Params = {}
    unmapped = []
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        path = key[len(prefix):]
        if shapes is not None and shapes.get(path) != tuple(v.shape):
            unmapped.append(key)
            continue
        t = torch.tensor(np.asarray(v, np.float32), device=dev)
        m, mb, mp = _LAYER.match(path), _BIASED.match(path), _PROP.match(path)
        mn, mg = _NORM.match(path), _PROP_GRID.match(path)
        ml = _LEVEL.match(path)
        if m:
            layers.setdefault((m.group(1), -1), {}).setdefault(
                int(m.group(2)), {})["w"] = t
        elif mb:
            layers.setdefault((mb.group(1), -1), {}).setdefault(
                int(mb.group(2)), {})[mb.group(3)] = t
        elif mp:
            layers.setdefault(("prop", int(mp.group(1))), {}).setdefault(
                int(mp.group(2)), {})["w"] = t
        elif mn:
            params.setdefault("samvit_norm", {})[mn.group(1)] = t
        elif mg:
            prop_grids[int(mg.group(1))] = t
        elif path in _TABLES and t.dim() == _TABLES[path]:
            params[path] = t
        elif ml and t.dim() == _TABLES[ml.group(1)]:
            levels.setdefault(ml.group(1), {})[int(ml.group(2))] = t
        else:
            unmapped.append(key)
    if unmapped:
        raise ValueError(f"params failed to map onto the port's model: "
                         f"{sorted(unmapped)}")
    if shapes is not None:
        missing = sorted(set(shapes) - {k[len(prefix):] for k in flat
                                        if k.startswith(prefix)})
        if missing:
            raise ValueError(f"params missing from the checkpoint: {missing}")
    for name, by_idx in levels.items():
        if name in params or sorted(by_idx) != list(range(len(by_idx))):
            raise ValueError(f"{name}: levels {sorted(by_idx)} are not "
                             f"contiguous, or a level beside a table")
        params[name] = [by_idx[i] for i in range(len(by_idx))]
    n_props = 1 + max([i for (n, i) in layers if n == "prop"]
                      + list(prop_grids), default=-1)
    for (name, i), by_idx in layers.items():
        if sorted(by_idx) != list(range(len(by_idx))):
            raise ValueError(f"{name}: layer indices {sorted(by_idx)} "
                             f"are not contiguous")
        seq = [by_idx[l] for l in range(len(by_idx))]
        if any("w" not in p for p in seq):
            raise ValueError(f"{name}: a layer has a bias and no weight")
        if name == "prop":
            params.setdefault("prop", [None] * n_props)[i] = {"mlp": seq}
        else:
            params[name] = seq
    for i, t in prop_grids.items():
        if params.get("prop", [None] * n_props)[i] is None:
            raise ValueError(f"prop/{i}/grid has no prop/{i}/mlp")
        params["prop"][i]["grid"] = t
    if any(p is None for p in params.get("prop", [])):
        raise ValueError("proposal net indices are not contiguous")
    return params


def _read(path: str):
    with open(path + ".json") as f:
        meta = json.load(f)
    with np.load(path + ".npz") as z:
        flat = {k: z[k] for k in z.files}
    return meta, flat


def load_asset(path: str, device=None, with_sam: bool = False,
               seed: int = 0) -> Tuple[ModelConfig, RenderConfig, Params]:
    """Read `<path>.json` (model_config, render_config) and `<path>.npz`
    (flat params) -> (model config, render config, params on `device`).

    `with_sam` serves the interactive frame: the model config gains
    `with_sam` and `sam_use_view_direction`, the SAM feature head is drawn
    from `torch.Generator().manual_seed(seed)` and every asset weight
    overlays the result (bench.py:60-67)."""
    dev = resolve_device(device)
    meta, flat = _read(path)
    mc = config_from_dict(ModelConfig, meta["model_config"])
    rc = config_from_dict(RenderConfig, meta["render_config"])
    params = params_from_jax(flat, make_model(mc, rc), dev)
    if with_sam:
        mc = dataclasses.replace(mc, with_sam=True,
                                 sam_use_view_direction=True)
        head = init_params(make_model(mc, rc),
                           torch.Generator().manual_seed(seed), dev)
        params = {**head, **params}
    return mc, rc, params


def load_mask_asset(path: str, device=None
                    ) -> Tuple[ModelConfig, RenderConfig, Params]:
    """The asset at `path` with the mask head of `<path>_mask.{json,npz}`
    overlaid (bench.py:194-211): `with_sam` off, `with_mask` on, the mask
    head type and `n_inst` from the mask JSON. Unlike bench.py it fails on
    any key of either npz that the mask model does not map, and on any key
    of the model that neither file holds."""
    dev = resolve_device(device)
    meta, flat = _read(path)
    mmeta, mflat = _read(path + "_mask")
    mc = dataclasses.replace(
        config_from_dict(ModelConfig, meta["model_config"]), with_sam=False,
        with_mask=True, mask_mlp_type=mmeta["mask_mlp_type"],
        n_inst=mmeta["n_inst"])
    rc = config_from_dict(RenderConfig, meta["render_config"])
    overlap = sorted(set(flat) & set(mflat) - {"__meta__"})
    if overlap:
        raise ValueError(f"the mask npz repeats asset keys: {overlap}")
    return mc, rc, params_from_jax({**flat, **mflat}, make_model(mc, rc), dev)
