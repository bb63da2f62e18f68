"""Reference `NeRFNetwork` checkpoint -> the port's hash-grid parameters
(JAX: sanerf_tpu/models/convert_nerf.py:62-142).

The reference's state dict (nerf/network.py:102-219: `grid` / `s_grid` /
`m_grid` GridEncoders, `grid_mlp` / `view_mlp` MLPs, `samvit_mlp`
Sequential(SkipConnMLP, LayerNorm), `mask_mlp`, `prop_encoders` /
`prop_mlp` pairs) maps onto the tree of models/fields.py for a model built
with `field_type="hashgrid"`. The hash tables have the same layout
(ops/hashgrid.build_spec sizes and offsets the levels as
gridencoder/grid.py:103-137 does), so `*.embeddings` copy over unchanged;
nn.Linear weights are [out, in] and transpose to [in, out]. Every mask
head maps: the default and `lightweight_mask` ones with their `m_grid`,
the `adaptive` ladder as the `mask_mlp.<i>` linears it holds.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from sanerf_tpu_torch.device import resolve_device
from sanerf_tpu_torch.models.fields import NerfModel, Params


class ConversionError(ValueError):
    pass


def _w(sd: Dict, key: str, dev) -> torch.Tensor:
    if key not in sd:
        raise ConversionError(f"missing key in state_dict: {key}")
    v = sd.pop(key)
    v = v.detach().cpu() if torch.is_tensor(v) else torch.from_numpy(
        np.asarray(v))
    return v.to(dtype=torch.float32, device=dev)


def _mlp(sd: Dict, prefix: str, n_layers: int, bias: bool, dev
         ) -> List[Params]:
    layers = []
    for l in range(n_layers):
        p = {"w": _w(sd, f"{prefix}.net.{l}.weight", dev).T.contiguous()}
        if bias:
            p["b"] = _w(sd, f"{prefix}.net.{l}.bias", dev)
        layers.append(p)
    return layers


def _grid(sd: Dict, key: str, spec, dev) -> torch.Tensor:
    emb = _w(sd, key, dev)
    expect = (spec.total_params, spec.level_dim)
    if tuple(emb.shape) != expect:
        raise ConversionError(
            f"{key}: table shape {tuple(emb.shape)} != spec {expect} - grid "
            "config mismatch (num_levels/level_dim/log2_hashmap/"
            "desired_resolution)")
    return emb.contiguous()


def convert_nerf_state_dict(sd: Dict, model: NerfModel, device=None
                            ) -> Params:
    """state dict (torch tensors or numpy arrays), or a reference Trainer
    checkpoint dict with a 'model' entry (utils.py:2041-2060) -> float32
    params on `device` (the CUDA card unless the caller asks for the
    CPU). Raises ConversionError on a missing key, a table of the wrong
    shape, an unconsumed key or the MLP family."""
    dev = resolve_device(device)
    if "model" in sd and not any("." in k for k in sd):
        sd = sd["model"]
    sd = dict(sd)  # consumed key by key
    c = model.cfg
    if model.is_mlp_field:
        raise ConversionError(
            "reference checkpoints hold hash tables; build the model with "
            "field_type='hashgrid' to convert")
    params: Params = {
        "grid": _grid(sd, "grid.embeddings", model.grid_spec, dev),
        "grid_mlp": _mlp(sd, "grid_mlp", c.grid_mlp_layers, False, dev),
        "view_mlp": _mlp(sd, "view_mlp", c.view_mlp_layers, False, dev),
        "prop": [{"grid": _grid(sd, f"prop_encoders.{i}.embeddings", spec,
                                dev),
                  "mlp": _mlp(sd, f"prop_mlp.{i}", c.prop_mlp_layers, False,
                              dev)}
                 for i, spec in enumerate(model.prop_specs)],
    }
    if c.with_sam:
        params["s_grid"] = _grid(sd, "s_grid.embeddings", model.s_grid_spec,
                                 dev)
        params["samvit_mlp"] = _mlp(sd, "samvit_mlp.0", c.samvit_mlp_layers,
                                    True, dev)
        params["samvit_norm"] = {"w": _w(sd, "samvit_mlp.1.weight", dev),
                                 "b": _w(sd, "samvit_mlp.1.bias", dev)}
    if c.with_mask and c.mask_mlp_type == "adaptive":
        # the adaptive ladder: bias-free linears mask_mlp.<i> (JAX
        # convert_nerf.py:115-122)
        layers = []
        while f"mask_mlp.{len(layers)}.weight" in sd:
            layers.append({"w": _w(sd, f"mask_mlp.{len(layers)}.weight",
                                   dev).T.contiguous()})
        if not layers:
            raise ConversionError("no mask_mlp.{i}.weight keys found")
        params["mask_mlp"] = layers
    elif c.with_mask:
        params["m_grid"] = _grid(sd, "m_grid.embeddings", model.m_grid_spec,
                                 dev)
        prefix = "mask_mlp.0" if c.mask_mlp_type == "default" else "mask_mlp"
        params["mask_mlp"] = _mlp(sd, prefix, 3, False, dev)
    leftovers = [k for k in sd
                 if not k.endswith(".offsets")  # GridEncoder buffers
                 and "aabb" not in k and "mean_count" not in k]
    if leftovers:
        raise ConversionError(
            f"unconsumed state_dict keys: {sorted(leftovers)[:8]}")
    return params


def convert_nerf_checkpoint(path: str, model: NerfModel, device=None
                            ) -> Params:
    """Load a reference `.pth` (a torch.save'd Trainer checkpoint or a bare
    state dict) and convert it."""
    return convert_nerf_state_dict(
        torch.load(path, map_location="cpu", weights_only=True), model, device)
