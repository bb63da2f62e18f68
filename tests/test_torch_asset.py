"""The port's config copy and weight carry-over from the JAX package."""

import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from sanerf_tpu.config import ModelConfig as JModelConfig
from sanerf_tpu.config import RenderConfig as JRenderConfig
from sanerf_tpu.models import fields as jfields
from sanerf_tpu.train.checkpoints import flatten_tree
from sanerf_tpu_torch.config import ModelConfig, RenderConfig, config_from_dict
from sanerf_tpu_torch.models import fields
from sanerf_tpu_torch.models.asset import (expected_shapes, load_asset,
                                           params_from_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "port_tools"))
import grid_params  # noqa: E402  (the served grid configurations)

torch.set_num_threads(1)
ASSET = os.path.join(ROOT, "assets", "serving_student")


def _meta():
    with open(ASSET + ".json") as f:
        return json.load(f)


@pytest.mark.parametrize("jcls,tcls", [(JModelConfig, ModelConfig),
                                       (JRenderConfig, RenderConfig)])
def test_configs_match_the_jax_fields(jcls, tcls):
    assert ([(f.name, f.default) for f in dataclasses.fields(jcls)]
            == [(f.name, f.default) for f in dataclasses.fields(tcls)])


def test_asset_configs_round_trip():
    meta = _meta()
    mc = config_from_dict(ModelConfig, meta["model_config"])
    rc = config_from_dict(RenderConfig, meta["render_config"])
    as_json = lambda c: json.loads(json.dumps(dataclasses.asdict(c)))  # noqa: E731
    assert as_json(mc) == meta["model_config"]
    assert as_json(rc) == meta["render_config"]


def test_load_asset_maps_every_key():
    mc, rc, params = load_asset(ASSET, device="cpu")
    flat = dict(np.load(ASSET + ".npz"))
    keys = {k[len("params/"):] for k in flat if k.startswith("params/")}
    assert keys == set(expected_shapes(fields.make_model(mc, rc)))
    assert len(params["grid_mlp"]) == 3 and len(params["prop"]) == 2
    np.testing.assert_array_equal(params["grid_mlp"][1]["w"].numpy(),
                                  flat["params/grid_mlp/1/w"])
    np.testing.assert_array_equal(params["prop"][1]["mlp"][0]["w"].numpy(),
                                  flat["params/prop/1/mlp/0/w"])
    assert params["sigma_cp_lines"].shape == (3, 128, 32)


def test_params_from_jax_matches_a_jax_tree():
    mc = JModelConfig(field_type="mlp", mlp_field_width=32, mlp_field_depth=4,
                      mlp_prop_width=16, mlp_prop_depth=2, mlp_cp_rank=8,
                      mlp_cp_res=16, mlp_sigma_cp_rank=4, mlp_sigma_cp_res=16)
    rc = JRenderConfig(num_steps=(16, 8), bound=4.0)
    jp = jfields.init_params(jfields.make_model(mc, rc), jax.random.key(0))
    flat = flatten_tree(jp, "params/")
    flat["ema/grid_mlp/0/w"] = flat["params/grid_mlp/0/w"]  # not params/
    model = fields.make_model(
        config_from_dict(ModelConfig, dataclasses.asdict(mc)),
        config_from_dict(RenderConfig, dataclasses.asdict(rc)))
    tp = params_from_jax(flat, model)
    assert set(expected_shapes(model)) == {k[7:] for k in flat
                                           if k.startswith("params/")}
    for l, p in enumerate(jp["view_mlp"]):
        np.testing.assert_array_equal(tp["view_mlp"][l]["w"].numpy(),
                                      np.asarray(p["w"]))


@pytest.mark.parametrize("bad", ["params/vm_planes",
                                 "params/grid_mlp/0/b",
                                 "params/cp_lines_extra",
                                 "params/samvit_mlp/0/q"])
def test_params_from_jax_raises_on_unmapped_key(bad):
    flat = dict(np.load(ASSET + ".npz"))
    flat[bad] = np.zeros((2, 2), np.float32)
    with pytest.raises(ValueError, match="failed to map"):
        params_from_jax(flat)


def test_params_from_jax_raises_on_shape_or_missing_key():
    meta = _meta()
    model = fields.make_model(
        config_from_dict(ModelConfig, meta["model_config"]),
        config_from_dict(RenderConfig, meta["render_config"]))
    flat = dict(np.load(ASSET + ".npz"))
    bad = dict(flat)
    bad["params/view_mlp/2/w"] = np.zeros((32, 4), np.float32)
    with pytest.raises(ValueError, match="failed to map"):
        params_from_jax(bad, model)
    missing = {k: v for k, v in flat.items() if k != "params/cp_lines"}
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(missing, model)


@pytest.mark.parametrize("kw", [dict(field_type="hashgrid",
                                     with_mask=True, mask_mlp_type="adaptive"),
                                dict(mlp_vm_rank=4, with_mask=True,
                                     mask_mlp_type="adaptive"),
                                dict(mlp_cp_rank=8, mlp_cp_levels=2,
                                     sum_after_mlp=True),
                                dict(with_mask=True, mask_mlp_type="adaptive"),
                                dict(field_type="hashgrid",
                                     sum_after_mlp=True),
                                dict(sum_after_mlp=True)])
def test_other_families_raise(kw):
    """Heads the port does not have raise, with or without factorized
    grids (which it serves)."""
    with pytest.raises(NotImplementedError):
        fields.make_model(ModelConfig(**kw), RenderConfig())


@pytest.mark.parametrize("name", sorted(grid_params.CONFIGS))
def test_grid_configs_build_as_in_jax(name):
    """make_model takes VM grids, ladders and sigma-VM; the encoding width,
    the bf16 table bytes and every parameter's path and shape are the JAX
    package's (the served configurations of port_tools/grid_params.py)."""
    kw = grid_params.CONFIGS[name]
    jm = jfields.make_model(JModelConfig(**kw), JRenderConfig())
    tm = fields.make_model(ModelConfig(**kw), RenderConfig())
    assert tm.grid_out_dim == jm.grid_out_dim
    assert tm.grid_table_bytes == jm.grid_table_bytes
    assert tm.has_sigma_grid == jm.has_sigma_grid
    tmpl = jax.eval_shape(lambda k: jfields.init_params(jm, k),
                          jax.random.key(0))
    shapes = {k: tuple(v.shape) for k, v in flatten_tree(
        jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                     tmpl), "").items()}
    assert expected_shapes(tm) == shapes


@pytest.mark.parametrize("kw", [
    dict(mlp_cp_rank=8, mlp_cp_res=32, mlp_cp_levels=2),
    dict(mlp_cp_rank=6, mlp_cp_res=16, mlp_vm_rank=4, mlp_vm_res=16,
         mlp_vm_levels=2, mlp_sigma_cp_rank=4, mlp_sigma_cp_res=16,
         mlp_sigma_vm_rank=3, mlp_sigma_vm_res=8)])
def test_params_from_jax_carries_grid_ladders(kw):
    """A JAX tree with ladders (list leaves `cp_lines/<i>`, `vm_planes/<i>`,
    `vm_lines/<i>`) and sigma-VM tables maps value for value; a missing or
    orphan level raises."""
    mc = JModelConfig(field_type="mlp", mlp_field_width=32, mlp_field_depth=3,
                      mlp_prop_width=16, mlp_prop_depth=2, **kw)
    rc = JRenderConfig(num_steps=(16, 8), bound=4.0)
    jp = jfields.init_params(jfields.make_model(mc, rc), jax.random.key(0))
    flat = flatten_tree(jp, "params/")
    model = fields.make_model(
        config_from_dict(ModelConfig, dataclasses.asdict(mc)),
        config_from_dict(RenderConfig, dataclasses.asdict(rc)))
    assert set(expected_shapes(model)) == {k[7:] for k in flat}
    tp = params_from_jax(flat, model)
    for key in ("cp_lines", "vm_planes", "vm_lines", "sigma_vm_planes",
                "sigma_vm_lines"):
        if key not in jp:
            continue
        ref = jp[key] if isinstance(jp[key], list) else [jp[key]]
        got = tp[key] if isinstance(jp[key], list) else [tp[key]]
        assert isinstance(tp[key], list) == isinstance(jp[key], list)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    lost = "params/" + ("cp_lines/0" if isinstance(jp["cp_lines"], list)
                        else "vm_planes/0")
    missing = {k: v for k, v in flat.items() if k != lost}
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(missing, model)
    with pytest.raises(ValueError, match="not contiguous"):
        params_from_jax(missing)


def _hashgrid_pair(**kw):
    mc = JModelConfig(field_type="hashgrid", grid_num_levels=4,
                      grid_log2_hashmap=10, grid_desired_resolution=64,
                      prop_num_levels=3, prop_log2_hashmap=8,
                      prop_resolutions=(32, 64), s_grid_num_levels=4,
                      s_grid_log2_hashmap=10, s_grid_desired_resolution=64,
                      with_sam=True, with_mask=True, n_inst=3, **kw)
    rc = JRenderConfig(num_steps=(16, 8, 4), bound=4.0)
    jp = jfields.init_params(jfields.make_model(mc, rc), jax.random.key(0))
    model = fields.make_model(
        config_from_dict(ModelConfig, dataclasses.asdict(mc)),
        config_from_dict(RenderConfig, dataclasses.asdict(rc)))
    return model, jp, flatten_tree(jp, "params/")


@pytest.mark.parametrize("mask_type", ["default", "lightweight_mask"])
def test_params_from_jax_round_trips_a_hashgrid_tree(mask_type):
    """Every key of a JAX hash-grid flat dict maps (tables `grid`,
    `prop/<i>/grid`, `s_grid`, `m_grid` and the MLPs), value for value."""
    model, jp, flat = _hashgrid_pair(mask_mlp_type=mask_type)
    assert set(expected_shapes(model)) == {k[7:] for k in flat}
    assert all(expected_shapes(model)[k[7:]] == tuple(v.shape)
               for k, v in flat.items())
    tp = params_from_jax(flat, model)
    for key in ("grid", "s_grid", "m_grid"):
        np.testing.assert_array_equal(tp[key].numpy(), np.asarray(jp[key]))
    for i, p in enumerate(jp["prop"]):
        np.testing.assert_array_equal(tp["prop"][i]["grid"].numpy(),
                                      np.asarray(p["grid"]))
        assert len(tp["prop"][i]["mlp"]) == len(p["mlp"])
    np.testing.assert_array_equal(tp["mask_mlp"][0]["w"].numpy(),
                                  np.asarray(jp["mask_mlp"][0]["w"]))
    assert len(tp["grid_mlp"]) == 3 and "m_field_mlp" not in tp


def test_params_from_jax_hashgrid_raises_on_bad_keys():
    model, _, flat = _hashgrid_pair()
    bad = dict(flat)
    bad["params/s_grid"] = bad["params/s_grid"][:-8]
    with pytest.raises(ValueError, match="failed to map"):
        params_from_jax(bad, model)
    extra = dict(flat)
    extra["params/prop/0/table"] = np.zeros((8, 2), np.float32)
    with pytest.raises(ValueError, match="failed to map"):
        params_from_jax(extra, model)
    missing = {k: v for k, v in flat.items() if k != "params/prop/1/grid"}
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(missing, model)
    orphan = {k: v for k, v in flat.items()
              if not k.startswith("params/prop/1/mlp")}
    with pytest.raises(ValueError, match="prop/1/grid"):
        params_from_jax(orphan)
