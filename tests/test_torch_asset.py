"""The port's config copy and weight carry-over from the JAX package."""

import dataclasses
import json
import os

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

torch.set_num_threads(1)
ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "serving_student")


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


@pytest.mark.parametrize("kw", [dict(field_type="hashgrid"),
                                dict(mlp_vm_rank=4),
                                dict(mlp_cp_rank=8, mlp_cp_levels=2),
                                dict(with_mask=True, mask_mlp_type="adaptive"),
                                dict(with_mask=True,
                                     mask_mlp_type="lightweight_mask"),
                                dict(sum_after_mlp=True)])
def test_other_families_raise(kw):
    with pytest.raises(NotImplementedError):
        fields.make_model(ModelConfig(**kw), RenderConfig())
