"""Parity: the port's reference-checkpoint conversion
(sanerf_tpu_torch/models/convert_nerf.py) against the JAX package's, on
the synthetic reference state dicts of tests/test_convert_nerf.py: every
converted tensor is equal, and the converted weights render what the JAX
conversion renders (2e-3)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_tpu.models import fields as jfields
from sanerf_tpu.models import renderer as jrenderer
from sanerf_tpu.models.convert_nerf import convert_nerf_state_dict as jconvert
from sanerf_tpu.train.checkpoints import flatten_tree
from sanerf_tpu_torch.config import ModelConfig, RenderConfig, config_from_dict
from sanerf_tpu_torch.models import fields, renderer
from sanerf_tpu_torch.models.convert_nerf import (ConversionError,
                                                  convert_nerf_checkpoint,
                                                  convert_nerf_state_dict)

from tests.test_convert_nerf import MC, RC, _torch_sd

torch.set_num_threads(1)


def _models(mc, rc=RC):
    return (jfields.make_model(mc, rc),
            fields.make_model(
                config_from_dict(ModelConfig, dataclasses.asdict(mc)),
                config_from_dict(RenderConfig, dataclasses.asdict(rc))))


def _flat_port(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        key = f"{prefix}{k}"
        out.update(_flat_port(v, key + "/") if isinstance(v, (dict, list))
                   else {key: v})
    return out


def _as_torch(sd):
    """The reference checkpoints hold torch tensors ([out, in] linears)."""
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _assert_same(tp, jp):
    jflat = flatten_tree(jp, "")
    tflat = _flat_port(tp)
    assert set(tflat) == set(jflat)
    for k, v in jflat.items():
        assert tflat[k].dtype == torch.float32, k
        np.testing.assert_array_equal(tflat[k].numpy(), np.asarray(v),
                                      err_msg=k)


def test_convert_rgb_checkpoint_matches_jax(rng):
    jm, tm = _models(MC)
    sd = _torch_sd(jm, rng)
    jp = jconvert(dict(sd), jm)
    tp = convert_nerf_state_dict(_as_torch(sd), tm, device="cpu")
    _assert_same(tp, jp)
    o = rng.normal(0, 0.5, (16, 3)).astype(np.float32)
    d = rng.normal(0, 1, (16, 3)).astype(np.float32)
    ref = jrenderer.run_rays(jm, jp, jnp.asarray(o), jnp.asarray(d))
    got = renderer.run_rays(tm, tp, torch.from_numpy(o), torch.from_numpy(d))
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=2e-3, atol=2e-3, err_msg=k)


@pytest.mark.parametrize("mask_type", ["default", "lightweight_mask"])
def test_convert_full_checkpoint_matches_jax(rng, mask_type):
    mc = dataclasses.replace(
        MC, with_sam=True, sam_use_view_direction=True, s_grid_num_levels=4,
        s_grid_log2_hashmap=10, s_grid_desired_resolution=64, with_mask=True,
        mask_mlp_type=mask_type, n_inst=3)
    jm, tm = _models(mc)
    sd = _torch_sd(jm, rng, with_sam=True, with_mask=True,
                   mask_type=mask_type)
    _assert_same(convert_nerf_state_dict(_as_torch(sd), tm, device="cpu"),
                 jconvert(dict(sd), jm))


def test_convert_wrapped_trainer_checkpoint_and_pth(rng, tmp_path):
    """A Trainer checkpoint nests the state dict under 'model'
    (utils.py:2041-2060), in memory and in a .pth."""
    jm, tm = _models(MC)
    sd = _torch_sd(jm, rng)
    jp = jconvert(dict(sd), jm)
    wrapped = {"model": _as_torch(sd), "epoch": 7}
    _assert_same(convert_nerf_state_dict(wrapped, tm, device="cpu"), jp)
    path = tmp_path / "ckpt.pth"
    torch.save(wrapped, path)
    _assert_same(convert_nerf_checkpoint(str(path), tm, device="cpu"), jp)


def test_convert_errors(rng):
    jm, tm = _models(MC)

    def sd():
        return _as_torch(_torch_sd(jm, rng))

    bad = sd()
    del bad["grid_mlp.net.1.weight"]
    with pytest.raises(ConversionError, match="missing key"):
        convert_nerf_state_dict(bad, tm, device="cpu")
    bad = sd()
    bad["grid.embeddings"] = bad["grid.embeddings"][:-8]
    with pytest.raises(ConversionError, match="table shape"):
        convert_nerf_state_dict(bad, tm, device="cpu")
    bad = sd()
    bad["mystery.weight"] = torch.zeros(3, 3)
    with pytest.raises(ConversionError, match="unconsumed"):
        convert_nerf_state_dict(bad, tm, device="cpu")
    _, mlp = _models(dataclasses.replace(MC, field_type="mlp"))
    with pytest.raises(ConversionError, match="hashgrid"):
        convert_nerf_state_dict(sd(), mlp, device="cpu")
    # the adaptive head converts (tests/test_torch_field_options.py); a
    # checkpoint without its ladder does not
    adaptive = fields.make_model(
        dataclasses.replace(tm.cfg, with_mask=True,
                            mask_mlp_type="adaptive"), tm.render_cfg)
    with pytest.raises(ConversionError, match="mask_mlp"):
        convert_nerf_state_dict(sd(), adaptive, device="cpu")
