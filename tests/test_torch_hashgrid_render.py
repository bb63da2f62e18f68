"""Parity: the hash-grid family through the port's renderer and interactive
frame (sanerf_tpu_torch/models/renderer.py, apps/frame_pipeline.py,
apps/interactive.py) against the JAX package, same weights carried across
by params_from_jax; and the `lightweight_mask` head of both families.

Tolerance 2e-3 for renders (tests/test_torch_renderer.py's bound), with
JAX's own jitter draws fed to the port for the perturbed case. The
hash-grid family runs the plain path; its gathers take the plain version
of their kernel on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_tpu.apps import frame_pipeline as jfp
from sanerf_tpu.config import ModelConfig as JModelConfig
from sanerf_tpu.config import RenderConfig as JRenderConfig
from sanerf_tpu.models import fields as jfields
from sanerf_tpu.models import renderer as jrenderer
from sanerf_tpu.models.sam import predictor as jpred
from sanerf_tpu.train.checkpoints import flatten_tree
from sanerf_tpu_torch.apps import frame_pipeline as fp
from sanerf_tpu_torch.apps.interactive import InteractiveSession
from sanerf_tpu_torch.config import ModelConfig, RenderConfig, config_from_dict
from sanerf_tpu_torch.models import fields, renderer
from sanerf_tpu_torch.models.asset import params_from_jax
from sanerf_tpu_torch.models.sam import predictor
from sanerf_tpu_torch.ops import hashgrid

from tests.test_sam import TINY_SAM
from tests.test_torch_hashgrid import tiny_hashgrid
from tests.test_torch_sam import port_cfg

torch.set_num_threads(1)
TOL = dict(rtol=2e-3, atol=2e-3)
POSE = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 2.0], [0, 0, 0, 1]],
                np.float32)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    d = (-o + 0.3 * rng.normal(0, 1.0, (n, 3))).astype(np.float32)
    return o, d


def _compare(got, ref, keys):
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **TOL)


def test_hashgrid_takes_the_plain_path():
    _, tm, _, tp = tiny_hashgrid()
    assert tm.render_cfg.use_fused_mlp and not renderer.uses_kernels(tm)
    pipe = fp.FramePipeline(tm, tp, None, None, 8, 8, device="cpu")
    assert pipe._kernel_nets() is None


@pytest.mark.parametrize("perturb", [False, True])
def test_run_rays_with_feats_matches_jax(perturb):
    jm, tm, jp, tp = tiny_hashgrid(None)
    o, d = _rays(24, seed=0)
    key = jax.random.key(3) if perturb else None
    ref = jrenderer.run_rays(jm, jp, jnp.asarray(o), jnp.asarray(d), key,
                             perturb=perturb, return_feats=True)
    jitter = None
    if perturb:
        keys = jax.random.split(key, len(jm.render_cfg.num_steps))
        jitter = [torch.from_numpy(np.array(jax.random.uniform(k, (24, T + 1))))
                  for k, T in zip(keys, jm.render_cfg.num_steps)]
    got = renderer.run_rays(tm, tp, torch.from_numpy(o), torch.from_numpy(d),
                            jitter, return_feats=True)
    assert got["samvit"].shape == (24, 32)
    _compare(got, ref, ("image", "depth", "weights_sum", "samvit"))
    assert float(got["depth"].std()) > 1e-3


@pytest.mark.parametrize("mask_type", ["default", "lightweight_mask"])
def test_run_rays_mask_matches_jax(mask_type):
    jm, tm, jp, tp = tiny_hashgrid(mask_type)
    o, d = _rays(16, seed=1)
    ref = jrenderer.run_rays(jm, jp, jnp.asarray(o), jnp.asarray(d),
                             return_mask=True)
    got = renderer.run_rays(tm, tp, torch.from_numpy(o), torch.from_numpy(d),
                            return_mask=True)
    assert got["instance_mask_logits"].shape == (16, 3)
    _compare(got, ref, ("image", "depth", "weights_sum",
                        "instance_mask_logits"))


@pytest.mark.parametrize("fused", [True, False])
def test_lightweight_mask_mlp_family_matches_jax(fused):
    """The lightweight head on the MLP family: [m_field_mlp features,
    colors] through the ReLU mask_mlp, on the fast and the plain path."""
    jmc = JModelConfig(field_type="mlp", mlp_field_width=32, mlp_field_depth=4,
                       mlp_prop_width=16, mlp_prop_depth=2, mlp_enc_freqs=4,
                       mlp_prop_enc_freqs=3, mlp_mask_width=32,
                       mlp_mask_depth=2, mlp_mask_feat_dim=16, n_inst=3,
                       with_mask=True, mask_mlp_type="lightweight_mask")
    jrc = JRenderConfig(num_steps=(16, 8), bound=4.0, contract=True,
                        use_fused_mlp=fused)
    jm = jfields.make_model(jmc, jrc)
    tm = fields.make_model(
        config_from_dict(ModelConfig, dataclasses.asdict(jmc)),
        config_from_dict(RenderConfig, dataclasses.asdict(jrc)))
    jp = jfields.init_params(jm, jax.random.key(0))
    tp = params_from_jax(flatten_tree(jp, "params/"), tm)
    assert tp["mask_mlp"][0]["w"].shape == (16 + tm.color_dim, 64)
    assert renderer.uses_kernels(tm) == fused
    o, d = _rays(16, seed=2)
    ref = jrenderer.run_rays(jm, jp, jnp.asarray(o), jnp.asarray(d),
                             return_mask=True)
    got = renderer.run_rays(tm, tp, torch.from_numpy(o), torch.from_numpy(d),
                            return_mask=True)
    _compare(got, ref, ("image", "depth", "weights_sum",
                        "instance_mask_logits"))


@pytest.fixture(scope="module")
def frame_setup():
    jm, tm, jp, tp = tiny_hashgrid(None, num_steps=(8, 4), table_scale=0.5,
                                   sam_use_view_direction=True,
                                   prop_resolutions=(32,))
    jsp = jpred.init_params(TINY_SAM, jax.random.key(1))
    tsp = predictor.params_from_jax(flatten_tree(jsp, ""), port_cfg(TINY_SAM))
    return jm, jp, jsp, tm, tp, tsp


def test_frame_program_matches_jax(frame_setup):
    """The whole interactive frame of a hash-grid model: depth and the
    accumulated image at 2e-3, the reprojected points, the mask on all but
    2 % of the pixels (tests/test_torch_frame_pipeline.py's bounds)."""
    jm, jp, jsp, tm, tp, tsp = frame_setup
    H = W = 16
    K = 2
    packed = np.zeros((28 + 4 * K,), np.float32)
    packed[:16] = POSE.reshape(-1)
    packed[16:20] = [0.5 * H, 0.5 * H, W / 2, H / 2]
    packed[20:26] = [0.05, -0.05, 0.0, 0.3, 0.2, -0.4]
    packed[20 + 3 * K:20 + 4 * K] = 1.0
    packed[26 + 4 * K] = 1.0
    kw = dict(hw=(H, W), feat_hw=(8, 8), input_hw=(64, 64), mode="image",
              perturb=False, with_overlay=True, fetch_format="rgb8")
    acc = np.zeros((H, W, 3), np.float32)
    ref = jfp._frame_program(jm, jp, TINY_SAM, jsp, jnp.asarray(packed),
                             jnp.asarray(acc), None, **kw)
    pix, depth, mask, acc_new, pts2d, valid = fp._frame_program(
        tm, tp, port_cfg(TINY_SAM), tsp, torch.from_numpy(packed),
        torch.from_numpy(acc), None, **kw)
    np.testing.assert_allclose(depth.numpy(), np.asarray(ref[1]), **TOL)
    np.testing.assert_allclose(acc_new.numpy(), np.asarray(ref[3]), **TOL)
    np.testing.assert_allclose(pts2d.numpy(), np.asarray(ref[4]), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref[5]))
    assert (mask.numpy() != np.asarray(ref[2])).mean() <= 0.02


def test_session_step_gathers_once_per_level(frame_setup, monkeypatch):
    """InteractiveSession.step on a hash-grid model: one gather per grid
    level per render. RGB render: 5 + 4 levels (proposal, field); feature
    render: the same plus the 4 s_grid levels."""
    _, _, _, tm, tp, tsp = frame_setup
    calls = []
    real = hashgrid.gather_rows

    def spy(table, idx, block_rows=1):
        calls.append(tuple(idx.shape))
        return real(table, idx, block_rows)

    monkeypatch.setattr(hashgrid, "gather_rows", spy)
    s = InteractiveSession(None, tm, tp, predictor.SamPredictor(
        port_cfg(TINY_SAM), tsp, device="cpu"), H=32, W=32, device="cpu")
    s.step(POSE)
    s.points_3d.append(np.zeros(3, np.float32))
    calls.clear()
    r = s.step(POSE, pipelined=False)
    per_render = 3 + 4  # prop_num_levels + grid_num_levels
    assert len(calls) == per_render + per_render + 4
    assert r.rgb_u8.shape == (32, 32, 3)
    assert bool(torch.isfinite(r.depth).all())
    assert r.mask is not None and r.mask.shape == (32, 32)
