"""Parity: the port's SAM feature head and default mask head
(sanerf_tpu_torch/models/fields.py, renderer.py `return_feats` /
`return_mask`) against the JAX package, same weights carried across by
params_from_jax.

Tolerances: 1e-5 for single float32 modules; 2e-3 for whole renders (the
JAX renderer suite's fast-vs-XLA bound, tests/test_ray_kernels.py:74-148);
on the CPU the port's fast path runs its kernels' plain versions and the
JAX fast path its Pallas kernels in interpret mode."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_tpu.config import ModelConfig as JModelConfig
from sanerf_tpu.config import RenderConfig as JRenderConfig
from sanerf_tpu.models import fields as jfields
from sanerf_tpu.models import renderer as jrenderer
from sanerf_tpu.train.checkpoints import flatten_tree
from sanerf_tpu.train.metrics import MeanIoUMeter as JMeanIoUMeter
from sanerf_tpu_torch.config import ModelConfig, RenderConfig, config_from_dict
from sanerf_tpu_torch.models import fields, renderer
from sanerf_tpu_torch.models.asset import (expected_shapes, load_asset,
                                           load_mask_asset, params_from_jax)
from sanerf_tpu_torch.train.metrics import MeanIoUMeter

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "assets", "serving_student")
MOD_TOL = dict(rtol=1e-5, atol=1e-5)
RENDER_TOL = dict(rtol=2e-3, atol=2e-3)


def _tiny(num_steps=(16, 8), fused=True, **mc_kw):
    jmc = JModelConfig(field_type="mlp", mlp_field_width=32,
                       mlp_field_depth=4, mlp_prop_width=16,
                       mlp_prop_depth=2, mlp_enc_freqs=4,
                       mlp_prop_enc_freqs=3, mlp_cp_rank=8, mlp_cp_res=16,
                       mlp_sigma_cp_rank=4, mlp_sigma_cp_res=16,
                       mlp_sam_width=32, mlp_sam_depth=2, mlp_sam_feat_dim=16,
                       sam_feat_dim=32, samvit_mlp_hidden=32,
                       mlp_mask_width=32, mlp_mask_depth=2,
                       mlp_mask_feat_dim=16, n_inst=3, **mc_kw)
    jrc = JRenderConfig(num_steps=num_steps, bound=4.0, contract=True,
                        use_fused_mlp=fused)
    jm = jfields.make_model(jmc, jrc)
    tm = fields.make_model(
        config_from_dict(ModelConfig, dataclasses.asdict(jmc)),
        config_from_dict(RenderConfig, dataclasses.asdict(jrc)))
    jp = jfields.init_params(jm, jax.random.key(0))
    # the samvit biases and norm init to 0 / 1 in JAX: give them values
    rng = np.random.default_rng(1)
    if "samvit_mlp" in jp:
        for p in jp["samvit_mlp"]:
            p["b"] = jnp.asarray(rng.normal(0, 0.1, p["b"].shape), jnp.float32)
        jp["samvit_norm"] = {
            k: jnp.asarray(rng.normal(1.0 if k == "w" else 0.0, 0.1, (32,)),
                           jnp.float32) for k in ("w", "b")}
    return jm, tm, jp, params_from_jax(flatten_tree(jp, "params/"), tm)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1.0, (n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9
    return o, (-o + 0.3 * d).astype(np.float32)


def _points(n, seed):
    return np.random.default_rng(seed).uniform(-2, 2, (n, 3)).astype(
        np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [False, True])
def test_apply_linear_bias_matches_jax(dtype, hidden):
    """A biased layer: product in the out dtype, + b, cast to the out
    dtype (JAX fields.py:57-70). bf16 within one bf16 step (2^-8)."""
    rng = np.random.default_rng(2)
    w = rng.normal(0, 0.3, (12, 7)).astype(np.float32)
    b = rng.normal(0, 1.0, (7,)).astype(np.float32)
    x = rng.normal(0, 1.0, (5, 12)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jfields.apply_linear({"w": jnp.asarray(w, jdt),
                                "b": jnp.asarray(b, jdt)}, jnp.asarray(x),
                               hidden=hidden)
    got = fields.apply_linear({"w": torch.tensor(w).to(tdt),
                               "b": torch.tensor(b).to(tdt)},
                              torch.tensor(x), hidden=hidden)
    assert str(got.dtype).split(".")[1] == str(ref.dtype)
    tol = 1e-5 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)
    # the bias is applied: a bias-free layer differs by it
    nob = fields.apply_linear({"w": torch.tensor(w).to(tdt)},
                              torch.tensor(x), hidden=hidden)
    assert float((got.float() - nob.float()).abs().max()) > 0.1


def test_model_dims_match_jax():
    jm, tm, _, _ = _tiny(with_sam=True, sam_use_view_direction=True,
                         with_mask=True)
    assert (tm.s_feat_dim, tm.m_feat_dim, tm.samvit_in_dim,
            tm.mask_out_dim()) == (jm.s_feat_dim, jm.m_feat_dim,
                                   jm.samvit_in_dim, jm.mask_out_dim())


def test_init_params_has_every_head():
    _, tm, jp, _ = _tiny(with_sam=True, sam_use_view_direction=True,
                         with_mask=True)
    tp = fields.init_params(tm, torch.Generator().manual_seed(0))
    from sanerf_tpu_torch.models.sam.predictor import _flatten

    got = {k: tuple(v.shape) for k, v in _flatten(tp).items()}
    assert got == expected_shapes(tm)
    assert got == {k: tuple(v.shape)
                   for k, v in flatten_tree(jp, "").items()}


def test_sam_features_and_head_match_jax():
    jm, tm, jp, tp = _tiny(with_sam=True, sam_use_view_direction=True)
    x = _points(40, seed=3)
    ref = jfields.sam_features(jm, jp, jnp.asarray(x))
    got = fields.sam_features(tm, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **MOD_TOL)
    f = np.random.default_rng(4).normal(0, 1, (9, tm.samvit_in_dim)).astype(
        np.float32)
    ref, _ = jfields.apply_samvit_head(jm, jp, jnp.asarray(f))
    got, _ = fields.apply_samvit_head(tm, tp, torch.from_numpy(f))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_mask_grid_features_and_head_match_jax():
    jm, tm, jp, tp = _tiny(with_mask=True)
    x = _points(40, seed=5)
    ref = jfields.mask_grid_features(jm, jp, jnp.asarray(x))
    got = fields.mask_grid_features(tm, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **MOD_TOL)
    geo = np.random.default_rng(6).normal(0, 1, (40, 15)).astype(np.float32)
    ref, _ = jfields.apply_skip_mlp(
        jp["mask_mlp"], jnp.concatenate([ref, jnp.asarray(geo)], -1), ())
    got = renderer._mask_head(tm, tp, got, torch.from_numpy(geo))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("view_dir", [True, False])
def test_run_rays_return_feats_matches_jax(fused, view_dir):
    jm, tm, jp, tp = _tiny(fused=fused, with_sam=True,
                           sam_use_view_direction=view_dir)
    assert renderer.uses_kernels(tm) == fused
    o, d = _rays(24, seed=7)
    ref = jrenderer.run_rays(jm, jp, jnp.asarray(o), jnp.asarray(d),
                             return_feats=True)
    got = renderer.run_rays(tm, tp, torch.from_numpy(o), torch.from_numpy(d),
                            return_feats=True)
    assert got["samvit"].shape == (24, 32)
    for k in ("image", "depth", "weights_sum", "samvit"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **RENDER_TOL)


@pytest.mark.parametrize("fused", [True, False])
def test_run_rays_return_mask_matches_jax(fused):
    jm, tm, jp, tp = _tiny(fused=fused, with_mask=True)
    o, d = _rays(24, seed=8)
    ref = jrenderer.run_rays(jm, jp, jnp.asarray(o), jnp.asarray(d),
                             return_mask=True)
    got = renderer.run_rays(tm, tp, torch.from_numpy(o), torch.from_numpy(d),
                            return_mask=True)
    assert got["instance_mask_logits"].shape == (24, 3)
    for k in ("image", "depth", "weights_sum", "instance_mask_logits"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **RENDER_TOL)


def test_render_frame_and_staged_keep_heads():
    _, tm, _, tp = _tiny(with_sam=True, sam_use_view_direction=True,
                         with_mask=True)
    o, d = (torch.from_numpy(a) for a in _rays(20, seed=9))
    whole = renderer.run_rays(tm, tp, o, d, return_feats=True,
                              return_mask=True)
    for fn in (renderer.render_frame, renderer.render_staged):
        out = fn(tm, tp, o, d, chunk=8, return_feats=True, return_mask=True)
        for k in ("samvit", "instance_mask_logits"):
            np.testing.assert_allclose(out[k].numpy(), whole[k].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="SAM head"):
        renderer.run_rays(*_tiny()[1::2], o, d, return_feats=True)


def test_mask_asset_loads_and_renders_like_jax():
    """The shipped mask head on the shipped asset: every key of both npz
    files maps; a few rays of the fast path against JAX's at 2e-3."""
    mc, rc, tp = load_mask_asset(ASSET, device="cpu")
    assert mc.n_inst == 5 and mc.with_mask and not mc.with_sam
    tm = fields.make_model(mc, dataclasses.replace(rc, num_steps=(32, 16)))
    from sanerf_tpu.config import config_from_dict as jcfd
    from sanerf_tpu.train.checkpoints import unflatten_like

    jmc = jcfd(JModelConfig, dataclasses.asdict(mc))
    jrc = jcfd(JRenderConfig, dataclasses.asdict(tm.render_cfg))
    jm = jfields.make_model(jmc, jrc)
    jp = jfields.init_params(jm, jax.random.key(0))
    tmpl = flatten_tree(jp, "")
    for name in (ASSET, ASSET + "_mask"):
        for k, v in np.load(name + ".npz").items():
            if k.startswith("params/"):
                tmpl[k[7:]] = v
    jp = unflatten_like(jp, tmpl, "")
    o, d = _rays(16, seed=10)
    o = o + np.float32([0, 0, 2.0])
    ref = jrenderer.run_rays(jm, jp, jnp.asarray(o), jnp.asarray(d),
                             return_mask=True)
    got = renderer.run_rays(tm, tp, torch.from_numpy(o), torch.from_numpy(d),
                            return_mask=True)
    np.testing.assert_allclose(got["instance_mask_logits"].numpy(),
                               np.asarray(ref["instance_mask_logits"]),
                               **RENDER_TOL)


def test_load_asset_with_sam_overlays_the_asset():
    mc, rc, plain = load_asset(ASSET, device="cpu")
    mcs, _, p = load_asset(ASSET, device="cpu", with_sam=True, seed=3)
    assert mcs.with_sam and mcs.sam_use_view_direction
    assert set(p) == set(plain) | {"s_field_mlp", "samvit_mlp", "samvit_norm"}
    assert torch.equal(p["grid_mlp"][0]["w"], plain["grid_mlp"][0]["w"])
    _, _, p2 = load_asset(ASSET, device="cpu", with_sam=True, seed=3)
    assert torch.equal(p["samvit_mlp"][0]["w"], p2["samvit_mlp"][0]["w"])
    tm = fields.make_model(mcs, rc)
    shapes = expected_shapes(tm)
    from sanerf_tpu_torch.models.sam.predictor import _flatten

    assert {k: tuple(v.shape) for k, v in _flatten(p).items()} == shapes


def test_mean_iou_meter_matches_jax():
    rng = np.random.default_rng(11)
    a, b = MeanIoUMeter(), JMeanIoUMeter()
    for _ in range(3):
        pred = rng.integers(0, 4, (64,))
        truth = rng.integers(-1, 4, (64,))
        a.update(pred, truth)
        b.update(pred, truth)
    assert a.measure() == pytest.approx(b.measure(), abs=1e-12)
