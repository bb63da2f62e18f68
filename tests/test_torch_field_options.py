"""Parity: the field options and heads the port's `make_model` used to
refuse, against the JAX package with the same weights (carried across by
params_from_jax):
  - `sum_after_mlp`: the per-sample view MLP composited after it, and the
    per-point SAM head (run_rays, fast path and plain path, 2e-3); on the
    fast path the final level's field runs through run_tmlp, as in JAX;
  - the `adaptive` mask head, all three `adaptive_mlp_type`s, whose
    `save_inter` route keeps the model off the fast path (2e-3), its
    parameter shapes, and `convert_nerf` of its reference weights (equal);
  - SH degrees 5-8 (1e-5 against JAX's polynomials; frames at 2e-3 on the
    plain path and on the fast path with the view head outside the kernel;
    with it inside, both packages refuse);
  - `contract_T` and `uncontract` (1e-6), `encode_boxes` and
    `encode_masks` of the SAM prompt encoder (1e-5), and
    `overlay_mask_and_points` (equal).
On the CPU the port's fast path runs its kernels' plain versions and the
JAX fast path its Pallas kernels in interpret mode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_tpu.apps.interactive import \
    overlay_mask_and_points as j_overlay
from sanerf_tpu.config import ModelConfig as JModelConfig
from sanerf_tpu.config import RenderConfig as JRenderConfig
from sanerf_tpu.models import fields as jfields
from sanerf_tpu.models import renderer as jrenderer
from sanerf_tpu.models.convert_nerf import convert_nerf_state_dict as jconvert
from sanerf_tpu.models.sam import prompt_encoder as jpe
from sanerf_tpu.ops import sampling as jsampling
from sanerf_tpu.ops.sh import sh_encode as j_sh_encode
from sanerf_tpu.train.checkpoints import flatten_tree
from sanerf_tpu_torch.apps.interactive import overlay_mask_and_points
from sanerf_tpu_torch.config import ModelConfig, RenderConfig, config_from_dict
from sanerf_tpu_torch.models import fields, renderer
from sanerf_tpu_torch.models.asset import expected_shapes, params_from_jax
from sanerf_tpu_torch.models.convert_nerf import convert_nerf_state_dict
from sanerf_tpu_torch.models.sam import prompt_encoder as tpe
from sanerf_tpu_torch.ops import sampling
from sanerf_tpu_torch.ops.sh import sh_encode

from tests.test_convert_nerf import MC as CONVERT_MC
from tests.test_convert_nerf import RC as CONVERT_RC
from tests.test_convert_nerf import _torch_sd

torch.set_num_threads(1)
RENDER_TOL = dict(rtol=2e-3, atol=2e-3)


def _tiny(num_steps=(16, 8), fused=True, render=None, **mc_kw):
    """A small MLP-family model in both packages and its JAX-drawn weights
    in both (the SAM head's biases and norm given visible values)."""
    jmc = JModelConfig(**{**dict(
        field_type="mlp", mlp_field_width=32, mlp_field_depth=4,
        mlp_prop_width=16, mlp_prop_depth=2, mlp_enc_freqs=4,
        mlp_prop_enc_freqs=3, mlp_cp_rank=8, mlp_cp_res=16,
        mlp_sam_width=32, mlp_sam_depth=2, mlp_sam_feat_dim=16,
        sam_feat_dim=32, samvit_mlp_hidden=32, mlp_mask_width=32,
        mlp_mask_depth=2, mlp_mask_feat_dim=16, n_inst=3), **mc_kw})
    jrc = JRenderConfig(num_steps=num_steps, bound=4.0, contract=True,
                        use_fused_mlp=fused, **(render or {}))
    jm = jfields.make_model(jmc, jrc)
    tm = fields.make_model(
        config_from_dict(ModelConfig, dataclasses.asdict(jmc)),
        config_from_dict(RenderConfig, dataclasses.asdict(jrc)))
    jp = jfields.init_params(jm, jax.random.key(0))
    rng = np.random.default_rng(1)
    if "samvit_mlp" in jp:
        for p in jp["samvit_mlp"]:
            p["b"] = jnp.asarray(rng.normal(0, 0.1, p["b"].shape),
                                 jnp.float32)
        jp["samvit_norm"] = {
            k: jnp.asarray(rng.normal(1.0 if k == "w" else 0.0, 0.1,
                                      (jmc.sam_feat_dim,)), jnp.float32)
            for k in ("w", "b")}
    return jm, tm, jp, params_from_jax(flatten_tree(jp, "params/"), tm)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1.0, (n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9
    return o, (-o + 0.3 * d).astype(np.float32)


def _frames(jm, tm, jp, tp, keys, n=16, seed=7, **kw):
    o, d = _rays(n, seed)
    ref = jrenderer.run_rays(jm, jp, jnp.asarray(o), jnp.asarray(d), **kw)
    got = renderer.run_rays(tm, tp, torch.from_numpy(o), torch.from_numpy(d),
                            **kw)
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **RENDER_TOL)
    return got


# -- sum_after_mlp ------------------------------------------------------------


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("sam", [None, "view", "geo"])
def test_sum_after_mlp_matches_jax(fused, sam):
    """The per-sample view MLP then the composite; with the SAM head its
    per-point input [features, f_colors | geo_feat, f_colors] and the
    composite of its outputs."""
    kw = {} if sam is None else dict(with_sam=True,
                                     sam_use_view_direction=sam == "view")
    jm, tm, jp, tp = _tiny(fused=fused, sum_after_mlp=True, **kw)
    assert tm.samvit_in_dim == jm.samvit_in_dim if sam else True
    assert renderer.uses_kernels(tm) == fused
    keys = ("image", "depth", "weights_sum") + (("samvit",) if sam else ())
    _frames(jm, tm, jp, tp, keys, return_feats=sam is not None)


def test_sum_after_mlp_runs_the_field_kernel():
    """On the fast path the final level's field runs through run_tmlp (the
    fused composite does not: its epilogue composites before the view
    MLP), as JAX's renderer.py:252-256 -> fields.forward(fast=True)."""
    jm, tm, jp, tp = _tiny(sum_after_mlp=True)
    calls = []
    real_tmlp, real_comp = fields.run_tmlp, fields.run_tmlp_composite

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append((name, a[1].kout))
            return fn(*a, **k)
        return wrapped
    fields.run_tmlp = spy("run_tmlp", real_tmlp)
    fields.run_tmlp_composite = spy("run_tmlp_composite", real_comp)
    try:
        _frames(jm, tm, jp, tp, ("image", "depth", "weights_sum"))
    finally:
        fields.run_tmlp, fields.run_tmlp_composite = real_tmlp, real_comp
    # the proposal net's run_tmlp, then the field's (16 outputs)
    assert calls == [("run_tmlp", 1), ("run_tmlp", 16)]


# -- the adaptive mask head ---------------------------------------------------

ADAPTIVE = {
    "density": dict(),
    "rgb": dict(sum_after_mlp=True),
    "sam": dict(sum_after_mlp=True, with_sam=True, samvit_mlp_layers=5),
}


@pytest.mark.parametrize("kind", sorted(ADAPTIVE))
def test_adaptive_mask_head_matches_jax(kind):
    """Each adaptive ladder over the backbone's detached activations:
    shapes as JAX draws them, the model off the fast path (save_inter),
    the composited mask logits within 2e-3. (JAX's `rgb` and `sam`
    ladders concatenate per-point activations with the view MLP's and the
    samvit head's, which are per point only with sum_after_mlp.)"""
    jm, tm, jp, tp = _tiny(with_mask=True, mask_mlp_type="adaptive",
                           adaptive_mlp_type=kind, **ADAPTIVE[kind])
    assert not renderer.uses_kernels(tm)
    assert expected_shapes(tm) == {k: tuple(v.shape) for k, v in
                                   flatten_tree(jp, "").items()}
    got = _frames(jm, tm, jp, tp, ("image", "depth", "weights_sum",
                                   "instance_mask_logits"),
                  return_mask=True)
    assert got["instance_mask_logits"].shape == (16, 3)


def test_adaptive_sam_needs_the_sam_head():
    for bad in (dict(with_sam=False), dict(with_sam=True,
                                           samvit_mlp_layers=4)):
        mc = ModelConfig(with_mask=True, mask_mlp_type="adaptive",
                         adaptive_mlp_type="sam", **bad)
        with pytest.raises(ValueError, match="adaptive_mlp_type='sam'"):
            fields.make_model(mc, RenderConfig())
        with pytest.raises(ValueError, match="adaptive_mlp_type='sam'"):
            jfields.make_model(
                JModelConfig(**dataclasses.asdict(mc)), JRenderConfig())


def test_convert_adaptive_checkpoint_matches_jax():
    """A reference checkpoint with the adaptive ladder (bare linears
    mask_mlp.<i>, no m_grid) converts to JAX's parameters."""
    mc = dataclasses.replace(CONVERT_MC, with_mask=True,
                             mask_mlp_type="adaptive",
                             adaptive_mlp_type="density", n_inst=3)
    jm = jfields.make_model(mc, CONVERT_RC)
    tm = fields.make_model(
        config_from_dict(ModelConfig, dataclasses.asdict(mc)),
        config_from_dict(RenderConfig, dataclasses.asdict(CONVERT_RC)))
    assert tm.m_grid_spec is None and jm.m_grid_spec is None
    sd = _torch_sd(jm, np.random.default_rng(3), with_mask=True,
                   mask_type="adaptive")
    jp = flatten_tree(jconvert(dict(sd), jm), "")
    tp = convert_nerf_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, tm,
        device="cpu")
    got = flatten_tree(jax.tree.map(lambda t: t.numpy(), tp), "")
    assert set(got) == set(jp) and "mask_mlp/5/w" in got
    for k, v in jp.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    assert expected_shapes(tm) == {k: v.shape for k, v in got.items()}


# -- SH degrees 5-8 -----------------------------------------------------------


@pytest.mark.parametrize("degree", range(1, 9))
def test_sh_encode_matches_jax(degree):
    d = np.random.default_rng(degree).normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    got = sh_encode(torch.from_numpy(d), degree)
    ref = np.asarray(j_sh_encode(jnp.asarray(d), degree))
    assert got.shape == (64, degree * degree)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("degree", [5, 8])
@pytest.mark.parametrize("route", ["plain", "fast, view outside"])
def test_high_sh_degree_frames_match_jax(degree, route):
    """Degrees past 4 route as in JAX: the plain path, and the fast path
    with the view head outside the kernel (RenderConfig.view_in_kernel
    False: the composite kernel, then SH and the view MLP on its sums)."""
    jm, tm, jp, tp = _tiny(fused=route != "plain", sh_degree=degree,
                           render={"view_in_kernel": False})
    _frames(jm, tm, jp, tp, ("image", "depth", "weights_sum"))


def test_high_sh_degree_in_the_kernel_refused_by_both():
    """With the view head in the composite kernel (the default) both
    packages refuse degree 5: their kernels evaluate degrees 1-4."""
    jm, tm, jp, tp = _tiny(sh_degree=5)
    o, d = _rays(4, 8)
    with pytest.raises(IndexError):
        jrenderer.run_rays(jm, jp, jnp.asarray(o), jnp.asarray(d))
    with pytest.raises(NotImplementedError, match="SH degrees 1-4"):
        renderer.run_rays(tm, tp, torch.from_numpy(o), torch.from_numpy(d))


# -- contract_T, uncontract ---------------------------------------------------


def _contraction_points(n, seed):
    """Points inside and outside the unit cube, with |x| == |y| and
    |y| == |z| ties (the first maximum dominates)."""
    x = np.random.default_rng(seed).uniform(-6, 6, (n, 3)).astype(np.float32)
    x[::7, 1] = -x[::7, 0]
    x[3::7, 2] = x[3::7, 1]
    x[5::7] *= 0.1
    return x


def test_contract_T_and_uncontract_match_jax():
    x = _contraction_points(301, 1)
    ref = np.asarray(jsampling.contract_T(jnp.asarray(x.T)))
    got = sampling.contract_T(torch.from_numpy(x.T.copy()))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        got.numpy(), sampling.contract(torch.from_numpy(x)).numpy().T)
    z = ref.T.copy()
    ref = np.asarray(jsampling.uncontract(jnp.asarray(z)))
    got = sampling.uncontract(torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    # the inverse: back to the points (to float32's conditioning near 2)
    inside = np.abs(z).max(-1) < 1.9
    np.testing.assert_allclose(got.numpy()[inside], x[inside], rtol=1e-3,
                               atol=1e-5)


# -- the SAM prompt encoder's boxes and masks ---------------------------------


def test_encode_boxes_and_masks_match_jax():
    cfg = jpe.PromptConfig(embed_dim=32, image_embedding_size=(8, 8),
                           input_image_size=(128, 128), mask_in_chans=8)
    jp = jpe.init_params(cfg, jax.random.key(2))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    tcfg = tpe.PromptConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(3)
    boxes = np.sort(rng.uniform(0, 128, (5, 2, 2)), axis=1).reshape(
        5, 4).astype(np.float32)
    ref = np.asarray(jpe.encode_boxes(jp, cfg, jnp.asarray(boxes)))
    got = tpe.encode_boxes(tp, tcfg, torch.from_numpy(boxes))
    assert got.shape == (5, 2, 32)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    masks = rng.normal(0, 1, (2, 32, 32, 1)).astype(np.float32)
    ref = np.asarray(jpe.encode_masks(jp, cfg, jnp.asarray(masks)))
    got = tpe.encode_masks(tp, tcfg, torch.from_numpy(masks))
    assert got.shape == (2, 64, 32)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


# -- the host-side overlay ----------------------------------------------------


def test_overlay_mask_and_points_matches_jax():
    rng = np.random.default_rng(4)
    rgb = rng.uniform(0, 1, (20, 24, 3)).astype(np.float32)
    mask = rng.uniform(0, 1, (20, 24)) > 0.6
    pts = np.float32([[0.5, 0.5], [23.2, 19.9], [10.7, 3.1], [-1.0, 5.0]])
    for m in (mask, None):
        got = overlay_mask_and_points(rgb, m, pts)
        ref = np.asarray(j_overlay(rgb, m, pts))
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == rgb.dtype
