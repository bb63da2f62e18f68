"""Parity: the port's renderer (sanerf_tpu_torch/models/renderer.py) vs the
JAX renderer, same weights (carried across by params_from_jax), at 2e-3.

On the CPU the port's fast path runs the plain versions of its kernels and
the JAX fast path runs its Pallas kernels in interpret mode."""

import dataclasses
import json
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
from sanerf_tpu_torch.config import ModelConfig, RenderConfig, config_from_dict
from sanerf_tpu_torch.models import fields, renderer
from sanerf_tpu_torch.models.asset import params_from_jax

torch.set_num_threads(1)
TOL = dict(rtol=2e-3, atol=2e-3)
ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "serving_student")
KEYS = ("weights_sum", "depth", "image")


def _pair(jmc, jrc):
    """(JAX model, port model) of one configuration."""
    d_m, d_r = dataclasses.asdict(jmc), dataclasses.asdict(jrc)
    return (jfields.make_model(jmc, jrc),
            fields.make_model(config_from_dict(ModelConfig, d_m),
                              config_from_dict(RenderConfig, d_r)))


def _tiny(num_steps, **rc_kw):
    jmc = JModelConfig(field_type="mlp", mlp_field_width=32,
                       mlp_field_depth=4, mlp_prop_width=16,
                       mlp_prop_depth=2, mlp_enc_freqs=4,
                       mlp_prop_enc_freqs=3)
    jrc = JRenderConfig(num_steps=num_steps, bound=4.0, contract=True,
                        **rc_kw)
    jm, tm = _pair(jmc, jrc)
    jp = jfields.init_params(jm, jax.random.key(0))
    return jm, tm, jp, params_from_jax(flatten_tree(jp, "params/"), tm)


def _asset(num_steps):
    with open(ASSET + ".json") as f:
        meta = json.load(f)
    flat = dict(np.load(ASSET + ".npz"))
    jmc = jax_cfg(JModelConfig, meta["model_config"])
    jrc = dataclasses.replace(jax_cfg(JRenderConfig, meta["render_config"]),
                              num_steps=num_steps)
    jm, tm = _pair(jmc, jrc)
    jp = jfields.init_params(jm, jax.random.key(0))
    jflat = flatten_tree(jp, "")
    for k, v in flat.items():
        if k.startswith("params/"):
            jflat[k[len("params/"):]] = v
    from sanerf_tpu.train.checkpoints import unflatten_like

    return jm, tm, unflatten_like(jp, jflat, ""), params_from_jax(flat, tm)


def jax_cfg(cls, d):
    from sanerf_tpu.config import config_from_dict as jcfd

    return jcfd(cls, d)


def _rays(n, seed, origin=(0.0, 0.0, 0.0)):
    rng = np.random.default_rng(seed)
    o = (rng.normal(0, 0.5, (n, 3)) + origin).astype(np.float32)
    d = rng.normal(0, 1.0, (n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9
    d = (-o + 0.3 * d).astype(np.float32)
    return o, d


def _compare(got, ref, tol=TOL):
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **tol)


@pytest.mark.parametrize("num_steps", [(16, 8, 4), (16, 4)])
def test_tiny_fast_path_matches_jax(num_steps):
    jm, tm, jp, tp = _tiny(num_steps)
    o, d = _rays(24, seed=0)
    ref = jrenderer.run_rays(jm, jp, jnp.asarray(o), jnp.asarray(d))
    got = renderer.run_rays(tm, tp, torch.from_numpy(o), torch.from_numpy(d))
    _compare(got, ref)


@pytest.mark.parametrize("num_steps", [(32, 16), (128, 64, 32)])
def test_asset_fast_path_matches_jax(num_steps):
    jm, tm, jp, tp = _asset(num_steps)
    o, d = _rays(32, seed=1, origin=(0.0, 0.0, 2.0))
    ref = jrenderer.run_rays(jm, jp, jnp.asarray(o), jnp.asarray(d))
    got = renderer.run_rays(tm, tp, torch.from_numpy(o), torch.from_numpy(d))
    assert renderer.uses_kernels(tm)
    _compare(got, ref)


def test_asset_field_forward_T_matches_jax():
    """The field chain alone (run_tmlp with CP, sigma-CP and skip) on the
    asset's float32 weights, [16, P] transposed, at the JAX suite's 3e-4."""
    jm, tm, jp, tp = _asset((32, 16))
    x = np.random.default_rng(3).uniform(-2, 2, (3, 40)).astype(np.float32)
    ref = jfields.field_forward_T(jm, jp, jnp.asarray(x), transposed=True)
    got = fields.field_forward_T(tm, tp, torch.from_numpy(x), transposed=True)
    assert got.shape == (16, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:16], rtol=3e-4,
                               atol=3e-4)


@pytest.mark.parametrize("num_steps", [(32, 16), (16, 8, 4)])
def test_asset_plain_path_matches_jax_xla(num_steps):
    jm, tm, jp, tp = _asset(num_steps)
    jm = dataclasses.replace(jm, render_cfg=dataclasses.replace(
        jm.render_cfg, use_fused_mlp=False))
    tm = dataclasses.replace(tm, render_cfg=dataclasses.replace(
        tm.render_cfg, use_fused_mlp=False))
    o, d = _rays(32, seed=2, origin=(0.0, 0.0, 2.0))
    cnf = np.array([[0.5, 3.5]], np.float32)
    ref = jrenderer.run_rays(jm, jp, jnp.asarray(o), jnp.asarray(d),
                             cam_near_far=jnp.asarray(cnf))
    got = renderer.run_rays(tm, tp, torch.from_numpy(o), torch.from_numpy(d),
                            cam_near_far=torch.from_numpy(cnf))
    assert not renderer.uses_kernels(tm)
    _compare(got, ref)


@pytest.mark.parametrize("rc_kw", [dict(view_in_kernel=False),
                                   dict(background="white")])
def test_tiny_options_match_jax(rc_kw):
    jm, tm, jp, tp = _tiny((16, 4), **rc_kw)
    o, d = _rays(16, seed=5)
    ref = jrenderer.run_rays(jm, jp, jnp.asarray(o), jnp.asarray(d))
    got = renderer.run_rays(tm, tp, torch.from_numpy(o), torch.from_numpy(d))
    _compare(got, ref)


def test_perturbed_fast_path_matches_plain_path():
    """The same jitter draws through both paths give the same frame, and
    the jitter moves the frame."""
    _, tm, _, tp = _tiny((16, 8, 4))
    slow = dataclasses.replace(tm, render_cfg=dataclasses.replace(
        tm.render_cfg, use_fused_mlp=False))
    o, d = (torch.from_numpy(a) for a in _rays(24, seed=7))
    g = torch.Generator().manual_seed(0)
    jit = [torch.rand(24, T + 1, generator=g) for T in (16, 8, 4)]
    got = renderer.run_rays(tm, tp, o, d, jit)
    ref = renderer.run_rays(slow, tp, o, d, jit)
    _compare(got, {k: v.numpy() for k, v in ref.items()})
    base = renderer.run_rays(tm, tp, o, d)
    assert float((got["image"] - base["image"]).abs().max()) > 1e-5


def test_render_frame_and_staged_chunking():
    _, tm, _, tp = _tiny((16, 4))
    o, d = (torch.from_numpy(a) for a in _rays(40, seed=9))
    whole = renderer.run_rays(tm, tp, o, d)
    for out in (renderer.render_frame(tm, tp, o, d, chunk=16),
                renderer.render_staged(tm, tp, o, d, chunk=16)):
        for k in KEYS:
            np.testing.assert_allclose(out[k].numpy(), whole[k].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    g = torch.Generator().manual_seed(1)
    twin = torch.cat([o[:8], o[:8]]), torch.cat([d[:8], d[:8]])
    out = renderer.render_frame(tm, tp, *twin, chunk=8, generator=g)
    assert float((out["image"][:8] - out["image"][8:]).abs().max()) > 1e-6


def test_fast_path_refuses_oversized_tables(monkeypatch):
    """Grid tables over RenderConfig.grid_vmem_budget send the model to the
    plain path (the same frame, bit for bit), as in the JAX package; the
    kernels' own guard, TABLE_BYTES_LIMIT, still raises."""
    from sanerf_tpu_torch.ops import fused_mlp_t

    jm, tm, jp, tp = _asset((16, 4))
    assert renderer.uses_kernels(tm)
    over = dataclasses.replace(tm, render_cfg=dataclasses.replace(
        tm.render_cfg, grid_vmem_budget=tm.grid_table_bytes - 1))
    slow = dataclasses.replace(tm, render_cfg=dataclasses.replace(
        tm.render_cfg, use_fused_mlp=False))
    assert not renderer.uses_kernels(over)
    o, d = (torch.from_numpy(a) for a in _rays(8, seed=1,
                                                origin=(0.0, 0.0, 2.0)))
    got, ref = renderer.run_rays(over, tp, o, d), renderer.run_rays(slow, tp,
                                                                    o, d)
    for k in KEYS:
        assert torch.equal(got[k], ref[k]), k
    monkeypatch.setattr(fused_mlp_t, "TABLE_BYTES_LIMIT", -1)
    nets = fields.KernelNets(tm, tp)
    with pytest.raises(NotImplementedError, match="limit"):
        fused_mlp_t._net_args(nets.field, torch.device("cpu"))


def test_flatten_kernel_frame_is_identical():
    """RenderConfig.flatten_kernel routes the [3, N, T] -> [3, N*T] pivot
    through flatten3_nt: the frame is bit for bit the default one, and the
    JAX frame of the same option within 2e-3."""
    jm, tm, jp, tp = _tiny((16, 8, 4), flatten_kernel=True)
    base = dataclasses.replace(tm, render_cfg=dataclasses.replace(
        tm.render_cfg, flatten_kernel=False))
    o, d = _rays(24, seed=5)
    got = renderer.run_rays(tm, tp, torch.from_numpy(o), torch.from_numpy(d))
    ref = renderer.run_rays(base, tp, torch.from_numpy(o),
                            torch.from_numpy(d))
    for k in KEYS:
        assert torch.equal(got[k], ref[k]), k
    _compare(got, jrenderer.run_rays(jm, jp, jnp.asarray(o), jnp.asarray(d)))


@pytest.mark.parametrize("view_in_kernel", [True, False])
def test_packed_epilogue_frame_matches_default(view_in_kernel):
    """RenderConfig.packed_epilogue: within 1e-6 of the unpacked fast path
    (the JAX suite's bound, tests/test_ray_kernels.py:197-226), and the
    JAX packed frame within 2e-3. The packed composite always runs the view
    head in the kernel."""
    jm, tm, jp, tp = _tiny((16, 8, 4), packed_epilogue=True,
                           view_in_kernel=view_in_kernel)
    base = dataclasses.replace(tm, render_cfg=dataclasses.replace(
        tm.render_cfg, packed_epilogue=False, view_in_kernel=True))
    o, d = _rays(24, seed=9)
    got = renderer.run_rays(tm, tp, torch.from_numpy(o), torch.from_numpy(d))
    ref = renderer.run_rays(base, tp, torch.from_numpy(o),
                            torch.from_numpy(d))
    _compare(got, {k: v.numpy() for k, v in ref.items()},
             dict(rtol=1e-6, atol=1e-6))
    _compare(got, jrenderer.run_rays(jm, jp, jnp.asarray(o), jnp.asarray(d)))
