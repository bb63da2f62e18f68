"""Parity: the port's hash-grid encoder (sanerf_tpu_torch/ops/hashgrid.py,
ops/encoding.py, ops/activation.py:trunc_exp) and the hash-grid family's
fields (models/fields.py) against the JAX package on the same inputs.

Level metadata and indices are compared exactly; the encoder and single
field modules at the JAX suite's 1e-5 (tests/test_hashgrid.py:87). The
JAX hash-grid path is XLA; the port's gathers take the plain version of
their kernel on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_tpu.config import HashGridConfig as JHashGridConfig
from sanerf_tpu.config import ModelConfig as JModelConfig
from sanerf_tpu.config import RenderConfig as JRenderConfig
from sanerf_tpu.models import fields as jfields
from sanerf_tpu.ops import activation as jactivation
from sanerf_tpu.ops import encoding as jencoding
from sanerf_tpu.ops import hashgrid as jhashgrid
from sanerf_tpu.train.checkpoints import flatten_tree
from sanerf_tpu_torch.config import HashGridConfig, ModelConfig, RenderConfig
from sanerf_tpu_torch.config import config_from_dict
from sanerf_tpu_torch.models import fields
from sanerf_tpu_torch.models.asset import params_from_jax
from sanerf_tpu_torch.ops import encoding, hashgrid
from sanerf_tpu_torch.ops.activation import trunc_exp

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _full_width_grids():
    """Every grid of ModelConfig(field_type="hashgrid", with_sam=True) at
    its defaults, and both mask grids (JAX: fields.py:308-357)."""
    mc = JModelConfig()
    return {
        "rgb": dict(num_levels=mc.grid_num_levels, level_dim=mc.grid_level_dim,
                    log2_hashmap_size=mc.grid_log2_hashmap,
                    desired_resolution=mc.grid_desired_resolution),
        **{f"prop{i}": dict(num_levels=mc.prop_num_levels,
                            level_dim=mc.prop_level_dim,
                            log2_hashmap_size=mc.prop_log2_hashmap,
                            desired_resolution=r)
           for i, r in enumerate(mc.prop_resolutions)},
        "s_grid": dict(num_levels=mc.s_grid_num_levels,
                       level_dim=mc.s_grid_level_dim,
                       log2_hashmap_size=mc.s_grid_log2_hashmap,
                       desired_resolution=mc.s_grid_desired_resolution),
        "m_grid": dict(num_levels=16, level_dim=8, log2_hashmap_size=19,
                       desired_resolution=512),
        "m_grid_lightweight": dict(num_levels=16, level_dim=2,
                                   log2_hashmap_size=10,
                                   desired_resolution=256),
        "rgb_tiled": dict(num_levels=16, level_dim=2, log2_hashmap_size=19,
                          desired_resolution=4096, gridtype="tiled"),
    }


GRIDS = _full_width_grids()


def _specs(kw):
    return (jhashgrid.build_spec(JHashGridConfig(**kw)),
            hashgrid.build_spec(HashGridConfig(**kw)))


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_build_spec_equals_jax(name):
    js, ts = _specs(GRIDS[name])
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert ts.total_params == js.total_params
    assert ts.output_dim == js.output_dim


@pytest.mark.parametrize("name", ["rgb", "s_grid", "rgb_tiled", "prop0"])
def test_grid_index_equals_jax_at_the_finest_levels(name):
    """Corner coordinates near the top of the grid, where the uint32 prime
    products and dense strides wrap."""
    js, ts = _specs(GRIDS[name])
    rng = np.random.default_rng(0)
    for level in range(js.num_levels - 3, js.num_levels):
        res = js.resolutions[level]
        pg = [rng.integers(max(0, res - 64), res, 4096).astype(np.int32)
              for _ in range(3)]
        pg[0][:4] = res - 1
        want = np.asarray(jhashgrid._grid_index(
            js, level, tuple(jnp.asarray(p) for p in pg)))
        got = hashgrid._grid_index(ts, level,
                                   [torch.from_numpy(p) for p in pg])
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


ENCODE_CASES = [
    dict(num_levels=6, level_dim=2, base_resolution=8, log2_hashmap_size=10,
         desired_resolution=512),
    dict(num_levels=5, level_dim=4, base_resolution=4, log2_hashmap_size=9,
         desired_resolution=128, gridtype="tiled"),
    dict(num_levels=5, level_dim=2, base_resolution=4, log2_hashmap_size=8,
         desired_resolution=200, interpolation="smoothstep"),
    dict(num_levels=4, level_dim=2, base_resolution=4, log2_hashmap_size=10,
         desired_resolution=64, align_corners=True),
    dict(num_levels=4, level_dim=3, base_resolution=4, log2_hashmap_size=9,
         desired_resolution=96, gridtype="tiled", interpolation="smoothstep",
         align_corners=True),
    dict(num_levels=16, level_dim=2, log2_hashmap_size=19,
         desired_resolution=4096),
]


def _table(spec, rng, dtype=np.float32):
    return rng.standard_normal((spec.total_params, spec.level_dim)
                               ).astype(dtype)


@pytest.mark.parametrize("kw", ENCODE_CASES)
def test_hash_encode_01_matches_jax(kw):
    js, ts = _specs(kw)
    rng = np.random.default_rng(1)
    table = _table(ts, rng)
    x = rng.uniform(-0.1, 1.1, (300, 3)).astype(np.float32)  # OOB included
    x[:3] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [1.0, 0.0, 0.5]]
    want = np.asarray(jhashgrid.hash_encode_01(jnp.asarray(x),
                                               jnp.asarray(table), js))
    got = hashgrid.hash_encode_01(torch.from_numpy(x),
                                  torch.from_numpy(table), ts)
    assert got.dtype == torch.float32 and got.shape == (300, ts.output_dim)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    oob = ((x < 0) | (x > 1)).any(-1)
    assert oob.any() and not got.numpy()[oob].any()


@pytest.mark.parametrize("max_level", [1, 3])
def test_hash_encode_max_level_and_prefix(max_level):
    kw = ENCODE_CASES[0]
    js, ts = _specs(kw)
    rng = np.random.default_rng(2)
    table = _table(ts, rng)
    x = rng.uniform(0, 1, (4, 5, 3)).astype(np.float32)
    want = np.asarray(jhashgrid.hash_encode_01(
        jnp.asarray(x), jnp.asarray(table), js, max_level=max_level))
    got = hashgrid.hash_encode_01(torch.from_numpy(x),
                                  torch.from_numpy(table), ts,
                                  max_level=max_level)
    assert got.shape == (4, 5, ts.output_dim)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[..., max_level * ts.level_dim:].any()


def test_hash_encode_bf16_table_and_bound():
    """A bf16 table (the served params) and world coordinates."""
    kw = ENCODE_CASES[0]
    js, ts = _specs(kw)
    rng = np.random.default_rng(3)
    table = jnp.asarray(_table(ts, rng)).astype(jnp.bfloat16)
    x = rng.uniform(-2.2, 2.2, (200, 3)).astype(np.float32)
    want = np.asarray(jhashgrid.hash_encode(jnp.asarray(x), table, js,
                                            bound=2.0))
    tt = torch.from_numpy(np.array(table.astype(jnp.float32))).bfloat16()
    got = hashgrid.hash_encode(torch.from_numpy(x), tt, ts, bound=2.0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_one_gather_per_level(monkeypatch):
    """All 2^D corners of a level go through one gather_rows call on that
    level's slice of the table."""
    _, ts = _specs(ENCODE_CASES[0])
    calls = []
    real = hashgrid.gather_rows

    def spy(table, idx, block_rows=1):
        calls.append((table.shape[0], tuple(idx.shape)))
        return real(table, idx, block_rows)

    monkeypatch.setattr(hashgrid, "gather_rows", spy)
    table = torch.zeros(ts.total_params, ts.level_dim)
    hashgrid.hash_encode_01(torch.rand(17, 3), table, ts)
    assert calls == [(s, (8, 17)) for s in ts.sizes]


def test_init_params_range():
    _, ts = _specs(ENCODE_CASES[0])
    t = hashgrid.init_params(torch.Generator().manual_seed(0), ts, std=0.5)
    assert t.shape == (ts.total_params, ts.level_dim)
    assert t.dtype == torch.float32 and float(t.abs().max()) <= 0.5
    assert float(t.std()) > 0.2


def test_trunc_exp_matches_jax():
    x = np.concatenate([np.linspace(-40, 40, 161),
                        [-15.0, 15.0, 0.0]]).astype(np.float32)
    want = np.asarray(jactivation.trunc_exp(jnp.asarray(x)))
    got = trunc_exp(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert float(got.max()) == pytest.approx(np.exp(15.0), rel=1e-6)
    bf = trunc_exp(torch.from_numpy(x).bfloat16())
    assert bf.dtype == torch.float32


@pytest.mark.parametrize("name", ["hashgrid", "tiledgrid", "frequency", "sh",
                                  "None"])
def test_get_encoder_matches_jax(name):
    kw = dict(num_levels=4, level_dim=2, base_resolution=4,
              log2_hashmap_size=8, desired_resolution=64)
    jp, japply, jdim = jencoding.get_encoder(name, 3, **kw)
    tp, tapply, tdim = encoding.get_encoder(name, 3, **kw)
    assert tdim == jdim
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    if name == "sh":
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
    if jp is not None:
        assert tuple(tp.shape) == tuple(jp.shape)
        tp = torch.from_numpy(rng.uniform(-1, 1, tp.shape).astype(np.float32))
        jp = jnp.asarray(tp.numpy())
    want = np.asarray(japply(jp, jnp.asarray(x)))
    got = tapply(tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# the hash-grid family's fields
# ---------------------------------------------------------------------------

def tiny_hashgrid(mask_type="lightweight_mask", num_steps=(16, 8, 4),
                  table_scale=1.0, **mc_kw):
    """(JAX model, port model, JAX params, port params) of a small hash-grid
    model with the SAM and mask heads, tables drawn U(-scale, scale) and
    non-trivial samvit biases and norm; weights carried across by
    params_from_jax."""
    kw = dict(field_type="hashgrid", grid_num_levels=4, grid_log2_hashmap=10,
              grid_desired_resolution=64, prop_num_levels=3,
              prop_log2_hashmap=8, prop_resolutions=(32, 64),
              s_grid_num_levels=4, s_grid_log2_hashmap=10,
              s_grid_desired_resolution=64, with_sam=True,
              sam_feat_dim=32, samvit_mlp_hidden=32, n_inst=3)
    if mask_type is not None:
        kw.update(with_mask=True, mask_mlp_type=mask_type)
    kw.update(mc_kw)
    jmc = JModelConfig(**kw)
    jrc = JRenderConfig(num_steps=num_steps, bound=4.0, contract=True)
    jm = jfields.make_model(jmc, jrc)
    tm = fields.make_model(
        config_from_dict(ModelConfig, dataclasses.asdict(jmc)),
        config_from_dict(RenderConfig, dataclasses.asdict(jrc)))
    jp = jfields.init_params(jm, jax.random.key(0))
    rng = np.random.default_rng(5)

    def u(shape):
        return jnp.asarray(rng.uniform(-table_scale, table_scale, shape),
                           jnp.float32)

    for k in ("grid", "s_grid", "m_grid"):
        if k in jp:
            jp[k] = u(jp[k].shape)
    for p in jp["prop"]:
        p["grid"] = u(p["grid"].shape)
    for p in jp.get("samvit_mlp", []):
        p["b"] = jnp.asarray(rng.normal(0, 0.1, p["b"].shape), jnp.float32)
    if "samvit_norm" in jp:
        jp["samvit_norm"] = {
            "w": jnp.asarray(rng.uniform(0.5, 1.5, (jmc.sam_feat_dim,)),
                             jnp.float32),
            "b": jnp.asarray(rng.normal(0, 0.1, (jmc.sam_feat_dim,)),
                             jnp.float32)}
    return jm, tm, jp, params_from_jax(flatten_tree(jp, "params/"), tm)


def test_make_model_specs_equal_jax():
    jm, tm, _, _ = tiny_hashgrid()
    assert not tm.is_mlp_field
    for a, b in ((tm.grid_spec, jm.grid_spec), (tm.s_grid_spec, jm.s_grid_spec),
                 (tm.m_grid_spec, jm.m_grid_spec)):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert [dataclasses.asdict(s) for s in tm.prop_specs] == \
        [dataclasses.asdict(s) for s in jm.prop_specs]
    for prop in ("grid_out_dim", "prop_in_dim", "s_feat_dim", "m_feat_dim",
                 "samvit_in_dim", "color_dim"):
        assert getattr(tm, prop) == getattr(jm, prop), prop


def test_init_params_has_the_jax_tree():
    jm, tm, jp, _ = tiny_hashgrid()
    tp = fields.init_params(tm, torch.Generator().manual_seed(0))
    jflat = {k: tuple(v.shape) for k, v in flatten_tree(jp, "").items()}

    def flat(t, prefix=""):
        out = {}
        items = t.items() if isinstance(t, dict) else enumerate(t)
        for k, v in items:
            key = f"{prefix}{k}"
            out.update(flat(v, key + "/") if isinstance(v, (dict, list))
                       else {key: tuple(v.shape)})
        return out

    assert flat(tp) == jflat
    assert float(tp["grid"].abs().max()) <= 1e-4


def _points(n, seed, lo=-2.2, hi=2.2):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(
        np.float32)


def test_forward_matches_jax():
    jm, tm, jp, tp = tiny_hashgrid()
    x = _points(200, 6)
    d = np.random.default_rng(7).normal(0, 1, (200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref = jfields.forward(jm, jp, jnp.asarray(x), jnp.asarray(d))
    got = fields.forward(tm, tp, torch.from_numpy(x), torch.from_numpy(d))
    for k in ("sigma", "geo_feat", "color", "grid_output"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **TOL)
    assert float(got["grid_output"].std()) > 0.1  # the tables matter


@pytest.mark.parametrize("proposal", [0, 1, -1])
def test_density_matches_jax(proposal):
    jm, tm, jp, tp = tiny_hashgrid()
    x = _points(200, 8)
    ref = jfields.density(jm, jp, jnp.asarray(x), proposal=proposal)
    got = fields.density(tm, tp, torch.from_numpy(x), proposal=proposal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("mask_type", ["default", "lightweight_mask"])
def test_sam_and_mask_features_match_jax(mask_type):
    jm, tm, jp, tp = tiny_hashgrid(mask_type)
    x = _points(100, 9)
    for fn in ("sam_features", "mask_grid_features"):
        ref = getattr(jfields, fn)(jm, jp, jnp.asarray(x))
        got = getattr(fields, fn)(tm, tp, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), err_msg=fn,
                                   **TOL)
    assert tm.m_feat_dim == (128 if mask_type == "default" else 32)


def test_bf16_params_match_jax():
    """The served cast: bf16 tables and weights, float32 features."""
    jm, tm, jp, tp = tiny_hashgrid(None)
    jb, tb = jfields.cast_params(jp), fields.cast_params(tp)
    x = _points(150, 10)
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (150, 1))
    ref = jfields.forward(jm, jb, jnp.asarray(x), jnp.asarray(d))
    got = fields.forward(tm, tb, torch.from_numpy(x), torch.from_numpy(d))
    for k in ("sigma", "geo_feat"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got["grid_output"].numpy(),
                               np.asarray(ref["grid_output"]), **TOL)
