"""The limits of the port's kernels lifted to what the JAX package's Pallas
path takes (ROADMAP queue C): rays past 128 samples (L1), more than 8
layers (L2), layers past 256 wide (L3), view heads past 32 (L4),
composites of more than 16 outputs (L5), ladders past 8 levels (L6) and
tables past 25 MB (L7).

Two kinds of check, both on the CPU:
  - the guards the wrappers launch through (`fused_mlp_t.kernel_plan`,
    `ray_kernels.ray_plan`) take every configuration of those rows at its
    full width, on every kernel launch its frame makes, and name
    ROADMAP.md's queue B past the limits that stay;
  - the plain versions (the CPU's route, and what the kernels are held to
    on the card) against the JAX package's kernels in interpret mode at
    small widths, at the JAX suite's bounds: the ray kernels 1e-5, the
    chain 2e-4, the composite 1e-3, run_rays frames 2e-3.
The kernels themselves are held against the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_tpu.config import ModelConfig as JModelConfig
from sanerf_tpu.config import RenderConfig as JRenderConfig
from sanerf_tpu.models import fields as jfields
from sanerf_tpu.models import renderer as jrenderer
from sanerf_tpu.ops import fused_mlp_t as jfm
from sanerf_tpu.ops import ray_kernels as jrk
from sanerf_tpu.train.checkpoints import flatten_tree
from sanerf_tpu_torch.config import ModelConfig, RenderConfig, config_from_dict
from sanerf_tpu_torch.models import fields, renderer
from sanerf_tpu_torch.models.asset import (expected_shapes, load_asset,
                                           params_from_jax)
from sanerf_tpu_torch.ops import fused_mlp_t as tfm
from sanerf_tpu_torch.ops import ray_kernels as trk

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "port_tools"))

from grid_params import CONFIGS as GRID_CONFIGS  # noqa: E402
from grid_params import LIMITS  # noqa: E402

ASSET = os.path.join(ROOT, "assets", "serving_student")

#: the configurations of the lifted limits (name -> ModelConfig fields or
#: "asset", and the RenderConfig fields), each at its full width: the
#: asset past 128 samples a ray, and port_tools/grid_params.py:LIMITS
LIFTED = {"L1 asset (256, 128, 64)": ("asset", {"num_steps": (256, 128, 64)}),
          "L1 asset (128, 256)": ("asset", {"num_steps": (128, 256)}),
          **LIMITS}


def _model_and_nets(name, dtype):
    """The configuration's model and its kernel nets (zero weights of the
    full shapes; the asset's own)."""
    mkw, rkw = LIFTED[name]
    if mkw == "asset":
        mc, rc, params = load_asset(ASSET, device="cpu")
        model = fields.make_model(mc, dataclasses.replace(rc, **rkw))
    else:
        model = fields.make_model(ModelConfig(**mkw), RenderConfig(**rkw))
        params = params_from_jax(
            {"params/" + k: np.zeros(s, np.float32)
             for k, s in expected_shapes(model).items()}, model)
    return model, fields.KernelNets(model, fields.cast_params(params, dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(LIFTED))
def test_guards_take_every_lifted_configuration(name, dtype):
    """Every kernel launch of the configuration's frame has a plan within
    the card's shared memory: each level's ray kernel, the proposal nets'
    and the field's run_tmlp, and the final level's composite with the
    view head in the kernel (RenderConfig's default). Under the former
    limits each of these configurations raised on the card alone."""
    model, nets = _model_and_nets(name, dtype)
    assert renderer.uses_kernels(model)
    steps = model.render_cfg.num_steps
    for level, T in enumerate(steps):
        if level == 0:
            plan = trk.ray_plan(T)
            assert max(plan["tile_smem"], plan["warp_smem"]) \
                <= trk.SMEM_LIMIT
        else:
            for up in (False, True):
                plan = trk.ray_plan(T, steps[level - 1], uniform_prev=up)
                assert plan["warps"] >= 1 and plan["rays"] >= 1
        if level < len(steps) - 1:
            p = tfm.kernel_plan(nets.props[level])
            assert p.small or p.total <= tfm.SMEM_LIMIT
    p = tfm.kernel_plan(nets.field)
    assert 0 < p.total <= tfm.SMEM_LIMIT
    T = steps[-1]
    for view in (nets.view, None):
        p = tfm.kernel_plan(nets.field, T, view)
        assert 0 < p.total <= tfm.SMEM_LIMIT
        assert p.nseg * p.M >= T and (p.nseg == 1 or p.R == 1)
        # the general composite exactly where the served one cannot go:
        # long rays, more outputs, a wider view head, parked chunks
        needs = (T > 128 or nets.field.kout > 16 or p.park_chunks > 0
                 or (view is not None and view.H > 32))
        assert bool(p.general) == needs or (p.general and p.nseg > 1)


def test_guards_name_queue_b_past_the_limits_that_stay():
    """The limits that stay (ROADMAP queue B): 32 layers (the layer table
    is a kernel parameter), layers 512 wide, composites of 64 outputs,
    view heads 128 wide, rays whose rows fill the shared memory. Each
    raises NotImplementedError naming ROADMAP.md's queue B, and the
    configuration just inside each is taken."""
    def net(depth=3, width=32, kout=16):
        sizes = ([(27, width)] + [(width, width)] * (depth - 2)
                 + [(width, kout)])
        return tfm.TransposedFieldMLP([{"w": torch.zeros(i, o)}
                                       for i, o in sizes], 4, 2.0)

    def view(H, geo=15):
        return tfm.ViewMLP([{"w": torch.zeros(geo + 16, H)},
                            {"w": torch.zeros(H, H)},
                            {"w": torch.zeros(H, 3)}], geo + 1, 4)

    cases = [(lambda: net(depth=32), lambda: net(depth=33)),
             (lambda: net(width=512), lambda: net(width=528)),
             ]
    for ok, bad in cases:
        tfm.kernel_plan(ok())
        with pytest.raises(NotImplementedError, match="ROADMAP.md, queue B"):
            tfm.kernel_plan(bad())
    tfm.kernel_plan(net(kout=64), 32)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, queue B"):
        tfm.kernel_plan(net(kout=80), 32)
    tfm.kernel_plan(net(), 32, view(128))
    with pytest.raises(NotImplementedError, match="ROADMAP.md, queue B"):
        tfm.kernel_plan(net(), 32, view(144))
    trk.ray_plan(4096)
    trk.ray_plan(1024, 4096)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, queue B"):
        trk.ray_plan(8192)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, queue B"):
        trk.ray_plan(1024, 16384)


def test_guard_plans_the_served_launches_as_before():
    """The asset's served launches keep their plans: the served epilogue
    (not the general one), whole rays a step, the weights all in shared
    memory, four warpgroups in the bf16 composite."""
    mc, rc, params = load_asset(ASSET, device="cpu")
    model = fields.make_model(mc, rc)
    nets = fields.KernelNets(model, fields.cast_params(params,
                                                       torch.bfloat16))
    for T, M, R, wgs in ((16, 64, 4, 4), (32, 64, 2, 4), (64, 64, 1, 4),
                         (24, 192, 8, 3), (12, 192, 16, 3)):
        p = tfm.kernel_plan(nets.field, T, nets.view)
        assert (p.general, p.nseg, p.M, p.R, p.wgs, p.w_mode) == (
            0, 1, M, R, wgs, tfm.W_ALL)
    assert tfm.kernel_plan(nets.props[0]).small
    assert trk.ray_plan(32)["R"] == 32 and trk.ray_plan(128)["R"] == 8
    assert trk.ray_plan(16, 32) == dict(
        warps=8, rays=32, warp_smem=8 * 4 * (4 * 32 + 17 + 2),
        thread_smem=32 * 4 * (33 + 17 + 33))


# -- the plain versions against the JAX kernels (interpret mode) ------------


def _to_torch(layers, dtype=torch.float32):
    return [{"w": torch.tensor(np.asarray(p["w"], np.float32)).to(dtype)}
            for p in layers]


def _points(n, bound, seed):
    return np.random.default_rng(seed).uniform(-bound, bound, (n, 3)).astype(
        np.float32)


def _rays8(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 0.5, (n, 3))
    d = rng.normal(0, 1, (n, 3))
    near = rng.uniform(0.2, 0.6, (n, 1))
    far = near + rng.uniform(1, 8, (n, 1))
    sp = lambda x: np.where(x < 1, x / 2, 1 - 1 / (2 * x))  # noqa: E731
    return np.concatenate([o, d, sp(near), sp(far)], 1).astype(np.float32)


def _held_level(got, ref, r8):
    """A level against JAX's at the resample's bound, 1e-5: the s-space
    edges, and the metric geometry (ts, dl, x3) computed from JAX's own
    edges, each delta at the scale of the two edges it differences
    (|d| <= 1e-5 + 1e-5 |ts|). spacing_fn_inv's slope near the far end
    (2 / (2 - 2s)^2, over 100 there) turns a last-bit difference of s,
    which XLA's CPU code (contracted multiply-adds) and PyTorch's round
    apart, into 1e-5 of a delta an edge of 5 wide."""
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-5, atol=1e-5, err_msg="bins")
    ts, dl, x3 = trk._level_body(torch.from_numpy(r8),
                                 torch.from_numpy(np.array(ref[0])), True)
    np.testing.assert_allclose(ts.numpy(), np.asarray(ref[1]), rtol=1e-5,
                               atol=1e-5, err_msg="ts")
    np.testing.assert_array_less(
        np.abs(dl.numpy() - np.asarray(ref[2])),
        1e-5 + 1e-5 * np.abs(np.asarray(ref[1])) + 1e-12, err_msg="dl")
    np.testing.assert_allclose(x3.numpy(), np.asarray(ref[3]), rtol=1e-5,
                               atol=1e-5, err_msg="x3")


@pytest.mark.parametrize("T", [129, 200, 256])
@pytest.mark.parametrize("jittered", [False, True])
def test_long_level0_matches_jax(T, jittered):
    """L1: ray_level0 past 128 samples a ray."""
    N = 6
    r8 = _rays8(N, T)
    jit = ((np.random.default_rng(T + 1).uniform(0, 1, (N, T + 1)) - 0.5)
           / T).astype(np.float32) if jittered else None
    ref = jrk.ray_level0(jnp.asarray(r8), T, True, interpret=True,
                         jitter=None if jit is None else jnp.asarray(jit))
    got = trk.ray_level0(torch.from_numpy(r8), T, True,
                         jitter=None if jit is None else torch.from_numpy(jit))
    _held_level(got, ref, r8)


@pytest.mark.parametrize("T0,T", [(129, 200), (200, 129), (64, 256),
                                  (256, 64)])
@pytest.mark.parametrize("uniform_prev", [False, True])
def test_long_level_matches_jax(T0, T, uniform_prev):
    """L1: ray_level's resample past 128 samples on either side."""
    N = 6
    r8 = _rays8(N, T0 + T)
    b0 = np.asarray(jrk.ray_level0(jnp.asarray(r8), T0, True,
                                   interpret=True)[0])
    w = (np.random.default_rng(T0).uniform(0, 1, (N, T0)) ** 4).astype(
        np.float32)
    w[0] = 0.0
    ref = jrk.ray_level(jnp.asarray(r8), jnp.asarray(w), jnp.asarray(b0), T,
                        True, uniform_prev=uniform_prev, interpret=True)
    got = trk.ray_level(torch.from_numpy(r8), torch.from_numpy(w),
                        torch.from_numpy(b0), T, True,
                        uniform_prev=uniform_prev)
    _held_level(got, ref, r8)


def _composite(layers, view_layers, N, T, seed, kout=16, geo=15,
               cp_lines=None):
    """The port's composite (plain on the CPU) and the JAX kernel's in
    interpret mode on the same operands -> (got, ref)."""
    rng = np.random.default_rng(seed)
    x = _points(N * T, 2.0, seed + 1)
    dl = rng.uniform(0.01, 0.1, (N, T)).astype(np.float32)
    ts = np.cumsum(dl, axis=1).astype(np.float32)
    r8 = np.concatenate([rng.normal(0, 1, (N, 6)), np.zeros((N, 2))],
                        1).astype(np.float32)
    ref = jfm.run_tmlp_composite(
        jnp.asarray(x.T), jnp.asarray(dl), jnp.asarray(ts), layers, 4, 2.0,
        (1,), leaky=True, interpret=True,
        rays8=None if view_layers is None else jnp.asarray(r8),
        view_layers=view_layers,
        cp_lines=None if cp_lines is None else jnp.asarray(cp_lines))
    tm = tfm.TransposedFieldMLP(
        _to_torch(layers), 4, 2.0, (1,), leaky=True,
        cp_lines=None if cp_lines is None else torch.from_numpy(cp_lines))
    vm = (None if view_layers is None
          else tfm.ViewMLP(_to_torch(view_layers), kout, 4))
    got = tfm.run_tmlp_composite(
        torch.from_numpy(x.T.copy()), torch.from_numpy(dl),
        torch.from_numpy(ts), tm, view=vm,
        rays8=None if vm is None else torch.from_numpy(r8))
    return got, ref


def _held_composite(got, ref, kout):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0])[:, :kout],
                               rtol=1e-3, atol=1e-3)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.parametrize("T", [129, 200])
def test_long_ray_composite_matches_jax(T):
    """L1: the composite of rays of 129 and 200 samples with the view
    head (the kernel runs them in segments, carrying the sums)."""
    layers = jfields.init_skip_mlp(jax.random.key(T), 27, 16, 32, 3, (1,),
                                   bias=False)
    view = jfields.init_mlp(jax.random.key(T + 1), 31, 3, 32, 3, bias=False)
    _held_composite(*_composite(layers, view, 5, T, T), 16)


@pytest.mark.parametrize("depth", [12, 16])
def test_deep_chain_matches_jax(depth):
    """L2: chains of 12 and 16 layers with the skip at depth // 2."""
    layers = jfields.init_skip_mlp(jax.random.key(depth), 27, 16, 32, depth,
                                   (depth // 2,), bias=False)
    x = _points(40, 2.0, depth)
    ref = np.asarray(jfm.run_tmlp(jnp.asarray(x), layers, 4, 2.0,
                                  (depth // 2,), leaky=True, block=16,
                                  interpret=True))
    tm = tfm.TransposedFieldMLP(_to_torch(layers), 4, 2.0, (depth // 2,),
                                leaky=True)
    got = tfm.run_tmlp(torch.from_numpy(x), tm)
    np.testing.assert_allclose(got.numpy(), ref[:16], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("width", [272, 320])
def test_wider_chain_matches_jax(width):
    """L3: layers of three chunks (272 = 128 + 128 + 16, 320)."""
    layers = jfields.init_skip_mlp(jax.random.key(width), 27, 16, width, 4,
                                   (2,), bias=False)
    x = _points(32, 2.0, width)
    ref = np.asarray(jfm.run_tmlp(jnp.asarray(x), layers, 4, 2.0, (2,),
                                  leaky=True, block=16, interpret=True))
    tm = tfm.TransposedFieldMLP(_to_torch(layers), 4, 2.0, (2,), leaky=True)
    got = tfm.run_tmlp(torch.from_numpy(x), tm)
    np.testing.assert_allclose(got.numpy(), ref[:16], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("H", [48, 128])
def test_wide_view_composite_matches_jax(H):
    """L4: view heads 48 and 128 wide in the composite's epilogue."""
    layers = jfields.init_skip_mlp(jax.random.key(H), 27, 16, 32, 3, (1,),
                                   bias=False)
    view = jfields.init_mlp(jax.random.key(H + 1), 31, 3, H, 3, bias=False)
    _held_composite(*_composite(layers, view, 6, 16, H), 16)


@pytest.mark.parametrize("kout", [20, 32])
def test_many_output_composite_matches_jax(kout):
    """L5: composites of 20 and 32 outputs (geom_feat_dim 19 / 31), with
    the view head on their sums and without."""
    layers = jfields.init_skip_mlp(jax.random.key(kout), 27, kout, 32, 3,
                                   (1,), bias=False)
    view = jfields.init_mlp(jax.random.key(kout + 1), kout - 1 + 16, 3, 32,
                            3, bias=False)
    for v in (view, None):
        _held_composite(*_composite(layers, v, 6, 16, kout, kout=kout),
                        kout)


@pytest.mark.parametrize("kind", ["cp", "vm"])
def test_sixteen_level_ladder_matches_jax(kind):
    """L6: a CP ladder and a VM ladder of 16 levels through run_tmlp (the
    JAX kernel's _grid_blocks loops over any number of levels)."""
    from sanerf_tpu_torch.ops.cpgrid import level_resolutions

    rng = np.random.default_rng(16)
    res = level_resolutions(64, 16)
    if kind == "cp":
        cp = [rng.normal(0, 1, (3, r, 2)).astype(np.float32) for r in res]
        kw = {"cp_lines": cp}
        kc = 2 * 16
    else:
        planes = [rng.normal(0, 1, (3, r, r, 1)).astype(np.float32)
                  for r in res]
        lines = [rng.normal(0, 1, (3, r, 1)).astype(np.float32) for r in res]
        kw = {"vm_planes": planes, "vm_lines": lines}
        kc = 3 * 16
    layers = jfields.init_skip_mlp(jax.random.key(17), 27 + kc, 16, 32, 3,
                                   (1,), bias=False)
    x = _points(40, 2.0, 18)
    ref = np.asarray(jfm.run_tmlp(
        jnp.asarray(x), layers, 4, 2.0, (1,), leaky=True, block=16,
        interpret=True, **{k: [jnp.asarray(t) for t in v]
                           for k, v in kw.items()}))
    tm = tfm.TransposedFieldMLP(
        _to_torch(layers), 4, 2.0, (1,), leaky=True,
        **{k: [torch.from_numpy(t) for t in v] for k, v in kw.items()})
    assert len(tm.cp) + len(tm.vm) == 16
    got = tfm.run_tmlp(torch.from_numpy(x), tm)
    np.testing.assert_allclose(got.numpy(), ref[:16], rtol=1e-3, atol=1e-3)


def test_tables_past_25_mb_take_the_kernels():
    """L7: the kernels read the tables from device memory, so no byte
    limit stays: a CP table of 30 MB has a plan, and the quality recipe
    with its budget raised takes the fast path in both packages (JAX's
    predicate, renderer.py:106-116, and the port's uses_kernels)."""
    big = torch.zeros(3, 2 ** 20, 5, dtype=torch.bfloat16)
    tm = tfm.TransposedFieldMLP(
        [{"w": torch.zeros(27 + 5, 32, dtype=torch.bfloat16)},
         {"w": torch.zeros(32, 16, dtype=torch.bfloat16)}], 4, 2.0,
        cp_lines=big)
    assert tm.table_bytes > 25 * 10 ** 6
    assert tfm.kernel_plan(tm).total > 0
    assert tfm.kernel_plan(tm, 32).total > 0
    qr = GRID_CONFIGS["quality_recipe"]
    jm = jfields.make_model(JModelConfig(**qr),
                            JRenderConfig(grid_vmem_budget=2 ** 27))
    tm = fields.make_model(ModelConfig(**qr),
                           RenderConfig(grid_vmem_budget=2 ** 27))
    assert tm.grid_table_bytes == jm.grid_table_bytes == 93_886_464
    assert renderer.uses_kernels(tm)


# -- run_rays frames of the lifted configurations at small widths -----------

FRAMES = {
    "L1 T 130": ({}, {"num_steps": (16, 130)}),
    "L2 depth 12": ({"mlp_field_depth": 12}, {}),
    "L4 view 48": ({"view_mlp_hidden": 48}, {}),
    "L5 geo 19": ({"geom_feat_dim": 19}, {}),
    "L6 CP x 16": ({"mlp_cp_rank": 32, "mlp_cp_res": 64,
                    "mlp_cp_levels": 16}, {}),
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_lifted_frames_match_jax(name):
    """A small field of each lifted kind through run_rays on the fast path
    (the port's plain versions on the CPU, the JAX kernels in interpret
    mode), 2e-3."""
    mkw, rkw = FRAMES[name]
    jmc = JModelConfig(**{**dict(
        field_type="mlp", mlp_field_width=32, mlp_field_depth=4,
        mlp_prop_width=16, mlp_prop_depth=2, mlp_enc_freqs=4,
        mlp_prop_enc_freqs=3), **mkw})
    jrc = JRenderConfig(**{**dict(num_steps=(16, 8), bound=4.0,
                                  contract=True), **rkw})
    jm = jfields.make_model(jmc, jrc)
    tm = fields.make_model(
        config_from_dict(ModelConfig, dataclasses.asdict(jmc)),
        config_from_dict(RenderConfig, dataclasses.asdict(jrc)))
    assert renderer.uses_kernels(tm)
    jp = jfields.init_params(jm, jax.random.key(0))
    tp = params_from_jax(flatten_tree(jp, "params/"), tm)
    rng = np.random.default_rng(19)
    o = rng.normal(0, 0.5, (12, 3)).astype(np.float32)
    d = (-o + 0.3 * rng.normal(0, 1, (12, 3))).astype(np.float32)
    ref = jrenderer.run_rays(jm, jp, jnp.asarray(o), jnp.asarray(d))
    got = renderer.run_rays(tm, tp, torch.from_numpy(o), torch.from_numpy(d))
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=2e-3, atol=2e-3, err_msg=k)


# -- the lifted configurations at full width, 64^2, against the JAX frames --


def _jax_frames():
    """The JAX package's 64^2 frames of the lifted configurations
    (port_tools/jax_limits.jsonl, from port_tools/jax_limits_reference.py;
    the quality recipe's is chip_smoke.py's JAX_GRID, from
    port_tools/jax_grid_reference.py)."""
    import importlib.util
    import json

    with open(os.path.join(ROOT, "port_tools", "jax_limits.jsonl")) as f:
        out = {r["name"]: r for r in map(json.loads, f)}
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    out["L7 quality recipe"] = dict(cs.JAX_GRID["quality_recipe"],
                                    pixels=cs.JAX_GRID["pixels"])
    return out


@pytest.mark.parametrize("name", sorted(LIMITS))
def test_lifted_frames_at_full_width_match_jax(name):
    """Each lifted configuration at its full width: the port's fast path
    (the kernels' plain versions, which the kernels are held to on the
    card) renders the JAX package's 64^2 frame (its XLA path, the same
    numpy-seeded float32 weights of port_tools/grid_params.py) within
    2e-3 abs + 2e-3 rel: the mean of image, depth and weights_sum and
    their values at 8 pixels."""
    from grid_params import frame_rays, make_flat

    ref = _jax_frames()[name]
    mkw, rkw = LIMITS[name]
    model = fields.make_model(ModelConfig(**mkw), RenderConfig(**rkw))
    assert renderer.uses_kernels(model)
    params = params_from_jax(make_flat(expected_shapes(model), 0), model)
    o, d = (torch.from_numpy(a) for a in frame_rays(64))
    out = renderer.run_rays(model, params, o, d)
    px = list(ref["pixels"])
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(
            float(out[k].double().mean()), ref["mean"][k], rtol=2e-3,
            atol=2e-3, err_msg=f"mean {k}")
        np.testing.assert_allclose(out[k][px].double().numpy(),
                                   np.asarray(ref[k]), rtol=2e-3, atol=2e-3,
                                   err_msg=k)
