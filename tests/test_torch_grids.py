"""Parity: the port's factorized grids (ops/cpgrid.py ladders, ops/vmgrid.py,
the VM / ladder / sigma-VM branches of ops/fused_mlp_t.py) against the JAX
package on the same numpy inputs: the lookups at 1e-5, the fused field
chain's plain version against JAX `run_tmlp(..., interpret=True)` at 3e-4
in float32 and the composite at 1e-3 (the bounds of
tests/test_fused_mlp_t.py)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_tpu.ops import cpgrid as jcp
from sanerf_tpu.ops import fused_mlp_t as jfm
from sanerf_tpu.ops import vmgrid as jvm
from sanerf_tpu_torch.ops import cpgrid, vmgrid
from sanerf_tpu_torch.ops import fused_mlp_t as tfm

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "port_tools"))
import grid_params  # noqa: E402  (the served grid configurations)

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
BOUND = 2.0


def _rng(seed):
    return np.random.default_rng(seed)


def _points(n, seed, bound=BOUND):
    x = _rng(seed).uniform(-bound, bound, (n, 3))
    x[0] = [-bound, bound, 0.0]  # the grid's ends
    x[1] = [bound, -bound, bound]
    return x.astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("res,levels", [(512, 4), (64, 2), (40, 3), (8, 1),
                                        (256, 1)])
def test_level_resolutions(res, levels):
    assert (cpgrid.level_resolutions(res, levels)
            == jcp.level_resolutions(res, levels))


@pytest.mark.parametrize("weights", [None, (1.0, 0.25, 0.5)])
def test_line_features_multi_matches_jax(weights):
    rng = _rng(0)
    levels = [rng.normal(0, 1, (3, r, k)).astype(np.float32)
              for r, k in ((16, 4), (32, 6), (64, 3))]
    x = _points(301, seed=1)
    lw = None if weights is None else np.asarray(weights, np.float32)
    ref = jcp.line_features_multi([jnp.asarray(l) for l in levels],
                                  jnp.asarray(x), BOUND,
                                  level_weights=None if lw is None
                                  else jnp.asarray(lw), lookup="gather")
    got = cpgrid.line_features_multi([_t(l) for l in levels],
                                     torch.from_numpy(x), BOUND,
                                     level_weights=None if lw is None
                                     else torch.from_numpy(lw))
    assert got.shape == (301, 13)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("R,Rl,K", [(8, 8, 4), (16, 11, 3), (5, 20, 8)])
def test_vm_features_gather_matches_jax(R, Rl, K):
    """Rl != R: lines at their own resolution."""
    rng = _rng(R + Rl + K)
    planes = rng.normal(0, 1, (3, R, R, K)).astype(np.float32)
    lines = rng.normal(0, 1, (3, Rl, K)).astype(np.float32)
    x = _points(257, seed=2)
    ref = jvm.vm_features_gather(jnp.asarray(planes), jnp.asarray(lines),
                                 jnp.asarray(x), BOUND)
    got = vmgrid.vm_features_gather(_t(planes), _t(lines),
                                    torch.from_numpy(x), BOUND)
    assert got.shape == (257, 3 * K)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # and the kernel's plain VM read (its own affine) against the same
    np.testing.assert_allclose(
        tfm._vm_plain(_t(planes), _t(lines), torch.from_numpy(x),
                      BOUND).numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("weights", [None, (0.5, 1.0)])
def test_vm_features_multi_matches_jax(weights):
    rng = _rng(3)
    planes = [rng.normal(0, 1, (3, r, r, 4)).astype(np.float32)
              for r in (16, 32)]
    lines = [rng.normal(0, 1, (3, r, 4)).astype(np.float32)
             for r in (16, 32)]
    x = _points(199, seed=4)
    lw = None if weights is None else np.asarray(weights, np.float32)
    ref = jvm.vm_features_multi(
        [jnp.asarray(p) for p in planes], [jnp.asarray(l) for l in lines],
        jnp.asarray(x), BOUND,
        level_weights=None if lw is None else jnp.asarray(lw))
    got = vmgrid.vm_features_multi(
        [_t(p) for p in planes], [_t(l) for l in lines], torch.from_numpy(x),
        BOUND, level_weights=None if lw is None else torch.from_numpy(lw))
    assert got.shape == (199, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_init_vm_shapes_match_jax():
    import jax

    g = torch.Generator().manual_seed(0)
    shapes = lambda f: jax.eval_shape(f, jax.random.key(0))  # noqa: E731
    for got, ref in ((vmgrid.init_vm(g, 12, 5, line_res=7),
                      shapes(lambda k: jvm.init_vm(k, 12, 5, line_res=7))),
                     (vmgrid.init_vm_multi(g, 64, 16, 2),
                      shapes(lambda k: jvm.init_vm_multi(k, 64, 16, 2)))):
        gp, gl = got
        rp, rl = ref
        if isinstance(rp, list):
            assert [tuple(p.shape) for p in gp] == [p.shape for p in rp]
            assert [tuple(l.shape) for l in gl] == [l.shape for l in rl]
        else:
            assert (tuple(gp.shape), tuple(gl.shape)) == (rp.shape, rl.shape)
    with pytest.raises(ValueError):
        vmgrid.init_vm_multi(g, 64, 15, 2)


# -- the fused field chain ------------------------------------------------------
# (name, CP levels [(R, K)], VM levels [(R, Rl, K)], sigma-CP (R, K),
#  sigma-VM (R, Rl, K)); Fourier L = 4, widths 32, depth 3, skip at 1
GRIDS = {
    "vm": ([], [(8, 8, 4)], None, None),
    "vm_rl": ([], [(8, 12, 3)], None, None),
    "cp_ladder": ([(16, 4), (32, 4)], [], None, None),
    "vm_ladder": ([(16, 6)], [(16, 16, 8), (32, 32, 8)], None, None),
    "sigma": ([(16, 8)], [(8, 8, 2)], (24, 6), (16, 16, 3)),
    "sigma_vm_only": ([], [], None, (12, 9, 5)),
}


def _field(name, seed=0, L=4, width=32, depth=3):
    """-> (JAX layers, JAX grid kwargs, the port's TransposedFieldMLP) of
    one grid configuration, numpy-seeded tables, float32."""
    import jax

    from sanerf_tpu.models import fields as jfields

    cps, vms, scp, svm = GRIDS[name]
    rng = _rng(seed)
    tab = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    cp = [tab(3, R, K) for R, K in cps]
    vm = [(tab(3, R, R, K), tab(3, Rl, K)) for R, Rl, K in vms]
    kc = sum(K for _, K in cps) + sum(3 * K for _, _, K in vms)
    F = 3 * (1 + 2 * L)
    layers = jfields.init_skip_mlp(jax.random.key(seed), F + kc, 16, width,
                                   depth, (depth // 2,), bias=False)
    jkw = dict(cp_lines=[jnp.asarray(t) for t in cp] or None,
               vm_planes=[jnp.asarray(p) for p, _ in vm] or None,
               vm_lines=[jnp.asarray(l) for _, l in vm] or None)
    tkw = dict(cp_lines=[_t(t) for t in cp] or None,
               vm_planes=[_t(p) for p, _ in vm] or None,
               vm_lines=[_t(l) for _, l in vm] or None)
    if scp is not None:
        s = tab(3, *scp)
        jkw["sigma_cp_lines"], tkw["sigma_cp_lines"] = jnp.asarray(s), _t(s)
    if svm is not None:
        R, Rl, K = svm
        p, l = tab(3, R, R, K), tab(3, Rl, K)
        jkw["sigma_vm_planes"], jkw["sigma_vm_lines"] = (jnp.asarray(p),
                                                         jnp.asarray(l))
        tkw["sigma_vm_planes"], tkw["sigma_vm_lines"] = _t(p), _t(l)
    tm = tfm.TransposedFieldMLP(
        [{"w": _t(p["w"])} for p in layers], L, BOUND, (depth // 2,),
        leaky=True, **tkw)
    return layers, jkw, tm


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_run_tmlp_plain_matches_jax(name):
    layers, jkw, tm = _field(name)
    x = _points(45, seed=5)
    ref = np.asarray(jfm.run_tmlp(jnp.asarray(x.T), layers, 4, BOUND, (1,),
                                  leaky=True, block=16, interpret=True,
                                  transposed=True, **jkw))
    got = tfm.run_tmlp(torch.from_numpy(x.T.copy()), tm, transposed=True)
    assert got.shape == (16, 45)
    np.testing.assert_allclose(got.numpy(), ref[:16], rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("name", ["vm_ladder", "sigma"])
@pytest.mark.parametrize("opaque", [True, False])
def test_run_tmlp_composite_plain_matches_jax(name, opaque):
    import jax

    from sanerf_tpu.models import fields as jfields

    layers, jkw, tm = _field(name, seed=1)
    view = jfields.init_mlp(jax.random.key(5), 31, 3, 32, 3, bias=False)
    N, T = 8, 4
    rng = _rng(6)
    x = _points(N * T, seed=7)
    dl = rng.uniform(0.05, 0.3, (N, T)).astype(np.float32)
    ts = np.cumsum(dl, axis=1).astype(np.float32)
    r8 = np.concatenate([rng.normal(0, 0.5, (N, 3)), rng.normal(0, 1, (N, 3)),
                         np.zeros((N, 2))], 1).astype(np.float32)
    ref = jfm.run_tmlp_composite(
        jnp.asarray(x.T), jnp.asarray(dl), jnp.asarray(ts), layers, 4, BOUND,
        (1,), leaky=True, opaque=opaque, interpret=True,
        rays8=jnp.asarray(r8), view_layers=view, sh_degree=4, **jkw)
    vm = tfm.ViewMLP([{"w": _t(p["w"])} for p in view], 16, 4)
    got = tfm.run_tmlp_composite(torch.from_numpy(x.T.copy()), _t(dl),
                                 _t(ts), tm, opaque=opaque, view=vm,
                                 rays8=_t(r8))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0])[:, :16],
                               rtol=1e-3, atol=1e-3, err_msg="gsum")
    for what, g, r in zip(("depth", "wsum", "rgb"), got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-3,
                                   atol=1e-3, err_msg=what)


def test_grid_descriptor_and_packing():
    """The encoding width and the kernel's grid descriptor: fixed slots of
    INLINE_LEVELS levels, each level's (R, K) / (R, Rl, K), affine and
    table address in its slot, empty slots and absent tables zero; a
    ladder's levels past the slots in an array in device memory
    (TransposedFieldMLP.grid_levels), in order."""
    import ctypes

    _, _, tm = _field("sigma")
    assert tm.kc == 8 + 3 * 2
    flat, desc = tm.packed(torch.device("cpu"))
    assert desc[4] == 48  # ke: 27 + 14 -> 48
    g = tfm.grids_of(tm)
    assert (g.n_cp, g.n_vm, g.n_cp_more, g.n_vm_more) == (1, 1, 0, 0)
    assert g.cp_more is None and g.vm_more is None
    assert (g.cp[0].table, g.cp[0].R, g.cp[0].K) == (tm.cp[0].data_ptr(),
                                                     16, 8)
    assert (g.cp[0].s, g.cp[0].o) == tfm._scale_off(16, BOUND)
    assert not any(g.cp[i].table or g.vm[i].planes
                   for i in range(1, tfm.INLINE_LEVELS))
    v = g.vm[0]
    assert (v.planes, v.lines, v.R, v.Rl, v.K) == (
        tm.vm[0][0].data_ptr(), tm.vm[0][1].data_ptr(), 8, 8, 2)
    assert (g.scp.table, g.scp.R, g.scp.K) == (tm.scp.data_ptr(), 24, 6)
    assert (g.svm.lines, g.svm.R, g.svm.Rl, g.svm.K) == (
        tm.svm[1].data_ptr(), 16, 16, 3)
    assert (g.svm.s, g.svm.o, g.svm.sl, g.svm.ol) == (
        *tfm._scale_off(16, BOUND), *tfm._scale_off(16, BOUND))
    # the C struct's layout: 8 B of counts, 24 B a CP and 48 B a VM level,
    # then the counts and addresses of the levels past the slots
    assert ctypes.sizeof(tfm.Grids) == 8 + 24 * 9 + 48 * 9 + 8 + 16
    _, _, no_sigma = _field("vm_rl")
    g = tfm.grids_of(no_sigma)
    assert g.scp.table is None and g.svm.planes is None and g.n_cp == 0
    assert tm.table_bytes == 4 * (3 * 16 * 8 + 3 * (64 + 8) * 2 + 3 * 24 * 6
                                  + 3 * (256 + 16) * 3)
    # ladders of 11 CP and 10 VM levels: 8 of each in the slots, the rest
    # in device memory, CP then VM
    cps = [torch.randn(3, 4 + i, 2) for i in range(11)]
    vms = [(torch.randn(3, 4 + i, 4 + i, 1), torch.randn(3, 5 + i, 1))
           for i in range(10)]
    kc = 2 * 11 + 3 * 10
    ladder = tfm.TransposedFieldMLP(
        [{"w": torch.zeros(27 + kc, 16)}], 4, BOUND,
        cp_lines=cps, vm_planes=[p for p, _ in vms],
        vm_lines=[l for _, l in vms])
    g = tfm.grids_of(ladder, torch.device("cpu"))
    assert (g.n_cp, g.n_vm, g.n_cp_more, g.n_vm_more) == (8, 8, 3, 2)
    assert [g.cp[i].R for i in range(8)] == list(range(4, 12))
    levels = ladder.grid_levels(torch.device("cpu"))
    assert g.cp_more == levels.data_ptr()
    assert g.vm_more == g.cp_more + 3 * ctypes.sizeof(tfm._Grid)
    raw = bytes(levels.numpy())
    assert len(raw) == 3 * ctypes.sizeof(tfm._Grid) + 2 * ctypes.sizeof(
        tfm._VMGrid)
    for i in range(3):
        c = tfm._Grid.from_buffer_copy(raw, i * ctypes.sizeof(tfm._Grid))
        assert (c.table, c.R, c.K) == (cps[8 + i].data_ptr(), 12 + i, 2)
        assert (c.s, c.o) == tfm._scale_off(12 + i, BOUND)
    for i in range(2):
        v = tfm._VMGrid.from_buffer_copy(
            raw, 3 * ctypes.sizeof(tfm._Grid)
            + i * ctypes.sizeof(tfm._VMGrid))
        assert (v.planes, v.lines, v.R, v.Rl, v.K) == (
            vms[8 + i][0].data_ptr(), vms[8 + i][1].data_ptr(), 12 + i,
            13 + i, 1)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_encode_probes_read_the_encoding_back(name):
    """fused_mlp_t.encode_probes: one-layer nets whose outputs are the
    field's encoding columns, 15 a probe, and row 0 its sigma sum alone;
    the kernels are held feature by feature through them on the card."""
    layers, jkw, tm = _field(name)
    x = torch.from_numpy(_points(45, seed=8).T.copy())
    probes = tfm.encode_probes(tm)
    width = tm.F + tm.kc
    assert len(probes) == -(-width // 15)
    got = torch.cat([tfm.run_tmlp(x, p, transposed=True)[1:]
                     for p in probes])
    xs = x.T
    z = xs * tm.scale
    assert torch.equal(got[:3], z.T)
    cols = [tfm._cp_plain(t, xs, BOUND) for t in tm.cp]
    cols += [tfm._vm_plain(p, l, xs, BOUND) for p, l in tm.vm]
    if cols:
        np.testing.assert_array_equal(got[tm.F:width].numpy(),
                                      torch.cat(cols, 1).T.numpy())
    assert not got[width:].any()
    sig = torch.zeros(45)
    if tm.scp is not None:
        sig = sig + tfm._cp_plain(tm.scp, xs, BOUND).sum(1)
    if tm.svm is not None:
        sig = sig + tfm._vm_plain(*tm.svm, xs, BOUND).sum(1)
    for p in probes:
        np.testing.assert_allclose(tfm.run_tmlp(x, p, transposed=True)[0],
                                   sig, rtol=1e-6, atol=1e-6)


# -- the renderer ------------------------------------------------------------------
_SMALL = dict(mlp_enc_freqs=4, mlp_field_width=32, mlp_field_depth=4,
              mlp_prop_enc_freqs=3, mlp_prop_width=16, mlp_prop_depth=2,
              prop_resolutions=(16,))
#: the configurations of the JAX suite's fast-vs-XLA tests
#: (tests/test_vmgrid.py:395-475, tests/test_cpgrid.py:221,
#: tests/test_sigma_grid.py:160-183)
RUN_RAYS = {
    "vm_cp": dict(_SMALL, mlp_vm_rank=4, mlp_vm_res=8, mlp_cp_rank=6,
                  mlp_cp_res=16),
    "vm": dict(_SMALL, mlp_vm_rank=3, mlp_vm_res=8),
    "vm_ladder_sigma_cp": dict(_SMALL, mlp_vm_rank=4, mlp_vm_res=16,
                               mlp_vm_levels=2, mlp_cp_rank=6, mlp_cp_res=16,
                               mlp_sigma_cp_rank=4, mlp_sigma_cp_res=16,
                               mlp_field_depth=3),
    "cp_ladder": dict(_SMALL, mlp_cp_rank=8, mlp_cp_res=32, mlp_cp_levels=2),
    "sigma": grid_params.SIGMA,
    "sigma_cp_vm": grid_params.SIGMA_VM,
}
_TABLES = ("cp_lines", "vm_planes", "vm_lines", "sigma_cp_lines",
           "sigma_vm_planes", "sigma_vm_lines")


def _render_pair(kw, seed, **rc_kw):
    """(JAX model, port model, JAX params, port params) of one grid
    configuration with cp_fused; the tables redrawn N(0, 1) with numpy, so
    that the grid features move the frame."""
    import dataclasses

    import jax

    from sanerf_tpu.config import ModelConfig as JModelConfig
    from sanerf_tpu.config import RenderConfig as JRenderConfig
    from sanerf_tpu.models import fields as jfields
    from sanerf_tpu.train.checkpoints import flatten_tree, unflatten_like
    from sanerf_tpu_torch.config import (ModelConfig, RenderConfig,
                                         config_from_dict)
    from sanerf_tpu_torch.models import fields
    from sanerf_tpu_torch.models.asset import params_from_jax

    jmc = JModelConfig(field_type="mlp", **kw)
    jrc = JRenderConfig(num_steps=(8, 4), bound=4.0, contract=True,
                        cp_fused=True, **rc_kw)
    jm = jfields.make_model(jmc, jrc)
    tm = fields.make_model(
        config_from_dict(ModelConfig, dataclasses.asdict(jmc)),
        config_from_dict(RenderConfig, dataclasses.asdict(jrc)))
    jp = jfields.init_params(jm, jax.random.key(seed))
    flat = flatten_tree(jp, "")
    rng = _rng(seed)
    for k in sorted(flat):
        if k.split("/")[0] in _TABLES:
            flat[k] = rng.standard_normal(flat[k].shape).astype(np.float32)
    jp = unflatten_like(jp, {k: jnp.asarray(v) for k, v in flat.items()}, "")
    tp = params_from_jax({"params/" + k: np.asarray(v)
                          for k, v in flat.items()}, tm)
    return jm, tm, jp, tp


def _render_rays(n, seed):
    rng = _rng(seed)
    o = np.zeros((n, 3), np.float32) + np.float32([0.0, 0.0, 2.0])
    o += rng.normal(0, 0.1, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3))
    d[:, 2] -= 2.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


@pytest.mark.parametrize("name", sorted(RUN_RAYS))
def test_run_rays_matches_jax_cp_fused(name):
    """The port's fast path (the kernels' plain versions on the CPU) against
    JAX run_rays with cp_fused=True (its Pallas kernels in interpret mode,
    _vm_block / _cp_level per level / the sigma sums in the kernel body),
    at the JAX suite's 2e-3; and the port's fast path against its plain
    path, the same bound."""
    import dataclasses

    from sanerf_tpu.models import renderer as jrenderer
    from sanerf_tpu_torch.models import renderer

    jm, tm, jp, tp = _render_pair(RUN_RAYS[name], seed=3)
    assert renderer.uses_kernels(tm)
    o, d = _render_rays(24, seed=4)
    ref = jrenderer.run_rays(jm, jp, jnp.asarray(o), jnp.asarray(d))
    got = renderer.run_rays(tm, tp, torch.from_numpy(o), torch.from_numpy(d))
    slow = renderer.run_rays(
        dataclasses.replace(tm, render_cfg=dataclasses.replace(
            tm.render_cfg, use_fused_mlp=False)),
        tp, torch.from_numpy(o), torch.from_numpy(d))
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=2e-3, atol=2e-3, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), slow[k].numpy(),
                                   rtol=2e-3, atol=2e-3, err_msg=k)
    assert float(np.asarray(ref["depth"]).std()) > 1e-3  # not a flat frame


def test_grid_budget_routes_to_the_plain_path():
    """Tables over RenderConfig.grid_vmem_budget: uses_kernels is False on
    both sides, and the cp_fused render equals use_fused_mlp=False exactly
    (tests/test_vmgrid.py:478-507); a ladder within the budget stays fast."""
    import dataclasses

    from sanerf_tpu.config import ModelConfig as JModelConfig
    from sanerf_tpu.config import RenderConfig as JRenderConfig
    from sanerf_tpu.models import fields as jfields
    from sanerf_tpu_torch.config import ModelConfig, RenderConfig
    from sanerf_tpu_torch.models import fields, renderer

    kw = dict(field_type="mlp", mlp_vm_rank=32, mlp_vm_res=1024,
              mlp_vm_levels=4, mlp_enc_freqs=4, mlp_field_width=32,
              mlp_field_depth=3, mlp_prop_enc_freqs=3, mlp_prop_width=16,
              mlp_prop_depth=2, prop_resolutions=(16,))
    rkw = dict(num_steps=(8, 4), bound=4.0, contract=True, cp_fused=True)
    for res, fast in ((1024, False), (32, True)):
        big = dict(kw, mlp_vm_res=res)
        jm = jfields.make_model(JModelConfig(**big), JRenderConfig(**rkw))
        tm = fields.make_model(ModelConfig(**big), RenderConfig(**rkw))
        assert tm.grid_table_bytes == jm.grid_table_bytes
        assert (tm.grid_table_bytes <= 6 * 2 ** 20) == fast
        assert renderer.uses_kernels(tm) == fast
        assert (jm.grid_table_bytes <= JRenderConfig().grid_vmem_budget
                ) == fast
    tp = fields.init_params(tm := fields.make_model(ModelConfig(**kw),
                                                    RenderConfig(**rkw)),
                            torch.Generator().manual_seed(0))
    assert isinstance(tp["vm_planes"], list) and len(tp["vm_planes"]) == 4
    o, d = (torch.from_numpy(a) for a in _render_rays(16, seed=5))
    a = renderer.run_rays(tm, tp, o, d)
    b = renderer.run_rays(dataclasses.replace(
        tm, render_cfg=dataclasses.replace(tm.render_cfg,
                                           use_fused_mlp=False)), tp, o, d)
    for k in ("image", "depth", "weights_sum"):
        assert torch.equal(a[k], b[k]), k


def test_mismatched_vm_levels_raise():
    _, _, tm = _field("vm_ladder")
    ws = [{"w": w} for w in tm.ws]
    with pytest.raises(ValueError, match="as many levels"):
        tfm.TransposedFieldMLP(ws, 4, BOUND, (1,), leaky=True,
                               cp_lines=tm.cp, vm_planes=[p for p, _ in tm.vm],
                               vm_lines=[tm.vm[0][1]])
    with pytest.raises(ValueError, match="do not match"):
        tfm.TransposedFieldMLP(ws, 4, BOUND, (1,), leaky=True,
                               cp_lines=tm.cp,
                               vm_planes=[p for p, _ in tm.vm],
                               vm_lines=[l[:, :, :4] for _, l in tm.vm])
