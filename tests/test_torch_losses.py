"""Parity: the training side of the port's ops against the JAX package on
the same numpy inputs, values and gradients.

Tolerances, each with its reason:
  - the losses and their gradients against `jax.grad`: 1e-6 relative (the
    same float32 operations; XLA's CPU cumsum is a triangular matmul, a
    sum in another order);
  - `trunc_exp`'s gradient at -20, 0, 20: exact to float32 (one product);
  - the hash encoder's table gradient through the plain gather (index_add_
    against XLA's scatter-add): 1e-5;
  - the regularizer gradients: 1e-6;
  - the resamplers (`linresize`, `resize_vm`, `resize_grid_tables`): 1e-5.
    jnp.linspace's float32 sample positions are an ulp away from those of
    any closed form tried (its iota / div, start (1 - s) + stop s, under
    XLA's rewrites), which moves a resampled value by up to 4e-6 at
    |values| <= 4;
  - the dense take and the bisection: exact.
"""

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
from sanerf_tpu.ops import activation as jact
from sanerf_tpu.ops import cpgrid as jcp
from sanerf_tpu.ops import hashgrid as jhg
from sanerf_tpu.ops import losses as jlosses
from sanerf_tpu.ops import sampling as jsampling
from sanerf_tpu.ops import vmgrid as jvm
from sanerf_tpu.train import checkpoints as jckpt
from sanerf_tpu_torch.config import (HashGridConfig, ModelConfig,
                                     RenderConfig, config_from_dict)
from sanerf_tpu_torch.models import fields
from sanerf_tpu_torch.models.asset import params_from_jax
from sanerf_tpu_torch.ops import activation, cpgrid, gather, hashgrid
from sanerf_tpu_torch.ops import losses, sampling, vmgrid
from sanerf_tpu_torch.train.checkpoints import flatten_tree

torch.set_num_threads(1)
REL = dict(rtol=1e-6, atol=1e-7)
TIGHT = dict(rtol=1e-6, atol=1e-6)
RESAMPLE = dict(rtol=1e-5, atol=1e-5)


def _t(a, requires_grad=False):
    return torch.tensor(np.asarray(a, np.float32),
                        requires_grad=requires_grad)


def _hist(seed, n=37, t=24):
    """Sorted bin edges [n, t + 1] in [0, 1] and positive weights [n, t]."""
    rng = np.random.default_rng(seed)
    edges = np.sort(rng.uniform(0, 1, (n, t + 1)), axis=-1)
    edges[:, 0], edges[:, -1] = 0.0, 1.0
    w = rng.uniform(0, 1, (n, t)) ** 3
    w[::5] = 0.0  # rays that see nothing
    return edges.astype(np.float32), (w / 3.0).astype(np.float32)


def test_searchsorted_and_dense_take_exact():
    rng = np.random.default_rng(0)
    seq = np.sort(rng.uniform(0, 1, (9, 17)), -1).astype(np.float32)
    vals = rng.uniform(-0.1, 1.1, (9, 13)).astype(np.float32)
    vals[0, :4] = seq[0, :4]  # ties go right
    got = sampling.searchsorted_right(_t(seq), _t(vals))
    ref = np.asarray(jsampling.searchsorted_right(seq, vals))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    idx = rng.integers(0, 17, (9, 13)).astype(np.int32)
    got = sampling.take_by_index_dense(_t(seq), torch.from_numpy(idx))
    ref = np.asarray(jsampling.take_by_index_dense(seq, idx))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_distort_loss_and_grad_match_jax():
    bins, w = _hist(1)
    ref, (gb, gw) = jax.value_and_grad(jlosses.distort_loss, (0, 1))(
        jnp.asarray(bins), jnp.asarray(w))
    tb, tw = _t(bins, True), _t(w, True)
    got = losses.distort_loss(tb, tw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), **REL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), **TIGHT)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), **TIGHT)


@pytest.mark.parametrize("levels", [1, 2])
def test_proposal_loss_and_grad_match_jax(levels):
    """Proposal levels of 24 and 16 bins against a final level of 12; the
    final level's histogram gets no gradient."""
    hists = [_hist(10 + i, t=t) for i, t in
             enumerate((24, 16, 12)[-(levels + 1):])]

    def jloss(ws):
        return jlosses.proposal_loss([jnp.asarray(b) for b, _ in hists], ws)

    ref, gref = jax.value_and_grad(jloss)([jnp.asarray(w) for _, w in hists])
    tws = [_t(w, True) for _, w in hists]
    got = losses.proposal_loss([_t(b) for b, _ in hists], tws)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), **REL)
    for tw, g in zip(tws[:-1], gref[:-1]):
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(g), **TIGHT)
    assert tws[-1].grad is None and not np.asarray(gref[-1]).any()


def test_entropy_loss_and_grad_match_jax():
    ws = np.random.default_rng(3).uniform(-0.1, 1.1, 301).astype(np.float32)
    ref, g = jax.value_and_grad(jlosses.entropy_loss)(jnp.asarray(ws))
    t = _t(ws, True)
    got = losses.entropy_loss(t)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), **REL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TIGHT)


def test_trunc_exp_gradient_exact_past_the_clamp():
    """Past +-15 the gradient is g exp(+-15), not 0 (a clamp's own
    gradient would be 0)."""
    x = np.asarray([-20.0, 0.0, 20.0], np.float32)
    gout = np.asarray([0.5, 2.0, 1.5], np.float32)
    _, vjp = jax.vjp(jact.trunc_exp, jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(gout))[0])
    t = _t(x, True)
    y = activation.trunc_exp(t)
    y.backward(torch.from_numpy(gout))
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(jact.trunc_exp(jnp.asarray(x))))
    np.testing.assert_array_equal(t.grad.numpy(), ref)
    assert t.grad[0] > 0 and t.grad[2] > 0


SPECS = {
    "hash": dict(num_levels=4, level_dim=2, base_resolution=8,
                 log2_hashmap_size=9, desired_resolution=64),
    "tiled_c4": dict(num_levels=3, level_dim=4, base_resolution=4,
                     log2_hashmap_size=8, desired_resolution=32,
                     gridtype="tiled"),
}


def _specs(name):
    kw = SPECS[name]
    return (hashgrid.build_spec(HashGridConfig(**kw)),
            jhg.build_spec(JHashGridConfig(**kw)))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_hash_encode_table_grad_matches_jax(name):
    """The gradient of sum(encode * r) in the table, through
    hash_grid_backward (its plain version, index_add_, on the CPU),
    against jax.grad through jnp.take."""
    spec, jspec = _specs(name)
    rng = np.random.default_rng(5)
    table = rng.uniform(-1, 1, (spec.total_params, spec.level_dim))
    table = table.astype(np.float32)
    x = rng.uniform(-0.05, 1.05, (211, 3)).astype(np.float32)
    r = rng.normal(0, 1, (211, spec.output_dim)).astype(np.float32)

    def jf(tab):
        return jnp.sum(jhg.hash_encode_01(jnp.asarray(x), tab, jspec)
                       * jnp.asarray(r))

    ref = np.asarray(jax.grad(jf)(jnp.asarray(table)))
    t = _t(table, True)
    (hashgrid.hash_encode_01(torch.from_numpy(x), t, spec)
     * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), ref, rtol=1e-5, atol=1e-5)
    with torch.no_grad():  # the inference path gives the same encode
        a = hashgrid.hash_encode_01(torch.from_numpy(x), t, spec)
    b = hashgrid.hash_encode_01(torch.from_numpy(x), t, spec)
    np.testing.assert_array_equal(a.numpy(), b.detach().numpy())


def test_gather_row_ranges_backward_adds_at_offsets():
    """Two ranges of one table: each range's output gradient lands at its
    row offset; indices outside a range add nothing."""
    table = torch.zeros(10, 3, requires_grad=True)
    i0 = torch.tensor([[0, 3], [3, 7]], dtype=torch.int32)
    i1 = torch.tensor([1, 1, 4, -1], dtype=torch.int32)
    g0 = torch.arange(12.0).reshape(2, 2, 3)
    g1 = torch.ones(4, 3)
    r0, r1 = gather.gather_row_ranges(table, [(0, 4), (4, 6)], [i0, i1])
    ((r0 * g0).sum() + (r1 * g1).sum()).backward()
    ref = np.zeros((10, 3), np.float32)
    np.add.at(ref, [0, 3], g0[0].numpy())
    np.add.at(ref, [3], g0[1, 0:1].numpy())  # 7 is outside range 0
    np.add.at(ref, [5, 5, 8], g1[:3].numpy())
    np.testing.assert_array_equal(table.grad.numpy(), ref)


def test_gather_rows_backward_plain_is_index_add():
    rng = np.random.default_rng(2)
    grad = rng.normal(0, 1, (50, 4)).astype(np.float32)
    idx = rng.integers(-3, 53, (7, 9)).astype(np.int32)
    gout = rng.normal(0, 1, (7, 9, 4)).astype(np.float32)
    ref = grad.copy()
    ok = (idx >= 0) & (idx < 50)
    np.add.at(ref, idx[ok], gout[ok])
    t = torch.from_numpy(grad.copy())
    got = gather.gather_rows_backward(t, torch.from_numpy(idx),
                                      torch.from_numpy(gout))
    assert got is t
    np.testing.assert_allclose(t.numpy(), ref, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        gather.gather_rows_backward(t, torch.from_numpy(idx),
                                    torch.from_numpy(gout[:, :3]))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_hashgrid_regularizer_grads_match_jax(name):
    spec, jspec = _specs(name)
    rng = np.random.default_rng(7)
    table = rng.normal(0, 1, (spec.total_params, spec.level_dim))
    table = table.astype(np.float32)
    x01 = rng.uniform(-0.02, 1.02, (513, 3)).astype(np.float32)
    ref = np.asarray(jhg.grad_total_variation(jnp.asarray(x01),
                                              jnp.asarray(table), jspec,
                                              0.3))
    got = hashgrid.grad_total_variation(_t(x01), _t(table), spec, 0.3)
    np.testing.assert_allclose(got.numpy(), ref, **TIGHT)
    ref = np.asarray(jhg.grad_weight_decay(jnp.asarray(table), jspec, 0.1))
    got = hashgrid.grad_weight_decay(_t(table), spec, 0.1)
    np.testing.assert_allclose(got.numpy(), ref, **TIGHT)


@pytest.mark.parametrize("R,new,axis", [(16, 32, 1), (17, 9, 1), (8, 8, 1),
                                        (12, 25, 2)])
def test_linresize_matches_jax(R, new, axis):
    t = np.random.default_rng(R).normal(0, 1, (3, R, R, 2))
    t = t.astype(np.float32)
    ref = np.asarray(jcp.linresize(jnp.asarray(t), new, axis=axis))
    got = cpgrid.linresize(_t(t), new, axis=axis)
    np.testing.assert_allclose(got.numpy(), ref, **RESAMPLE)


def test_grid_training_ops_match_jax():
    rng = np.random.default_rng(4)
    planes = rng.normal(0, 1, (3, 12, 12, 3)).astype(np.float32)
    lines = rng.normal(0, 1, (3, 9, 3)).astype(np.float32)
    for a, b in zip(vmgrid.resize_vm(_t(planes), _t(lines), 20),
                    jvm.resize_vm(jnp.asarray(planes), jnp.asarray(lines),
                                  20)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **RESAMPLE)
    np.testing.assert_allclose(
        cpgrid.grad_total_variation(_t(lines), 0.7).numpy(),
        np.asarray(jcp.grad_total_variation(jnp.asarray(lines), 0.7)),
        **TIGHT)
    np.testing.assert_allclose(
        vmgrid.grad_total_variation_planes(_t(planes), 0.7).numpy(),
        np.asarray(jvm.grad_total_variation_planes(jnp.asarray(planes),
                                                   0.7)), **TIGHT)
    for alpha in (0.0, 0.3, 1.0):
        np.testing.assert_allclose(
            cpgrid.anneal_level_weights(torch.tensor(alpha), 4).numpy(),
            np.asarray(jcp.anneal_level_weights(jnp.float32(alpha), 4)),
            **TIGHT)


#: a ladder model with every factorized table (the sigma grids and the
#: CP / VM ladders of tests/test_sigma_grid.py and tests/test_vmgrid.py)
GRID_MC = dict(mlp_enc_freqs=3, mlp_field_width=16, mlp_field_depth=4,
               mlp_prop_enc_freqs=2, mlp_prop_width=16, mlp_prop_depth=2,
               prop_resolutions=(16,), mlp_cp_rank=8, mlp_cp_res=32,
               mlp_cp_levels=2, mlp_vm_rank=4, mlp_vm_res=16,
               mlp_vm_levels=2, mlp_sigma_cp_rank=6, mlp_sigma_cp_res=24,
               mlp_sigma_vm_rank=3, mlp_sigma_vm_res=16)
HASH_MC = dict(field_type="hashgrid", grid_num_levels=4,
               grid_log2_hashmap=10, grid_desired_resolution=64,
               prop_num_levels=3, prop_log2_hashmap=8, prop_resolutions=(32,))


def _models(kw):
    jrc = JRenderConfig(num_steps=(8, 4), bound=4.0)
    jmc = JModelConfig(**kw)
    model = fields.make_model(
        config_from_dict(ModelConfig, dataclasses.asdict(jmc)),
        config_from_dict(RenderConfig, dataclasses.asdict(jrc)))
    jmodel = jfields.make_model(jmc, jrc)
    jp = jfields.init_params(jmodel, jax.random.key(3))
    flat = jckpt.flatten_tree(jp, "params/")
    return model, jmodel, params_from_jax(flat, model, "cpu"), jp


def _same_tree(got, ref, tol):
    a = flatten_tree(got)
    b = jckpt.flatten_tree(ref)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], err_msg=k, **tol)


@pytest.mark.parametrize("kw", [GRID_MC, HASH_MC], ids=["grids", "hash"])
def test_field_regularizers_and_resize_match_jax(kw):
    model, jmodel, params, jp = _models(kw)
    x01 = np.random.default_rng(1).uniform(0, 1, (257, 3))
    x01 = x01.astype(np.float32)
    _same_tree(fields.apply_total_variation(model, params, _t(x01), 1e-2),
               jfields.apply_total_variation(jmodel, jp, jnp.asarray(x01),
                                             1e-2), TIGHT)
    _same_tree(fields.apply_weight_decay(model, params, 0.2),
               jfields.apply_weight_decay(jmodel, jp, 0.2), TIGHT)
    _same_tree(fields.apply_l1_sparsity(model, params, 0.2),
               jfields.apply_l1_sparsity(jmodel, jp, 0.2), TIGHT)
    assert fields.grid_resolutions(params) == jfields.grid_resolutions(jp)
    if model.is_mlp_field:
        targets = {"cp": 64, "vm": 8, "sigma_cp": 12, "sigma_vm": 32}
        _same_tree(fields.resize_grid_tables(model, params, targets),
                   jfields.resize_grid_tables(jmodel, jp, targets), RESAMPLE)
