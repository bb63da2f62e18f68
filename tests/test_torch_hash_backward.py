"""The hash grid's table gradient in one launch a grid (ops/hashgrid.py:
hash_grid_backward, csrc/hashgrid.cu) on the CPU, where the wrapper takes
its plain version, against the JAX package and against the route it
replaces on the training step.

Tolerances, each with its reason:
  - against `jax.grad` of sanerf_tpu/ops/hashgrid.py:hash_encode_01 in the
    table: |d| <= 1e-6 S + 1e-6 |ref| + 1e-7 at every element, S the sum of
    the magnitudes of the adds into it (the plain version with |g|). XLA's
    scatter-add sums the adds in another order than index_add_, and a
    float32 sum of n terms in another order moves by at most ~n 2^-24 S
    (n <= ~40 adds a row here). The adds themselves are the same float32
    products but for one rounding: XLA on the CPU may round x res - 0.5
    twice where the port rounds it once (as the card does), which moves
    frac by an ulp of x res; that changes a smoothstep weight near a cell
    face (3 frac^2) relatively, by 6.5e-4 of an add of 3e-6 here, so the
    floor has an absolute part, 1e-7 (the differences it covers are under
    3e-9);
  - against the route it replaces (the taps of every level and one
    gather_rows_backward a level, whose plain version is index_add_ in the
    same corner-major order): bit for bit;
  - the encode's forward on the new route against the encode without a
    gradient: bit for bit (the same function).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_tpu.config import HashGridConfig as JHashGridConfig
from sanerf_tpu.ops import hashgrid as jhg
from sanerf_tpu_torch.config import (HashGridConfig, ModelConfig,
                                     RenderConfig, TrainConfig)
from sanerf_tpu_torch.models import fields
from sanerf_tpu_torch.ops import gather, hashgrid
from sanerf_tpu_torch.train import state

torch.set_num_threads(1)

#: (gridtype, interpolation, align_corners, D, C, max_level): every value of
#: each option at least twice, in a covering set rather than the product
CASES = [
    ("hash", "linear", False, 3, 2, None),
    ("hash", "linear", False, 3, 1, None),
    ("hash", "smoothstep", False, 3, 8, None),
    ("tiled", "linear", True, 3, 2, None),
    ("tiled", "smoothstep", True, 2, 1, None),
    ("hash", "linear", True, 2, 8, 2),
    ("hash", "smoothstep", False, 2, 2, 3),
    ("tiled", "linear", False, 3, 8, 2),
    ("hash", "linear", True, 3, 4, None),
    ("tiled", "smoothstep", False, 2, 3, None),
]


def _cfg(gridtype, interp, align, D, C):
    return dict(input_dim=D, num_levels=5, level_dim=C, base_resolution=4,
                log2_hashmap_size=9 if D == 3 else 7, desired_resolution=48,
                gridtype=gridtype, interpolation=interp, align_corners=align)


def _specs(kw):
    return (hashgrid.build_spec(HashGridConfig(**kw)),
            jhg.build_spec(JHashGridConfig(**kw)))


def _inputs(spec, n=257, seed=3):
    """numpy points (some outside the unit cube), table, output gradient."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.05, 1.05, (n, spec.input_dim)).astype(np.float32)
    table = rng.uniform(-1, 1, (spec.total_params, spec.level_dim))
    g = rng.normal(0, 1, (n, spec.output_dim)).astype(np.float32)
    return x, table.astype(np.float32), g


def _id(case):
    return "-".join(str(v) for v in case)


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_plain_matches_jax(case):
    *kw, max_level = case
    spec, jspec = _specs(_cfg(*kw))
    x, table, g = _inputs(spec)

    def jf(tab):
        return jnp.sum(jhg.hash_encode_01(jnp.asarray(x), tab, jspec,
                                          max_level) * jnp.asarray(g))

    ref = np.asarray(jax.grad(jf)(jnp.asarray(table)))
    n = None if max_level is None else min(max_level, spec.num_levels)
    got = hashgrid.hash_grid_backward(torch.from_numpy(x),
                                      torch.from_numpy(g), spec, n).numpy()
    mag = hashgrid.hash_grid_backward_plain(
        torch.from_numpy(x), torch.from_numpy(np.abs(g)), spec, n).numpy()
    assert got.shape == ref.shape and (mag > 0).any()
    assert (np.abs(got - ref) <= 1e-6 * mag + 1e-6 * np.abs(ref) + 1e-7
            ).all()
    if max_level is not None:  # the inactive levels get nothing
        assert not got[spec.offsets[max_level]:].any()


def _level_route(x, table, g, spec, n):
    """The table's gradient as the route it replaces computes it: every
    level's taps, one gather_rows_backward (index_add_ on the CPU) a
    level into one zero gradient (ops/gather.py:gather_row_ranges)."""
    t = torch.from_numpy(table).requires_grad_(True)
    xg = torch.from_numpy(x).requires_grad_(True)  # takes that route
    (hashgrid.hash_encode_01(xg, t, spec, n) * torch.from_numpy(g)
     ).sum().backward()
    return t.grad


@pytest.mark.parametrize("case", CASES[:6], ids=[_id(c) for c in CASES[:6]])
def test_plain_is_the_level_route(case):
    *kw, max_level = case
    spec, _ = _specs(_cfg(*kw))
    x, table, g = _inputs(spec, seed=4)
    got = hashgrid.hash_grid_backward_plain(torch.from_numpy(x),
                                            torch.from_numpy(g), spec,
                                            max_level)
    ref = _level_route(x, table, g, spec, max_level)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


@pytest.mark.parametrize("case", CASES[:4], ids=[_id(c) for c in CASES[:4]])
def test_hash_encode_route(case, monkeypatch):
    """With a table that needs a gradient and points that do not, the
    forward is bit for bit the encode without a gradient, autograd keeps
    the points alone, and the backward is one hash_grid_backward call and
    no gather_rows_backward call."""
    *kw, max_level = case
    spec, _ = _specs(_cfg(*kw))
    x, table, g = _inputs(spec, n=301, seed=5)
    calls = {"fused": 0, "level": 0}
    real_f, real_l = hashgrid.hash_grid_backward, gather.gather_rows_backward

    def fused(*a):
        calls["fused"] += 1
        return real_f(*a)

    def level(*a):
        calls["level"] += 1
        return real_l(*a)

    monkeypatch.setattr(hashgrid, "hash_grid_backward", fused)
    monkeypatch.setattr(gather, "gather_rows_backward", level)
    xt = torch.from_numpy(x).reshape(7, 43, spec.input_dim)  # any prefix
    t = torch.from_numpy(table).requires_grad_(True)
    out = hashgrid.hash_encode_01(xt, t, spec, max_level)
    with torch.no_grad():
        ref = hashgrid.hash_encode_01(xt, t, spec, max_level)
    assert out.shape == (7, 43, spec.output_dim)
    np.testing.assert_array_equal(out.detach().numpy(), ref.numpy())
    node = out.grad_fn.next_functions[0][0]  # under the prefix's reshape
    assert [tuple(s.shape) for s in node.saved_tensors] == [
        (301, spec.input_dim)]
    (out * torch.from_numpy(g).reshape(7, 43, -1)).sum().backward()
    assert calls == {"fused": 1, "level": 0}
    np.testing.assert_array_equal(
        t.grad.numpy(),
        hashgrid.hash_grid_backward_plain(torch.from_numpy(x),
                                          torch.from_numpy(g), spec,
                                          max_level).numpy())


def test_training_step_one_backward_a_grid(monkeypatch):
    """A hash-grid training step with proposal updates: one
    hash_grid_backward call for each of its three grids, no
    gather_rows_backward call; without proposal updates one."""
    model = fields.make_model(
        ModelConfig(field_type="hashgrid", grid_num_levels=6,
                    grid_log2_hashmap=12, grid_desired_resolution=128,
                    prop_num_levels=3, prop_log2_hashmap=10,
                    prop_resolutions=(32, 64)),
        RenderConfig(num_steps=(12, 8, 6), bound=2.0))
    tc = TrainConfig(num_rays=48, adaptive_num_rays=False)
    params = fields.init_params(model, torch.Generator().manual_seed(0),
                                "cpu")
    gen = torch.Generator().manual_seed(1)
    rng = np.random.default_rng(2)
    batch = {"rays_o": torch.from_numpy(rng.normal(0, 0.2, (48, 3))
                                        .astype(np.float32)),
             "rays_d": torch.from_numpy(rng.normal(0, 1, (48, 3))
                                        .astype(np.float32)),
             "images": torch.from_numpy(rng.uniform(0, 1, (48, 3))
                                        .astype(np.float32))}
    seen, levels = [], []
    real_f, real_l = hashgrid.hash_grid_backward, gather.gather_rows_backward

    def fused(x01, g, spec, n):
        seen.append(spec)
        return real_f(x01, g, spec, n)

    def level(*a):
        levels.append(a)
        return real_l(*a)

    monkeypatch.setattr(hashgrid, "hash_grid_backward", fused)
    monkeypatch.setattr(gather, "gather_rows_backward", level)
    monkeypatch.setattr(hashgrid, "gather_rows_backward", level)
    for update, grids in ((True, 3), (False, 1)):
        seen.clear()
        draws = state.draw_step(model, tc, 48, gen)
        _, _, grads = state.loss_and_grads(model, tc, params, batch, draws,
                                           0, update)
        assert len(seen) == grids and not levels
        assert seen[0] == model.grid_spec
        assert bool(grads["grid"].abs().sum() > 0)


def test_point_gradient_keeps_jax_semantics():
    """Points that need a gradient take the level route: the points' and
    the table's gradients are JAX's."""
    spec, jspec = _specs(_cfg("hash", "smoothstep", False, 3, 2))
    x, table, g = _inputs(spec, n=97, seed=6)
    x = np.clip(x, 0.01, 0.99)  # the points' gradient is defined

    def jf(xx, tab):
        return jnp.sum(jhg.hash_encode_01(xx, tab, jspec) * jnp.asarray(g))

    jdx, jdt = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x),
                                           jnp.asarray(table))
    before = gather.gather_rows_backward.launches
    xt = torch.from_numpy(x).requires_grad_(True)
    t = torch.from_numpy(table).requires_grad_(True)
    (hashgrid.hash_encode_01(xt, t, spec) * torch.from_numpy(g)).sum(
    ).backward()
    assert gather.gather_rows_backward.launches == before  # the CPU's
    scale = float(np.abs(jdx).max())
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), rtol=1e-4,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jdt), rtol=1e-5,
                               atol=1e-5)


def test_wrapper_refuses_and_takes_the_plain_version_on_the_cpu():
    spec, _ = _specs(_cfg("hash", "linear", False, 3, 2))
    x, _, g = _inputs(spec, n=50)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    before = hashgrid.hash_grid_backward.launches
    got = hashgrid.hash_grid_backward(xt, gt, spec)
    assert hashgrid.hash_grid_backward.launches == before
    np.testing.assert_array_equal(
        got.numpy(), hashgrid.hash_grid_backward_plain(xt, gt, spec).numpy())
    with pytest.raises(ValueError):
        hashgrid.hash_grid_backward(xt, gt.to(torch.bfloat16), spec)
    with pytest.raises(ValueError):
        hashgrid.hash_grid_backward(xt, gt[:, :-1], spec)
    with pytest.raises(ValueError):
        hashgrid.hash_grid_backward(xt[:, :2], gt, spec)
    for kw in (dict(level_dim=16), dict(input_dim=4, log2_hashmap_size=8),
               dict(num_levels=40, per_level_scale=1.05,
                    log2_hashmap_size=8)):
        wide = hashgrid.build_spec(HashGridConfig(**kw))
        xw = torch.rand(20, wide.input_dim)
        gw = torch.randn(20, wide.output_dim)
        with pytest.raises(NotImplementedError, match="queue B"):
            hashgrid.hash_grid_backward(xw, gw, wide)
        assert not hashgrid.backward_takes(wide, wide.num_levels)
        # the encode routes such a grid to the level route, which takes it
        t = torch.randn(wide.total_params, wide.level_dim,
                        requires_grad=True)
        (hashgrid.hash_encode_01(xw, t, wide) * gw).sum().backward()
        np.testing.assert_array_equal(
            t.grad.numpy(),
            hashgrid.hash_grid_backward_plain(xw, gw, wide).numpy())


def test_bf16_table_keeps_the_level_route():
    """The kernel adds float32 only: a bfloat16 table that needs a
    gradient keeps the level route (its plain version on the CPU)."""
    spec, _ = _specs(_cfg("hash", "linear", False, 3, 2))
    x, table, g = _inputs(spec, n=40)
    t = torch.from_numpy(table).to(torch.bfloat16).requires_grad_(True)
    out = hashgrid.hash_encode_01(torch.from_numpy(x), t, spec)
    (out * torch.from_numpy(g)).sum().backward()
    assert t.grad.dtype == torch.bfloat16 and bool(t.grad.abs().sum() > 0)
