"""Parity: the port's import distillation (sanerf_tpu_torch/models/
import_distill.py) against the JAX package's, on tests/test_import_distill.
py's tiny teachers (a hash grid with smooth tables, and the MLP-family grid
teacher of test_serving_distill_from_grid_teacher), the JAX weights
carried across by `params_from_jax` and JAX's random draws fed across
(`TargetDraws`, `DistillDraws`).

Tolerances: `student_config`'s fields and the optimizer's labels bit for
bit; `_log_density` / `_match_loss` 1e-6; `build_targets` 1e-5 abs + 1e-5
rel (its points bit for bit); the optimizer against optax 1e-6; 20
distillation steps from JAX's point pool: each of the last step's losses
within 1e-4 relative, `render_psnr` within 0.05 dB; the copied heads bit
for bit. The pool itself depends on the rank order of the teacher's
densities, which float32 rounding can flip for two near-equal values
(test_distill_steps_match_jax counts them).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sanerf_tpu.config import ModelConfig as JModelConfig
from sanerf_tpu.config import RenderConfig as JRenderConfig
from sanerf_tpu.models import fields as jfields
from sanerf_tpu.models import import_distill as jid
from sanerf_tpu.train.checkpoints import flatten_tree
from sanerf_tpu_torch.config import ModelConfig, RenderConfig, config_from_dict
from sanerf_tpu_torch.models import fields
from sanerf_tpu_torch.models import import_distill as tid
from sanerf_tpu_torch.models.asset import params_from_jax
from sanerf_tpu_torch.train.checkpoints import flatten_tree as tflatten

from tests.test_import_distill import _smooth_tables, _tiny_models

torch.set_num_threads(2)
RC = JRenderConfig(num_steps=(16, 8), bound=2.0, contract=True, min_near=0.05)


def _port_model(jmodel):
    return fields.make_model(
        config_from_dict(ModelConfig, dataclasses.asdict(jmodel.cfg)),
        config_from_dict(RenderConfig, dataclasses.asdict(jmodel.render_cfg)))


def _hash_teacher(**kw):
    jm, jp = _tiny_models(**kw)
    jp["grid"] = _smooth_tables(jm.grid_spec, seed=1)
    for i, p in enumerate(jp["prop"]):
        p["grid"] = _smooth_tables(jm.prop_specs[i], seed=2 + i)
    return jm, jp


def _grid_teacher():
    """test_serving_distill_from_grid_teacher's MLP-family teacher."""
    tc = JModelConfig(field_type="mlp", mlp_cp_rank=8, mlp_cp_res=32,
                      mlp_sigma_cp_rank=4, mlp_sigma_cp_res=32,
                      mlp_field_width=32, mlp_field_depth=3,
                      mlp_enc_freqs=4, mlp_prop_enc_freqs=3,
                      mlp_prop_width=16, mlp_prop_depth=2,
                      prop_resolutions=(8, 16))
    jm = jfields.make_model(tc, RC)
    jp = jfields.init_params(jm, jax.random.key(1))
    jp["cp_lines"] = 0.5 * jax.random.normal(jax.random.key(2),
                                             jp["cp_lines"].shape)
    return jm, jp


TEACHERS = {"hashgrid": functools.cache(_hash_teacher),
            "grid": functools.cache(_grid_teacher),
            "hashgrid_heads": functools.cache(lambda: _hash_teacher(
                with_sam=True, with_mask=True, mask_type="lightweight_mask"))}


def _pair(name):
    jm, jp = TEACHERS[name]()
    tm = _port_model(jm)
    return jm, jp, tm, params_from_jax(flatten_tree(jp, "params/"), tm)


def _jax_draws(key, n, batch, iters, bound):
    """The draws jid.distill_to_mlp makes from `key`, as the port's."""
    k_init, k_data, k_train = jax.random.split(key, 3)
    kx, kj, kp = jax.random.split(k_data, 3)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    targets = tid.TargetDraws(
        t(jid._sample_points(kx, n, bound)),
        t(jax.random.normal(kj, (n // 3, 3))),
        t(jax.random.permutation(kp, n)).long())
    n_epochs = max(1, iters // (n // batch))
    perms = [t(jax.random.permutation(jax.random.fold_in(k_train, e),
                                      n)).long() for e in range(n_epochs)]
    return k_init, tid.DistillDraws(targets, perms)


@pytest.mark.parametrize("kw", [
    {}, dict(cp_rank=64, cp_res=128, sigma_cp_rank=32, sigma_cp_res=128,
             width=128, depth=3, prop_width=32, prop_depth=2),
    dict(vm_rank=4, vm_res=8, vm_levels=2, sigma_vm_rank=2, cp_levels=3)])
@pytest.mark.parametrize("teacher", ["hashgrid_heads", "grid"])
def test_student_config_equals_jax(teacher, kw):
    jm, _ = TEACHERS[teacher]()
    tm = _port_model(jm)
    got = dataclasses.asdict(tid.student_config(tm.cfg, **kw))
    assert got == dataclasses.asdict(jid.student_config(jm.cfg, **kw))


def test_log_density_and_match_loss_match_jax():
    rng = np.random.default_rng(0)
    f = rng.normal(0, 8, (257, 5)).astype(np.float32)
    f[:4, 0] = [-40.0, 40.0, 12.5, 30.0]  # past the clip and the cap
    g = rng.normal(0, 8, (257, 5)).astype(np.float32)
    for mlp in (False, True):
        np.testing.assert_allclose(
            tid._log_density(torch.from_numpy(f[:, 0]), mlp).numpy(),
            np.asarray(jid._log_density(jnp.asarray(f[:, 0]), mlp)),
            rtol=1e-6, atol=1e-6)
        for k in (1, 5):
            np.testing.assert_allclose(
                tid._match_loss(torch.from_numpy(f[:, :k]),
                                torch.from_numpy(g[:, :k]), mlp).item(),
                float(jid._match_loss(jnp.asarray(f[:, :k]),
                                      jnp.asarray(g[:, :k]), mlp)),
                rtol=1e-6)


@pytest.mark.parametrize("teacher", ["hashgrid_heads", "grid"])
def test_build_targets_matches_jax(teacher):
    jm, jp, tm, tp = _pair(teacher)
    n = 1 << 10
    key = jax.random.key(4)
    x_ref, t_ref = jid.build_targets(jm, jp, key, n, chunk=256)
    kx, kj, kp = jax.random.split(key, 3)
    draws = tid.TargetDraws(
        torch.from_numpy(np.array(jid._sample_points(kx, n, jm.bound))),
        torch.from_numpy(np.array(jax.random.normal(kj, (n // 3, 3)))),
        torch.from_numpy(np.array(jax.random.permutation(kp, n))).long())
    x, targets = tid.build_targets(tm, tp, draws, chunk=256)
    np.testing.assert_array_equal(x.numpy(), np.asarray(x_ref))
    assert sorted(targets) == sorted(t_ref)
    if teacher == "hashgrid_heads":
        assert set(targets) == {"field", "prop0", "prop1", "sam", "mask"}
    for k, v in t_ref.items():
        np.testing.assert_allclose(targets[k].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_distill_optimizer_matches_optax():
    """The distillation's optimizer (the trainer's Adam at a constant lr)
    against optax's chain on a tree with both labels, over steps that clip
    and steps that do not."""
    rng = np.random.default_rng(1)
    tree = {"cp_lines": rng.normal(0, 1, (3, 8, 4)).astype(np.float32),
            "grid_mlp": [{"w": rng.normal(0, 1, (5, 4)).astype(np.float32)}],
            "sigma_vm_planes": rng.normal(0, 1, (3, 2, 4, 4)).astype(
                np.float32)}
    jt = jax.tree.map(jnp.asarray, tree)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.multi_transform(
        {"lines": optax.adam(10.0 * 2e-3, eps=1e-15),
         "rest": optax.adam(2e-3, eps=1e-15)},
        {"cp_lines": "lines", "grid_mlp": [{"w": "rest"}],
         "sigma_vm_planes": "lines"}))
    st = tx.init(jt)
    tt = jax.tree.map(torch.from_numpy, tree)
    opt = tid.distill_optimizer()
    ts = opt.init(tt)
    for step, scale in enumerate((0.01, 3.0, 0.05, 10.0)):
        g = jax.tree.map(lambda a: (scale * rng.normal(0, 1, a.shape)
                                    ).astype(np.float32), tree)
        u, st = tx.update(jax.tree.map(jnp.asarray, g), st, jt)
        jt = optax.apply_updates(jt, u)
        tt, ts = opt.update(jax.tree.map(torch.from_numpy, g), ts, tt,
                            lr=2e-3)
        ref = flatten_tree(jt)
        for k, v in tflatten(tt).items():
            np.testing.assert_allclose(v, ref[k], rtol=1e-6, atol=1e-6,
                                       err_msg=f"{k} step {step}")


def test_param_labels_match_jax(monkeypatch):
    """The leaves the port trains at 10 lr are the leaves JAX labels
    "lines" (captured from jid.distill_to_mlp's multi_transform)."""
    jm, jp = _hash_teacher()
    scfg = jid.student_config(jm.cfg, cp_rank=8, cp_res=16, cp_levels=2,
                              vm_rank=2, vm_res=8, sigma_cp_rank=4,
                              sigma_cp_res=16, sigma_vm_rank=2,
                              sigma_vm_res=8)
    seen = []
    real = optax.multi_transform

    def spy(transforms, labels, *a, **k):
        seen.append(labels)
        return real(transforms, labels, *a, **k)

    monkeypatch.setattr(optax, "multi_transform", spy)
    jid.distill_to_mlp(jm, jp, key=jax.random.key(0),
                       student_model=jfields.make_model(scfg, RC),
                       n_points=256, batch=256, iters=1, render_check=0)
    leaves, _ = jax.tree_util.tree_flatten_with_path(seen[0])
    ref = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path): lab for path, lab in leaves}
    sm = fields.make_model(config_from_dict(ModelConfig,
                                            dataclasses.asdict(scfg)),
                           _port_model(jm).render_cfg)
    sp = fields.init_params(sm, torch.Generator().manual_seed(0))
    tree = {k: sp[k] for k in ("grid_mlp", "prop", "cp_lines", "vm_planes",
                               "vm_lines", "sigma_cp_lines",
                               "sigma_vm_planes", "sigma_vm_lines")}
    got = tid.param_labels(tree)
    assert got == ref
    assert {k.split("/")[0] for k, v in got.items() if v == "lines"} == {
        "cp_lines", "vm_planes", "vm_lines", "sigma_cp_lines",
        "sigma_vm_planes", "sigma_vm_lines"}


@pytest.mark.parametrize("teacher", ["hashgrid", "grid"])
def test_distill_steps_match_jax(teacher):
    """20 steps (one epoch of 20 batches) from JAX's pool, its draws and its
    initial student; render_psnr on one 16^2 frame. Then distill_to_mlp
    end to end on the same draws: its pool is JAX's but where the
    teacher's densities rank within float32 rounding of each other (the
    port's and XLA's sums differ by an ulp there: 4 and 2 of these 5,120
    points), and the heads are copied bit for bit."""
    jm, jp, tm, tp = _pair(teacher)
    n, batch, iters = 20 * 256, 256, 20
    key = jax.random.key(0)
    sm_j, sp_j, rep_j = jid.distill_to_mlp(
        jm, jp, key=key, n_points=n, batch=batch, iters=iters,
        render_check=1, render_hw=16)
    k_init, draws = _jax_draws(key, n, batch, iters, jm.bound)
    x_j, t_j = jid.build_targets(jm, jp, jax.random.split(key, 3)[1], n)
    sm = _port_model(sm_j)
    init = params_from_jax(flatten_tree(
        jfields.init_params(sm_j, k_init), "params/"), sm)
    student = dict(init, view_mlp=tp["view_mlp"])
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    sp_t, losses, history = tid.fit_student(
        sm, student, t(x_j), {k: t(v) for k, v in t_j.items()}, draws.perms,
        batch, 2e-3, tm.is_mlp_field)
    assert len(history) == 20 and all(np.isfinite(history))
    assert sorted(losses) == sorted(rep_j["losses"])
    for k, v in rep_j["losses"].items():
        np.testing.assert_allclose(losses[k], v, rtol=1e-4, err_msg=k)
    psnr = tid._render_fidelity(tm, tp, sm, sp_t, 1, 16, "cpu")
    assert abs(psnr - rep_j["render_psnr"]) <= 0.05, (psnr, rep_j)
    # the fitted leaves agree too, and moved from their start
    ref, out, start = flatten_tree(sp_j, ""), tflatten(sp_t), tflatten(init)
    for k in ("grid_mlp/0/w", "prop/0/mlp/1/w"):
        scale = float(np.abs(ref[k]).max())
        np.testing.assert_allclose(out[k], ref[k], rtol=0,
                                   atol=1e-3 * scale, err_msg=k)
        assert not np.array_equal(out[k], start[k])

    x_t, _ = tid.build_targets(tm, tp, draws.targets)
    assert np.any(x_t.numpy() != np.asarray(x_j), -1).sum() <= 4
    _, sp_e, rep_e = tid.distill_to_mlp(
        tm, tp, n_points=n, batch=batch, iters=iters, student_model=sm,
        render_check=0, init_params=init, draws=draws, device="cpu")
    assert rep_e["iters"] == rep_j["iters"] == 20
    assert rep_e["copied_heads"] == rep_j["copied_heads"] == ["view_mlp"]
    assert all(np.isfinite(rep_e["loss_history"]))
    got = tflatten(sp_e["view_mlp"])
    for k, v in flatten_tree(sp_j["view_mlp"]).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_draws_and_default_generator():
    """The port's own draws: the mixture's three parts in their ranges,
    a permutation, and distill_to_mlp end to end from a generator."""
    g = torch.Generator().manual_seed(3)
    d = tid.draw_targets(g, 999, 2.0)
    p = d.points
    assert p.shape == (999, 3) and d.noise.shape == (333, 3)
    assert p[:499].abs().max() <= 1.0 and p.abs().max() <= 2.0
    assert sorted(d.perm.tolist()) == list(range(999))
    jm, jp, tm, tp = _pair("hashgrid")
    sm, sp, rep = tid.distill_to_mlp(tm, tp, torch.Generator().manual_seed(0),
                                     n_points=1024, batch=256, iters=8,
                                     render_check=0, device="cpu")
    assert sm.is_mlp_field and rep["iters"] == 8
    assert all(np.isfinite(rep["loss_history"]))
