"""Parity: stage-1 training of the port (train/state.py, the renderer's
training mode, the data sampling, the meters) against the JAX package on
the CPU, with the same numpy params and the JAX-drawn random tensors fed to
both sides. The configurations are tests/test_train_e2e.py's `MC` (hash
grid), `MC_MLP`, `RC` and `TC`, and one grid config with sigma grids, CP /
VM ladders and `anneal_iters`.

Tolerances, each with its reason:
  - `rgb_loss_fn`'s value: 1e-5 relative; every leaf's gradient against
    `jax.grad(rgb_loss_fn)`: 1e-4 x max|g| per leaf (the same float32
    operations, summed in another order through a deep chain: XLA's CPU
    cumsum is a triangular matmul, its scatter-add against index_add_);
  - the optimizer fed the same numpy gradients as optax's
    `make_optimizer` for 5 steps (clip active, grid_lr_mult, a frozen
    mask, warm-up): 1e-6 (optax's bias corrections and schedule are float32
    powers, computed here with numpy's);
  - the EMA, the schedule, update_proposal_now, adaptive_num_rays and
    grid_upsample_targets: exact;
  - sample_rays (every mode) and collate_train: identical to the JAX
    package's with the same numpy generator;
  - ssim: 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sanerf_tpu import config as jconfig
from sanerf_tpu.data import rays as jrays
from sanerf_tpu.data.synthetic import SyntheticSphereDataset as JDataset
from sanerf_tpu.models import fields as jfields
from sanerf_tpu.train import checkpoints as jckpt
from sanerf_tpu.train import metrics as jmetrics
from sanerf_tpu.train import state as jstate
from sanerf_tpu_torch import config
from sanerf_tpu_torch.data import rays
from sanerf_tpu_torch.data.synthetic import SyntheticSphereDataset
from sanerf_tpu_torch.models import fields
from sanerf_tpu_torch.models.asset import params_from_jax
from sanerf_tpu_torch.train import metrics
from sanerf_tpu_torch.train import state
from sanerf_tpu_torch.train.checkpoints import flatten_tree

torch.set_num_threads(1)

RC = dict(num_steps=(16, 8), bound=4.0, contract=True, max_ray_batch=2048)
MC = dict(field_type="hashgrid", grid_num_levels=8, grid_log2_hashmap=13,
          grid_desired_resolution=128, prop_num_levels=4,
          prop_log2_hashmap=10, prop_resolutions=(64,))
MC_MLP = dict(field_type="mlp", prop_resolutions=(64,), mlp_enc_freqs=6,
              mlp_field_width=64, mlp_field_depth=4, mlp_prop_enc_freqs=4,
              mlp_prop_width=32, mlp_prop_depth=2)
MC_GRID = dict(mlp_enc_freqs=3, mlp_field_width=16, mlp_field_depth=4,
               mlp_prop_enc_freqs=2, mlp_prop_width=16, mlp_prop_depth=2,
               prop_resolutions=(16,), mlp_cp_rank=8, mlp_cp_res=32,
               mlp_cp_levels=2, mlp_vm_rank=4, mlp_vm_res=16,
               mlp_vm_levels=2, mlp_sigma_cp_rank=6, mlp_sigma_cp_res=24,
               mlp_sigma_vm_rank=3, mlp_sigma_vm_res=16)
TC = dict(iters=300, lr=1e-2, num_rays=1024, adaptive_num_rays=False,
          lambda_distort=0.01)
CASES = {"hashgrid": (MC, TC),
         "mlp": (MC_MLP, TC),
         "grids": (MC_GRID, dict(TC, anneal_iters=40, lambda_entropy=1e-3))}
N_RAYS = 96


def _port(cls, jcfg):
    return config.config_from_dict(cls, dataclasses.asdict(jcfg))


def _setup(case, background="last_sample"):
    mkw, tkw = CASES[case]
    jrc = jconfig.RenderConfig(**RC, background=background)
    jmc, jtc = jconfig.ModelConfig(**mkw), jconfig.TrainConfig(**tkw)
    jmodel = jfields.make_model(jmc, jrc)
    model = fields.make_model(_port(config.ModelConfig, jmc),
                              _port(config.RenderConfig, jrc))
    jp = jfields.init_params(jmodel, jax.random.key(0))
    params = params_from_jax(jckpt.flatten_tree(jp, "params/"), model, "cpu")
    return model, jmodel, params, jp, _port(config.TrainConfig, jtc), jtc


def _batch(n=N_RAYS):
    ds = JDataset(H=24, W=24, n_views=4)
    b = ds.collate_train(np.random.default_rng(1), n)
    return {k: v for k, v in b.items() if isinstance(v, np.ndarray)}


def _jitter(model, key, n):
    """The uniform draws JAX's run_rays makes from `key`, per level."""
    keys = jax.random.split(key, len(model.render_cfg.num_steps))
    return [torch.tensor(np.asarray(jax.random.uniform(k, (n, T + 1))))
            for k, T in zip(keys, model.render_cfg.num_steps)]


@pytest.mark.parametrize("update_proposal", [True, False],
                         ids=["update", "frozen_prop"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_rgb_loss_and_grads_match_jax(case, update_proposal):
    model, jmodel, params, jp, tc, jtc = _setup(case)
    b = _batch()
    key = jax.random.key(7)
    step = 13
    enc_alpha = (jnp.minimum(step / jtc.anneal_iters, 1.0)
                 if jtc.anneal_iters else None)
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def jloss(p):
        return jstate.rgb_loss_fn(jmodel, jtc, p, jb, jb["images"],
                                  jnp.ones(()), key, update_proposal,
                                  enc_alpha=enc_alpha)

    (jl, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    draws = state.StepDraws(_jitter(model, key, N_RAYS))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    loss, aux, grads = state.loss_and_grads(model, tc, params, tb, draws,
                                            step, update_proposal)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for k in ("loss_rgb", "proposal_loss", "distort_loss"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5,
                                   atol=1e-9)
    got, ref = flatten_tree(grads), jckpt.flatten_tree(jg)
    assert sorted(got) == sorted(ref)
    for k in ref:
        scale = max(float(np.abs(ref[k]).max()), 1e-12)
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=1e-4 * scale, err_msg=k)
        if k.startswith("prop/") and not update_proposal:
            assert not ref[k].any() and not got[k].any(), k


def test_random_background_and_tv_draws_match_jax():
    """A "random" background and the hash grid's TV term: the bg draw and
    the TV points cross as tensors, and the step's regularized gradient
    matches JAX's."""
    model, jmodel, params, jp, tc, jtc = _setup("hashgrid", "random")
    tc = dataclasses.replace(tc, lambda_tv=1e-3, lambda_wd=1e-4)
    jtc = dataclasses.replace(jtc, lambda_tv=1e-3, lambda_wd=1e-4)
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    render_key, bg_key = jax.random.split(jax.random.key(3))
    reg_key = jax.random.key(4)
    bg = jax.random.uniform(bg_key, (N_RAYS, 3))
    x01 = jax.random.uniform(reg_key, (state.TV_POINTS, 3))

    def jloss(p):
        return jstate.rgb_loss_fn(jmodel, jtc, p, jb, jb["images"], bg,
                                  render_key, True)

    jg, _ = jax.grad(jloss, has_aux=True)(jp)
    jg = jstate._apply_regularizer_grads(jmodel, jtc, jp, jg, reg_key)
    draws = state.StepDraws(_jitter(model, render_key, N_RAYS),
                            torch.tensor(np.asarray(bg)),
                            torch.tensor(np.asarray(x01)))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    _, _, grads = state.loss_and_grads(model, tc, params, tb, draws, 0, True)
    grads = state._apply_regularizer_grads(model, tc, params, grads,
                                           draws.tv_points)
    got, ref = flatten_tree(grads), jckpt.flatten_tree(jg)
    for k in ref:
        scale = max(float(np.abs(ref[k]).max()), 1e-12)
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=1e-4 * scale, err_msg=k)


def test_optimizer_matches_optax():
    """5 steps on the same numpy gradients: the clip active (gradients of
    norm ~40 against a clip of 1), grid_lr_mult on the CP tables, a frozen
    leaf, a warm-up."""
    rng = np.random.default_rng(0)
    shapes = {"grid_mlp": [(6, 4), (4, 3)], "cp_lines": (3, 8, 2),
              "view_mlp": [(5, 3)]}
    p0 = {"grid_mlp": [{"w": rng.normal(0, 1, s).astype(np.float32)}
                       for s in shapes["grid_mlp"]],
          "cp_lines": rng.normal(0, 1, shapes["cp_lines"]).astype(np.float32),
          "view_mlp": [{"w": rng.normal(0, 1, (5, 3)).astype(np.float32)}]}
    trainable = {"grid_mlp": [{"w": True}, {"w": True}], "cp_lines": True,
                 "view_mlp": [{"w": False}]}
    jtc = jconfig.TrainConfig(iters=50, lr_warmup_steps=3, grad_clip=1.0,
                              grid_lr_mult=10.0)
    tc = _port(config.TrainConfig, jtc)
    tx = jstate.make_optimizer(jtc, trainable)
    jp = jax.tree.map(jnp.asarray, p0)
    js = tx.init(jp)
    tp = jax.tree.map(torch.from_numpy, p0)
    opt = state.make_optimizer(tc, trainable)
    ts = opt.init(tp)
    for i in range(5):
        g = jax.tree.map(lambda a: (rng.normal(0, 10, a.shape)
                                    * (rng.uniform(size=a.shape) > 0.2)
                                    ).astype(np.float32), p0)
        upd, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tg = jax.tree.map(torch.from_numpy, g)
        tg["view_mlp"][0]["w"] = None  # frozen: no gradient
        tp, ts = opt.update(tg, ts, tp)
        a, b = flatten_tree(tp), jckpt.flatten_tree(jp)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6,
                                       err_msg=f"step {i}: {k}")
    np.testing.assert_array_equal(flatten_tree(tp)["view_mlp/0/w"],
                                  p0["view_mlp"][0]["w"])
    assert ts.mu["view_mlp"][0]["w"] is None and ts.count == 5


def test_ema_and_schedules_exact():
    rng = np.random.default_rng(3)
    e = rng.normal(0, 1, (64,)).astype(np.float32)
    p = rng.normal(0, 1, (64,)).astype(np.float32)
    ref = np.asarray(jstate._ema_update({"a": jnp.asarray(e)},
                                        {"a": jnp.asarray(p)}, 0.95)["a"])
    got = state._ema_update({"a": torch.from_numpy(e)},
                            {"a": torch.from_numpy(p)}, 0.95)["a"]
    np.testing.assert_array_equal(got.numpy(), ref)
    for kw in (dict(), dict(lr_warmup_steps=7), dict(lr=3e-3, iters=1000)):
        jtc = jconfig.TrainConfig(**kw)
        tc = _port(config.TrainConfig, jtc)
        sched = jstate.lr_schedule(jtc)
        for s in (0, 1, 5, 6, 7, 500, 999, 20000, 30000):
            assert state.lr_schedule(tc, s) == float(sched(jnp.int32(s))), s
    jtc = jconfig.TrainConfig(grid_upsample_steps=(5, 9, 40))
    tc = _port(config.TrainConfig, jtc)
    for case in CASES:
        jmc = jconfig.ModelConfig(**CASES[case][0])
        mc = _port(config.ModelConfig, jmc)
        for s in (0, 4, 5, 9, 39, 40, 41):
            assert (state.grid_upsample_targets(tc, mc, s)
                    == jstate.grid_upsample_targets(jtc, jmc, s))
    for s in range(0, 3100, 7):
        assert (state.update_proposal_now(tc, s)
                == jstate.update_proposal_now(jtc, s))
    for kw in (dict(), dict(adaptive_num_rays=False, num_rays=777),
               dict(num_points=1000)):
        jtc = jconfig.TrainConfig(**kw)
        for last in (32, 8, 3):
            assert (state.adaptive_num_rays(_port(config.TrainConfig, jtc),
                                            last)
                    == jstate.adaptive_num_rays(jtc, last))


def test_configs_round_trip_and_match_jax():
    for jcls, cls in ((jconfig.TrainConfig, config.TrainConfig),
                      (jconfig.SamTrainConfig, config.SamTrainConfig),
                      (jconfig.MaskTrainConfig, config.MaskTrainConfig),
                      (jconfig.DataConfig, config.DataConfig)):
        assert ([(f.name, f.default) for f in dataclasses.fields(cls)]
                == [(f.name, f.default) for f in dataclasses.fields(jcls)])
    jcfg = jconfig.Config(workspace="w", seed=3,
                          train=jconfig.TrainConfig(grid_upsample_steps=(
                              2, 4)),
                          model=jconfig.ModelConfig(**MC))
    cfg = config.config_from_dict(config.Config, dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert config.config_from_dict(config.Config,
                                   dataclasses.asdict(cfg)) == cfg
    assert [f.name for f in dataclasses.fields(config.Config)] == [
        f.name for f in dataclasses.fields(jconfig.Config)]


def _rays_same(a, b):
    for k in ("rays_o", "rays_d", "inds", "i", "j", "inds_coarse"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)


@pytest.mark.parametrize("mode", ["uniform", "all", "coords", "patch",
                                  "patch_map", "importance"])
def test_sample_rays_modes_identical(mode):
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.3, -0.2, 2.0]
    intr = np.array([30.0, 31.0, 12.0, 9.5], np.float32)
    H, W = 40, 36
    imp = np.random.default_rng(9).uniform(0, 1, 16 * 16)
    kw = {"uniform": dict(N=50),
          "all": dict(N=-1),
          "coords": dict(N=3, coords=np.array([[0, 0], [5, 7], [39, 35]])),
          "patch": dict(N=32, patch_size=4),
          "patch_map": dict(N=16, patch_size=4, importance_map=imp,
                            importance_size=16, patch_from_map=True),
          "importance": dict(N=40, importance_map=imp, importance_size=16),
          }[mode]
    a = rays.sample_rays(pose, intr, H, W, rng=np.random.default_rng(2),
                         **kw)
    b = jrays.sample_rays(pose, intr, H, W, rng=np.random.default_rng(2),
                          **kw)
    _rays_same(a, b)


def test_collate_train_identical():
    ds = SyntheticSphereDataset(H=20, W=24, n_views=5, scene="textured")
    jds = JDataset(H=20, W=24, n_views=5, scene="textured")
    r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(3):
        a, b = ds.collate_train(r1, 77), jds.collate_train(r2, 77)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], k)


def test_ssim_and_meters_match_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (30, 34, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(metrics.ssim(x, y), jmetrics.ssim(x, y),
                               rtol=1e-6)
    for cls, jcls in ((metrics.SSIMMeter, jmetrics.SSIMMeter),
                      (metrics.PSNRMeter, jmetrics.PSNRMeter)):
        m, jm = cls(), jcls()
        m.update(x, y)
        jm.update(x, y)
        assert m.report() == jm.report()
    lp = metrics.LPIPSMeter()
    assert lp.available == jmetrics.LPIPSMeter().available
    if not lp.available:
        lp.update(x, y)
        assert np.isnan(lp.measure()) and "n/a" in lp.report()


def test_train_step_runs_on_every_case():
    """One rgb_step_body per configuration on the CPU: finite aux, the step
    counted, the EMA between the old and new params."""
    for case in CASES:
        model, _, params, _, tc, _ = _setup(case)
        st = state.create_train_state(model, tc, params=params)
        step = state.make_rgb_train_step(model, tc)
        tb = {k: torch.from_numpy(v) for k, v in _batch(64).items()}
        g = torch.Generator().manual_seed(0)
        st2, aux = step(st, tb, state.draw_step(model, tc, 64, g), True)
        assert st2.step == 1 and st2.opt_state.count == 1
        assert all(np.isfinite(float(v)) for v in aux.values()), aux
        a = flatten_tree(st2.ema_params)
        b, c = flatten_tree(params), flatten_tree(st2.params)
        for k in a:
            np.testing.assert_allclose(a[k], 0.95 * b[k] + 0.05 * c[k],
                                       rtol=1e-5, atol=1e-6)
