"""Checkpoints and the Trainer of the port against the JAX package's, on the
CPU: one npz format both ways (identical leaves), rolling retention, the
stage handoff's freeze mask, and tests/test_train_e2e.py's 2-epoch run
with resume, evaluation artifacts and the resume modes. Every comparison
of loaded leaves is exact: the npz carries the float32 bits."""

import dataclasses
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from sanerf_tpu import config as jconfig
from sanerf_tpu.models import fields as jfields
from sanerf_tpu.train import checkpoints as jckpt
from sanerf_tpu.train import state as jstate
from sanerf_tpu_torch import config
from sanerf_tpu_torch.data.synthetic import SyntheticSphereDataset
from sanerf_tpu_torch.models import fields
from sanerf_tpu_torch.models.asset import params_from_jax
from sanerf_tpu_torch.train import checkpoints as ckpt
from sanerf_tpu_torch.train import state
from sanerf_tpu_torch.train.metrics import PSNRMeter, SSIMMeter
from sanerf_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)
RC = dict(num_steps=(16, 8), bound=4.0, contract=True, max_ray_batch=2048)
MC = dict(field_type="hashgrid", grid_num_levels=8, grid_log2_hashmap=13,
          grid_desired_resolution=128, prop_num_levels=4,
          prop_log2_hashmap=10, prop_resolutions=(64,))
TC = dict(iters=300, lr=1e-2, num_rays=1024, adaptive_num_rays=False,
          lambda_distort=0.01)
SAM_MC = dict(MC, with_sam=True, sam_use_view_direction=True,
              s_grid_num_levels=4, s_grid_log2_hashmap=10,
              s_grid_desired_resolution=64)


def _models(mkw):
    jrc, jmc = jconfig.RenderConfig(**RC), jconfig.ModelConfig(**mkw)
    port = lambda cls, c: config.config_from_dict(  # noqa: E731
        cls, dataclasses.asdict(c))
    return (fields.make_model(port(config.ModelConfig, jmc),
                              port(config.RenderConfig, jrc)),
            jfields.make_model(jmc, jrc))


def _same(flat_a, flat_b):
    assert sorted(flat_a) == sorted(flat_b)
    for k in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_a[k]),
                                      np.asarray(flat_b[k]), k)


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    """A JAX-written full checkpoint (params, EMA, optax state): params and
    EMA load with identical leaves, its optax `opt/` is not the port's
    layout and leaves the optimizer fresh."""
    model, jmodel = _models(MC)
    jp = jfields.init_params(jmodel, jax.random.key(0))
    jtc = jconfig.TrainConfig(**TC)
    js = jstate.create_train_state(jmodel, jtc, jax.random.key(1), params=jp)
    jema = jax.tree.map(lambda a: a * 0.5, js.params)
    path = jckpt.CheckpointManager(str(tmp_path), "j").save(
        12, js.params, jema, js.opt_state, stats={"epoch": 3})
    template = fields.init_params(model, torch.Generator().manual_seed(5))
    opt = state.make_optimizer(config.TrainConfig(**TC)).init(template)
    mgr = ckpt.CheckpointManager(str(tmp_path), "j")
    params, ema, opt_state, meta = mgr.load(path, template, opt)
    _same(ckpt.flatten_tree(params), jckpt.flatten_tree(js.params))
    _same(ckpt.flatten_tree(ema), jckpt.flatten_tree(jema))
    assert opt_state is None and meta["step"] == 12
    flat, _ = ckpt.CheckpointManager.load_file(path)
    _same(ckpt.flatten_tree(params_from_jax(flat, model, "cpu",
                                            prefix="ema/")),
          jckpt.flatten_tree(jema))


def test_port_checkpoint_loads_into_jax(tmp_path):
    model, jmodel = _models(MC)
    params = fields.init_params(model, torch.Generator().manual_seed(2))
    tc = config.TrainConfig(**TC)
    st = state.create_train_state(model, tc, params=params)
    ema = {**st.params, "grid": st.params["grid"] * 2.0}
    path = ckpt.CheckpointManager(str(tmp_path), "p").save(
        7, st.params, ema, st.opt_state, stats={"epoch": 1})
    jtemplate = jfields.init_params(jmodel, jax.random.key(9))
    jtx = jstate.make_optimizer(jconfig.TrainConfig(**TC))
    got = jckpt.CheckpointManager(str(tmp_path), "p").load(
        path, jtemplate, jtx.init(jtemplate))
    jparams, jema, jopt, meta = got
    _same(jckpt.flatten_tree(jparams), ckpt.flatten_tree(params))
    _same(jckpt.flatten_tree(jema), ckpt.flatten_tree(ema))
    assert meta == {"step": 7, "stats": {"epoch": 1}}
    # the port's own optimizer layout round-trips in the port
    back = ckpt.CheckpointManager(str(tmp_path), "p").load(
        path, params, st.opt_state)
    assert back[2].count == 0
    _same(ckpt.flatten_tree(back[2].mu), ckpt.flatten_tree(st.opt_state.mu))


def test_flatten_paths_match_jax():
    model, jmodel = _models(dict(field_type="mlp", mlp_cp_rank=4,
                                 mlp_cp_levels=2, mlp_vm_rank=2,
                                 mlp_vm_levels=2, mlp_field_depth=2,
                                 mlp_field_width=8))
    jp = jfields.init_params(jmodel, jax.random.key(0))
    flat = jckpt.flatten_tree(jp, "params/")
    p = params_from_jax(flat, model, "cpu")
    assert list(ckpt.flatten_tree(p, "params/")) == list(flat)
    zeros = jax.tree.map(torch.zeros_like, p)
    _same(ckpt.flatten_tree(ckpt.unflatten_like(zeros, flat, "params/"),
                            "params/"), flat)


def test_rolling_retention_and_best(tmp_path):
    model, _ = _models(MC)
    params = fields.init_params(model, torch.Generator().manual_seed(0))
    mgr = ckpt.CheckpointManager(str(tmp_path), "x", max_keep=2)
    for s in range(5):
        mgr.save(s, params, full=False)
    assert len(mgr.list_checkpoints()) == 2
    assert "step00000004" in mgr.list_checkpoints()[-1]
    assert mgr.resolve("best") == mgr.list_checkpoints()[-1]
    best = mgr.save(3, params, best=True, full=False)
    assert mgr.resolve("best") == best and len(mgr.list_checkpoints()) == 2
    assert mgr.resolve("scratch") is None


def test_partial_load_and_freeze_matches_jax(tmp_path):
    """A stage-1 checkpoint into a model with a SAM head: the port's mask
    is JAX's, and the masked optimizer keeps the frozen leaves fixed."""
    model1, jmodel1 = _models(MC)
    params1 = fields.init_params(model1, torch.Generator().manual_seed(0))
    path = ckpt.CheckpointManager(str(tmp_path), "s1").save(
        100, params1, full=False)
    model2, jmodel2 = _models(SAM_MC)
    params2 = fields.init_params(model2, torch.Generator().manual_seed(1))
    merged, trainable = ckpt.load_partial_and_freeze(path, params2)
    jmerged, jtrainable = jckpt.load_partial_and_freeze(
        path, jfields.init_params(jmodel2, jax.random.key(1)))
    assert (ckpt.flatten_tree(trainable)
            == {k: np.asarray(v) for k, v in
                jckpt.flatten_tree(jtrainable).items()})
    assert trainable["grid"] is False and trainable["s_grid"] is True
    np.testing.assert_array_equal(merged["grid"].numpy(),
                                  params1["grid"].numpy())
    tc = dataclasses.replace(config.TrainConfig(**TC), iters=10)
    opt = state.make_optimizer(tc, trainable)
    st = opt.init(merged)
    grads = jax.tree.map(lambda t, on: torch.ones_like(t) if on else None,
                         merged, trainable)
    new, _ = opt.update(grads, st, merged)
    assert torch.equal(new["grid"], merged["grid"])
    assert not torch.equal(new["s_grid"], merged["s_grid"])


def _cfg(tmp_path, **tkw):
    return config.Config(
        workspace=str(tmp_path / "ws"), render=config.RenderConfig(**RC),
        model=config.ModelConfig(**MC),
        train=config.TrainConfig(**dict(TC, iters=60, save_cnt=2,
                                        eval_cnt=1, num_rays=256), **tkw))


def test_trainer_loop_and_checkpoint_resume(tmp_path):
    """tests/test_train_e2e.py:77-94 on the port: two epochs, the step and
    params restored in a fresh Trainer; the JSONL log has one record an
    epoch; evaluation writes its artifacts and the best checkpoint."""
    cfg = _cfg(tmp_path)
    model = fields.make_model(cfg.model, cfg.render)
    ds = SyntheticSphereDataset(H=16, W=16, n_views=4)
    valid = SyntheticSphereDataset(H=16, W=16, n_views=2, training=False)
    tr = Trainer("t", cfg, model, use_checkpoint="scratch", device="cpu",
                 metrics=[PSNRMeter(), SSIMMeter()])
    tr.train(ds, valid_dataset=valid, max_epoch=2, steps_per_epoch=6)
    assert tr.global_step == 12 and tr.state.step == 12
    assert len(tr.ckpt_mgr.list_checkpoints()) >= 1
    with open(tr.metrics_path) as f:
        recs = [json.loads(l) for l in f]
    assert [r["step"] for r in recs] == [6, 12]
    assert all(np.isfinite(r["loss"]) for r in recs)
    out = os.path.join(cfg.workspace, "validation")
    assert os.path.exists(os.path.join(out, "ep0002_001_gt.png"))
    assert os.path.exists(os.path.join(out, "ep0002_000_depth.npy"))
    assert os.path.exists(tr.ckpt_mgr.resolve("best"))

    tr2 = Trainer("t", cfg, model, use_checkpoint="latest", device="cpu")
    assert tr2.global_step == 12 and tr2.epoch == 2
    assert tr2.state.opt_state.count == 12
    _same(ckpt.flatten_tree(tr.state.params),
          ckpt.flatten_tree(tr2.state.params))
    _same(ckpt.flatten_tree(tr.state.ema_params),
          ckpt.flatten_tree(tr2.state.ema_params))
    tr3 = Trainer("t", cfg, model, use_checkpoint="latest_model",
                  device="cpu")
    assert tr3.global_step == 0 and tr3.state.opt_state.count == 0
    _same(ckpt.flatten_tree(tr.state.params),
          ckpt.flatten_tree(tr3.state.params))
    tr2.test(valid)
    assert os.path.exists(os.path.join(cfg.workspace, "results",
                                       "0001_rgb.png"))
    img = tr2.render_pose(valid.poses[0], valid.intrinsics, 8, 8)
    assert img["image"].shape == (64, 3) and np.isfinite(img["image"]).all()


def _dp_trainer_rank(rank, store, cfg):
    """A rank of test_trainer_refuses_what_the_port_lacks' 2-rank run."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    try:
        model = fields.make_model(cfg.model, cfg.render)
        tr = Trainer("t", cfg, model, use_checkpoint="scratch",
                     device="cpu")
        assert tr.mesh.size == 2 and tr.mesh.rank == rank
        tr.train(SyntheticSphereDataset(H=16, W=16, n_views=4), max_epoch=1,
                 steps_per_epoch=3)
        tr2 = Trainer("t", cfg, model, use_checkpoint="latest",
                      device="cpu")
        assert tr2.global_step == 3
    finally:
        dist.destroy_process_group()


def test_trainer_refuses_what_the_port_lacks(tmp_path):
    """n_devices=2 needs a process group (no silent 1-rank mesh); with one
    (2 gloo ranks on the CPU) it trains, saves on rank 0 and resumes on
    both. A dataset of images without near/far trains on the native
    loader."""
    import torch.multiprocessing as mp

    cfg = _cfg(tmp_path)
    model = fields.make_model(cfg.model, cfg.render)
    dp_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, n_devices=2, use_native_loader=False))
    with pytest.raises(RuntimeError, match="process group"):
        Trainer("t", dp_cfg, model, device="cpu")
    ctx = mp.start_processes(_dp_trainer_rank, nprocs=2, join=False,
                             start_method="spawn",
                             args=(str(tmp_path / "store"), dp_cfg))
    deadline = time.time() + 180
    try:
        while not ctx.join(timeout=5):  # True once both ranks have ended
            assert time.time() < deadline, "2 ranks did not end in 180 s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    with open(os.path.join(dp_cfg.workspace, "log_t.txt")) as f:
        assert "2 ranks (gloo)" in f.read()
    tr = Trainer("t", cfg, model, use_checkpoint="scratch", device="cpu")

    class Images:  # images and no per-view near/far: the native loader's
        ds = SyntheticSphereDataset(H=8, W=8, n_views=2)
        poses, intrinsics, images = ds.poses, ds.intrinsics, ds.images

        def __len__(self):
            return 2

    # the native loader is in the port now: such a dataset trains on it
    tr.train(Images(), max_epoch=1, steps_per_epoch=2)
    assert tr.global_step == 2
    with open(tr.log_path) as f:
        assert "[native loader]" in f.read()


def test_trainer_resizes_the_grid_tables(tmp_path):
    """The coarse-to-fine schedule at epoch boundaries: the tables start
    at grid_upsample_targets(step 0) and reach the next milestone's."""
    mc = config.ModelConfig(mlp_enc_freqs=3, mlp_field_width=16,
                            mlp_field_depth=3, mlp_prop_enc_freqs=2,
                            mlp_prop_width=16, mlp_prop_depth=2,
                            prop_resolutions=(16,), mlp_cp_rank=8,
                            mlp_cp_res=64, mlp_cp_levels=2, mlp_vm_rank=4,
                            mlp_vm_res=32, mlp_vm_levels=2,
                            mlp_sigma_cp_rank=4, mlp_sigma_cp_res=32,
                            mlp_sigma_vm_rank=2, mlp_sigma_vm_res=16)
    cfg = dataclasses.replace(
        _cfg(tmp_path, grid_upsample_steps=(2, 100), lambda_tv=1e-3,
             anneal_iters=50), model=mc)
    model = fields.make_model(mc, cfg.render)
    tr = Trainer("g", cfg, model, use_checkpoint="scratch", device="cpu")
    tr.train(SyntheticSphereDataset(H=16, W=16, n_views=4), max_epoch=2,
             steps_per_epoch=2)
    want = state.grid_upsample_targets(cfg.train, mc, 2)
    assert fields.grid_resolutions(tr.state.params) == want
    assert want == {"cp": 32, "vm": 16, "sigma_cp": 16, "sigma_vm": 8}
    assert tr.state.opt_state.count == 2  # reset at the resize


def test_trainer_defaults_to_cuda(tmp_path):
    """Like every entry point of the port, the Trainer runs on the card
    unless the caller passes device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is satisfiable")
    cfg = _cfg(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer("t", cfg, fields.make_model(cfg.model, cfg.render))
