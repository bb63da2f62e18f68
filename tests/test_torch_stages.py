"""Stages 2 and 3 of the port (train/distill.py, train/mask_trainer.py,
ops/losses.py's mask losses) against the JAX package.

- One step's loss, and the gradients of every trainable leaf, against the
  JAX step body (`sam_step_body`, `mask_step_body`) on the same params,
  batch and random draws (the similarity anchors' Gumbel noise drawn from
  the JAX key; both steps render unperturbed): the loss within 1e-4 relative, each
  leaf's gradient within 1e-4 x its max |g|; the frozen leaves get no
  gradient (None) and keep their bits through the optimizer.
- The mask losses alone against JAX at 1e-5.
- tests/test_stages.py's protocol with the port's trainers (its MC1, RC,
  TC; the 32^2 8-view sphere; the same steps and bounds): the SAM
  distillation's feature MSE below 0.8 of its first value, the mask field's
  mIoU above max(first, 0.6), the backbone frozen.
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
from sanerf_tpu.ops import losses as jlosses
from sanerf_tpu.train import checkpoints as jckpt
from sanerf_tpu.train import distill as jdistill
from sanerf_tpu.train import mask_trainer as jmask
from sanerf_tpu.train import state as jstate
from sanerf_tpu_torch import config
from sanerf_tpu_torch.data.rays import sample_rays
from sanerf_tpu_torch.data.synthetic import SyntheticSphereDataset
from sanerf_tpu_torch.models import fields
from sanerf_tpu_torch.models.asset import params_from_jax
from sanerf_tpu_torch.ops import losses
from sanerf_tpu_torch.train import checkpoints as ckpt_lib
from sanerf_tpu_torch.train import distill, mask_trainer
from sanerf_tpu_torch.train import state as state_lib
from sanerf_tpu_torch.train.checkpoints import flatten_tree
from sanerf_tpu_torch.train.trainer import Trainer
from sanerf_tpu_torch.train.tree import tree_map
from sanerf_tpu_torch.utils.image import resize

from tests.test_stages import MC1, RC, TC

torch.set_num_threads(1)

HEADS = {"sam": ("s_field_mlp", "samvit_mlp", "samvit_norm"),
         "mask": ("m_field_mlp", "mask_mlp")}


def _port(cls, jcfg):
    return config.config_from_dict(cls, dataclasses.asdict(jcfg))


def _port_cfg(jcfg):
    return config.config_from_dict(config.Config, dataclasses.asdict(jcfg))


def _setup(stage, mask_kw=None):
    kw = (dict(with_sam=True, sam_use_view_direction=True) if stage == "sam"
          else dict(with_mask=True, n_inst=2))
    jmc = dataclasses.replace(MC1, **kw)
    jcfg = jconfig.Config(render=RC, model=jmc, train=TC,
                          mask=jconfig.MaskTrainConfig(**(mask_kw or {})))
    jmodel = jfields.make_model(jmc, RC)
    model = fields.make_model(_port(config.ModelConfig, jmc),
                              _port(config.RenderConfig, RC))
    jp = jfields.init_params(jmodel, jax.random.key(0))
    rng = np.random.default_rng(1)
    if "samvit_norm" in jp:  # biases and norms away from 0 / 1
        for p in jp["samvit_mlp"]:
            p["b"] = jnp.asarray(rng.normal(0, 0.1, p["b"].shape), jnp.float32)
    params = params_from_jax(jckpt.flatten_tree(jp, "params/"), model, "cpu")
    ttrain = {k: tree_map(lambda _: k in HEADS[stage], v)
              for k, v in params.items()}
    return jmodel, model, jp, params, ttrain, jcfg


def _capture_step(body):
    """Runs a JAX step body, jitted, with an optax transformation that
    updates nothing and keeps the gradients it is given as its state ->
    (aux, gradients)."""
    tx = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))

    def run(jp, *args):
        st = jstate.TrainState(params=jp, ema_params=jp, opt_state=tx.init(jp),
                               step=jnp.zeros((), jnp.int32))
        new, aux = jax.jit(lambda st, *a: body(tx, st, *a))(st, *args)
        return aux, new.opt_state

    return run


def _hold(grads, jg, trainable_keys):
    got, ref = flatten_tree(grads), jckpt.flatten_tree(jg)
    assert sorted(got) == sorted(k for k in ref
                                 if k.split("/")[0] in trainable_keys)
    for k in got:
        scale = max(float(np.abs(ref[k]).max()), 1e-12)
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=1e-4 * scale, err_msg=k)


def test_sam_step_matches_jax():
    jmodel, model, jp, params, ttrain, jcfg = _setup("sam")
    ds = JDataset(H=32, W=32, n_views=4)
    b = ds.collate_sam(np.random.default_rng(3))
    gt = np.random.default_rng(4).normal(0, 1, (64, 64, 64)).astype(
        np.float32)
    key = jax.random.key(9)
    jb = {k: jnp.asarray(v) for k, v in b.items()
          if isinstance(v, np.ndarray)}
    jaux, jg = _capture_step(
        lambda tx, st, jb, gt: jdistill.sam_step_body(
            jmodel, jcfg, tx, st, jb, gt, key, b["h"], b["w"]))(
        jp, jb, jnp.asarray(gt))
    tb = {k: torch.from_numpy(v) for k, v in b.items()
          if isinstance(v, np.ndarray)}
    loss, aux, grads = state_lib.value_and_grads(
        lambda p: distill.sam_loss_fn(model, p, tb, torch.from_numpy(gt),
                                      b["h"], b["w"]),
        params, ttrain)
    np.testing.assert_allclose(loss.item(), float(jaux["loss"]), rtol=1e-4)
    _hold(grads, jg, HEADS["sam"])
    # the step: frozen leaves keep their bits, the head moves
    cfg = _port_cfg(jcfg)
    opt = state_lib.make_optimizer(cfg.train, ttrain)
    st = state_lib.create_train_state(model, cfg.train, params=params,
                                      trainable=ttrain)
    st2, _ = distill.sam_step_body(model, cfg, opt, st, tb,
                                   torch.from_numpy(gt), b["h"], b["w"])
    a, c = flatten_tree(params), flatten_tree(st2.params)
    for k in a:
        if k.split("/")[0] in HEADS["sam"]:
            continue
        np.testing.assert_array_equal(c[k], a[k], err_msg=k)
    assert not np.array_equal(c["samvit_mlp/0/w"], a["samvit_mlp/0/w"])


def _mask_batch(n_global, patch, n_patch, seed):
    """Global rays of a view, `n_patch` local patches of patch^2 pixels,
    labels with some -1, incoherent maps of 0 / 1."""
    ds = JDataset(H=32, W=32, n_views=4)
    rng = np.random.default_rng(seed)
    b = ds.collate_mask(rng, n_global)
    parts = [b]
    for _ in range(n_patch):
        rb = jrays.sample_rays(ds.poses[b["index"]], ds.intrinsics, 32, 32,
                               N=patch ** 2, patch_size=patch, rng=rng)
        parts.append({"rays_o": rb.rays_o, "rays_d": rb.rays_d,
                      "masks": ds.masks[b["index"]].reshape(-1)[rb.inds]})
    out = {k: np.concatenate([p[k] for p in parts])
           for k in ("rays_o", "rays_d", "masks")}
    out["masks"][::7] = -1
    out["incoherent_masks"] = (rng.random(len(out["masks"])) < 0.3).astype(
        np.float32)
    out["cam_near_far"] = b["cam_near_far"]
    return out


MASK_CASES = {
    "ce": {},
    "all_losses": dict(rgb_similarity_loss_weight=1.0, rgb_similarity_iter=0,
                       mixed_sampling=True, num_local_sample=2,
                       local_sample_patch_size=4,
                       incoherent_uncertainty_weight=0.5,
                       label_regularization_weight=0.5, patch_size=4),
    "bce_logistics": dict(rgb_similarity_loss_weight=0.7,
                          rgb_similarity_iter=0, mixed_sampling=True,
                          num_local_sample=2, local_sample_patch_size=4,
                          rgb_similarity_num_sample=3,
                          rgb_similarity_use_pred_logistics=True),
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_mask_step_matches_jax(case):
    mk = MASK_CASES[case]
    jmodel, model, jp, params, ttrain, jcfg = _setup("mask", mk)
    if case == "bce_logistics":
        jmodel = jfields.make_model(dataclasses.replace(
            jmodel.cfg, redundant_instance=1), RC)
        model = fields.make_model(dataclasses.replace(
            model.cfg, redundant_instance=1), model.render_cfg)
    n_global, patch = 64, 4
    n_patch = 2 if mk.get("mixed_sampling") else 0
    b = _mask_batch(n_global, patch, n_patch, 5)
    key = jax.random.key(11)
    use_sim = bool(mk.get("mixed_sampling"))
    jaux, jg = _capture_step(
        lambda tx, st, jb: jmask.mask_step_body(jmodel, jcfg, tx, st, jb, key,
                                                n_global, use_sim))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    gumbel = (torch.tensor(np.asarray(jax.random.gumbel(
        key, (n_patch, patch * patch)))) if use_sim else None)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    cfg = _port_cfg(jcfg)
    loss, aux, grads = state_lib.value_and_grads(
        lambda p: mask_trainer.mask_loss_fn(model, cfg, p, tb, n_global,
                                            use_sim, gumbel),
        params, ttrain)
    np.testing.assert_allclose(loss.item(), float(jaux["loss"]), rtol=1e-4)
    np.testing.assert_allclose(aux["ce"].item(), float(jaux["ce"]),
                               rtol=1e-4)
    np.testing.assert_array_equal(aux["pred"].numpy(),
                                  np.asarray(jaux["pred"]))
    np.testing.assert_allclose(aux["error"].numpy(),
                               np.asarray(jaux["error"]), rtol=1e-4,
                               atol=1e-6)
    _hold(grads, jg, HEADS["mask"])
    opt = state_lib.make_optimizer(cfg.train, ttrain)
    st = state_lib.create_train_state(model, cfg.train, params=params,
                                      trainable=ttrain)
    st2, _ = mask_trainer.mask_step_body(model, cfg, opt, st, tb, n_global,
                                         use_sim, gumbel)
    a, c = flatten_tree(params), flatten_tree(st2.params)
    for k in a:
        if k.split("/")[0] not in HEADS["mask"]:
            np.testing.assert_array_equal(c[k], a[k], err_msg=k)
    assert not np.array_equal(c["mask_mlp/0/w"], a["mask_mlp/0/w"])


@pytest.mark.parametrize("patch", [1, 3])
def test_mask_losses_match_jax(patch):
    rng = np.random.default_rng(patch)
    S, P, inst = 3, 16, 3
    depth = rng.random(S * patch * patch * 4).astype(np.float32)
    probs = rng.dirichlet(np.ones(inst), len(depth)).astype(np.float32)
    ref = jlosses.label_regularization(jnp.asarray(depth),
                                       jnp.asarray(probs), patch, inst)
    got = losses.label_regularization(torch.from_numpy(depth),
                                      torch.from_numpy(probs), patch, inst)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5, atol=1e-7)
    rgb = rng.random((S, P, 3)).astype(np.float32)
    im = rng.dirichlet(np.ones(inst), (S, P)).astype(np.float32)
    inc = (rng.random((S, P)) < 0.4).astype(np.float32)
    inc[0] = 1.0  # a patch with no coherent pixel: uniform anchors
    key = jax.random.key(patch)
    g = torch.tensor(np.asarray(jax.random.gumbel(key, (S, P))))
    for kw in (dict(), dict(num_sample=2, use_pred_logistics=True),
               dict(redundant_instance=1, threshold=0.5)):
        ref = jlosses.rgb_similarity_loss(key, jnp.asarray(rgb),
                                          jnp.asarray(im), jnp.asarray(inc),
                                          **kw)
        got = losses.rgb_similarity_loss(g, torch.from_numpy(rgb),
                                         torch.from_numpy(im),
                                         torch.from_numpy(inc), **kw)
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5,
                                   atol=1e-7, err_msg=str(kw))


def test_cache_ring_buffer():
    c = distill.Cache(3)
    assert not c.full()
    for i in range(5):
        c.insert(i)
    assert c.full() and sorted(c.data) == [2, 3, 4]
    assert c.get(np.random.default_rng(0)) in {2, 3, 4}
    empty = distill.Cache(0)
    empty.insert(1)
    assert empty.data == []


# -- tests/test_stages.py's protocol with the port's trainers ---------------

def _cfg(ws, mc, **sections):
    return config.Config(workspace=ws, render=_port(config.RenderConfig, RC),
                         model=mc, **sections)


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("s1"))
    ds = SyntheticSphereDataset(H=32, W=32, n_views=8)
    mc = _port(config.ModelConfig, MC1)
    cfg = _cfg(ws, mc, train=_port(config.TrainConfig, TC))
    tr = Trainer("s1", cfg, fields.make_model(mc, cfg.render), workspace=ws,
                 use_checkpoint="scratch", device="cpu")
    tr.train(ds, max_epoch=2, steps_per_epoch=60)
    return ws, tr.ckpt_mgr.list_checkpoints()[-1], ds


def _handoff(ckpt, mc, seed):
    model = fields.make_model(mc, _port(config.RenderConfig, RC))
    params = fields.init_params(model, torch.Generator().manual_seed(seed),
                                "cpu")
    merged, trainable = ckpt_lib.load_partial_and_freeze(ckpt, params)
    return model, merged, trainable


def test_sam_distillation_learns(stage1):
    ws, ckpt, ds = stage1
    mc2 = dataclasses.replace(_port(config.ModelConfig, MC1), with_sam=True,
                              sam_use_view_direction=True)
    model2, merged, trainable = _handoff(ckpt, mc2, 1)
    tc = _port(config.TrainConfig, TC)
    cfg2 = _cfg(ws + "_sam", mc2, train=dataclasses.replace(tc, iters=80,
                                                            lr=5e-3),
                sam=config.SamTrainConfig(cache_size=8, cache_interval=2,
                                          online_resolution=32))
    proj = np.random.default_rng(0).standard_normal(
        (3, mc2.sam_feat_dim)).astype(np.float32) * 0.3

    def teacher(img_uint8):  # learnable: a projection of the image
        return resize(img_uint8.astype(np.float32) / 255.0, (64, 64)) @ proj

    tr = distill.SamDistillTrainer(
        "s2", cfg2, model2, teacher=teacher, workspace=cfg2.workspace,
        use_checkpoint="scratch", trainable=trainable, init_params=merged,
        device="cpu")
    mse0 = tr.eval_feature_mse(ds, n_frames=2)
    tr.train(ds, max_epoch=2, steps_per_epoch=40)
    mse1 = tr.eval_feature_mse(ds, n_frames=2)
    assert np.isfinite(mse1)
    assert mse1 < mse0 * 0.8, f"distillation did not learn: {mse0} -> {mse1}"
    flat0, flat1 = flatten_tree(merged), flatten_tree(tr.state.params)
    np.testing.assert_array_equal(flat1["grid_mlp/0/w"], flat0["grid_mlp/0/w"])
    assert not np.allclose(flat1["samvit_mlp/0/w"], flat0["samvit_mlp/0/w"])


def test_mask_training_learns(stage1):
    ws, ckpt, ds = stage1
    mc3 = dataclasses.replace(_port(config.ModelConfig, MC1), with_mask=True,
                              mask_mlp_type="default", n_inst=2)
    model3, merged, trainable = _handoff(ckpt, mc3, 2)
    tc = _port(config.TrainConfig, TC)
    cfg3 = _cfg(ws + "_mask", mc3, train=dataclasses.replace(
        tc, iters=150, lr=1e-2, num_rays=512))
    tr = mask_trainer.MaskTrainer(
        "s3", cfg3, model3, workspace=cfg3.workspace, use_checkpoint="scratch",
        trainable=trainable, init_params=merged, device="cpu")
    miou0 = tr.evaluate_mask(ds, n_frames=2)
    tr.train(ds, max_epoch=3, steps_per_epoch=50)
    miou1 = tr.evaluate_mask(ds, n_frames=2)
    assert miou1 > max(miou0, 0.6), f"mask field: {miou0} -> {miou1}"
    flat0, flat1 = flatten_tree(merged), flatten_tree(tr.state.params)
    np.testing.assert_array_equal(flat1["grid_mlp/0/w"], flat0["grid_mlp/0/w"])


def test_mask_training_with_similarity_losses(stage1):
    """Mixed sampling, rgb similarity, label regularization, the dynamic
    incoherent refresh and the error map execute and stay finite."""
    ws, ckpt, _ = stage1
    mc3 = dataclasses.replace(_port(config.ModelConfig, MC1), with_mask=True,
                              n_inst=2)
    model3, merged, trainable = _handoff(ckpt, mc3, 3)
    mcfg = config.MaskTrainConfig(
        rgb_similarity_loss_weight=1.0, rgb_similarity_iter=0,
        mixed_sampling=True, num_local_sample=2, local_sample_patch_size=4,
        incoherent_uncertainty_weight=0.5, label_regularization_weight=0.1,
        use_dynamic_incoherent=True, incoherent_update_iter=5)
    cfg3 = _cfg(ws + "_mask2", mc3, mask=mcfg, train=dataclasses.replace(
        _port(config.TrainConfig, TC), iters=20, num_rays=256))

    class DS(SyntheticSphereDataset):
        incoherent_masks = None

        def collate_mask(self, rng, num_rays):
            b = super().collate_mask(rng, num_rays)
            parts = [b]
            for _ in range(mcfg.num_local_sample):
                rb = sample_rays(self.poses[b["index"]], self.intrinsics,
                                 self.H, self.W, N=16, patch_size=4, rng=rng)
                parts.append({"rays_o": rb.rays_o, "rays_d": rb.rays_d,
                              "masks": self.masks[b["index"]].reshape(-1)[
                                  rb.inds], "inds_coarse": rb.inds_coarse})
            out = {k: np.concatenate([p[k] for p in parts])
                   for k in ("rays_o", "rays_d", "masks", "inds_coarse")}
            out.update(index=b["index"], H=self.H, W=self.W,
                       incoherent_masks=self.incoherent_masks[
                           b["index"]].reshape(-1)[:len(out["masks"])])
            return out

    ds2 = DS(H=32, W=32, n_views=4)
    ds2.incoherent_masks = np.zeros((4, 32, 32), np.float32)
    tr = mask_trainer.MaskTrainer(
        "s3b", cfg3, model3, workspace=cfg3.workspace,
        use_checkpoint="scratch", trainable=trainable, init_params=merged,
        device="cpu")
    tr.train(ds2, max_epoch=1, steps_per_epoch=10)
    assert tr.global_step == 10
    assert ds2.incoherent_masks.shape == (4, 32, 32)
    assert set(np.unique(ds2.incoherent_masks)) <= {0.0, 1.0}
