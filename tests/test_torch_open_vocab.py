"""Parity: the port's open-vocabulary segmentation (sanerf_tpu_torch/apps/
open_vocab.py) against the JAX package's, on tests/test_open_vocab.py's
settings (its MC1, RC, TC; the 32^2 8-view sphere) with language
embeddings of D = 16.

Tolerances: `relevancy` 1e-5; the text encoder's and the region
teacher's outputs bit for bit; one LangDistillTrainer step as stage 2's in
tests/test_torch_stages.py (the loss within 1e-4 relative, each trainable
leaf's gradient within 1e-4 x its max |g|); the SAM-refined query's mask
on all but 0.1 % of the pixels; the offline query (`main`) within the
renderer suite's 2e-3 of the JAX package's relevancy. Then
tests/test_open_vocab.py's protocol with the port's trainers: the
feature MSE below 0.8 of its first value, the text query's IoU with the
sphere above 0.5, the peak on it.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_tpu.apps import open_vocab as jov
from sanerf_tpu.config import Config as JConfig
from sanerf_tpu.models import fields as jfields
from sanerf_tpu.models.sam import predictor as jpred
from sanerf_tpu.train import distill as jdistill
from sanerf_tpu.train.checkpoints import flatten_tree
from sanerf_tpu_torch import config
from sanerf_tpu_torch.apps import open_vocab as ov
from sanerf_tpu_torch.data.synthetic import SyntheticSphereDataset
from sanerf_tpu_torch.models import fields
from sanerf_tpu_torch.models.asset import params_from_jax
from sanerf_tpu_torch.models.renderer import run_rays
from sanerf_tpu_torch.models.sam import predictor
from sanerf_tpu_torch.train import checkpoints as ckpt_lib
from sanerf_tpu_torch.train import distill
from sanerf_tpu_torch.train import state as state_lib
from sanerf_tpu_torch.train.trainer import Trainer
from sanerf_tpu_torch.train.tree import tree_map
from sanerf_tpu_torch.utils.image import resize

from tests.test_open_vocab import MC1, RC, TC
from tests.test_sam import TINY_SAM
from tests.test_torch_sam import port_cfg
from tests.test_torch_stages import _capture_step, _hold

torch.set_num_threads(2)
D = 16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(cls, jcfg):
    return config.config_from_dict(cls, dataclasses.asdict(jcfg))


def _vocab(seed, n=2, d=D):
    v = np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _regions(img_uint8):
    return (img_uint8.mean(-1) > 40).astype(np.int32)


def test_relevancy_matches_jax():
    rng = np.random.default_rng(0)
    text, negs = _vocab(1, 1)[0], _vocab(2, 4)
    for shape in ((3,), (4, 5), (2, 3, 7)):
        feats = rng.standard_normal((*shape, D)).astype(np.float32)
        feats.reshape(-1, D)[0] = text * 3.0  # the query itself
        feats.reshape(-1, D)[-1] = 0.0  # a zero feature (the norm's floor)
        got = ov.relevancy(torch.from_numpy(feats), text, negs).numpy()
        ref = np.asarray(jov.relevancy(jnp.asarray(feats), jnp.asarray(text),
                                       jnp.asarray(negs)))
        assert got.shape == shape
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        assert got.reshape(-1)[0] > 0.5
    assert ov.CANONICAL_NEGATIVES == jov.CANONICAL_NEGATIVES


def test_text_encoder_and_region_teacher_equal_jax(tmp_path):
    table = {"a chair": np.arange(D, dtype=np.float32) - 3.0,
             "object": _vocab(3, 1)[0] * 7.0}
    path = str(tmp_path / "vocab.npz")
    np.savez(path, **table)
    a, b = ov.PrecomputedTextEncoder(path), jov.PrecomputedTextEncoder(path)
    np.testing.assert_array_equal(a.encode([" A Chair", "object"]),
                                  b.encode([" A Chair", "object"]))
    with pytest.raises(KeyError):
        a.encode(["a banana"])
    with pytest.raises(FileNotFoundError):
        ov.HFClipTextEncoder(str(tmp_path / "no_clip"))
    img = (np.random.default_rng(4).random((37, 53, 3)) * 255).astype(
        np.uint8)
    vocab = _vocab(5, 2)
    np.testing.assert_array_equal(
        ov.make_region_teacher(_regions, vocab, grid=24)(img),
        jov.make_region_teacher(_regions, vocab, grid=24)(img))


def test_text_query_mask_matches_jax():
    """The plain path, then the SAM refinement at the peak through the
    rendered-feature decode (tests/test_sam.py's TINY_SAM, same weights)."""
    vocab = _vocab(6, 2)
    fmap = np.tile(vocab[0], (6, 6, 1)).astype(np.float32)
    fmap[2:4, 2:4] = vocab[1]
    fmap += np.random.default_rng(7).normal(0, 0.05, fmap.shape).astype(
        np.float32)
    got = ov.text_query_mask(torch.from_numpy(fmap), vocab[1], vocab[:1])
    ref = jov.text_query_mask(jnp.asarray(fmap), jnp.asarray(vocab[1]),
                              jnp.asarray(vocab[:1]))
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5, atol=1e-5)
    assert got[2] == ref[2] and got[0][2:4, 2:4].all()

    jsam = jpred.init_params(TINY_SAM, jax.random.key(1))
    tsam = predictor.SamPredictor(
        port_cfg(TINY_SAM), predictor.params_from_jax(flatten_tree(jsam, ""),
                                                      port_cfg(TINY_SAM)),
        device="cpu")
    smap = np.random.default_rng(8).normal(0, 1, (6, 6, 32)).astype(
        np.float32)
    got = ov.text_query_mask(torch.from_numpy(fmap), vocab[1], vocab[:1],
                             sam_predictor=tsam,
                             samvit_map=torch.from_numpy(smap),
                             frame_hw=(48, 48))
    ref = jov.text_query_mask(jnp.asarray(fmap), jnp.asarray(vocab[1]),
                              jnp.asarray(vocab[:1]),
                              sam_predictor=jpred.SamPredictor(TINY_SAM,
                                                               jsam),
                              samvit_map=jnp.asarray(smap), frame_hw=(48, 48))
    assert got[0].shape == (48, 48) and got[0].dtype == bool
    assert (got[0] == ref[0]).mean() >= 0.999
    assert got[2] == ref[2]


def test_lang_distill_step_matches_jax(tmp_path):
    """The normalised teacher target and one stage-2 step on it, against
    the JAX step body (D = 16, the samvit head outside the kernels)."""
    jmc = dataclasses.replace(MC1, with_sam=True, sam_use_view_direction=True,
                              sam_feat_dim=D)
    jcfg = JConfig(render=RC, model=jmc, train=TC)
    jm = jfields.make_model(jmc, RC)
    jp = jfields.init_params(jm, jax.random.key(0))
    model = fields.make_model(_port(config.ModelConfig, jmc),
                              _port(config.RenderConfig, RC))
    params = params_from_jax(flatten_tree(jp, "params/"), model, "cpu")
    heads = ("s_field_mlp", "samvit_mlp", "samvit_norm")
    ttrain = {k: tree_map(lambda _: k in heads, v) for k, v in params.items()}
    cfg = _port(config.Config, jcfg)
    vocab = _vocab(9, 2) * np.float32([[3.0], [0.5]])  # not unit length
    teacher = ov.make_region_teacher(_regions, vocab, grid=32)
    tr = ov.LangDistillTrainer("lang", cfg, model, teacher=teacher,
                               workspace=str(tmp_path),
                               use_checkpoint="scratch", device="cpu")
    jtr = jov.LangDistillTrainer.__new__(jov.LangDistillTrainer)
    jtr.teacher = jov.make_region_teacher(_regions, vocab, grid=32)
    ds = SyntheticSphereDataset(H=32, W=32, n_views=4)
    b = ds.collate_sam(np.random.default_rng(3))
    img = (np.clip(ds.images[b["index"]], 0, 1) * 255).astype(np.uint8)
    gt = tr.teacher_features(img)
    jgt = jtr.teacher_features(img)
    np.testing.assert_allclose(gt.numpy(), np.asarray(jgt), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(gt.numpy(), axis=-1), 1.0,
                               rtol=1e-6)
    jb = {k: jnp.asarray(v) for k, v in b.items()
          if isinstance(v, np.ndarray)}
    jaux, jg = _capture_step(
        lambda tx, st, jb, gt: jdistill.sam_step_body(
            jm, jcfg, tx, st, jb, gt, jax.random.key(2), b["h"], b["w"]))(
        jp, jb, jgt)
    tb = {k: torch.from_numpy(v) for k, v in b.items()
          if isinstance(v, np.ndarray)}
    loss, _, grads = state_lib.value_and_grads(
        lambda p: distill.sam_loss_fn(model, p, tb, gt, b["h"], b["w"]),
        params, ttrain)
    np.testing.assert_allclose(loss.item(), float(jaux["loss"]), rtol=1e-4)
    _hold(grads, jg, heads)


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("ov_s1"))
    ds = SyntheticSphereDataset(H=32, W=32, n_views=8)
    mc = _port(config.ModelConfig, MC1)
    cfg = config.Config(workspace=ws, render=_port(config.RenderConfig, RC),
                        model=mc, train=_port(config.TrainConfig, TC))
    tr = Trainer("s1", cfg, fields.make_model(mc, cfg.render), workspace=ws,
                 use_checkpoint="scratch", device="cpu")
    tr.train(ds, max_epoch=2, steps_per_epoch=60)
    return ws, tr.ckpt_mgr.list_checkpoints()[-1], ds


def test_lang_distillation_and_text_query(stage1):
    """tests/test_open_vocab.py's protocol on the port (sam_feat_dim 8 there:
    MC1's)."""
    ws, ckpt, ds = stage1
    mc2 = dataclasses.replace(_port(config.ModelConfig, MC1), with_sam=True,
                              sam_use_view_direction=True)
    rc = _port(config.RenderConfig, RC)
    model2 = fields.make_model(mc2, rc)
    merged, trainable = ckpt_lib.load_partial_and_freeze(
        ckpt, fields.init_params(model2, torch.Generator().manual_seed(1)))
    vocab = _vocab(3, 2, mc2.sam_feat_dim)
    cfg2 = config.Config(
        workspace=ws + "_lang", render=rc, model=mc2,
        train=dataclasses.replace(_port(config.TrainConfig, TC), iters=120,
                                  lr=5e-3),
        sam=config.SamTrainConfig(cache_size=8, cache_interval=2,
                                  online_resolution=32))
    tr = ov.LangDistillTrainer(
        "lang", cfg2, model2,
        teacher=ov.make_region_teacher(_regions, vocab, grid=32),
        workspace=cfg2.workspace, use_checkpoint="scratch",
        trainable=trainable, init_params=merged, device="cpu")
    mse0 = tr.eval_feature_mse(ds, n_frames=2)
    tr.train(ds, max_epoch=2, steps_per_epoch=60)
    mse1 = tr.eval_feature_mse(ds, n_frames=2)
    assert mse1 < mse0 * 0.8, f"lang distill did not learn: {mse0} -> {mse1}"

    batch = ds.collate_sam(np.random.default_rng(0), index=0)
    with torch.no_grad():
        out = run_rays(model2, tr.state.params,
                       torch.from_numpy(batch["rays_o_lr"]),
                       torch.from_numpy(batch["rays_d_lr"]),
                       return_feats=True)
        full = run_rays(model2, tr.state.params,
                        torch.from_numpy(batch["rays_o"]),
                        torch.from_numpy(batch["rays_d"]))
    h, w = batch["h"], batch["w"]
    mask, rel, peak = ov.text_query_mask(out["samvit"].reshape(h, w, -1),
                                         vocab[1], vocab[:1])
    rgb = full["image"].numpy().reshape(batch["H"], batch["W"], 3)
    gt = resize((rgb.mean(-1) > 40 / 255).astype(np.uint8), (w, h),
                "nearest").astype(bool)
    iou = (mask & gt).sum() / max((mask | gt).sum(), 1)
    assert iou > 0.5, f"text query IoU too low: {iou:.3f}"
    assert gt[int(peak[1]), int(peak[0])]


def test_offline_query_main_matches_jax(tmp_path):
    """`main` on a scene and a workspace's checkpoint (CLI flags, the
    samvit head 256 wide as the CLI builds it): the port's relevancy maps
    within 2e-3 of the JAX package's, the masks written."""
    sys.path.insert(0, os.path.join(ROOT, "port_tools"))
    from scene_files import write_transforms_scene

    ds = SyntheticSphereDataset(H=16, W=16, n_views=4)
    scene = write_transforms_scene(ds, str(tmp_path / "scene"))
    ws = str(tmp_path / "ws")
    vocab = str(tmp_path / "vocab.npz")
    v = _vocab(10, 5, 256)
    np.savez(vocab, **{p: v[i] for i, p in enumerate(
        ("a sphere", *jov.CANONICAL_NEGATIVES))})
    argv = [scene, "--workspace", ws, "--data_type", "llff", "--bound", "4",
            "--num_steps", "8", "4", "--with_sam", "--sam_use_view_direction",
            "--mlp_width", "16", "--mlp_depth", "2", "--online_resolution",
            "64", "--vocab", vocab, "--phrase", "a sphere", "--test_split",
            "test"]
    from sanerf_tpu_torch.apps.main import build_parser, config_from_args

    cfg = config_from_args(build_parser().parse_known_args(argv)[0])
    model = fields.make_model(cfg.model, cfg.render)
    Trainer("ngp", cfg, model, use_checkpoint="scratch",
            device="cpu").save_checkpoint()
    out_t = ov.main(argv + ["--out_dir", str(tmp_path / "t")], device="cpu")
    jov.main(argv + ["--out_dir", str(tmp_path / "j")])
    names = sorted(os.listdir(out_t))
    assert names == sorted(os.listdir(tmp_path / "j")) and len(names) >= 2
    for n in names:
        a, b = np.load(os.path.join(out_t, n)), np.load(tmp_path / "j" / n)
        assert a.shape == b.shape == (4, 4)
        if n.endswith("_relevancy.npy"):
            np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3)
