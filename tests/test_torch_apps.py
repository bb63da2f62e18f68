"""Parity: the port's apps (sanerf_tpu_torch/apps/evaluation.py,
sam_project.py, auto_generator.py, gui.py, batch.py) against the JAX
package's, set up as tests/test_apps.py sets up its tests (tiny MLP field
with the SAM head, tests/test_sam.py:TINY_SAM), the same weights on both
sides.

Tolerances: bit for bit (np.array_equal) for the numpy helpers
(projection, point grids, crop boxes, RLE, stability scores, box NMS),
evaluation's IoU and accuracy on the same files, cv2's grayscale PNG read,
valid.json and mask_iters_heuristic; the decoder's logits at
tests/test_torch_sam.py's DEC_TOL; generate_masks' label maps agree on at
least 99.9 % of the pixels; the automatic generator gives the same masks
(its candidates' scores are checked to lie off the thresholds by more than
1e-4); the viewer's frames as tests/test_torch_frame_pipeline.py holds the
session's (u8 within 1 where the masks agree, masks on all but 2 %).
"""

import dataclasses
import json
import os

import cv2
import jax
import numpy as np
import pytest
import torch

from sanerf_tpu.apps import auto_generator as jag
from sanerf_tpu.apps import batch as jbatch
from sanerf_tpu.apps import evaluation as jev
from sanerf_tpu.apps import gui as jgui
from sanerf_tpu.apps import sam_project as jsp
from sanerf_tpu.apps.interactive import InteractiveSession as JSession
from sanerf_tpu.config import Config as JConfig
from sanerf_tpu.config import TrainConfig as JTrainConfig
from sanerf_tpu.models import fields as jfields
from sanerf_tpu.models.sam import predictor as jpred
from sanerf_tpu.train.checkpoints import flatten_tree
from sanerf_tpu.train.trainer import Trainer as JTrainer
from sanerf_tpu_torch.apps import auto_generator as ag
from sanerf_tpu_torch.apps import batch
from sanerf_tpu_torch.apps import evaluation as ev
from sanerf_tpu_torch.apps import gui
from sanerf_tpu_torch.apps import sam_project as sp
from sanerf_tpu_torch.apps.interactive import InteractiveSession
from sanerf_tpu_torch.config import Config, config_from_dict
from sanerf_tpu_torch.data.synthetic import SyntheticSphereDataset
from sanerf_tpu_torch.models import fields
from sanerf_tpu_torch.models.asset import params_from_jax
from sanerf_tpu_torch.models.sam import predictor
from sanerf_tpu_torch.train.trainer import Trainer
from sanerf_tpu_torch.utils.camera import OrbitCamera

from tests.test_apps import MC, RC
from tests.test_sam import TINY_SAM
from tests.test_torch_sam import DEC_TOL, port_cfg

torch.set_num_threads(2)
SAM = port_cfg(TINY_SAM)


def _cfg(jcfg):
    return config_from_dict(Config, dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def setup():
    """(JAX model, params, SAM params; port model, params, SAM params),
    the SAM decoder's and encoder's weights drawn non-trivially."""
    jm = jfields.make_model(MC, RC)
    jp = jfields.init_params(jm, jax.random.key(0))
    jsam = jpred.init_params(TINY_SAM, jax.random.key(1))
    tcfg = _cfg(JConfig(render=RC, model=MC))
    tm = fields.make_model(tcfg.model, tcfg.render)
    tp = params_from_jax(flatten_tree(jp, "params/"), tm)
    tsam = predictor.params_from_jax(flatten_tree(jsam, ""), SAM)
    return jm, jp, jsam, tm, tp, tsam


def _predictors(setup):
    _, _, jsam, _, _, tsam = setup
    return (jpred.SamPredictor(TINY_SAM, jsam),
            predictor.SamPredictor(SAM, tsam, device="cpu"))


# -- evaluation -----------------------------------------------------------------

def _png(path, img):
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR if img.shape[-1] == 3
                           else cv2.COLOR_RGBA2BGRA)
    cv2.imwrite(path, img)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_read_gray_png_is_cv2_grayscale(tmp_path, channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (23, 37, channels), dtype=np.uint8)
    img[0] = img[0, :, :1]  # a row of grey pixels
    path = str(tmp_path / "a.png")
    _png(path, img[..., 0] if channels == 1 else img)
    np.testing.assert_array_equal(ev.read_gray_png(path),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def test_iou_and_accuracy_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        gt = rng.integers(-1, 2, (31, 17))
        pred = rng.integers(0, 3, (31, 17))
        assert ev.eval_iou(pred, gt) == jev.eval_iou(pred, gt)
        assert ev.eval_acc(pred, gt) == jev.eval_acc(pred, gt)
    empty = np.full((4, 4), -1)
    assert ev.eval_iou(empty, empty) == jev.eval_iou(empty, empty) == 1.0
    assert ev.eval_acc(empty, empty) == jev.eval_acc(empty, empty) == 1.0


def test_evaluate_scene_equals_jax(tmp_path):
    """Every method's loader on the same files (logits and labels, RGB,
    RGBA and gray PNGs, a prediction at another size), through
    evaluate_scene and main."""
    rng = np.random.default_rng(1)
    gt_dir, res = str(tmp_path / "gt"), str(tmp_path / "res")
    os.makedirs(gt_dir)
    os.makedirs(res)
    names = ["a", "b", "c", "d"]
    for i, n in enumerate(names):
        gt = np.zeros((24, 32), np.int64)
        gt[4 + i:18, 6:20 + i] = 1
        gt[::5] = -1
        np.save(os.path.join(gt_dir, f"{n}_masks.npy"), gt)
        logits = rng.normal(0, 1, (24, 32, 2)).astype(np.float32)
        logits[5:17, 7:21, 1] += 2.0
        np.save(os.path.join(res, f"{n}_mask.npy"),
                logits if i % 2 else (logits[..., 1] > 0).astype(np.int64)
                if i == 0 else np.argmax(logits[::2, ::2], -1))
        img = (rng.random((24, 32, 3 if i < 2 else 4)) * 255).astype(np.uint8)
        img[5:17, 7:21] = 200
        _png(os.path.join(res, f"{n}.png"), img if i != 3 else img[..., 0])
        _png(os.path.join(res, f"{n}_mask.png"), img)
    for method in ("ours", "sa3d", "isrf"):
        ref = jev.evaluate_scene(gt_dir, res, names + ["none"], method)
        got = ev.evaluate_scene(gt_dir, res, names + ["none"], method)
        assert got == ref, method
        assert got["n_views"] == 4
    views = str(tmp_path / "views.json")
    with open(views, "w") as f:
        json.dump({"s": ["b", "c"]}, f)
    for argv in ([], ["--test_view_json", views, "--scene_name", "s"]):
        argv = ["--gt_dir", gt_dir, "--result_dir", res, *argv]
        assert ev.main(argv) == jev.main(argv)


# -- sam_project ----------------------------------------------------------------

def test_projection_equals_jax(tmp_path):
    ds = SyntheticSphereDataset(H=32, W=40, n_views=3)
    rng = np.random.default_rng(2)
    pts = rng.normal(0, 0.7, (50, 3)).astype(np.float32)
    for pose in ds.poses:
        got = sp.project_to_2d(pts, pose, ds.intrinsics, 32, 40)
        ref = jsp.project_to_2d(pts, pose, ds.intrinsics, 32, 40)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
        assert got[2].any() and not got[2].all()
        back = sp.project_to_3d(got[0], got[1], pose, ds.intrinsics)
        np.testing.assert_array_equal(
            back, jsp.project_to_3d(ref[0], ref[1], pose, ds.intrinsics))
    meta = {"scene": {"obj": {"points": pts[:3].tolist(),
                              "negative_points": pts[3:5].tolist()}}}
    path = str(tmp_path / "meta.json")
    with open(path, "w") as f:
        json.dump(meta, f)
    for a, b in zip(sp.load_scene_metadata(path, "scene", "obj"),
                    jsp.load_scene_metadata(path, "scene", "obj")):
        np.testing.assert_array_equal(a, b)


def _trainers(setup, tmp_path):
    jm, jp, _, tm, tp, _ = setup
    jcfg = JConfig(render=RC, model=MC, workspace=str(tmp_path / "j"))
    jt = JTrainer("j", jcfg, jm, workspace=jcfg.workspace,
                  use_checkpoint="scratch", init_params=jp)
    tt = Trainer("t", _cfg(jcfg), tm, workspace=str(tmp_path / "t"),
                 use_checkpoint="scratch", init_params=tp, device="cpu")
    return jcfg, jt, tt


@pytest.mark.parametrize("route", ["nerf_feature", "image"])
def test_generate_masks_matches_jax(setup, tmp_path, route):
    """Both routes with the occlusion test on the rendered depth: valid.json
    bit for bit, the label maps on >= 99.9 % of the pixels, the overlays
    written. The first point sits on the rendered surface of the first
    view, the second behind it, a third off every screen; one negative."""
    jcfg, jt, tt = _trainers(setup, tmp_path)
    jsam, tsam = _predictors(setup)
    ds = SyntheticSphereDataset(H=32, W=32, n_views=3)
    depth = tt.render_pose(ds.poses[0], ds.intrinsics, 32, 32)["depth"]
    front = sp.project_to_3d(np.array([[14.0, 17.0]]),
                             depth.reshape(32, 32)[17:18, 14], ds.poses[0],
                             ds.intrinsics)[0]
    pts = np.stack([front, front * 1.5, [0.0, 9.0, 0.0]]).astype(np.float32)
    neg = np.array([[0.3, -0.2, 0.1]], np.float32)
    kw = dict(negative_points=neg, use_nerf_feature=route == "nerf_feature",
              depth_threshold=0.05)
    out_j, out_t = str(tmp_path / "mj"), str(tmp_path / "mt")
    vj = jsp.generate_masks(jcfg, ds, pts, jsam, out_j, trainer=jt, **kw)
    vt = sp.generate_masks(_cfg(jcfg), ds, pts, tsam, out_t, trainer=tt,
                           **kw)
    assert vt == vj and any(vt.values())
    with open(os.path.join(out_j, "valid.json")) as f, \
            open(os.path.join(out_t, "valid.json")) as g:
        assert f.read() == g.read()
    same = total = 0
    for name in vt:
        a = np.load(os.path.join(out_j, f"{name}_masks.npy"))
        b = np.load(os.path.join(out_t, f"{name}_masks.npy"))
        assert a.shape == b.shape == (32, 32) and b.dtype == np.int64
        same += int((a == b).sum())
        total += a.size
        assert os.path.exists(os.path.join(out_t, f"{name}_overlay.png")) \
            == vt[name]
    assert same >= 0.999 * total, (same, total)


# -- auto_generator -------------------------------------------------------------

def test_numpy_helpers_equal_jax():
    rng = np.random.default_rng(3)
    for n in (1, 3, 4, 32):
        np.testing.assert_array_equal(ag.build_point_grid(n),
                                      jag.build_point_grid(n))
    for hw, layers, ratio in (((64, 64), 1, 512 / 1500), ((48, 80), 2, 0.2),
                              ((100, 37), 3, 512 / 1500)):
        assert ag.generate_crop_boxes(hw, layers, ratio) == \
            jag.generate_crop_boxes(hw, layers, ratio)
    for shape in ((13, 17), (1, 1), (5, 9)):
        m = rng.random(shape) > 0.5
        m.flat[0] = shape[0] % 2 == 1
        assert ag.mask_to_rle(m) == jag.mask_to_rle(m)
        np.testing.assert_array_equal(ag.rle_to_mask(ag.mask_to_rle(m)), m)
        np.testing.assert_array_equal(ag.box_from_mask(m),
                                      jag.box_from_mask(m))
    np.testing.assert_array_equal(ag.box_from_mask(np.zeros((3, 3), bool)),
                                  jag.box_from_mask(np.zeros((3, 3), bool)))
    logits = rng.normal(0, 2, (6, 16, 16)).astype(np.float32)
    np.testing.assert_array_equal(ag.batch_stability_scores(logits, 0.0),
                                  jag.batch_stability_scores(logits, 0.0))
    for k in range(6):
        assert ag.mask_stability_score(logits[k], 0.5) == \
            jag.mask_stability_score(logits[k], 0.5)
    boxes = rng.integers(0, 40, (60, 2)).astype(np.float64)
    boxes = np.concatenate([boxes, boxes + rng.integers(1, 30, (60, 2))], 1)
    scores = np.round(rng.random(60), 1)  # ties
    for thr in (0.3, 0.5, 0.7):
        assert ag.box_nms(boxes, scores, thr) == jag.box_nms(boxes, scores,
                                                             thr)
    for box in boxes[:20]:
        assert ag.box_near_crop_edge(box, [0, 0, 32, 32], [0, 0, 64, 64]) \
            == jag.box_near_crop_edge(box, [0, 0, 32, 32], [0, 0, 64, 64])


def test_predict_batch_matches_jax_and_the_loop(setup):
    """One batched decode per chunk: its logits and IoUs against JAX's and
    against the port's one-point-at-a-time decode, at DEC_TOL."""
    jsam, tsam = _predictors(setup)
    feats = np.random.default_rng(1).normal(0, 1, (8, 8, 32)).astype(
        np.float32)
    jsam.set_features(feats, 64, 64)
    tsam.set_features(torch.from_numpy(feats), 64, 64)
    pts = ag.build_point_grid(3) * 64.0
    lt, it = tsam.predict_batch(pts[:, None, :], chunk=4)
    lj, ij = jsam.predict_batch(pts[:, None, :], chunk=4)
    np.testing.assert_allclose(lt, lj, **DEC_TOL)
    np.testing.assert_allclose(it, ij, **DEC_TOL)
    for k in range(len(pts)):
        masks, iou, _ = tsam.predict(pts[k:k + 1], np.ones(1, np.int32),
                                     multimask_output=True,
                                     return_logits=True)
        np.testing.assert_allclose(lt[k], masks, **DEC_TOL)
        np.testing.assert_allclose(it[k], iou, **DEC_TOL)


def _sharp_predictors(setup):
    """The predictors with the hypernetworks' last layers x1000 and the IoU
    head's x10: the seeded decoder's mask logits, within +-1.3, then spread
    to +-31, so the stability scores (offset 1) leave 0."""
    from sanerf_tpu.train.checkpoints import unflatten_like

    jsam = setup[2]
    flat = flatten_tree(jsam, "")
    for k in flat:
        if k.startswith("mask_decoder/hyper_mlps") and k.endswith("2/w"):
            flat[k] = flat[k] * 1000.0
        elif k == "mask_decoder/iou_head/layers/2/w":
            flat[k] = flat[k] * 10.0
    return (jpred.SamPredictor(TINY_SAM, unflatten_like(jsam, flat, "")),
            predictor.SamPredictor(SAM, predictor.params_from_jax(flat, SAM),
                                   device="cpu"))


@pytest.mark.parametrize("layers", [0, 1])
def test_auto_generator_equals_jax(setup, layers):
    """Rendered-feature route, with and without the crop pyramid: the same
    records (RLE, area, box, point, crop box; scores at DEC_TOL). Every
    candidate's IoU and stability lie more than 1e-4 off the thresholds
    (checked on JAX's candidates), so the filters must agree."""
    jsam, tsam = _sharp_predictors(setup)
    feats = np.random.default_rng(2).normal(0, 1, (8, 8, 32)).astype(
        np.float32)
    kw = dict(points_per_side=4, pred_iou_thresh=0.4,
              stability_score_thresh=0.65, crop_n_layers=layers,
              crop_n_points_downscale_factor=2, points_per_batch=8)
    gj, gt = jag.AutomaticMaskGenerator(jsam, **kw), \
        ag.AutomaticMaskGenerator(tsam, **kw)
    seen = []
    real = jsam.predict_batch

    def spy(*a, **k):
        logits, iou = real(*a, **k)
        seen.append((iou.ravel(), jag.batch_stability_scores(
            logits.reshape(-1, *logits.shape[2:]), 0.0)))
        return logits, iou

    jsam.predict_batch = spy
    ref = gj.generate(features=feats, hw=(64, 64))
    got = gt.generate(features=torch.from_numpy(feats), hw=(64, 64))
    ious = np.concatenate([s[0] for s in seen])
    stab = np.concatenate([s[1] for s in seen])
    assert np.abs(ious - 0.4).min() > 1e-4
    assert np.abs(stab - 0.65).min() > 1e-4
    assert len(ref) > 0 and len(got) == len(ref)
    for a, b in zip(got, ref):
        for k in ("segmentation", "area", "bbox", "point_coords",
                  "crop_box"):
            assert a[k] == b[k], k
        for k in ("predicted_iou", "stability_score"):
            np.testing.assert_allclose(a[k], b[k], **DEC_TOL)


# -- gui ------------------------------------------------------------------------

def test_adaptive_controller_equals_jax():
    a, b = gui.AdaptiveController(), jgui.AdaptiveController()
    for ms in (900.0, 120.0, 3000.0, 40.0, 510.0, 1.0, 20000.0, 250.0):
        a.update_train_steps(ms)
        b.update_train_steps(ms)
        a.update_downscale(ms / 3)
        b.update_downscale(ms / 3)
        assert (a.train_steps, a.downscale) == (b.train_steps, b.downscale)


def test_orbit_camera_equals_jax():
    from sanerf_tpu.utils.camera import OrbitCamera as JOrbit

    a, b = OrbitCamera(64, 48), JOrbit(64, 48)
    for op, args in (("orbit", (50, 10)), ("scale", (2,)), ("pan", (3, -4)),
                     ("orbit", (-20, 7))):
        getattr(a, op)(*args)
        getattr(b, op)(*args)
        np.testing.assert_array_equal(a.pose, b.pose)
    np.testing.assert_array_equal(a.intrinsics, b.intrinsics)


def _hold_frame(got, ref):
    """u8 within 1 where the masks agree; masks on all but 2 %."""
    assert got.rgb_u8.shape == ref.rgb_u8.shape
    differ = np.zeros(got.rgb_u8.shape[:2], bool)
    if ref.mask is not None:
        differ = np.asarray(got.mask) != np.asarray(ref.mask)
        assert differ.mean() <= 0.02
        k = got.rgb_u8.shape[0] // differ.shape[0]  # a downscaled frame
        differ = differ.repeat(k, 0).repeat(k, 1)
    d = np.abs(got.rgb_u8.astype(int) - np.asarray(ref.rgb_u8).astype(int))
    assert d[~differ].max() <= 1


def test_headless_viewer_matches_jax(setup):
    """The same orbit, clicks, live AABB, depth mode and a downscale of 2
    through both viewers (pipelined: each frame returns the one before;
    the controllers' downscale, which follows the host's frame times, held
    fixed)."""
    jm, jp, jsam, tm, tp, tsam = setup
    jcfg = JConfig(render=RC, model=MC)
    js = JSession(jcfg, jm, jp, jpred.SamPredictor(TINY_SAM, jsam), H=64,
                  W=64, fetch_format="rgb8")
    ts = InteractiveSession(_cfg(jcfg), tm, tp,
                            predictor.SamPredictor(SAM, tsam, device="cpu"),
                            H=64, W=64, fetch_format="rgb8", device="cpu")
    vj, vt = jgui.HeadlessViewer(jcfg, js), gui.HeadlessViewer(_cfg(jcfg), ts)
    for v in (vj, vt):  # the downscale follows the host's frame times
        v.ctrl.update_downscale = lambda ms: None
    steps = [("orbit", (50, 10)), ("frame", ()), ("frame", ()),
             ("right_click", (32, 32)), ("frame", ()), ("pan", (3, 0)),
             ("frame", ()), ("zoom", (1,)), ("frame", ()), ("frame", ())]
    for op, args in steps:
        rj, rt = getattr(vj, op)(*args), getattr(vt, op)(*args)
        if op in ("frame", "right_click"):
            _hold_frame(rt, rj)
            assert len(ts.points_3d) == len(js.points_3d)
    assert len(ts.points_3d) == 1
    np.testing.assert_allclose(ts.points_3d[0], js.points_3d[0], atol=2e-3)
    for v in (vj, vt):
        v.aabb = np.asarray([-0.05] * 3 + [0.05] * 3, np.float32)
        v.mark_dirty()
    _hold_frame(vt.frame(), vj.frame())
    _hold_frame(vt.frame(), vj.frame())
    for v in (vj, vt):
        v.mode = "depth"
        v.mark_dirty()
    vj.frame(), vt.frame()
    rj, rt = vj.frame(), vt.frame()
    _hold_frame(rt, rj)
    assert vt.fps > 0
    vj.ctrl.downscale = vt.ctrl.downscale = 2
    vj.mark_dirty(), vt.mark_dirty()
    vj.frame(), vt.frame()
    rj, rt = vj.frame(), vt.frame()
    assert rt.rgb_u8.shape == (64, 64, 3)
    _hold_frame(rt, rj)


def test_headless_viewer_spp_and_controls(setup):
    """tests/test_apps.py's control-surface protocol on the port: spp
    accumulation restarts when the camera moves, the accumulated frame
    stays finite, a static frame at max_spp is reused, the train controls
    are no-ops without a trainer."""
    _, _, _, tm, tp, tsam = setup
    ts = InteractiveSession(_cfg(JConfig(render=RC, model=MC)), tm, tp,
                            predictor.SamPredictor(SAM, tsam, device="cpu"),
                            H=32, W=32, device="cpu")
    v = gui.HeadlessViewer(Config(), ts)
    v.max_spp = 3
    v.frame()
    assert v.spp == 1
    r2 = v.frame()
    assert v.spp == 2 and np.isfinite(r2.composed).all()
    v.frame()
    assert v.spp == 3
    n = ts.dispatch_count
    assert v.frame() is v._last_result and ts.dispatch_count == n
    v.pan(3, 0)
    v.frame()
    assert v.spp == 1
    v.start_training()
    assert not v.training
    v.stop_training()
    v.save_checkpoint()
    v.ctrl.update_downscale(3000.0)
    assert v.ctrl.downscale > 1
    assert v.frame().rgb_u8.shape == (32, 32, 3)


def test_headless_viewer_trains_between_frames(tmp_path):
    """With a trainer and a dataset the viewer takes ctrl.train_steps
    Trainer steps before each frame and shows the EMA weights."""
    mc = dataclasses.replace(MC, with_sam=False)
    cfg = _cfg(JConfig(render=RC, model=mc, workspace=str(tmp_path),
                       train=JTrainConfig(num_rays=128,
                                          adaptive_num_rays=False)))
    tm = fields.make_model(cfg.model, cfg.render)
    tr = Trainer("v", cfg, tm, use_checkpoint="scratch", device="cpu")
    ds = SyntheticSphereDataset(H=32, W=32, n_views=4)
    ts = InteractiveSession(cfg, tm, tr.eval_params(), None, H=32, W=32,
                            device="cpu")
    v = gui.HeadlessViewer(cfg, ts, tr, ds)
    assert v.training
    v.ctrl.train_steps = 4
    r = v.frame()
    assert tr.global_step == 4 and ts.params is tr.eval_params()
    assert np.isfinite(r.rgb).all()
    v.stop_training()
    v.frame()
    assert tr.global_step == 4


def test_launch_gui_writes_headless_frames(setup, tmp_path):
    """No dearpygui here: launch_gui spins the headless loop, its frames
    512^2 PNGs under <workspace>/gui_frames, the last one the viewer's
    last frame (the frames' pixels are held against JAX above)."""
    _, _, _, tm, tp, _ = setup
    jcfg = JConfig(render=RC, model=MC, workspace=str(tmp_path / "t"))
    tr = Trainer("g", _cfg(jcfg), tm, use_checkpoint="scratch",
                 init_params=tp, device="cpu")
    v = gui.launch_gui(_cfg(jcfg), tr, None)
    files = sorted(os.listdir(tmp_path / "t" / "gui_frames"))
    assert files == [f"frame_{i:03d}.png" for i in range(10)]
    from sanerf_tpu_torch.utils.image import read_png

    img = read_png(str(tmp_path / "t" / "gui_frames" / "frame_009.png"))
    assert img.shape == (512, 512, 3) and v.fps > 0
    np.testing.assert_array_equal(img, v._last_result.rgb_u8)
    assert not v.training  # no dataset: the viewer does not train


# -- batch ----------------------------------------------------------------------

def test_batch_registry_and_heuristic_equal_jax(tmp_path):
    reg = str(tmp_path / "scene_list.json")
    with open(reg, "w") as f:
        json.dump({"mip": ["garden", "room"], "llff": ["fern"]}, f)
    for dt in ("mip", "llff", "lerf"):
        assert batch.load_scene_list(reg, dt) == jbatch.load_scene_list(reg,
                                                                        dt)
    assert batch.mask_iters_heuristic(str(tmp_path / "none.json")) == 250
    for n_valid, n in ((0, 3), (5, 9), (100, 120)):
        path = str(tmp_path / f"valid_{n}.json")
        with open(path, "w") as f:
            json.dump({f"v{i}": i < n_valid for i in range(n)}, f)
        for kw in ({}, dict(base=10, per_view=3, cap=40)):
            assert batch.mask_iters_heuristic(path, **kw) == \
                jbatch.mask_iters_heuristic(path, **kw)


@pytest.mark.parametrize("command", ["train-rgb", "train-sam", "train-mask",
                                     "eval-rgb", "eval-feat", "eval-mask"])
def test_batch_commands_run_the_jax_configs(tmp_path, monkeypatch, command):
    """Each subcommand hands `run` the Config the JAX driver hands its
    `run`, scene by scene and object by object."""
    data, out = tmp_path / "data", tmp_path / "trials"
    for scene in ("s1", "s2"):
        os.makedirs(out / f"{scene}_rgb" / "checkpoints")
        for step in (5, 10):
            (out / f"{scene}_rgb" / "checkpoints" /
             f"ngp_step{step:08d}.npz").write_bytes(b"")
        os.makedirs(data / scene / "chair")
        with open(data / scene / "chair" / "valid.json", "w") as f:
            json.dump({"a": True, "b": scene == "s2"}, f)
    meta = str(tmp_path / "meta.json")
    with open(meta, "w") as f:
        json.dump({"s1": {"chair": {}}, "s2": {"chair": {}, "lamp": {}}}, f)
    seen = {"jax": [], "port": []}
    monkeypatch.setattr(jbatch, "run", lambda cfg: seen["jax"].append(
        dataclasses.asdict(cfg)))
    monkeypatch.setattr(batch, "run", lambda cfg, device=None: seen[
        "port"].append(dataclasses.asdict(cfg)))
    argv = [command, "--data_root", str(data), "--out_root", str(out),
            "--metadata", meta, "--scenes", "s1", "s2", "--iters", "7",
            "--object_name", "chair"]
    jbatch.main(argv)
    batch.main(argv, device="cpu")
    assert len(seen["port"]) == (3 if command == "train-mask" else 2)
    assert seen["port"] == seen["jax"]


def test_sam_project_main_matches_jax(tmp_path, monkeypatch):
    """`main` end to end on scene files, a workspace's checkpoint and a
    tiny seeded SAM checkpoint in the official key layout, the rendered-
    feature route: the JAX package's valid.json and labels."""
    import sys

    from sanerf_tpu.models.sam import convert as jconvert
    from sanerf_tpu_torch.apps.main import build_parser, config_from_args
    from sanerf_tpu_torch.models.sam import convert as tconvert

    from tests.test_torch_cli import ROOT, _tiny_sam_checkpoint

    sys.path.insert(0, os.path.join(ROOT, "port_tools"))
    from scene_files import write_transforms_scene

    ds = SyntheticSphereDataset(H=16, W=16, n_views=4)
    scene = write_transforms_scene(ds, str(tmp_path / "scene"))
    pth = str(tmp_path / "sam.pth")
    tcfg = _tiny_sam_checkpoint(pth)
    monkeypatch.setattr(tconvert, "sam_config_for", lambda v: tcfg)
    jcfg = dataclasses.replace(
        jconvert.sam_config_for("vit_b"), vit=dataclasses.replace(
            jconvert.sam_config_for("vit_b").vit,
            **dataclasses.asdict(tcfg.vit)))
    monkeypatch.setattr(jconvert, "sam_config_for", lambda v: jcfg)
    ws = str(tmp_path / "ws")
    argv = [scene, "--workspace", ws, "--data_type", "llff", "--bound", "4",
            "--num_steps", "8", "4", "--with_sam", "--mlp_width", "16",
            "--mlp_depth", "2", "--sam_ckpt", pth, "--scene_name", "s",
            "--object_name", "obj"]
    cfg = config_from_args(build_parser().parse_known_args(argv)[0])
    tr = Trainer("ngp", cfg, fields.make_model(cfg.model, cfg.render),
                 use_checkpoint="scratch", device="cpu")
    tr.save_checkpoint()
    from sanerf_tpu_torch.data.provider import SceneDataset

    views = SceneDataset(cfg, "train")
    depth = tr.render_pose(views.poses[0], views.intrinsics, 16, 16)["depth"]
    front = sp.project_to_3d(np.array([[7.0, 8.0]]),
                             depth.reshape(16, 16)[8:9, 7], views.poses[0],
                             views.intrinsics)
    meta = str(tmp_path / "meta.json")
    with open(meta, "w") as f:
        json.dump({"s": {"obj": {"points": front.tolist()}}}, f)
    extra = ["--scenes_metadata", meta, "--use_nerf_feature"]
    vt = sp.main(argv + extra + ["--mask_out", str(tmp_path / "t")],
                 device="cpu")
    jsp.main(argv + extra + ["--mask_out", str(tmp_path / "j")])
    with open(tmp_path / "j" / "valid.json") as f:
        vj = json.load(f)
    assert vt == vj and vt[views.names[0]]
    for name in vt:
        a = np.load(tmp_path / "t" / f"{name}_masks.npy")
        b = np.load(tmp_path / "j" / f"{name}_masks.npy")
        assert a.shape == b.shape == (16, 16)
        assert (a == b).mean() >= 0.999, name
