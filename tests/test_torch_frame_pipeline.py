"""Parity: the port's interactive frame (sanerf_tpu_torch/apps/
frame_pipeline.py, apps/interactive.py) against the JAX package's, set up as
tests/test_apps.py sets up its frame-pipeline tests (tiny MLP field with
the SAM head, tests/test_sam.py:TINY_SAM), same weights on both sides.

Tolerances: u8 pixels within 1 (the yuv rounding and the I420 decode:
numpy here, OpenCV in the JAX package when it is installed), except
where the two masks differ; depth 2e-3 (the renderer suite's bound);
reprojected points 1e-4; the masks agree on all but 2 % of the pixels (a
mask is the sign of a logit, and the two renders differ by up to 2e-3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_tpu.apps import frame_pipeline as jfp
from sanerf_tpu.config import ModelConfig as JModelConfig
from sanerf_tpu.config import RenderConfig as JRenderConfig
from sanerf_tpu.models import fields as jfields
from sanerf_tpu.models.sam import predictor as jpred
from sanerf_tpu.train.checkpoints import flatten_tree
from sanerf_tpu_torch.apps import frame_pipeline as fp
from sanerf_tpu_torch.apps.interactive import InteractiveSession
from sanerf_tpu_torch.config import ModelConfig, RenderConfig, config_from_dict
from sanerf_tpu_torch.models import fields
from sanerf_tpu_torch.models.asset import params_from_jax
from sanerf_tpu_torch.models.sam import predictor

from tests.test_sam import TINY_SAM
from tests.test_torch_sam import port_cfg

torch.set_num_threads(1)
H = W = 16
h = w = 8
POSE = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 2.0], [0, 0, 0, 1]],
                np.float32)
INTR = np.asarray([0.5 * H, 0.5 * H, W / 2, H / 2], np.float32)
SAM = port_cfg(TINY_SAM)


@pytest.fixture(scope="module")
def setup():
    jrc = JRenderConfig(num_steps=(8, 4), bound=4.0, contract=True)
    jmc = JModelConfig(field_type="mlp", with_sam=True,
                       sam_use_view_direction=True, sam_feat_dim=32,
                       mlp_enc_freqs=4, mlp_field_width=32, mlp_field_depth=4,
                       mlp_prop_enc_freqs=3, mlp_prop_width=16,
                       mlp_prop_depth=2, prop_resolutions=(32,))
    jm = jfields.make_model(jmc, jrc)
    jp = jfields.init_params(jm, jax.random.key(0))
    tm = fields.make_model(
        config_from_dict(ModelConfig, dataclasses.asdict(jmc)),
        config_from_dict(RenderConfig, dataclasses.asdict(jrc)))
    tp = params_from_jax(flatten_tree(jp, "params/"), tm)
    jsp = jpred.init_params(TINY_SAM, jax.random.key(1))
    tsp = predictor.params_from_jax(flatten_tree(jsp, ""), SAM)
    return jm, jp, jsp, tm, tp, tsp


def _packed(points, active):
    K = len(active)
    p = np.zeros((28 + 4 * K,), np.float32)
    p[:16] = POSE.reshape(-1)
    p[16:20] = INTR
    p[20:20 + 3 * K] = np.asarray(points, np.float32).reshape(-1)
    p[20 + 3 * K:20 + 4 * K] = active
    p[26 + 4 * K] = 1.0  # background
    return p


def _surface_point(depth, i, j):
    """The 3D point seen at pixel (i, j) at the rendered depth."""
    d = np.float32([(i + 0.5 - INTR[2]) / INTR[0],
                    -(j + 0.5 - INTR[3]) / INTR[1], -1.0])
    return POSE[:3, 3] + (POSE[:3, :3] @ d) * depth[j, i]


def test_rgb_to_yuv420_matches_jax():
    img = np.random.default_rng(0).random((16, 24, 3)).astype(np.float32)
    jy, jc = jfp._rgb_to_yuv420(jnp.asarray(img))
    ty, tc = fp._rgb_to_yuv420(torch.from_numpy(img))
    assert ty.dtype == torch.uint8 and tc.shape == (8, 12, 2)
    for t, j in ((ty, jy), (tc, jc)):
        assert np.abs(t.numpy().astype(int) - np.asarray(j)).max() <= 1


def test_pack_unpack_display_matches_jax():
    rng = np.random.default_rng(1)
    img = rng.random((32, 32, 3)).astype(np.float32)
    pts = rng.normal(0, 5, (4, 2)).astype(np.float32)
    valid = np.array([1, 0, 1, 1], bool)
    jb = np.asarray(jfp._pack_display(jnp.asarray(img), jnp.asarray(pts),
                                      jnp.asarray(valid), 32))
    tb = fp._pack_display(torch.from_numpy(img), torch.from_numpy(pts),
                          torch.from_numpy(valid), 32).numpy()
    assert tb.shape == jb.shape and tb.dtype == np.uint8
    assert np.abs(tb.astype(int) - jb).max() <= 1
    np.testing.assert_array_equal(tb[48:], jb[48:])  # metadata rows, exact
    a = jfp.unpack_display(jb, 32, 32, 4)
    b = fp.unpack_display(jb, 32, 32, 4)
    assert np.abs(a[0].astype(int) - b[0]).max() <= 1
    np.testing.assert_array_equal(b[1], pts)
    np.testing.assert_array_equal(b[2], valid)
    # grey survives the round trip exactly (Cb = Cr = 128)
    g = np.repeat(np.linspace(0, 1, 256, dtype=np.float32).reshape(
        16, 16, 1), 3, -1)
    y, cbcr = fp._rgb_to_yuv420(torch.from_numpy(g))
    assert bool((cbcr == 128).all())
    rt = fp.yuv420_to_rgb8(y.numpy(), cbcr.numpy())
    assert np.abs(rt[..., 0].astype(int) - np.round(g[..., 0] * 255)).max() \
        <= 1


def test_project_points_device_matches_jax():
    rng = np.random.default_rng(2)
    pts = rng.normal(0, 0.6, (6, 3)).astype(np.float32)
    pts[:2] = [[0.1, 0.2, 0.0], [-0.3, 0.1, 0.5]]  # on screen
    pts[5] = [0.0, 0.0, 3.0]  # behind the camera
    active = np.float32([1, 1, 1, 0, 1, 1])
    depth = rng.uniform(1.0, 3.0, (H, W)).astype(np.float32)
    z = 2.0 - pts[:, 2]
    x = np.round(pts[:, 0] / z * INTR[0] + INTR[2] - 0.5).astype(int)
    y = np.round(-pts[:, 1] / z * INTR[1] + INTR[3] - 0.5).astype(int)
    for k in (0, 1):  # make two points visible
        depth[np.clip(y[k], 0, H - 1), np.clip(x[k], 0, W - 1)] = z[k]
    ref = jfp.project_points_device(pts, active, POSE, INTR, depth, H, W)
    got = fp.project_points_device(*(torch.from_numpy(a) for a in (
        pts, active, POSE, INTR, depth)), H, W)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert got[1].numpy()[:2].all() and not got[1].numpy()[5]


@pytest.mark.parametrize("fetch_format,mode", [("rgb8", "image"),
                                               ("yuv420", "image"),
                                               ("rgb8", "depth")])
def test_frame_program_matches_jax(setup, fetch_format, mode):
    jm, jp, jsp, tm, tp, tsp = setup
    kw = dict(hw=(H, W), feat_hw=(h, w), input_hw=(64, 64), mode=mode,
              perturb=False, with_overlay=True, fetch_format=fetch_format)
    # a first frame gives the depth; then one point on the surface, one
    # hidden behind it, one inactive
    p0 = _packed(np.zeros((3, 3)), np.zeros(3))
    _, depth0, *_ = jfp._frame_program(jm, jp, TINY_SAM, jsp,
                                       jnp.asarray(p0),
                                       jnp.zeros((H, W, 3)), None, **kw)
    depth0 = np.asarray(depth0)
    front = _surface_point(depth0, 6, 9)
    behind = front + np.float32([0, 0, -0.5])
    packed = _packed([front, behind, front], np.float32([1, 1, 0]))
    acc = np.full((H, W, 3), 0.25, np.float32)
    ref = jfp._frame_program(jm, jp, TINY_SAM, jsp, jnp.asarray(packed),
                             jnp.asarray(acc), None, **kw)
    got = fp._frame_program(tm, tp, SAM, tsp, torch.from_numpy(packed),
                            torch.from_numpy(acc), None, **kw)
    pix, depth, mask, acc_new, pts2d, valid = got
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref[5]))
    assert valid.numpy().tolist() == [True, False, False]
    np.testing.assert_allclose(pts2d.numpy(), np.asarray(ref[4]), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(depth.numpy(), np.asarray(ref[1]),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(acc_new.numpy(), np.asarray(ref[3]),
                               rtol=2e-3, atol=2e-3)
    assert mask.shape == (H, W) and mask.dtype == torch.bool
    differ = mask.numpy() != np.asarray(ref[2])
    assert differ.mean() <= 0.02
    jpix = np.asarray(ref[0]).astype(int)
    assert pix.shape == jpix.shape and pix.dtype == torch.uint8
    d = np.abs(pix.numpy().astype(int) - jpix)
    if fetch_format == "rgb8":
        d = d[~differ]
    else:
        d = d[:H]  # Y plane; the mask changes it where the masks differ
        d = d[~differ]
    assert d.max() <= 1


def test_frame_pipeline_double_buffered(setup):
    """One frame per render call; `render` returns the oldest in flight
    (f1, f1, f1, f2 at depth 2), `render_sync` and `flush` drain."""
    _, _, _, tm, tp, tsp = setup
    pipe = fp.FramePipeline(tm, tp, SAM, tsp, H, W, h, w, depth=2,
                            device="cpu")
    p3, act = pipe.pad_points([[0.0, 0.0, 0.0]])
    poses = [POSE.copy() for _ in range(4)]
    for k, p in enumerate(poses):
        p[0, 3] = 0.01 * k
    out = [pipe.render(p, INTR, p3, act) for p in poses]
    img, depth, mask, pts2d, valid = out[0]
    assert img.shape == (H, W, 3) and img.dtype == np.uint8
    assert depth.shape == (H, W) and mask.shape == (H, W)
    assert abs(pts2d[0, 0] - (W / 2 - 0.5)) < 1e-3
    assert out[1][0] is out[0][0] and out[2][0] is out[0][0]
    np.testing.assert_array_equal(pipe.last_pose, poses[1])
    last = pipe.flush()
    np.testing.assert_array_equal(pipe.last_pose, poses[3])
    assert last is not None and pipe.flush() is None
    sync = pipe.render_sync(poses[0], INTR, *pipe.pad_points(None))
    assert not np.asarray(sync[2]).any()  # no points: mask gated off
    np.testing.assert_array_equal(sync[1].numpy(), out[0][1].numpy())
    assert pipe.dispatch_count == 5


def test_frame_pipeline_spp_accumulates(setup):
    _, _, _, tm, tp, _ = setup
    pipe = fp.FramePipeline(tm, tp, None, None, H, W, overlay=False,
                            device="cpu")
    p3, act = pipe.pad_points(None)
    base, d0, *_ = pipe.render_sync(POSE, INTR, p3, act, spp=0)
    g = torch.Generator().manual_seed(5)
    pert, d1, *_ = pipe.render_sync(POSE, INTR, p3, act, spp=1, generator=g,
                                    perturb=True)
    assert float((d1 - d0).abs().max()) > 0
    restart, *_ = pipe.render_sync(POSE, INTR, p3, act, spp=0)
    np.testing.assert_array_equal(restart, base)


def test_session_click_lifts_and_toggles(setup):
    """A click lifts through the displayed frame's depth; the point then
    reprojects onto the clicked pixel; clicking it again removes it; a
    downscaled frame comes back at full size."""
    _, _, _, tm, tp, tsp = setup
    s = InteractiveSession(None, tm, tp, predictor.SamPredictor(
        SAM, tsp, device="cpu"), H=32, W=32, device="cpu")
    intr = s.intrinsics_for(POSE)
    s.step(POSE, intr)
    r = s.step(POSE, intr, click=(20.0, 12.0))
    assert len(s.points_3d) == 1
    np.testing.assert_allclose(r.points_2d, [[20.0, 12.0]], atol=1e-3)
    assert r.mask is not None and r.mask.shape == (32, 32)
    s.step(POSE, intr, click=(20.0, 12.0))
    assert not s.points_3d
    r = s.step(POSE, intr, downscale=2)
    assert r.rgb_u8.shape == (32, 32, 3) and r.depth.shape == (16, 16)
    assert s.dispatch_count == 4
