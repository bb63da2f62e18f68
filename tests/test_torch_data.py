"""Parity: the port's numpy twins of the data side (rays, camera, the
textured fixture, the PSNR meter) against the JAX package's, on the same
inputs."""

import numpy as np
import pytest
import torch

from sanerf_tpu.data import rays as jrays
from sanerf_tpu.data.synthetic import SyntheticSphereDataset as JDataset
from sanerf_tpu.train.metrics import PSNRMeter as JPSNRMeter
from sanerf_tpu.utils import camera as jcamera
from sanerf_tpu_torch.data import rays
from sanerf_tpu_torch.data.synthetic import SyntheticSphereDataset
from sanerf_tpu_torch.train.metrics import PSNRMeter
from sanerf_tpu_torch.utils import camera

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-6)


def _pose():
    return jcamera.circle_poses(radius=1.8, height=0.5, n=5)[2]


def test_camera_math():
    np.testing.assert_allclose(camera.circle_poses(2.0, 0.3, 7),
                               jcamera.circle_poses(2.0, 0.3, 7), **TOL)
    assert camera.fov_to_focal(60.0, 512) == jcamera.fov_to_focal(60.0, 512)


def test_sample_rays_and_full_frame_rays():
    pose = _pose()
    intr = np.array([30.0, 31.0, 12.0, 9.5], np.float32)
    ref = jrays.sample_rays(pose, intr, 20, 24, N=-1)
    got = rays.sample_rays(pose, intr, 20, 24, N=-1)
    for k in ("rays_o", "rays_d", "inds"):
        np.testing.assert_allclose(getattr(got, k), getattr(ref, k), **TOL)
    # N > 0: uniform pixels, the same ones as the JAX package's from the
    # same generator
    got = rays.sample_rays(pose, intr, 20, 24, N=16,
                           rng=np.random.default_rng(1))
    ref = jrays.sample_rays(pose, intr, 20, 24, N=16,
                            rng=np.random.default_rng(1))
    for k in ("rays_o", "rays_d", "inds", "inds_coarse"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))
    jo, jd = jrays.full_frame_rays(pose, intr, 20, 24)
    o, d = rays.full_frame_rays(pose, intr, 20, 24, device="cpu")
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)


def test_textured_fixture_twin():
    kw = dict(H=12, W=12, n_views=3, radius=1.8, scene="textured",
              training=False)
    ref, got = JDataset(**kw), SyntheticSphereDataset(**kw)
    assert len(got) == len(ref) == 3
    for name in ("poses", "intrinsics", "images", "depths", "cam_near_far"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    fg, fr = got.frame(1), ref.frame(1)
    for k in ("rays_o", "rays_d", "images", "cam_near_far"):
        np.testing.assert_allclose(fg[k], fr[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    with pytest.raises(NotImplementedError):
        SyntheticSphereDataset(H=4, W=4, n_views=1, scene="spheres")


def test_sphere_fixture_is_the_default():
    """With no `scene`, both fixtures are the Lambertian sphere: same
    frames, depths, instance masks and per-view near/far."""
    ref = JDataset(H=32, W=32, n_views=8)
    got = SyntheticSphereDataset(H=32, W=32, n_views=8)
    assert got.scene == ref.scene == "sphere"
    for name in ("poses", "intrinsics", "images", "depths", "cam_near_far"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got.instances, ref.instances)
    assert 0 < got.instances.mean() < 1  # the sphere is in view
    fg, fr = got.frame(3), ref.frame(3)
    for k in ("rays_o", "rays_d", "images", "masks", "cam_near_far"):
        np.testing.assert_allclose(fg[k], fr[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_psnr_meter():
    rng = np.random.default_rng(0)
    ours, theirs = PSNRMeter(), JPSNRMeter()
    for _ in range(3):
        a, b = rng.uniform(0, 1, (2, 50, 3)).astype(np.float32)
        ours.update(a, b)
        theirs.update(a, b)
    assert ours.measure() == pytest.approx(theirs.measure(), rel=1e-12)
