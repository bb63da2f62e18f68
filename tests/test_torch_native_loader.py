"""The port's native ray loader (sanerf_tpu_torch/native/dataloader.cpp,
data/native_loader.py), with the checks of tests/test_native_loader.py:
rays equal to the numpy ray math (origins, the pixel recovered from each
direction, its colour), the direction convention against the port's
sample_rays, the prefetch ring; and the Trainer's hook: a dataset of
images without per-view near/far trains from the loader (the
`[native loader]` tag), and from its numpy collate, logged, where the
loader does not build."""

import dataclasses

import numpy as np
import pytest

from sanerf_tpu_torch import config
from sanerf_tpu_torch.data import native_loader
from sanerf_tpu_torch.data.rays import sample_rays
from sanerf_tpu_torch.data.synthetic import SyntheticSphereDataset
from sanerf_tpu_torch.models import fields
from sanerf_tpu_torch.train import trainer as trainer_mod


@pytest.fixture(scope="module")
def scene():
    assert native_loader.available(), native_loader.build_error()
    return SyntheticSphereDataset(H=48, W=48, n_views=6)


def _pixels(scene, b):
    pose = scene.poses[b["index"]]
    fx, fy, cx, cy = scene.intrinsics
    d_cam = b["rays_d"] @ pose[:3, :3]
    px = np.round(d_cam[:, 0] / -d_cam[:, 2] * fx + cx - 0.5).astype(int)
    py = np.round(-d_cam[:, 1] / -d_cam[:, 2] * fy + cy - 0.5).astype(int)
    return px, py


def test_batches_match_numpy_ray_math(scene):
    s = native_loader.NativeRaySampler(scene.poses, scene.intrinsics,
                                       scene.images, num_rays=256, seed=7)
    try:
        for _ in range(4):
            b = s.next_batch()
            i = b["index"]
            assert 0 <= i < 6 and (b["H"], b["W"]) == (48, 48)
            np.testing.assert_allclose(
                b["rays_o"], np.broadcast_to(scene.poses[i][:3, 3], (256, 3)),
                rtol=1e-6)
            px, py = _pixels(scene, b)
            assert px.min() >= 0 and px.max() < 48
            assert py.min() >= 0 and py.max() < 48
            np.testing.assert_allclose(b["images"], scene.images[i][py, px],
                                       atol=1 / 255 + 1e-6)
    finally:
        s.close()


def test_direction_convention_matches_sample_rays(scene):
    s = native_loader.NativeRaySampler(scene.poses, scene.intrinsics,
                                       scene.images, num_rays=64, seed=3)
    try:
        b = s.next_batch()
        px, py = _pixels(scene, b)
        rb = sample_rays(scene.poses[b["index"]], scene.intrinsics, 48, 48,
                         coords=np.stack([py, px], -1))
        np.testing.assert_allclose(b["rays_d"], rb.rays_d, rtol=1e-5,
                                   atol=1e-6)
        # collate_train is the provider's signature
        c = s.collate_train(np.random.default_rng(0), 64)
        assert c["rays_o"].shape == (64, 3) and c["images"].shape == (64, 3)
    finally:
        s.close()


def test_rgba_images_are_refused(scene):
    """The sampler reads 3 bytes a pixel: RGBA scenes take the collate."""
    rgba = np.concatenate([scene.images, scene.images[..., :1]], -1)
    with pytest.raises(ValueError, match="H, W, 3"):
        native_loader.NativeRaySampler(scene.poses, scene.intrinsics, rgba,
                                       num_rays=8)


def test_prefetch_ring_fills(scene):
    import time

    s = native_loader.NativeRaySampler(scene.poses, scene.intrinsics,
                                       scene.images, num_rays=128,
                                       prefetch_depth=3, n_threads=2)
    try:
        deadline = time.time() + 10
        while s.ready_count() < 3 and time.time() < deadline:
            time.sleep(0.05)
        assert s.ready_count() == 3  # the ring is full while nothing reads
        s.next_batch()
        assert s.ready_count() <= 3
    finally:
        s.close()


class _Images:
    """Images and no per-view near/far (a transforms.json scene)."""

    def __init__(self):
        ds = SyntheticSphereDataset(H=16, W=16, n_views=3)
        self.poses, self.intrinsics, self.images = (ds.poses, ds.intrinsics,
                                                    ds.images)
        self._ds = ds

    def __len__(self):
        return 3

    def collate_train(self, rng, num_rays):
        b = self._ds.collate_train(rng, num_rays)
        del b["cam_near_far"]
        return b


def _trainer(tmp_path):
    rc = config.RenderConfig(num_steps=(8, 4), bound=4.0, max_ray_batch=512)
    mc = config.ModelConfig(prop_resolutions=(16,), mlp_enc_freqs=3,
                            mlp_field_width=16, mlp_field_depth=3,
                            mlp_prop_enc_freqs=2, mlp_prop_width=16,
                            mlp_prop_depth=2)
    cfg = config.Config(workspace=str(tmp_path), render=rc, model=mc,
                        train=config.TrainConfig(
                            iters=4, num_rays=64, adaptive_num_rays=False,
                            save_cnt=1, eval_cnt=1))
    return trainer_mod.Trainer("t", cfg, fields.make_model(mc, rc),
                               use_checkpoint="scratch", device="cpu")


def test_trainer_takes_the_native_loader(tmp_path):
    tr = _trainer(tmp_path)
    tr.train(_Images(), max_epoch=1, steps_per_epoch=3)
    with open(tr.log_path) as f:
        log = f.read()
    assert "[native loader]" in log and "unavailable" not in log
    assert tr.global_step == 3


def test_trainer_logs_the_numpy_collate_without_the_loader(tmp_path,
                                                           monkeypatch):
    def no_loader(*a, **k):
        raise RuntimeError("native dataloader unavailable: no g++")

    monkeypatch.setattr(trainer_mod, "NativeRaySampler", no_loader)
    tr = _trainer(tmp_path)
    tr.train(_Images(), max_epoch=1, steps_per_epoch=2)
    with open(tr.log_path) as f:
        log = f.read()
    assert "native loader unavailable" in log and "numpy collate" in log
    assert "[native loader]" not in log and tr.global_step == 2
    # the setting turns it off
    tr2 = _trainer(tmp_path / "b")
    tr2.cfg = dataclasses.replace(tr2.cfg, train=dataclasses.replace(
        tr2.cfg.train, use_native_loader=False))
    tr2.train(_Images(), max_epoch=1, steps_per_epoch=1)
    with open(tr2.log_path) as f:
        assert "native loader" not in f.read()


@pytest.mark.parametrize("threads", [(1, 1), (2, 2), (1, 2), (4, 1)])
def test_batches_are_a_function_of_the_seed(scene, threads):
    """Batch k is a function of (seed, k) whatever thread draws it: two
    samplers of one seed give the same first batches bit for bit with 1,
    2 or 4 worker threads (the Trainer runs 4), and another seed other
    batches."""
    def first(n_threads, seed=5, n=8):
        s = native_loader.NativeRaySampler(
            scene.poses, scene.intrinsics, scene.images, num_rays=96,
            seed=seed, prefetch_depth=3, n_threads=n_threads)
        try:
            return [s.next_batch() for _ in range(n)]
        finally:
            s.close()

    a, b = (first(t) for t in threads)
    for x, y in zip(a, b):
        assert x["index"] == y["index"]
        for k in ("rays_o", "rays_d", "images"):
            np.testing.assert_array_equal(x[k], y[k])
    other = first(threads[0], seed=6)
    assert any(not np.array_equal(x["rays_d"], y["rays_d"])
               for x, y in zip(a, other))


def test_draws_stay_uniform(scene):
    """Over many batches every image is drawn, and the pixels of the
    batches cover the image evenly (a chi-square over 4 x 4 cells)."""
    s = native_loader.NativeRaySampler(scene.poses, scene.intrinsics,
                                       scene.images, num_rays=512, seed=11,
                                       n_threads=3)
    try:
        counts = np.zeros((4, 4))
        images = set()
        for _ in range(60):
            b = s.next_batch()
            images.add(b["index"])
            px, py = _pixels(scene, b)
            np.add.at(counts, (py // 12, px // 12), 1)
    finally:
        s.close()
    assert images == set(range(6))
    expect = counts.sum() / 16
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 45.0  # 15 degrees of freedom: p < 1e-4 past 45
