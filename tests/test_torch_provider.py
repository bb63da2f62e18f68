"""The port's scene provider (sanerf_tpu_torch/data/provider.py, colmap_utils,
rays.get_incoherent_mask) against the JAX package's on the same scene
files, written here as tests/test_provider.py writes them: COLMAP models
(binary and text), transforms.json (llff / lerf), LIFT (metadata.json and
pose txts), pano, per-view masks with valid.json, scenes_test_view.json.

Held: poses, intrinsics, images, per-view near/far, the AABB, the scale,
names and split indices, test trajectories, masks and incoherent maps
within 1e-6 (rotations and positions pass the same float32 numpy
operations, so they are in fact equal); every collate's arrays equal for
the same numpy generator; the COLMAP readers' fields equal;
get_incoherent_mask equal on masks with boundaries.
"""

import dataclasses
import json
import os
import sys

import cv2
import numpy as np
import pytest

from sanerf_tpu import config as jconfig
from sanerf_tpu.data import colmap_utils as jcolmap
from sanerf_tpu.data import provider as jprovider
from sanerf_tpu.data import rays as jrays
from sanerf_tpu.data.synthetic import SyntheticSphereDataset as JDataset
from sanerf_tpu_torch import config
from sanerf_tpu_torch.data import colmap_utils, provider, rays
from sanerf_tpu_torch.utils import camera as cam_util

from tests.test_provider import _write_colmap_binary

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "port_tools"))
from scene_files import write_colmap_scene, write_masks  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)
ARRAYS = ("poses", "intrinsics", "images", "cam_near_far", "pts_aabb",
          "masks", "incoherent_masks", "error_map")


def _cfgs(**sections):
    """(JAX Config, port Config) from the same section kwargs."""
    kw = {}
    for name, cls in (("data", jconfig.DataConfig),
                      ("model", jconfig.ModelConfig),
                      ("mask", jconfig.MaskTrainConfig),
                      ("sam", jconfig.SamTrainConfig)):
        if name in sections:
            kw[name] = cls(**sections.pop(name))
    jc = jconfig.Config(**kw, **sections)
    return jc, config.config_from_dict(config.Config, dataclasses.asdict(jc))


def _same(a, b):
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_allclose(y, x, err_msg=name, **TOL)
    assert a.names == b.names
    assert (a.H, a.W) == (b.H, b.W)
    assert getattr(a, "scale", None) == getattr(b, "scale", None)


def _both(split="train", **sections):
    jc, pc = _cfgs(**sections)
    ref = jprovider.SceneDataset(jc, split)
    got = provider.SceneDataset(pc, split)
    _same(ref, got)
    return ref, got


def _colmap_text(sparse, poses_w2c, fx, W, H, pts3d):
    os.makedirs(sparse, exist_ok=True)
    with open(os.path.join(sparse, "cameras.txt"), "w") as f:
        f.write("# camera list\n")
        f.write(f"1 PINHOLE {W} {H} {fx} {fx} {W / 2} {H / 2}\n")
    with open(os.path.join(sparse, "images.txt"), "w") as f:
        for i, m in enumerate(poses_w2c):
            q = colmap_utils.rotmat2qvec(m[:3, :3])
            f.write(f"{i + 1} {' '.join(repr(float(v)) for v in q)} "
                    f"{' '.join(repr(float(v)) for v in m[:3, 3])} 1 "
                    f"img_{i:03d}.png\n")
            f.write("10.0 20.0 0 11.0 21.0 1\n")
    with open(os.path.join(sparse, "points3D.txt"), "w") as f:
        for i, p in enumerate(pts3d):
            x, y, z = (repr(float(v)) for v in p)
            f.write(f"{i} {x} {y} {z} 255 128 0 0.5 1 0\n")


def _w2c(gl_poses):
    out = []
    for p in gl_poses:
        cv = p.astype(np.float64).copy()
        cv[:3, 1:3] *= -1
        out.append(np.linalg.inv(cv))
    return out


@pytest.fixture(scope="module")
def colmap_root(tmp_path_factory):
    """tests/test_provider.py's COLMAP scene (20 views around 50 points),
    binary under sparse/0 and the same model as text in a second root,
    textured images, masks with one view invalid, and a val_split file."""
    root = str(tmp_path_factory.mktemp("colmap"))
    text_root = str(tmp_path_factory.mktemp("colmap_text"))
    W = H = 32
    w2c = _w2c(cam_util.circle_poses(radius=3.0, n=20))
    pts3d = np.random.default_rng(0).uniform(-0.5, 0.5, (50, 3))
    _write_colmap_binary(os.path.join(root, "sparse", "0"), w2c, 40.0, W, H,
                         pts3d)
    _colmap_text(os.path.join(text_root, "sparse"), w2c, 40.0, W, H, pts3d)
    rng = np.random.default_rng(1)
    for r in (root, text_root):
        os.makedirs(os.path.join(r, "images"), exist_ok=True)
    labels = []
    for i in range(20):
        img = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        for r in (root, text_root):
            cv2.imwrite(os.path.join(r, "images", f"img_{i:03d}.png"), img)
        lab = np.full((H, W), -1, np.int64)
        lab[8 + i % 5:24, 6:26 - i % 3] = 1
        lab[:8] = 0
        labels.append(lab)
    names = [f"img_{i:03d}.png" for i in range(20)]
    d = write_masks(root, "obj_masks", names, labels)
    with open(os.path.join(d, "valid.json"), "w") as f:
        json.dump({n: n != "img_005.png" for n in names}, f)
    # a [K, H, W] binary stack for one view
    stack = np.stack([labels[3] == 0, labels[3] == 1]).astype(np.uint8)
    np.save(os.path.join(d, "img_003.png_masks.npy"), stack)
    with open(os.path.join(root, "scenes_test_view.json"), "w") as f:
        json.dump({"garden": ["img_004", "img_011.png"]}, f)
    return root, text_root


@pytest.mark.parametrize("data", [
    {}, {"enable_cam_center": True}, {"enable_cam_near_far": True},
    {"val_type": "val_all"}, {"scale": 0.5, "offset": (0.1, -0.2, 0.3)},
    {"downscale": 2},
], ids=["default", "cam_center", "near_far", "val_all", "scale", "ds2"])
@pytest.mark.parametrize("split", ["train", "val", "trainval", "all"])
def test_colmap_binary_equals_jax(colmap_root, data, split):
    _both(split, data=dict(path=colmap_root[0], data_type="mip", **data))


def test_colmap_text_and_val_split_equal_jax(colmap_root):
    for split in ("train", "val"):
        _both(split, data=dict(path=colmap_root[1], data_type="mip",
                               enable_cam_near_far=True))
    ref, got = _both("val", data=dict(path=colmap_root[0], data_type="mip",
                                      val_type="val_split"))
    assert got.names == ["img_004.png", "img_011.png"]


@pytest.mark.parametrize("traj", ["circle", "interp"])
def test_test_trajectories_equal_jax(colmap_root, traj):
    ref, got = _both("test", seed=3, data=dict(
        path=colmap_root[0], data_type="mip", camera_traj=traj))
    assert got.images is None and len(got) == (100 if traj == "circle"
                                               else 80)


def test_colmap_readers_equal_jax(colmap_root):
    for sparse in (os.path.join(colmap_root[0], "sparse", "0"),
                   os.path.join(colmap_root[1], "sparse")):
        cams, imgs, pts, rgb, id_map = colmap_utils.read_model(sparse)
        jcams, jimgs, jpts, jrgb, jid = jcolmap.read_model(sparse)
        assert id_map == jid and sorted(imgs) == sorted(jimgs)
        np.testing.assert_array_equal(pts, jpts)
        np.testing.assert_array_equal(rgb, jrgb)
        for k in cams:
            assert cams[k].model == jcams[k].model
            np.testing.assert_array_equal(cams[k].params, jcams[k].params)
        for k in imgs:
            a, b = imgs[k], jimgs[k]
            assert a.name == b.name and a.camera_id == b.camera_id
            for f in ("qvec", "tvec", "xys", "point3d_ids"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            np.testing.assert_array_equal(a.cam_to_world(), b.cam_to_world())
    # the quaternion helpers round-trip
    R = cam_util.circle_poses(radius=2.0, n=7)[3][:3, :3].astype(np.float64)
    np.testing.assert_allclose(
        colmap_utils.qvec2rotmat(colmap_utils.rotmat2qvec(R)), R, atol=1e-12)


def _masks_cfg(root, **mask):
    return dict(data=dict(path=root, data_type="mip"),
                model=dict(with_mask=True, n_inst=2),
                mask=dict(mask_folder_name="obj_masks", **mask))


@pytest.mark.parametrize("mask", [
    {}, {"mixed_sampling": True, "num_local_sample": 2,
         "local_sample_patch_size": 4, "error_map": True},
    {"use_multi_res": True, "max_multi_res_level": 2,
     "incoherent_downsample_scale": 2},
    {"mixed_sampling": True, "num_local_sample": 3,
     "local_sample_patch_size": 5, "error_map_size": 16},
], ids=["plain", "mixed_error_map", "multi_res", "mixed_incoherent"])
def test_masks_and_collate_mask_equal_jax(colmap_root, mask):
    ref, got = _both("train", **_masks_cfg(colmap_root[0], **mask))
    assert (got.masks == -1).all(axis=(1, 2)).sum() == 1  # the invalid view
    ra, rb = np.random.default_rng(5), np.random.default_rng(5)
    for level in (0, 1):
        ref.multi_res_level = got.multi_res_level = level
        a, b = ref.collate_mask(ra, 64), got.collate_mask(rb, 64)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], err_msg=k, **TOL)
    if ref.error_map is not None:
        err = np.linspace(0, 1, 5).astype(np.float32)
        ref.update_error_map(a["index"], a["inds_coarse"][:5], err)
        got.update_error_map(b["index"], b["inds_coarse"][:5], err)
        np.testing.assert_allclose(got.error_map, ref.error_map, **TOL)


@pytest.mark.parametrize("data,sam", [
    ({}, {}), ({"random_image_batch": True}, {}),
    ({"enable_cam_near_far": True}, {"pose_jittering": True}),
], ids=["plain", "random_image_batch", "near_far_jitter"])
def test_collate_train_sam_frame_equal_jax(colmap_root, data, sam):
    for split in ("train", "val"):
        ref, got = _both(split, data=dict(path=colmap_root[0],
                                          data_type="mip", **data),
                         sam=dict(online_resolution=64, **sam))
        ra, rb = np.random.default_rng(2), np.random.default_rng(2)
        pairs = [(ref.collate_train(ra, 48), got.collate_train(rb, 48)),
                 (ref.collate_sam(ra), got.collate_sam(rb)),
                 (ref.collate_sam(ra, index=0), got.collate_sam(rb, index=0)),
                 (ref.frame(len(ref) - 1), got.frame(len(got) - 1))]
        for a, b in pairs:
            assert sorted(a) == sorted(b)
            for k in a:
                if isinstance(a[k], str):
                    assert a[k] == b[k]
                else:
                    np.testing.assert_allclose(b[k], a[k], err_msg=k, **TOL)


@pytest.fixture(scope="module")
def fixture_roots(tmp_path_factory):
    """transforms.json (llff / lerf), LIFT (metadata.json, pose txts) and
    pano scenes of the textured fixture's views."""
    ds = JDataset(H=24, W=20, n_views=6, scene="textured")
    imgs = [(ds.images[i] * 255).astype(np.uint8) for i in range(6)]
    roots = {}
    r = roots["transforms"] = str(tmp_path_factory.mktemp("tf"))
    frames = []
    for i in range(6):
        cv2.imwrite(os.path.join(r, f"r_{i}.png"),
                    cv2.cvtColor(imgs[i], cv2.COLOR_RGB2BGR))
        frames.append({"file_path": f"r_{i}",
                       "transform_matrix": ds.poses[i].tolist()})
    with open(os.path.join(r, "transforms.json"), "w") as f:
        json.dump({"fl_x": float(ds.intrinsics[0]), "fl_y": 31.0, "cx": 10.5,
                   "frames": frames}, f)
    for kind in ("lift_meta", "lift_txt"):
        r = roots[kind] = str(tmp_path_factory.mktemp(kind))
        os.makedirs(os.path.join(r, "rgb"))
        os.makedirs(os.path.join(r, "pose"))
        meta = {}
        for i in range(6):
            name = f"v{i}"
            cv2.imwrite(os.path.join(r, "rgb", name + ".png"),
                        cv2.cvtColor(imgs[i], cv2.COLOR_RGB2BGR))
            m = ds.poses[i].astype(np.float64).copy()
            m[:3, 1:3] *= -1
            meta[name] = {"quaternion": list(colmap_utils.rotmat2qvec(
                m[:3, :3])), "translation": list(m[:3, 3])}
            np.savetxt(os.path.join(r, "pose", name + ".txt"), m)
        if kind == "lift_meta":
            with open(os.path.join(r, "metadata.json"), "w") as f:
                json.dump(meta, f)
            np.savetxt(os.path.join(r, "intrinsics.txt"),
                       np.array([[30.0, 0, 10], [0, 31.0, 12], [0, 0, 1]]))
    r = roots["pano"] = str(tmp_path_factory.mktemp("pano"))
    for sub in ("images", "pose", "intrinsic"):
        os.makedirs(os.path.join(r, sub))
    K = np.array([[30.0, 0, 10.0, 0], [0, 31.0, 12.0, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]])
    np.savetxt(os.path.join(r, "intrinsic", "intrinsic_color.txt"), K)
    for i in range(6):
        m = ds.poses[i].copy()
        m[:, 1:3] = -m[:, 1:3]
        np.savetxt(os.path.join(r, "pose", f"f_{i}.txt"), m)
        cv2.imwrite(os.path.join(r, "images", f"f_{i}.png"),
                    cv2.cvtColor(imgs[i], cv2.COLOR_RGB2BGR))
    np.savetxt(os.path.join(r, "pose", "f_9.txt"), np.eye(4))  # no image
    return roots


@pytest.mark.parametrize("kind,data_type", [
    ("transforms", "llff"), ("transforms", "lerf"), ("transforms", "ctr"),
    ("lift_meta", "lift"), ("lift_txt", "lift"), ("pano", "pano")])
@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_other_flavours_equal_jax(fixture_roots, kind, data_type, split):
    ref, got = _both(split, data=dict(path=fixture_roots[kind],
                                      data_type=data_type,
                                      val_type="val_all"))
    if split != "test":
        a = ref.collate_train(np.random.default_rng(0), 32)
        b = got.collate_train(np.random.default_rng(0), 32)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], err_msg=k, **TOL)


def test_scene_files_colmap_equals_transforms(tmp_path):
    """port_tools/scene_files.py's COLMAP model of the fixture's cameras,
    read by `mip` with enable_cam_center, gives the poses the fixture's
    transforms.json gives to `llff`, and equals the JAX package's read."""
    ds = JDataset(H=16, W=16, n_views=4, scene="textured")
    root = str(tmp_path / "c")
    write_colmap_scene(ds, root, np.random.default_rng(0).uniform(
        -0.5, 0.5, (12, 3)))
    ref, got = _both("train", data=dict(path=root, data_type="mip",
                                        enable_cam_center=True,
                                        val_type="val_all"))
    want, _ = cam_util.center_poses(ds.poses.copy())
    want, _, _ = cam_util.auto_scale_poses(want)
    np.testing.assert_allclose(got.poses, want, atol=1e-5)
    np.testing.assert_allclose(got.intrinsics, ds.intrinsics, rtol=1e-6)
    np.testing.assert_array_equal(
        got.images, (ds.images * 255).astype(np.uint8) / np.float32(255.0))


@pytest.mark.parametrize("sfact", [1, 2, 3])
def test_get_incoherent_mask_equals_jax(sfact):
    """Masks with boundaries: the fixture's instance maps, a disc and a
    random blocky map, as [H, W] and [H, W, C]."""
    ds = JDataset(H=37, W=45, n_views=2, scene="textured")
    yy, xx = np.mgrid[:40, :52]
    disc = ((yy - 19.5) ** 2 + (xx - 23) ** 2 < 150).astype(np.float32)
    blocks = np.kron(np.random.default_rng(sfact).integers(0, 2, (8, 13)),
                     np.ones((5, 4))).astype(np.float32)
    masks = [(ds.instances[0] >= 2).astype(np.float32),
             (ds.instances[1] == 1).astype(np.float32), disc, blocks,
             np.stack([disc, blocks], -1)]
    for m in masks:
        ref = jrays.get_incoherent_mask(m, sfact=sfact)
        got = rays.get_incoherent_mask(m, sfact=sfact)
        assert got.shape == ref.shape and (sfact == 1 or ref.any())
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(
            rays.get_incoherent_mask(m, sfact, keep_size=False),
            jrays.get_incoherent_mask(m, sfact, keep_size=False))


def test_synthetic_stage_collates_equal_jax():
    ref = JDataset(H=32, W=32, n_views=4)
    from sanerf_tpu_torch.data.synthetic import SyntheticSphereDataset

    got = SyntheticSphereDataset(H=32, W=32, n_views=4)
    ra, rb = np.random.default_rng(4), np.random.default_rng(4)
    for a, b in ((ref.collate_sam(ra), got.collate_sam(rb)),
                 (ref.collate_sam(ra, index=2), got.collate_sam(rb, index=2)),
                 (ref.collate_mask(ra, 40), got.collate_mask(rb, 40))):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], err_msg=k, **TOL)
    np.testing.assert_array_equal(got.masks, ref.masks)
    assert got.error_map is None and ref.error_map is None
