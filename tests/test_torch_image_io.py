"""The port's image reading and resizes (sanerf_tpu_torch/utils/image.py)
against OpenCV, which the JAX package's data path calls: PNGs of every
colour type cv2 writes (gray, RGB, RGBA) at every compression level (so
every PNG filter), bit for bit against cv2.imread; cv2.resize's linear,
area and nearest modes on uint8 bit for bit and on float32 within 1e-6,
at random and edge-case sizes; the provider's `_load_image` with a
downscale equal to the JAX package's; a JPEG through PIL, equal to the
JAX package's cv2 read."""

import os

import cv2
import numpy as np
import pytest

from sanerf_tpu.data.provider import _load_image as jax_load_image
from sanerf_tpu_torch.utils import image

CV2 = {"linear": cv2.INTER_LINEAR, "area": cv2.INTER_AREA,
       "nearest": cv2.INTER_NEAREST}


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("level", [0, 3, 9])
def test_read_png_matches_cv2(tmp_path, channels, level):
    rng = np.random.default_rng(channels * 10 + level)
    # smooth gradients plus noise, so the writer picks varied filters
    H, W = 23, 37
    yy, xx = np.mgrid[:H, :W]
    base = (xx * 5 + yy * 3)[..., None] + rng.integers(0, 9, (H, W, channels))
    img = (base % 256).astype(np.uint8)
    if channels == 1:
        img = img[..., 0]
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if channels == 3:
        ref = cv2.cvtColor(ref, cv2.COLOR_BGR2RGB)
    elif channels == 4:
        ref = cv2.cvtColor(ref, cv2.COLOR_BGRA2RGBA)
    got = image.read_png(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_read_png_rejects_what_it_does_not_read(tmp_path):
    path = str(tmp_path / "deep.png")
    cv2.imwrite(path, np.zeros((4, 4), np.uint16))
    with pytest.raises(ValueError, match="bit depth 16"):
        image.read_png(path)
    with pytest.raises(ValueError, match="not a PNG"):
        image.read_png(__file__)


def _cases(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        H, W = (int(v) for v in rng.integers(1, 70, 2))
        if rng.random() < 0.1:
            H = 1
        if rng.random() < 0.1:
            W = 1
        h, w = (int(v) for v in rng.integers(1, 140, 2))
        out.append((H, W, h, w, int(rng.choice([1, 3, 4]))))
    return out


# edge cases: identity, 1 x 1, exact 2x shrink (area in cv2), 2x growth,
# the SAM input square from a 512^2 render, thin strips
EDGE = [(17, 17, 17, 17, 3), (1, 1, 5, 7, 1), (5, 7, 1, 1, 3),
        (64, 48, 32, 24, 3), (32, 32, 64, 64, 4), (512, 512, 1024, 1024, 3),
        (1, 40, 1, 13, 1), (40, 1, 13, 1, 4), (33, 65, 16, 32, 3)]


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("mode", ["linear", "nearest"])
def test_resize_matches_cv2(mode, dtype):
    rng = np.random.default_rng(1)
    for H, W, h, w, c in EDGE + _cases(150, 2):
        shape = (H, W) if c == 1 else (H, W, c)
        img = (rng.integers(0, 256, shape).astype(np.uint8)
               if dtype == "uint8" else rng.random(shape).astype(np.float32))
        ref = cv2.resize(img, (w, h), interpolation=CV2[mode])
        got = image.resize(img, (w, h), mode)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        if dtype == "uint8":
            np.testing.assert_array_equal(got, ref,
                                          err_msg=str((H, W, h, w, c)))
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6,
                                       err_msg=str((H, W, h, w, c)))


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_area_shrink_matches_cv2(dtype):
    """Integer factors (1-5) and fractional shrinks."""
    rng = np.random.default_rng(3)
    for t in range(120):
        H, W = (int(v) for v in rng.integers(2, 70, 2))
        c = int(rng.choice([1, 3, 4]))
        if t % 2:
            k = int(rng.integers(1, 6))
            h, w = max(1, H // k), max(1, W // k)
        else:
            h, w = int(rng.integers(1, H + 1)), int(rng.integers(1, W + 1))
        shape = (H, W) if c == 1 else (H, W, c)
        img = (rng.integers(0, 256, shape).astype(np.uint8)
               if dtype == "uint8" else rng.random(shape).astype(np.float32))
        ref = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
        got = image.resize(img, (w, h), "area")
        if dtype == "uint8":
            np.testing.assert_array_equal(got, ref, err_msg=str((H, W, h, w)))
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6,
                                       err_msg=str((H, W, h, w)))


@pytest.mark.parametrize("downscale", [1, 2, 3])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_load_image_matches_the_jax_provider(tmp_path, downscale, channels):
    rng = np.random.default_rng(downscale + 7 * channels)
    img = rng.integers(0, 256, (30, 41, channels)).astype(np.uint8)
    path = str(tmp_path / "v.png")
    cv2.imwrite(path, img[..., 0] if channels == 1 else img)
    got = image.load_image(path, downscale)
    np.testing.assert_array_equal(got, jax_load_image(path, downscale))


def test_load_image_takes_other_formats_through_pil(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (16, 24, 3)).astype(
        np.uint8)
    path = str(tmp_path / "v.jpg")
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(image.load_image(path, 2),
                                  jax_load_image(path, 2))
    with pytest.raises(FileNotFoundError):
        image.load_image(os.path.join(str(tmp_path), "missing.png"))


def test_load_image_names_the_format_without_pil(tmp_path, monkeypatch):
    import builtins

    real = builtins.__import__

    def no_imaging(name, *a, **k):
        if name.split(".")[0] in ("PIL", "cv2"):
            raise ImportError(name)
        return real(name, *a, **k)

    path = str(tmp_path / "v.jpg")
    cv2.imwrite(path, np.zeros((4, 4, 3), np.uint8))
    png = str(tmp_path / "v.png")
    img = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)
    cv2.imwrite(png, img)
    monkeypatch.setattr(builtins, "__import__", no_imaging)
    with pytest.raises(RuntimeError, match=r"v\.jpg: format \.jpg"):
        image.load_image(path)
    # a PNG needs neither
    np.testing.assert_array_equal(image.load_image(png), img[..., ::-1])
