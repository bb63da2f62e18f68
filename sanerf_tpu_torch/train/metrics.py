"""Evaluation meters (numpy; JAX package: sanerf_tpu/train/metrics.py),
with the `update / measure / write / report / clear` protocol the Trainer
drives: PSNR, SSIM (11x11 Gaussian window, scipy), LPIPS (the `lpips`
package and its pretrained VGG; without them `available` is False and
`measure()` gives nan) and mean IoU."""

from __future__ import annotations

import numpy as np


class PSNRMeter:
    """Mean per-image peak signal-to-noise ratio over [0, 1] images."""

    def __init__(self):
        self.clear()

    def clear(self):
        self.V, self.N = 0.0, 0

    def update(self, preds: np.ndarray, truths: np.ndarray):
        preds = np.asarray(preds, np.float64)
        truths = np.asarray(truths, np.float64)
        mse = np.mean((preds - truths) ** 2)
        self.V += -10.0 * np.log10(mse + 1e-12)
        self.N += 1

    def measure(self) -> float:
        return self.V / max(self.N, 1)

    def write(self, writer, global_step: int, prefix: str = ""):
        writer.add_scalar(f"{prefix}/PSNR", self.measure(), global_step)

    def report(self) -> str:
        return f"PSNR = {self.measure():.6f}"


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    k = np.outer(g, g)
    return k / k.sum()


def ssim(img0: np.ndarray, img1: np.ndarray, max_val: float = 1.0,
         k1: float = 0.01, k2: float = 0.03) -> float:
    """Single-scale SSIM with an 11x11 Gaussian window (sigma 1.5), 'valid'
    filtering, averaged over the map and the channels, in float64."""
    from scipy.signal import convolve2d

    c1, c2 = (k1 * max_val) ** 2, (k2 * max_val) ** 2
    kernel = _gaussian_kernel()

    def filt(x):
        return convolve2d(x, kernel, mode="valid")

    vals = []
    img0 = np.atleast_3d(np.asarray(img0, np.float64))
    img1 = np.atleast_3d(np.asarray(img1, np.float64))
    for c in range(img0.shape[-1]):
        x, y = img0[..., c], img1[..., c]
        mx, my = filt(x), filt(y)
        mxx, myy, mxy = filt(x * x), filt(y * y), filt(x * y)
        vx, vy = mxx - mx * mx, myy - my * my
        cov = mxy - mx * my
        s = ((2 * mx * my + c1) * (2 * cov + c2)) / (
            (mx * mx + my * my + c1) * (vx + vy + c2))
        vals.append(s.mean())
    return float(np.mean(vals))


class SSIMMeter:
    """Mean per-image SSIM."""

    def __init__(self):
        self.clear()

    def clear(self):
        self.V, self.N = 0.0, 0

    def update(self, preds: np.ndarray, truths: np.ndarray):
        self.V += ssim(preds, truths)
        self.N += 1

    def measure(self) -> float:
        return self.V / max(self.N, 1)

    def write(self, writer, global_step: int, prefix: str = ""):
        writer.add_scalar(f"{prefix}/SSIM", self.measure(), global_step)

    def report(self) -> str:
        return f"SSIM = {self.measure():.6f}"


class LPIPSMeter:
    """Learned perceptual similarity through the `lpips` package; where it
    or its pretrained weights are missing, `available` is False, updates
    are ignored and `measure()` gives nan."""

    def __init__(self, net: str = "vgg"):
        self.clear()
        try:
            import lpips

            self._fn = lpips.LPIPS(net=net)
            self.available = True
        except Exception:
            self._fn = None
            self.available = False

    def clear(self):
        self.V, self.N = 0.0, 0

    def update(self, preds: np.ndarray, truths: np.ndarray):
        if not self.available:
            return
        import torch

        p = torch.from_numpy(np.asarray(preds, np.float32)).permute(
            2, 0, 1)[None] * 2 - 1
        g = torch.from_numpy(np.asarray(truths, np.float32)).permute(
            2, 0, 1)[None] * 2 - 1
        with torch.no_grad():
            self.V += float(self._fn(p, g).item())
        self.N += 1

    def measure(self) -> float:
        if not self.available or self.N == 0:
            return float("nan")
        return self.V / self.N

    def write(self, writer, global_step: int, prefix: str = ""):
        writer.add_scalar(f"{prefix}/LPIPS", self.measure(), global_step)

    def report(self) -> str:
        if not self.available:
            return "LPIPS = n/a (no pretrained weights)"
        return f"LPIPS = {self.measure():.6f}"


class MeanIoUMeter:
    """Per-class IoU averaged over the classes of a frame, then over frames;
    labels -1 are ignored."""

    def __init__(self):
        self.clear()

    def clear(self):
        self.V, self.N = 0.0, 0

    def update(self, preds: np.ndarray, truths: np.ndarray):
        preds = np.asarray(preds).reshape(-1)
        truths = np.asarray(truths).reshape(-1)
        valid = truths != -1
        preds, truths = preds[valid], truths[valid]
        ious = []
        for c in np.unique(truths):
            inter = np.sum((preds == c) & (truths == c))
            union = np.sum((preds == c) | (truths == c))
            if union > 0:
                ious.append(inter / union)
        if ious:
            self.V += float(np.mean(ious))
            self.N += 1

    def measure(self) -> float:
        return self.V / max(self.N, 1)

    def write(self, writer, global_step: int, prefix: str = ""):
        writer.add_scalar(f"{prefix}/mIoU", self.measure(), global_step)

    def report(self) -> str:
        return f"mIoU = {self.measure():.6f}"
