"""Evaluation meters (numpy; JAX package: sanerf_tpu/train/metrics.py)."""

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
