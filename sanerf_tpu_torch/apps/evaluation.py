"""Mask-quality evaluation: mIoU and accuracy against ground-truth masks
(JAX: sanerf_tpu/apps/evaluation.py).

For each named view, `<name>_masks.npy` of `gt_dir` (-1 = not labelled)
against the prediction a method's loader reads from `result_dir`: `ours`
the `<name>_mask.npy` the CLI's `--test` writes (the argmax of its
logits), `sa3d` and `isrf` the baselines' grayscale PNGs. A prediction
of another size is resized nearest to the ground truth's.

The baselines' PNGs are read as cv2's IMREAD_GRAYSCALE reads them,
without OpenCV (`read_gray_png`): a colour PNG goes through libpng's
fixed-point rgb-to-gray, the weights 0.299 / 0.587 as 9797 / 19234 /
3737 of 32768, the sum shifted right by 15 (no rounding), alpha dropped.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List

import numpy as np

from sanerf_tpu_torch.utils.image import read_png, resize

# libpng's png_set_rgb_to_gray(png, 1, 0.299, 0.587), as cv2 calls it
_RED, _GREEN = 29900 * 32768 // 100000, 58700 * 32768 // 100000
_BLUE = 32768 - _RED - _GREEN


def read_gray_png(path: str) -> np.ndarray:
    """cv2.imread(path, cv2.IMREAD_GRAYSCALE) of an 8-bit PNG -> uint8
    [H, W] (module docstring)."""
    img = read_png(path)
    if img.ndim == 2:
        return img
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    return ((_RED * r + _GREEN * g + _BLUE * b) >> 15).astype(np.uint8)


def eval_iou(pred: np.ndarray, gt: np.ndarray) -> float:
    """Binary IoU over the labelled (gt != -1) pixels; 1 for an empty
    union."""
    valid = gt != -1
    p, g = pred[valid] > 0, gt[valid] > 0
    union = np.sum(p | g)
    return float(np.sum(p & g) / union) if union else 1.0


def eval_acc(pred: np.ndarray, gt: np.ndarray) -> float:
    valid = gt != -1
    return (float(np.mean((pred[valid] > 0) == (gt[valid] > 0)))
            if valid.any() else 1.0)


def load_ours(result_dir: str, name: str) -> np.ndarray:
    """`<name>_mask.npy`: labels, or logits [H, W, K] and their argmax."""
    m = np.load(os.path.join(result_dir, f"{name}_mask.npy"))
    if m.ndim == 3:
        m = np.argmax(m, -1)
    return m


def load_sa3d(result_dir: str, name: str) -> np.ndarray:
    """SA3D's `<name>.png`: nonzero = object."""
    img = read_gray_png(os.path.join(result_dir, f"{name}.png"))
    return (img > 0).astype(np.int64)


def load_isrf(result_dir: str, name: str) -> np.ndarray:
    """ISRF's `<name>_mask.png`: above 127 = object."""
    img = read_gray_png(os.path.join(result_dir, f"{name}_mask.png"))
    return (img > 127).astype(np.int64)


ADAPTERS: Dict[str, Callable] = {"ours": load_ours, "sa3d": load_sa3d,
                                 "isrf": load_isrf}


def evaluate_scene(gt_dir: str, result_dir: str, view_names: List[str],
                   method: str = "ours") -> Dict[str, float]:
    """mIoU and accuracy over the named views that have ground truth."""
    loader = ADAPTERS[method]
    ious, accs = [], []
    for name in view_names:
        gt_path = os.path.join(gt_dir, f"{name}_masks.npy")
        if not os.path.exists(gt_path):
            continue
        gt = np.load(gt_path)
        pred = loader(result_dir, name)
        if pred.shape != gt.shape:
            pred = resize(pred.astype(np.uint8), gt.shape[::-1],
                          "nearest").astype(np.int64)
        ious.append(eval_iou(pred, gt))
        accs.append(eval_acc(pred, gt))
    return {
        "miou": float(np.mean(ious)) if ious else float("nan"),
        "acc": float(np.mean(accs)) if accs else float("nan"),
        "n_views": len(ious),
    }


def build_parser():
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--gt_dir", required=True)
    p.add_argument("--result_dir", required=True)
    p.add_argument("--method", default="ours", choices=list(ADAPTERS))
    p.add_argument("--test_view_json", default="scenes_test_view.json")
    p.add_argument("--scene_name", default=None)
    return p


def main(argv=None):
    """python -m sanerf_tpu_torch.apps.evaluation --gt_dir D --result_dir R
    [--method ours|sa3d|isrf] [--test_view_json J --scene_name S]: the
    views J names for S, else every `*_masks.npy` of D; prints one JSON
    line."""
    args = build_parser().parse_args(argv)

    if os.path.exists(args.test_view_json) and args.scene_name:
        with open(args.test_view_json) as f:
            views = json.load(f)[args.scene_name]
    else:
        views = sorted(
            os.path.splitext(f)[0].replace("_masks", "")
            for f in os.listdir(args.gt_dir) if f.endswith("_masks.npy"))
    res = evaluate_scene(args.gt_dir, args.result_dir, views, args.method)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
