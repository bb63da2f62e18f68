"""Automatic mask generation: grid prompts -> filters -> NMS -> RLE masks
(JAX: sanerf_tpu/apps/auto_generator.py).

SAM's automatic mask generator: prompt SAM with a regular point grid,
decoded `points_per_batch` points at a time through
`SamPredictor.predict_batch`, over an optional crop pyramid
(`crop_n_layers`: layer i re-runs the grid on (2^i)^2 overlapping crops);
keep the masks whose predicted IoU and stability pass their thresholds,
de-duplicate them by box NMS within each crop and then across crops
(smaller crops preferred), and return them RLE-encoded.

`generate(features=..., hw=...)` takes a NeRF-rendered feature map in
place of the ViT encoder; each crop slices the map in proportion. The
helpers are numpy and give the JAX package's results bit for bit; the
decode runs on the predictor's device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np


def build_point_grid(n_per_side: int) -> np.ndarray:
    """[n^2, 2] evenly spaced points in [0,1]^2."""
    offset = 1.0 / (2 * n_per_side)
    ticks = np.linspace(offset, 1 - offset, n_per_side)
    gx, gy = np.meshgrid(ticks, ticks)
    return np.stack([gx.ravel(), gy.ravel()], -1)


def generate_crop_boxes(
    im_size: Tuple[int, int], n_layers: int, overlap_ratio: float
) -> Tuple[List[List[int]], List[int]]:
    """Crop boxes per pyramid layer (amg.py generate_crop_boxes semantics):
    layer 0 is the full image; layer i has (2^i)^2 overlapping crops."""
    H, W = im_size
    boxes: List[List[int]] = [[0, 0, W, H]]
    layer_idxs: List[int] = [0]
    short_side = min(H, W)

    def crop_len(orig_len, n_crops, overlap):
        return int(math.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_side))
        cw = crop_len(W, n_side, overlap)
        ch = crop_len(H, n_side, overlap)
        x0s = [int((cw - overlap) * i) for i in range(n_side)]
        y0s = [int((ch - overlap) * i) for i in range(n_side)]
        for y0 in y0s:
            for x0 in x0s:
                boxes.append([x0, y0, min(x0 + cw, W), min(y0 + ch, H)])
                layer_idxs.append(i_layer + 1)
    return boxes, layer_idxs


def mask_to_rle(mask: np.ndarray) -> Dict:
    """Binary mask -> uncompressed RLE (column-major, SAM convention)."""
    flat = np.asarray(mask, bool).T.ravel()
    change = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    idx = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(idx).tolist()
    if flat[0]:
        counts = [0] + counts
    return {"size": list(mask.shape), "counts": counts}


def rle_to_mask(rle: Dict) -> np.ndarray:
    h, w = rle["size"]
    out = np.zeros(h * w, bool)
    pos, val = 0, False
    for c in rle["counts"]:
        out[pos : pos + c] = val
        pos += c
        val = not val
    return out.reshape(w, h).T


def mask_stability_score(logits: np.ndarray, threshold: float,
                         offset: float = 1.0) -> float:
    """IoU between masks thresholded at +/- offset around the cutoff."""
    hi = np.sum(logits > threshold + offset)
    lo = np.sum(logits > threshold - offset)
    return float(hi / lo) if lo else 0.0


def batch_stability_scores(logits: np.ndarray, threshold: float,
                           offset: float = 1.0) -> np.ndarray:
    """Vectorized stability over [K, H, W] logits -> [K]."""
    hi = np.sum(logits > threshold + offset, axis=(-2, -1))
    lo = np.sum(logits > threshold - offset, axis=(-2, -1))
    return np.where(lo > 0, hi / np.maximum(lo, 1), 0.0)


def box_from_mask(mask: np.ndarray) -> np.ndarray:
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return np.zeros(4)
    return np.array([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1], np.float64)


def box_near_crop_edge(box: np.ndarray, crop_box: List[int],
                       orig_box: List[int], atol: float = 20.0) -> bool:
    """True when a box touches its crop's boundary but not the image's
    (amg.py is_box_near_crop_edge) — such masks are crop artifacts."""
    near_crop = [abs(box[i] - crop_box[i]) <= atol for i in range(4)]
    near_orig = [abs(box[i] - orig_box[i]) <= atol for i in range(4)]
    return any(c and not o for c, o in zip(near_crop, near_orig))


def box_nms(boxes: np.ndarray, scores: np.ndarray, iou_thresh: float = 0.7) -> List[int]:
    order = np.argsort(-scores)
    keep = []
    while len(order):
        i = order[0]
        keep.append(int(i))
        if len(order) == 1:
            break
        rest = order[1:]
        xx0 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy0 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx1 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy1 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(xx1 - xx0, 0) * np.maximum(yy1 - yy0, 0)
        a = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        b = (boxes[rest, 2] - boxes[rest, 0]) * (boxes[rest, 3] - boxes[rest, 1])
        iou = inter / np.maximum(a + b - inter, 1e-9)
        order = rest[iou <= iou_thresh]
    return keep


class AutomaticMaskGenerator:
    """Grid-prompted dense segmentation over an image or a precomputed
    (NeRF-rendered) feature map, with batched decoding and an optional
    crop pyramid."""

    def __init__(
        self,
        predictor,
        points_per_side: int = 32,
        points_per_batch: int = 64,
        pred_iou_thresh: float = 0.88,
        stability_score_thresh: float = 0.95,
        box_nms_thresh: float = 0.7,
        min_mask_region_area: int = 0,
        crop_n_layers: int = 0,
        crop_nms_thresh: float = 0.7,
        crop_overlap_ratio: float = 512 / 1500,
        crop_n_points_downscale_factor: int = 1,
    ):
        self.predictor = predictor
        # one grid per pyramid layer, downscaled by the reference factor
        # (auto_generator.py:50-52, build_all_layer_point_grids)
        self.point_grids = [
            build_point_grid(
                max(1, points_per_side // (crop_n_points_downscale_factor ** i)))
            for i in range(crop_n_layers + 1)
        ]
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.box_nms_thresh = box_nms_thresh
        self.min_mask_region_area = min_mask_region_area
        self.crop_n_layers = crop_n_layers
        self.crop_nms_thresh = crop_nms_thresh
        self.crop_overlap_ratio = crop_overlap_ratio

    @property
    def point_grid(self) -> np.ndarray:  # back-compat: layer-0 grid
        return self.point_grids[0]

    def generate(self, image: Optional[np.ndarray] = None,
                 features: Optional[np.ndarray] = None,
                 hw: Optional[tuple] = None) -> List[Dict]:
        """image: uint8 [H, W, 3]; OR features [h, w, 256] + hw=(H, W)
        (the debug.py precomputed-features path)."""
        if features is not None:
            H, W = hw
        else:
            H, W = image.shape[:2]

        crop_boxes, layer_idxs = generate_crop_boxes(
            (H, W), self.crop_n_layers, self.crop_overlap_ratio)

        records: List[Dict] = []
        for crop_box, layer in zip(crop_boxes, layer_idxs):
            records.extend(self._process_crop(
                image, features, (H, W), crop_box, layer))

        if not records:
            return []
        boxes = np.stack([r["box"] for r in records])
        if len(crop_boxes) > 1:
            # cross-crop NMS, preferring masks from smaller crops
            # (auto_generator.py:176-184: scores = 1 / box_area(crop_box))
            areas = np.asarray(
                [(r["crop_box"][2] - r["crop_box"][0])
                 * (r["crop_box"][3] - r["crop_box"][1]) for r in records],
                np.float64)
            keep = box_nms(boxes, 1.0 / areas, self.crop_nms_thresh)
            records = [records[i] for i in keep]
            boxes = boxes[keep]

        out = []
        for r, box in zip(records, boxes):
            out.append({
                "segmentation": mask_to_rle(r["mask"]),
                "area": int(r["mask"].sum()),
                "bbox": box.tolist(),
                "predicted_iou": r["iou"],
                "stability_score": r["stability"],
                "point_coords": [r["point"].tolist()],
                "crop_box": list(r["crop_box"]),
            })
        return out

    # -- internals -------------------------------------------------------------

    def _set_crop_state(self, image, features, crop_box, hw):
        """Point the predictor at this crop (image crop, or the
        proportionally sliced feature map on the rendered-features path)."""
        x0, y0, x1, y1 = crop_box
        if features is not None:
            H, W = hw
            h, w = features.shape[:2]
            fy0, fy1 = int(y0 / H * h), max(int(y0 / H * h) + 1, round(y1 / H * h))
            fx0, fx1 = int(x0 / W * w), max(int(x0 / W * w) + 1, round(x1 / W * w))
            self.predictor.set_features(
                features[fy0:fy1, fx0:fx1], y1 - y0, x1 - x0)
        else:
            self.predictor.set_image(image[y0:y1, x0:x1])

    def _process_crop(self, image, features, hw, crop_box, layer) -> List[Dict]:
        H, W = hw
        x0, y0, x1, y1 = crop_box
        ch, cw = y1 - y0, x1 - x0
        self._set_crop_state(image, features, crop_box, hw)

        coords = self.point_grids[layer] * np.array([cw, ch])
        records: List[Dict] = []
        thr = self.predictor.cfg.mask_threshold
        for start in range(0, len(coords), self.points_per_batch):
            pts = coords[start : start + self.points_per_batch]
            # ONE batched decode for the whole chunk (B single-point prompts)
            logits, ious = self.predictor.predict_batch(
                pts[:, None, :], multimask_output=True)
            B, M = ious.shape
            flat_logits = logits.reshape(B * M, ch, cw)
            flat_iou = ious.reshape(B * M)
            flat_pts = np.repeat(pts, M, axis=0)

            keep = flat_iou > self.pred_iou_thresh
            stab = batch_stability_scores(flat_logits, thr)
            keep &= stab >= self.stability_score_thresh
            for k in np.nonzero(keep)[0]:
                mask = flat_logits[k] > thr
                area = int(mask.sum())
                if area == 0 or (self.min_mask_region_area
                                 and area < self.min_mask_region_area):
                    continue
                box = box_from_mask(mask) + np.array([x0, y0, x0, y0])
                if len(self.point_grids) > 1 and box_near_crop_edge(
                        box, crop_box, [0, 0, W, H]):
                    continue
                # uncrop into the full-image frame
                if (ch, cw) != (H, W):
                    full = np.zeros((H, W), bool)
                    full[y0:y1, x0:x1] = mask
                    mask = full
                records.append({
                    "mask": mask,
                    "box": box,
                    "iou": float(flat_iou[k]),
                    "stability": float(stab[k]),
                    "point": flat_pts[k] + np.array([x0, y0]),
                    "crop_box": crop_box,
                })

        if not records:
            return []
        # per-crop NMS (auto_generator.py:216-222)
        boxes = np.stack([r["box"] for r in records])
        scores = np.asarray([r["iou"] for r in records])
        keep = box_nms(boxes, scores, self.box_nms_thresh)
        return [records[i] for i in keep]
