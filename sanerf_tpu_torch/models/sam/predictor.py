"""SAM predictor on rendered features (JAX: sanerf_tpu/models/sam/
predictor.py).

- `decode`: prompt encode + mask decode on a [1, 64, 64, C] feature grid;
- `decode_fused`: the interactive frame's decode in one call: the rendered
  feature map resized so its longest side is 64 and zero-padded, the click
  coordinates moved to the virtual input size, `decode`, then the masks
  upsampled to the input square, cropped and resized to the frame;
- `SamPredictor`: the stateful wrapper (`set_features`, `predict`,
  `predict_batch`, `postprocess`). `set_image` raises: the ViT image
  encoder is not ported yet.

Resizes are bilinear with half-pixel centres, as `jax.image.resize`; that
one antialiases when it shrinks, so a downsample here passes
`antialias=True` (the 1024 -> 512 mask step of a 512^2 frame).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sanerf_tpu_torch.device import resolve_device
from sanerf_tpu_torch.models.sam import common, mask_decoder, prompt_encoder
from sanerf_tpu_torch.models.sam.mask_decoder import DecoderConfig
from sanerf_tpu_torch.models.sam.prompt_encoder import PromptConfig


@dataclass(frozen=True)
class ViTConfig:
    """The image encoder's configuration (ViT-H defaults). The port keeps
    it for `img_size`, the side of SAM's input square."""

    img_size: int = 1024
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: float = 4.0
    out_chans: int = 256
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    use_rel_pos: bool = True

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size


@dataclass(frozen=True)
class SamConfig:
    vit: ViTConfig = field(default_factory=ViTConfig)
    prompt: PromptConfig = field(default_factory=PromptConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    mask_threshold: float = 0.0


def init_params(cfg: SamConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random prompt encoder and mask decoder (no image encoder), float32,
    drawn on the CPU from `generator` and moved to `device`."""
    p = {"prompt_encoder": prompt_encoder.init_params(cfg.prompt, generator),
         "mask_decoder": mask_decoder.init_params(cfg.decoder, generator)}
    return p if device is None else _map(p, lambda t: t.to(device))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """'/'-joined paths, list indices as numbers (the JAX package's
    train/checkpoints.py:flatten_tree format)."""
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple)) else None)
    if items is None:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}/"))
    return out


def _rebuild(tree, flat: Dict[str, torch.Tensor], prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, flat, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, flat, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return flat[prefix[:-1]]


def params_from_jax(flat: Dict[str, np.ndarray], cfg: SamConfig,
                    device=None) -> dict:
    """A JAX SAM parameter tree, flattened to numpy under 'a/b/0/c' path
    keys, -> the port's tree (float32 tensors on `device`, CPU by default).
    Keys under `image_encoder/` are skipped (the encoder is not ported).
    Raises ValueError on any other key the port does not hold, on a shape
    that differs, and on a missing key."""
    dev = torch.device("cpu") if device is None else resolve_device(device)
    tmpl = init_params(cfg, torch.Generator().manual_seed(0))
    want = {k: tuple(v.shape) for k, v in _flatten(tmpl).items()}
    got = {k: v for k, v in flat.items() if not k.startswith("image_encoder/")}
    bad = sorted(k for k, v in got.items()
                 if want.get(k) != tuple(np.shape(v)))
    if bad:
        raise ValueError(f"SAM params failed to map: {bad}")
    missing = sorted(set(want) - set(got))
    if missing:
        raise ValueError(f"SAM params missing: {missing}")
    tens = {k: torch.tensor(np.asarray(v, np.float32), device=dev)
            for k, v in got.items()}
    return _rebuild(tmpl, tens)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Resize the last two axes of x [..., H, W] (float32) bilinearly with
    half-pixel centres, antialiased when an axis shrinks (the semantics of
    `jax.image.resize(..., "bilinear")`)."""
    H, W = x.shape[-2:]
    if (H, W) == tuple(size):
        return x.float()
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape(1, -1, H, W).float(), size=tuple(size),
                      mode="bilinear", align_corners=False,
                      antialias=size[0] < H or size[1] < W)
    return y.reshape(*lead, *size)


def _inject(cfg: SamConfig, feats: torch.Tensor):
    """[h, w, C] rendered features -> [1, g, g, C]: resized so the longest
    side is g = image_embedding_size[0], zero-padded; and (nh, nw)."""
    grid = cfg.prompt.image_embedding_size[0]
    h, w = feats.shape[:2]
    scale = grid / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    f = resize_bilinear(feats.permute(2, 0, 1), (nh, nw)).permute(1, 2, 0)
    f = F.pad(f, (0, 0, 0, grid - nw, 0, grid - nh))
    return f[None], (nh, nw)


def decode(cfg: SamConfig, params, features: torch.Tensor,
           point_coords: torch.Tensor, point_labels: torch.Tensor,
           multimask_output: bool = False):
    """features [1, 64, 64, C]; point_coords [B, N, 2] input-space (x, y);
    point_labels [B, N] -> (mask logits [B, M, 256, 256], iou [B, M])."""
    pe = params["prompt_encoder"]
    sparse = prompt_encoder.encode_points(pe, cfg.prompt, point_coords,
                                          point_labels)
    B = sparse.shape[0]
    dense = prompt_encoder.no_mask_dense(pe, cfg.prompt, B)
    image_pe = prompt_encoder.dense_pe(pe, cfg.prompt)
    feats = features.expand(B, *features.shape[1:])
    masks, iou = mask_decoder.predict_masks(
        cfg.decoder, params["mask_decoder"], feats, image_pe, sparse, dense)
    return mask_decoder.select_masks(masks, iou, multimask_output)


def _to_frame(cfg: SamConfig, masks: torch.Tensor, input_hw, out_hw):
    """[B, M, 256, 256] logits -> [B, M, oh, ow]: up to the input square,
    crop the valid region, resize to the frame."""
    target = cfg.vit.img_size
    up = resize_bilinear(masks, (target, target))
    up = up[:, :, :input_hw[0], :input_hw[1]]
    return resize_bilinear(up, tuple(out_hw))


def decode_fused(cfg: SamConfig, params, feats: torch.Tensor,
                 point_coords: torch.Tensor, point_labels: torch.Tensor,
                 feat_hw: Tuple[int, int], out_hw: Tuple[int, int],
                 input_hw: Tuple[int, int], multimask_output: bool = False):
    """The interactive decode: feats [h, w, C] rendered feature map,
    point_coords [B, N, 2] ORIGINAL-frame (x, y), point_labels [B, N] ->
    (masks [B, M, oh, ow] bool, iou [B, M])."""
    if tuple(feats.shape[:2]) != tuple(feat_hw):
        raise ValueError(f"feats {tuple(feats.shape)} vs feat_hw {feat_hw}")
    oh, ow = out_hw
    ih, iw = input_hw
    f, _ = _inject(cfg, feats)
    scale = common.const_row([iw / ow, ih / oh], point_coords.device)
    masks, iou = decode(cfg, params, f, point_coords.float() * scale,
                        point_labels, multimask_output)
    full = _to_frame(cfg, masks, input_hw, out_hw)
    return full > cfg.mask_threshold, iou


class SamPredictor:
    """Stateful wrapper over `decode` (segment_anything's SamPredictor
    surface) for features rendered by the NeRF."""

    def __init__(self, cfg: SamConfig, params, device=None):
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.reset()

    def reset(self):
        self.features = None
        self.original_size: Optional[Tuple[int, int]] = None
        self.input_size: Optional[Tuple[int, int]] = None

    def set_image(self, image: np.ndarray):
        raise NotImplementedError(
            "the SAM ViT image encoder is not in the port yet; use "
            "set_features with a rendered feature map")

    def set_features(self, feats, H: int, W: int):
        """feats [h, w, C]: the rendered feature map of an H x W frame,
        resized so its longest side is 64 and zero-padded to 64 x 64."""
        feats = torch.as_tensor(feats, device=self.device)
        self.features, (nh, nw) = _inject(self.cfg, feats)
        self.original_size = (H, W)
        # the virtual input size at SAM's 16x patch stride
        self.input_size = (nh * 16, nw * 16)

    def transform_coords(self, coords: np.ndarray) -> np.ndarray:
        """Original-frame (x, y) pixels -> model input space."""
        oh, ow = self.original_size
        ih, iw = self.input_size
        out = np.asarray(coords, np.float32).copy()
        out[..., 0] *= iw / ow
        out[..., 1] *= ih / oh
        return out

    def _decode(self, coords: np.ndarray, labels: np.ndarray,
                multimask_output: bool):
        if self.features is None:
            raise RuntimeError("call set_features first")
        return decode(self.cfg, self.params, self.features,
                      torch.as_tensor(coords, device=self.device),
                      torch.as_tensor(np.asarray(labels, np.int64),
                                      device=self.device),
                      multimask_output)

    def predict(self, point_coords: np.ndarray, point_labels: np.ndarray,
                multimask_output: bool = False, return_logits: bool = False):
        """point_coords [N, 2] original-frame (x, y), point_labels [N] ->
        (masks [M, H, W] bool (logits with return_logits), iou [M],
        low-res logits [M, 256, 256]), numpy."""
        masks, iou = self._decode(self.transform_coords(point_coords)[None],
                                  np.asarray(point_labels)[None],
                                  multimask_output)
        out = self.postprocess(masks)[0]
        if not return_logits:
            out = out > self.cfg.mask_threshold
        return (out.cpu().numpy(), iou[0].cpu().numpy(),
                masks[0].cpu().numpy())

    def predict_batch(self, point_coords: np.ndarray,
                      point_labels: Optional[np.ndarray] = None,
                      multimask_output: bool = True, chunk: int = 16):
        """B independent prompts, `chunk` per decode -> (mask logits
        [B, M, H, W] float32, iou [B, M]), numpy."""
        coords = self.transform_coords(np.asarray(point_coords, np.float32))
        B, N = coords.shape[:2]
        if point_labels is None:
            point_labels = np.ones((B, N), np.int64)
        out_masks, out_iou = [], []
        for s in range(0, B, chunk):
            masks, iou = self._decode(coords[s:s + chunk],
                                      np.asarray(point_labels)[s:s + chunk],
                                      multimask_output)
            out_masks.append(self.postprocess(masks).cpu().numpy())
            out_iou.append(iou.cpu().numpy())
        return np.concatenate(out_masks), np.concatenate(out_iou)

    def postprocess(self, masks: torch.Tensor) -> torch.Tensor:
        """[B, M, 256, 256] logits -> [B, M, H, W] at the original size."""
        return _to_frame(self.cfg, masks, self.input_size, self.original_size)
