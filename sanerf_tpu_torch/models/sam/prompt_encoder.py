"""SAM prompt encoder (JAX: sanerf_tpu/models/sam/prompt_encoder.py):
point prompts (the interactive frame's), box prompts and dense mask
prompts."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from sanerf_tpu_torch.models.sam import common
from sanerf_tpu_torch.models.sam.common import Params


@dataclass(frozen=True)
class PromptConfig:
    embed_dim: int = 256
    image_embedding_size: Tuple[int, int] = (64, 64)
    input_image_size: Tuple[int, int] = (1024, 1024)
    mask_in_chans: int = 16


def init_params(cfg: PromptConfig, g: torch.Generator) -> Params:
    d, mc = cfg.embed_dim, cfg.mask_in_chans
    return {
        # Gaussian matrix of the Fourier position encoding (scale 1)
        "pe_gaussian": torch.randn(2, d // 2, generator=g),
        # 0: negative point, 1: positive point, 2/3: box corners
        "point_embeddings": [torch.randn(d, generator=g) for _ in range(4)],
        "not_a_point": torch.randn(d, generator=g),
        "no_mask": torch.randn(d, generator=g),
        "mask_down": {
            "conv1": common.init_conv(g, 2, 1, mc // 4),
            "ln1": common.init_layer_norm(mc // 4),
            "conv2": common.init_conv(g, 2, mc // 4, mc),
            "ln2": common.init_layer_norm(mc),
            "conv3": common.init_conv(g, 1, mc, d),
        },
    }


def _pe_encode(params: Params, coords01: torch.Tensor) -> torch.Tensor:
    """Fourier position encoding of [0, 1] coordinates [..., 2]."""
    c = 2.0 * coords01 - 1.0
    c = c.float() @ params["pe_gaussian"].float()
    c = 2.0 * math.pi * c
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def dense_pe(params: Params, cfg: PromptConfig) -> torch.Tensor:
    """Encoding of the image-embedding grid -> [h*w, C]."""
    h, w = cfg.image_embedding_size
    dev = params["pe_gaussian"].device
    gy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    gx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    grid = torch.stack([gx[None, :].expand(h, w), gy[:, None].expand(h, w)],
                       dim=-1)  # (x, y)
    return _pe_encode(params, grid.reshape(-1, 2))


def encode_points(params: Params, cfg: PromptConfig, coords: torch.Tensor,
                  labels: torch.Tensor, pad_with_no_box: bool = True
                  ) -> torch.Tensor:
    """coords [B, N, 2] input-image pixels (x, y); labels [B, N] (1 fg,
    0 bg, -1 padding) -> sparse embeddings [B, N(+1), C]. Without a box
    SAM appends one padding point."""
    if pad_with_no_box:
        coords = torch.cat([coords, coords.new_zeros(coords.shape[0], 1, 2)],
                           dim=1)
        labels = torch.cat([labels, -torch.ones_like(labels[:, :1])], dim=1)
    size = common.const_row([cfg.input_image_size[1],
                             cfg.input_image_size[0]], coords.device)
    pe = _pe_encode(params, (coords.float() + 0.5) / size)
    lab = labels[..., None]
    pe = torch.where(lab == -1, 0.0, pe)  # padding points carry no PE
    out = pe + torch.where(lab == -1, params["not_a_point"], 0.0)
    out = out + torch.where(lab == 0, params["point_embeddings"][0], 0.0)
    out = out + torch.where(lab == 1, params["point_embeddings"][1], 0.0)
    return out


def encode_boxes(params: Params, cfg: PromptConfig, boxes: torch.Tensor
                 ) -> torch.Tensor:
    """boxes [B, 4] (x0, y0, x1, y1) input-image pixels -> [B, 2, C] corner
    embeddings (the position encoding plus point_embeddings[2] / [3])."""
    size = common.const_row([cfg.input_image_size[1],
                             cfg.input_image_size[0]], boxes.device)
    pe = _pe_encode(params, (boxes.float().reshape(-1, 2, 2) + 0.5) / size)
    emb = params["point_embeddings"]
    return pe + torch.stack([emb[2], emb[3]])[None].float()


def encode_masks(params: Params, cfg: PromptConfig, masks: torch.Tensor
                 ) -> torch.Tensor:
    """Dense mask prompt [B, 4h, 4w, 1] -> [B, h*w, C] through the
    downscaler: two 2x2 stride-2 convolutions, each with a LayerNorm2d and
    the exact GELU, then a 1x1 convolution."""
    p = params["mask_down"]
    x = common.conv2d_patches(p["conv1"], masks)
    x = F.gelu(common.layer_norm_2d(p["ln1"], x))
    x = common.conv2d_patches(p["conv2"], x)
    x = F.gelu(common.layer_norm_2d(p["ln2"], x))
    x = common.conv2d_patches(p["conv3"], x)
    return x.reshape(x.shape[0], -1, x.shape[-1])


def no_mask_dense(params: Params, cfg: PromptConfig, batch: int
                  ) -> torch.Tensor:
    """Dense embedding without a mask prompt: the learned constant,
    [B, h*w, C]."""
    h, w = cfg.image_embedding_size
    nm = params["no_mask"]
    return nm[None, None, :].expand(batch, h * w, nm.shape[0])
