"""SAM mask decoder: tokens + image features -> masks and IoU predictions
(JAX: sanerf_tpu/models/sam/mask_decoder.py). Channels-last throughout."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import torch
import torch.nn.functional as F

from sanerf_tpu_torch.models.sam import common, transformer
from sanerf_tpu_torch.models.sam.common import Params
from sanerf_tpu_torch.models.sam.transformer import TwoWayConfig


@dataclass(frozen=True)
class DecoderConfig:
    transformer: TwoWayConfig = field(default_factory=TwoWayConfig)
    num_multimask_outputs: int = 3
    embed_dim: int = 256
    iou_head_depth: int = 3
    iou_head_hidden: int = 256

    @property
    def num_mask_tokens(self) -> int:
        return self.num_multimask_outputs + 1


def init_params(cfg: DecoderConfig, g: torch.Generator) -> Params:
    d, nmt = cfg.embed_dim, cfg.num_mask_tokens
    return {
        "iou_token": torch.randn(d, generator=g),
        "mask_tokens": torch.randn(nmt, d, generator=g),
        "transformer": transformer.init_params(cfg.transformer, g),
        "upscale": {
            "convt1": common.init_conv_transpose(g, 2, d, d // 4),
            "ln1": common.init_layer_norm(d // 4),
            "convt2": common.init_conv_transpose(g, 2, d // 4, d // 8),
        },
        "hyper_mlps": [common.init_mlp(g, d, d, d // 8, 3)
                       for _ in range(nmt)],
        "iou_head": common.init_mlp(g, d, cfg.iou_head_hidden, nmt,
                                    cfg.iou_head_depth),
    }


def predict_masks(cfg: DecoderConfig, params: Params,
                  image_embeddings: torch.Tensor, image_pe: torch.Tensor,
                  sparse_prompt: torch.Tensor, dense_prompt: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """image_embeddings [B, H, W, C], image_pe [HW, C], sparse_prompt
    [B, Np, C], dense_prompt [B, HW, C] -> (masks [B, nmt, 4H, 4W],
    iou_pred [B, nmt])."""
    B, H, W, C = image_embeddings.shape
    nmt = cfg.num_mask_tokens
    output_tokens = torch.cat([params["iou_token"][None, :],
                               params["mask_tokens"]], dim=0).float()
    tokens = torch.cat([output_tokens[None].expand(B, 1 + nmt, C),
                        sparse_prompt.float()], dim=1)
    src = image_embeddings.reshape(B, H * W, C) + dense_prompt
    pe = image_pe[None].expand(B, H * W, C)
    hs, src = transformer.apply(cfg.transformer, params["transformer"], src,
                                pe, tokens)
    iou_tok = hs[:, 0, :]
    mask_toks = hs[:, 1:1 + nmt, :]
    # upscale the image features 4x
    up = params["upscale"]
    x = src.reshape(B, H, W, C)
    x = common.conv_transpose2d(up["convt1"], x, stride=2)
    x = F.gelu(common.layer_norm_2d(up["ln1"], x))
    x = common.conv_transpose2d(up["convt2"], x, stride=2)
    x = F.gelu(x)  # [B, 4H, 4W, C/8]
    hyper = torch.stack([common.mlp(params["hyper_mlps"][i], mask_toks[:, i])
                         for i in range(nmt)], dim=1)  # [B, nmt, C/8]
    masks = torch.einsum("bnc,bhwc->bnhw", hyper, x)
    iou_pred = common.mlp(params["iou_head"], iou_tok)
    return masks, iou_pred


def select_masks(masks: torch.Tensor, iou_pred: torch.Tensor,
                 multimask_output: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slice 0 for one mask, slices 1: for the multimask output."""
    if multimask_output:
        return masks[:, 1:], iou_pred[:, 1:]
    return masks[:, :1], iou_pred[:, :1]
