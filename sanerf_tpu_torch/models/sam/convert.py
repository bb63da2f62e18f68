"""The official SAM checkpoint (`sam_vit_h_4b8939.pth`, and ViT-L / ViT-B)
-> the port's parameter tree (JAX: sanerf_tpu/models/sam/convert.py). The
state dict's torch tensors are laid out straight into the port's modules
(float32 on the CPU):

- Linear: torch [out, in] -> [in, out];
- Conv2d: torch [out, in, kh, kw] -> HWIO [kh, kw, in, out];
- ConvTranspose2d: torch [in, out, kh, kw] -> [in, kh, kw, out];
- pos_embed, rel_pos, tokens, LayerNorm / LayerNorm2d: as they are.

`convert_checkpoint(path, variant)` reads a .pth; `convert_state_dict` an
in-memory dict; `export_reference_keys(cfg)` lists every key consumed.
"""

from __future__ import annotations

from typing import Dict

import torch

from sanerf_tpu_torch.models.sam.image_encoder import VIT_B, VIT_H, VIT_L
from sanerf_tpu_torch.models.sam.mask_decoder import DecoderConfig
from sanerf_tpu_torch.models.sam.predictor import SamConfig
from sanerf_tpu_torch.models.sam.prompt_encoder import PromptConfig

VARIANTS = {"vit_h": VIT_H, "vit_l": VIT_L, "vit_b": VIT_B}


def sam_config_for(variant: str) -> SamConfig:
    vit = VARIANTS[variant]
    return SamConfig(vit=vit, prompt=PromptConfig(), decoder=DecoderConfig())


def _lin(sd, prefix):
    p = {"w": sd[prefix + ".weight"].T.contiguous()}
    if prefix + ".bias" in sd:
        p["b"] = sd[prefix + ".bias"]
    return p


def _conv(sd, prefix):
    p = {"w": sd[prefix + ".weight"].permute(2, 3, 1, 0).contiguous()}
    if prefix + ".bias" in sd:
        p["b"] = sd[prefix + ".bias"]
    return p


def _convt(sd, prefix):
    p = {"w": sd[prefix + ".weight"].permute(0, 2, 3, 1).contiguous()}
    if prefix + ".bias" in sd:
        p["b"] = sd[prefix + ".bias"]
    return p


def _ln(sd, prefix):
    return {"w": sd[prefix + ".weight"], "b": sd[prefix + ".bias"]}


def _attn(sd, prefix):
    return {
        "q": _lin(sd, prefix + ".q_proj"),
        "k": _lin(sd, prefix + ".k_proj"),
        "v": _lin(sd, prefix + ".v_proj"),
        "out": _lin(sd, prefix + ".out_proj"),
    }


def convert_state_dict(sd: Dict[str, torch.Tensor], cfg: SamConfig) -> dict:
    """The full SAM state dict (torch tensors or numpy arrays) -> the port's
    tree of float32 CPU tensors."""
    sd = {k: torch.as_tensor(v).detach().to("cpu", torch.float32)
          for k, v in sd.items()}
    vit = cfg.vit

    blocks = []
    for i in range(vit.depth):
        pre = f"image_encoder.blocks.{i}"
        bp = {
            "norm1": _ln(sd, pre + ".norm1"),
            "qkv": _lin(sd, pre + ".attn.qkv"),
            "proj": _lin(sd, pre + ".attn.proj"),
            "norm2": _ln(sd, pre + ".norm2"),
            "mlp": {
                "lin1": _lin(sd, pre + ".mlp.lin1"),
                "lin2": _lin(sd, pre + ".mlp.lin2"),
            },
        }
        if vit.use_rel_pos:
            bp["rel_pos_h"] = sd[pre + ".attn.rel_pos_h"]
            bp["rel_pos_w"] = sd[pre + ".attn.rel_pos_w"]
        blocks.append(bp)

    image_params = {
        "patch_embed": _conv(sd, "image_encoder.patch_embed.proj"),
        "pos_embed": sd["image_encoder.pos_embed"],
        "blocks": blocks,
        "neck": {
            "conv1": _conv(sd, "image_encoder.neck.0"),
            "ln1": _ln(sd, "image_encoder.neck.1"),
            "conv2": _conv(sd, "image_encoder.neck.2"),
            "ln2": _ln(sd, "image_encoder.neck.3"),
        },
    }

    prompt_params = {
        "pe_gaussian": sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"],
        "point_embeddings": [
            sd[f"prompt_encoder.point_embeddings.{i}.weight"][0] for i in range(4)
        ],
        "not_a_point": sd["prompt_encoder.not_a_point_embed.weight"][0],
        "no_mask": sd["prompt_encoder.no_mask_embed.weight"][0],
        "mask_down": {
            "conv1": _conv(sd, "prompt_encoder.mask_downscaling.0"),
            "ln1": _ln(sd, "prompt_encoder.mask_downscaling.1"),
            "conv2": _conv(sd, "prompt_encoder.mask_downscaling.3"),
            "ln2": _ln(sd, "prompt_encoder.mask_downscaling.4"),
            "conv3": _conv(sd, "prompt_encoder.mask_downscaling.6"),
        },
    }

    tw_blocks = []
    for i in range(cfg.decoder.transformer.depth):
        pre = f"mask_decoder.transformer.layers.{i}"
        tw_blocks.append(
            {
                "self_attn": _attn(sd, pre + ".self_attn"),
                "norm1": _ln(sd, pre + ".norm1"),
                "cross_t2i": _attn(sd, pre + ".cross_attn_token_to_image"),
                "norm2": _ln(sd, pre + ".norm2"),
                "mlp": {
                    "lin1": _lin(sd, pre + ".mlp.lin1"),
                    "lin2": _lin(sd, pre + ".mlp.lin2"),
                },
                "norm3": _ln(sd, pre + ".norm3"),
                "cross_i2t": _attn(sd, pre + ".cross_attn_image_to_token"),
                "norm4": _ln(sd, pre + ".norm4"),
            }
        )

    nmt = cfg.decoder.num_mask_tokens
    decoder_params = {
        "iou_token": sd["mask_decoder.iou_token.weight"][0],
        "mask_tokens": sd["mask_decoder.mask_tokens.weight"],
        "transformer": {
            "blocks": tw_blocks,
            "final_attn": _attn(sd, "mask_decoder.transformer.final_attn_token_to_image"),
            "final_norm": _ln(sd, "mask_decoder.transformer.norm_final_attn"),
        },
        "upscale": {
            "convt1": _convt(sd, "mask_decoder.output_upscaling.0"),
            "ln1": _ln(sd, "mask_decoder.output_upscaling.1"),
            "convt2": _convt(sd, "mask_decoder.output_upscaling.3"),
        },
        "hyper_mlps": [
            {
                "layers": [
                    _lin(sd, f"mask_decoder.output_hypernetworks_mlps.{i}.layers.{j}")
                    for j in range(3)
                ]
            }
            for i in range(nmt)
        ],
        "iou_head": {
            "layers": [
                _lin(sd, f"mask_decoder.iou_prediction_head.layers.{j}")
                for j in range(cfg.decoder.iou_head_depth)
            ]
        },
    }

    return {
        "image_encoder": image_params,
        "prompt_encoder": prompt_params,
        "mask_decoder": decoder_params,
    }


def convert_checkpoint(path: str, variant: str = "vit_h"):
    """A torch .pth SAM checkpoint -> (SamConfig, params)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    cfg = sam_config_for(variant)
    return cfg, convert_state_dict(sd, cfg)


def export_reference_keys(cfg: SamConfig) -> list:
    """The torch state_dict keys this converter consumes (for coverage
    tests against a synthetic checkpoint)."""
    keys = [
        "image_encoder.patch_embed.proj.weight", "image_encoder.patch_embed.proj.bias",
        "image_encoder.pos_embed",
    ]
    for i in range(cfg.vit.depth):
        pre = f"image_encoder.blocks.{i}"
        keys += [f"{pre}.norm1.weight", f"{pre}.norm1.bias",
                 f"{pre}.attn.qkv.weight", f"{pre}.attn.qkv.bias",
                 f"{pre}.attn.proj.weight", f"{pre}.attn.proj.bias",
                 f"{pre}.norm2.weight", f"{pre}.norm2.bias",
                 f"{pre}.mlp.lin1.weight", f"{pre}.mlp.lin1.bias",
                 f"{pre}.mlp.lin2.weight", f"{pre}.mlp.lin2.bias"]
        if cfg.vit.use_rel_pos:
            keys += [f"{pre}.attn.rel_pos_h", f"{pre}.attn.rel_pos_w"]
    for j in range(4):
        keys += [f"image_encoder.neck.{j}.weight"]
        if j in (1, 3):
            keys += [f"image_encoder.neck.{j}.bias"]
    return keys
