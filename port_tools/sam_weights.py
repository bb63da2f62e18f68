"""A seeded SAM state dict in the official key layout (the keys and shapes
of `sam_vit_h_4b8939.pth` for `sam_config_for("vit_h")`), for driving the
port's stage 2 without the downloaded checkpoint:

    sd = seeded_state_dict(sam_config_for("vit_h"), seed=0)
    torch.save(sd, "build/sam_vit_h_seeded.pth")   # float32, ~2.5 GB

Linear and conv weights U(+-1/sqrt(fan_in)) (torch's default), biases 0,
norms 1 / 0, the positional and relative-position tables 0 (as the JAX
package's `image_encoder.init_params`), the prompt embeddings and tokens
N(0, 1). Drawn on the CPU from a torch.Generator. Called by
chip_smoke.py's `cli` phase and tests/test_torch_sam_encoder.py.
"""

from __future__ import annotations

from typing import Dict

import torch


def seeded_state_dict(cfg, seed: int = 0) -> Dict[str, torch.Tensor]:
    g = torch.Generator().manual_seed(seed)
    sd: Dict[str, torch.Tensor] = {}

    def uni(shape, fan_in):
        b = fan_in ** -0.5
        return torch.empty(shape).uniform_(-b, b, generator=g)

    def lin(pre, i, o, bias=True):
        sd[pre + ".weight"] = uni((o, i), i)
        if bias:
            sd[pre + ".bias"] = torch.zeros(o)

    def conv(pre, i, o, k, bias=True):
        sd[pre + ".weight"] = uni((o, i, k, k), i * k * k)
        if bias:
            sd[pre + ".bias"] = torch.zeros(o)

    def ln(pre, n):
        sd[pre + ".weight"] = torch.ones(n)
        sd[pre + ".bias"] = torch.zeros(n)

    def randn(*shape):
        return torch.randn(shape, generator=g)

    vit = cfg.vit
    ed, hd = vit.embed_dim, vit.embed_dim // vit.num_heads
    conv("image_encoder.patch_embed.proj", vit.in_chans, ed, vit.patch_size)
    sd["image_encoder.pos_embed"] = torch.zeros(1, vit.grid, vit.grid, ed)
    for i in range(vit.depth):
        pre = f"image_encoder.blocks.{i}"
        ln(pre + ".norm1", ed)
        lin(pre + ".attn.qkv", ed, 3 * ed)
        lin(pre + ".attn.proj", ed, ed)
        if vit.use_rel_pos:
            size = (vit.grid if i in vit.global_attn_indexes
                    else vit.window_size)
            sd[pre + ".attn.rel_pos_h"] = torch.zeros(2 * size - 1, hd)
            sd[pre + ".attn.rel_pos_w"] = torch.zeros(2 * size - 1, hd)
        ln(pre + ".norm2", ed)
        lin(pre + ".mlp.lin1", ed, int(ed * vit.mlp_ratio))
        lin(pre + ".mlp.lin2", int(ed * vit.mlp_ratio), ed)
    conv("image_encoder.neck.0", ed, vit.out_chans, 1, bias=False)
    ln("image_encoder.neck.1", vit.out_chans)
    conv("image_encoder.neck.2", vit.out_chans, vit.out_chans, 3, bias=False)
    ln("image_encoder.neck.3", vit.out_chans)

    pc = cfg.prompt
    pd, mc = pc.embed_dim, pc.mask_in_chans
    sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = \
        randn(2, pd // 2)
    for i in range(4):
        sd[f"prompt_encoder.point_embeddings.{i}.weight"] = randn(1, pd)
    sd["prompt_encoder.not_a_point_embed.weight"] = randn(1, pd)
    sd["prompt_encoder.no_mask_embed.weight"] = randn(1, pd)
    conv("prompt_encoder.mask_downscaling.0", 1, mc // 4, 2)
    ln("prompt_encoder.mask_downscaling.1", mc // 4)
    conv("prompt_encoder.mask_downscaling.3", mc // 4, mc, 2)
    ln("prompt_encoder.mask_downscaling.4", mc)
    conv("prompt_encoder.mask_downscaling.6", mc, pd, 1)

    dc = cfg.decoder
    tc = dc.transformer
    d, nmt = dc.embed_dim, dc.num_mask_tokens
    sd["mask_decoder.iou_token.weight"] = randn(1, d)
    sd["mask_decoder.mask_tokens.weight"] = randn(nmt, d)
    dd = d // tc.attn_downsample
    for i in range(tc.depth):
        pre = f"mask_decoder.transformer.layers.{i}"
        for a, idim in (("self_attn", d), ("cross_attn_token_to_image", dd),
                        ("cross_attn_image_to_token", dd)):
            for proj in ("q_proj", "k_proj", "v_proj"):
                lin(f"{pre}.{a}.{proj}", d, idim)
            lin(f"{pre}.{a}.out_proj", idim, d)
        for n in ("norm1", "norm2", "norm3", "norm4"):
            ln(f"{pre}.{n}", d)
        lin(f"{pre}.mlp.lin1", d, tc.mlp_dim)
        lin(f"{pre}.mlp.lin2", tc.mlp_dim, d)
    pre = "mask_decoder.transformer.final_attn_token_to_image"
    for proj in ("q_proj", "k_proj", "v_proj"):
        lin(f"{pre}.{proj}", d, dd)
    lin(f"{pre}.out_proj", dd, d)
    ln("mask_decoder.transformer.norm_final_attn", d)
    # ConvTranspose2d weights are [in, out, k, k]
    sd["mask_decoder.output_upscaling.0.weight"] = uni((d, d // 4, 2, 2), d)
    sd["mask_decoder.output_upscaling.0.bias"] = torch.zeros(d // 4)
    ln("mask_decoder.output_upscaling.1", d // 4)
    sd["mask_decoder.output_upscaling.3.weight"] = uni(
        (d // 4, d // 8, 2, 2), d // 4)
    sd["mask_decoder.output_upscaling.3.bias"] = torch.zeros(d // 8)
    for i in range(nmt):
        dims = [d, d, d, d // 8]
        for j in range(3):
            lin(f"mask_decoder.output_hypernetworks_mlps.{i}.layers.{j}",
                dims[j], dims[j + 1])
    dims = ([d] + [dc.iou_head_hidden] * (dc.iou_head_depth - 1) + [nmt])
    for j in range(dc.iou_head_depth):
        lin(f"mask_decoder.iou_prediction_head.layers.{j}", dims[j],
            dims[j + 1])
    return sd
