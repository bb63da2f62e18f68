"""SAM's ViT image encoder (JAX: sanerf_tpu/models/sam/image_encoder.py):
a [B, 1024, 1024, 3] normalized image -> [B, 64, 64, 256] feature map,
channels-last. The frozen teacher of stage 2.

- patch embedding (16 x 16 conv, stride 16) plus the absolute positional
  embedding;
- `depth` blocks: windowed attention (window 14, zero-padded) except at
  `global_attn_indexes`, with the decomposed relative-position bias on
  the H and W axes; an exact-GELU MLP of ratio 4;
- the neck: 1 x 1 conv, LayerNorm2d, 3 x 3 conv, LayerNorm2d.

Parameters are the JAX tree (linear weights [in, out], convs HWIO). As in
the JAX module, every linear and conv rounds its input to the weight dtype
and multiplies in float32 (common.py), and the attention products, the
softmax and the relative-position terms run in float32; the teacher's bf16
weights (apps/main.py) therefore give bf16 products with float32 sums.
The products are torch.matmul / einsum: the JAX encoder runs no Pallas
kernel, so the port has none to write here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from sanerf_tpu_torch.models.sam import common
from sanerf_tpu_torch.models.sam.common import Params


@dataclass(frozen=True)
class ViTConfig:
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


VIT_H = ViTConfig()
VIT_L = ViTConfig(embed_dim=1024, depth=24, num_heads=16,
                  global_attn_indexes=(5, 11, 17, 23))
VIT_B = ViTConfig(embed_dim=768, depth=12, num_heads=12,
                  global_attn_indexes=(2, 5, 8, 11))

# SAM's image normalization
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


def init_params(cfg: ViTConfig, g: torch.Generator) -> Params:
    """Random encoder weights (torch's default uniform linears and convs,
    zero biases, zero positional and relative-position tables, unit
    norms), float32 on the CPU."""
    hd = cfg.embed_dim // cfg.num_heads
    D = cfg.embed_dim

    def block(i):
        p = {"norm1": common.init_layer_norm(D),
             "qkv": common.init_linear(g, D, 3 * D),
             "proj": common.init_linear(g, D, D),
             "norm2": common.init_layer_norm(D),
             "mlp": common.init_mlp_block(g, D, int(D * cfg.mlp_ratio))}
        if cfg.use_rel_pos:
            size = (cfg.grid if i in cfg.global_attn_indexes
                    else cfg.window_size)
            p["rel_pos_h"] = torch.zeros(2 * size - 1, hd)
            p["rel_pos_w"] = torch.zeros(2 * size - 1, hd)
        return p

    return {
        "patch_embed": common.init_conv(g, cfg.patch_size, cfg.in_chans, D),
        "pos_embed": torch.zeros(1, cfg.grid, cfg.grid, D),
        "blocks": [block(i) for i in range(cfg.depth)],
        "neck": {
            "conv1": common.init_conv(g, 1, D, cfg.out_chans, bias=False),
            "ln1": common.init_layer_norm(cfg.out_chans),
            "conv2": common.init_conv(g, 3, cfg.out_chans, cfg.out_chans,
                                      bias=False),
            "ln2": common.init_layer_norm(cfg.out_chans)},
    }


def window_partition(x: torch.Tensor, window: int):
    """[B, H, W, C] -> ([B * nW, win, win, C] zero-padded, (Hp, Wp))."""
    B, H, W, C = x.shape
    pad_h, pad_w = (window - H % window) % window, (window - W % window) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // window, window, Wp // window, window, C)
    return (x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, C),
            (Hp, Wp))


def window_unpartition(x: torch.Tensor, window: int,
                       padded: Tuple[int, int], orig: Tuple[int, int]):
    Hp, Wp = padded
    H, W = orig
    B = x.shape[0] // ((Hp // window) * (Wp // window))
    x = x.reshape(B, Hp // window, Wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor
                ) -> torch.Tensor:
    """The relative-position embeddings of a (q, k) size pair, linearly
    resized (half-pixel centres, clamped) when the table's length is not
    2 max(q, k) - 1 (SAM's get_rel_pos)."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    dev = rel_pos.device
    if rel_pos.shape[0] != max_rel_dist:
        L_in = rel_pos.shape[0]
        src = ((torch.arange(max_rel_dist, dtype=torch.float32, device=dev)
                + 0.5) * (L_in / max_rel_dist) - 0.5).clamp(0.0, L_in - 1)
        lo = torch.floor(src).long()
        hi = torch.clamp(lo + 1, max=L_in - 1)
        frac = (src - lo)[:, None]
        rel_pos = rel_pos[lo] * (1.0 - frac) + rel_pos[hi] * frac
    q_coords = (torch.arange(q_size, dtype=torch.float32, device=dev)[:, None]
                * max(k_size / q_size, 1.0))
    k_coords = (torch.arange(k_size, dtype=torch.float32, device=dev)[None]
                * max(q_size / k_size, 1.0))
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


def attention(p: Params, x: torch.Tensor, num_heads: int,
              use_rel_pos: bool) -> torch.Tensor:
    """Multi-head self-attention over a [B, H, W, C] token grid with the
    decomposed relative-position bias."""
    B, H, W, C = x.shape
    hd = C // num_heads
    qkv = common.linear(p["qkv"], x.reshape(B, H * W, C))
    qkv = qkv.reshape(B, H * W, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # [B, heads, HW, hd]
    attn = torch.einsum("bhqd,bhkd->bhqk", q * hd ** -0.5, k)
    if use_rel_pos:
        Rh = get_rel_pos(H, H, p["rel_pos_h"]).float()
        Rw = get_rel_pos(W, W, p["rel_pos_w"]).float()
        q_grid = q.reshape(B, num_heads, H, W, hd)
        rel_h = torch.einsum("bnhwc,hkc->bnhwk", q_grid, Rh)
        rel_w = torch.einsum("bnhwc,wkc->bnhwk", q_grid, Rw)
        attn = (attn.reshape(B, num_heads, H, W, H, W)
                + rel_h[..., :, None] + rel_w[..., None, :])
        attn = attn.reshape(B, num_heads, H * W, H * W)
    attn = torch.softmax(attn, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", attn, v)
    out = out.permute(0, 2, 1, 3).reshape(B, H, W, C)
    return common.linear(p["proj"], out)


def encode(cfg: ViTConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """[B, img, img, 3] normalized -> [B, grid, grid, out_chans] float32."""
    x = common.conv2d_patches(params["patch_embed"], x) + params["pos_embed"]
    for i, bp in enumerate(params["blocks"]):
        shortcut = x
        h = common.layer_norm(bp["norm1"], x)
        if i not in cfg.global_attn_indexes and cfg.window_size > 0:
            h, padded = window_partition(h, cfg.window_size)
            h = attention(bp, h, cfg.num_heads, cfg.use_rel_pos)
            h = window_unpartition(h, cfg.window_size, padded,
                                   (x.shape[1], x.shape[2]))
        else:
            h = attention(bp, h, cfg.num_heads, cfg.use_rel_pos)
        x = shortcut + h
        x = x + common.mlp_block(bp["mlp"], common.layer_norm(bp["norm2"], x))
    n = params["neck"]
    x = common.layer_norm_2d(n["ln1"], common.conv2d(n["conv1"], x, "VALID"))
    x = common.layer_norm_2d(n["ln2"], common.conv2d(n["conv2"], x, "SAME"))
    return x


def preprocess(img: torch.Tensor, img_size: int = 1024) -> torch.Tensor:
    """A [h, w, 3] uint8 / float image -> [1, img_size, img_size, 3]:
    normalized by SAM's mean and std, zero-padded at the bottom and right."""
    mean = common.const_row(PIXEL_MEAN, img.device)
    std = common.const_row(PIXEL_STD, img.device)
    x = (img.float() - mean) / std
    h, w = x.shape[:2]
    return F.pad(x, (0, 0, 0, img_size - w, 0, img_size - h))[None]

