"""SAM's two-way transformer, prompt tokens <-> image embedding
(JAX: sanerf_tpu/models/sam/transformer.py).

`depth` blocks of [token self-attention, token->image cross-attention,
token MLP, image->token cross-attention], each followed by a LayerNorm,
then a final token->image attention. Cross-attention works at
embedding_dim / attn_downsample. Attention is written out (products and an
explicit softmax in float32), as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from sanerf_tpu_torch.models.sam import common
from sanerf_tpu_torch.models.sam.common import Params


@dataclass(frozen=True)
class TwoWayConfig:
    depth: int = 2
    embedding_dim: int = 256
    num_heads: int = 8
    mlp_dim: int = 2048
    attn_downsample: int = 2


def init_attn(g: torch.Generator, dim: int, internal_dim: int) -> Params:
    return {"q": common.init_linear(g, dim, internal_dim),
            "k": common.init_linear(g, dim, internal_dim),
            "v": common.init_linear(g, dim, internal_dim),
            "out": common.init_linear(g, internal_dim, dim)}


def attn(p: Params, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         num_heads: int) -> torch.Tensor:
    """Multi-head attention over token sequences [B, N, C]."""
    q = common.linear(p["q"], q)
    k = common.linear(p["k"], k)
    v = common.linear(p["v"], v)
    B, Nq, C = q.shape
    Nk = k.shape[1]
    hd = C // num_heads
    q = q.reshape(B, Nq, num_heads, hd).transpose(1, 2)
    k = k.reshape(B, Nk, num_heads, hd).transpose(1, 2)
    v = v.reshape(B, Nk, num_heads, hd).transpose(1, 2)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / hd ** 0.5
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", w, v)
    out = out.transpose(1, 2).reshape(B, Nq, C)
    return common.linear(p["out"], out)


def init_block(cfg: TwoWayConfig, g: torch.Generator) -> Params:
    d, dd = cfg.embedding_dim, cfg.embedding_dim // cfg.attn_downsample
    return {
        "self_attn": init_attn(g, d, d),
        "norm1": common.init_layer_norm(d),
        "cross_t2i": init_attn(g, d, dd),
        "norm2": common.init_layer_norm(d),
        "mlp": common.init_mlp_block(g, d, cfg.mlp_dim),
        "norm3": common.init_layer_norm(d),
        "cross_i2t": init_attn(g, d, dd),
        "norm4": common.init_layer_norm(d),
    }


def init_params(cfg: TwoWayConfig, g: torch.Generator) -> Params:
    return {
        "blocks": [init_block(cfg, g) for _ in range(cfg.depth)],
        "final_attn": init_attn(g, cfg.embedding_dim,
                                cfg.embedding_dim // cfg.attn_downsample),
        "final_norm": common.init_layer_norm(cfg.embedding_dim),
    }


def apply(cfg: TwoWayConfig, params: Params, image_embedding: torch.Tensor,
          image_pe: torch.Tensor, point_embedding: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """image_embedding, image_pe [B, HW, C]; point_embedding [B, Nt, C]
    -> (tokens [B, Nt, C], image features [B, HW, C])."""
    queries = point_embedding
    keys = image_embedding
    ln = common.layer_norm
    for i, bp in enumerate(params["blocks"]):
        # token self-attention (the first block attends the raw embeddings)
        if i == 0:
            queries = queries + attn(bp["self_attn"], queries, queries,
                                     queries, cfg.num_heads)
        else:
            q = queries + point_embedding
            queries = queries + attn(bp["self_attn"], q, q, queries,
                                     cfg.num_heads)
        queries = ln(bp["norm1"], queries)
        # tokens -> image
        q = queries + point_embedding
        k = keys + image_pe
        queries = queries + attn(bp["cross_t2i"], q, k, keys, cfg.num_heads)
        queries = ln(bp["norm2"], queries)
        # token MLP
        queries = ln(bp["norm3"], queries + common.mlp_block(bp["mlp"],
                                                             queries))
        # image -> tokens
        q = queries + point_embedding
        k = keys + image_pe
        keys = keys + attn(bp["cross_i2t"], k, q, queries, cfg.num_heads)
        keys = ln(bp["norm4"], keys)
    q = queries + point_embedding
    k = keys + image_pe
    queries = queries + attn(params["final_attn"], q, k, keys, cfg.num_heads)
    queries = ln(params["final_norm"], queries)
    return queries, keys
