"""Shared SAM building blocks (JAX: sanerf_tpu/models/sam/common.py).

Parameters are nested dicts of tensors with the JAX names and layouts:
linear weights [in, out], transposed-conv weights [c_in, k, k, c_out],
activations channels-last. Every product takes its inputs in the weight
dtype and returns float32 (JAX's `preferred_element_type=float32`): the
inputs are rounded to the weight dtype, then multiplied and summed in
float32, so bf16 weights give bf16 products with float32 accumulation.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def const_row(values, device) -> torch.Tensor:
    """A float32 vector of Python numbers made on `device` by fill kernels:
    `torch.tensor(values, device=cuda)` copies from pageable host memory
    and waits for the card, which would stall a pipelined frame."""
    return torch.stack([torch.full((), float(v), dtype=torch.float32,
                                   device=device) for v in values])


def _in_weight_dtype(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.to(w.dtype).float()


def uniform(g: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=g) * 2.0 - 1.0) * bound


def init_linear(g: torch.Generator, d_in: int, d_out: int,
                bias: bool = True) -> Params:
    """torch's default: U(-1/sqrt(d_in), 1/sqrt(d_in)) weights, zero bias."""
    p = {"w": uniform(g, (d_in, d_out), 1.0 / d_in ** 0.5)}
    if bias:
        p["b"] = torch.zeros(d_out)
    return p


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = _in_weight_dtype(x, p["w"]) @ p["w"].float()
    if "b" in p:
        y = y + p["b"]
    return y


def init_layer_norm(dim: int) -> Params:
    return {"w": torch.ones(dim), "b": torch.zeros(dim)}


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-6
               ) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    return p["w"] * (x - mu) * torch.rsqrt(var + eps) + p["b"]


def layer_norm_2d(p: Params, x: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    """Channels-last [..., H, W, C], normalized over C (SAM's LayerNorm2d)."""
    return layer_norm(p, x, eps)


def init_conv(g: torch.Generator, k: int, c_in: int, c_out: int,
              bias: bool = True) -> Params:
    """[k, k, c_in, c_out] (HWIO) weights."""
    p = {"w": uniform(g, (k, k, c_in, c_out), 1.0 / (c_in * k * k) ** 0.5)}
    if bias:
        p["b"] = torch.zeros(c_out)
    return p


def init_conv_transpose(g: torch.Generator, k: int, c_in: int, c_out: int,
                        bias: bool = True) -> Params:
    """[c_in, k, k, c_out] weights (torch's ConvTranspose2d holds
    [c_in, c_out, k, k])."""
    p = {"w": uniform(g, (c_in, k, k, c_out), 1.0 / (c_in * k * k) ** 0.5)}
    if bias:
        p["b"] = torch.zeros(c_out)
    return p


def conv2d_patches(p: Params, x: torch.Tensor) -> torch.Tensor:
    """VALID conv with stride == kernel (k) on [B, H, W, C] channels-last
    with HWIO weights (JAX common.conv2d(..., stride=k, padding="VALID")):
    the k x k patches do not overlap, so it is a per-patch product,
    out[i, j, o] = sum_{di, dj, c} x[k i + di, k j + dj, c] W[di, dj, c, o],
    in float32 from the input rounded to the weight dtype (no cuDNN, whose
    float32 convolutions run in TF32 by default)."""
    k = p["w"].shape[0]
    B, H, W, C = x.shape
    H2, W2 = H // k, W // k
    xp = _in_weight_dtype(x[:, :H2 * k, :W2 * k], p["w"]).reshape(
        B, H2, k, W2, k, C)
    y = torch.einsum("bhiwjc,ijco->bhwo", xp, p["w"].float())
    if "b" in p:
        y = y + p["b"]
    return y


def conv2d(p: Params, x: torch.Tensor, padding: str = "SAME"
           ) -> torch.Tensor:
    """Stride-1 conv on [B, H, W, C] channels-last with HWIO weights (JAX
    common.conv2d, "VALID" or "SAME" zero padding): one product per kernel
    tap over the shifted input, in float32 from the input rounded to the
    weight dtype (no cuDNN, whose float32 convolutions run in TF32 by
    default)."""
    k = p["w"].shape[0]
    xin = _in_weight_dtype(x, p["w"])
    if padding == "SAME":
        lo = (k - 1) // 2
        xin = F.pad(xin, (0, 0, lo, k - 1 - lo, lo, k - 1 - lo))
    H2, W2 = xin.shape[1] - k + 1, xin.shape[2] - k + 1
    w = p["w"].float()
    y = None
    for i in range(k):
        for j in range(k):
            t = xin[:, i:i + H2, j:j + W2] @ w[i, j]
            y = t if y is None else y + t
    if "b" in p:
        y = y + p["b"]
    return y


def conv_transpose2d(p: Params, x: torch.Tensor, stride: int = 2
                     ) -> torch.Tensor:
    """Transposed conv with kernel == stride on [B, H, W, C]: no output
    overlap, so it is a per-pixel product and a pixel shuffle,
    out[k i + di, k j + dj, o] = sum_c x[i, j, c] W[c, di, dj, o]."""
    B, H, W, _ = x.shape
    k = p["w"].shape[1]
    y = torch.einsum("bhwc,cklo->bhkwlo", _in_weight_dtype(x, p["w"]),
                     p["w"].float())
    y = y.reshape(B, H * k, W * k, p["w"].shape[-1])
    if "b" in p:
        y = y + p["b"]
    return y


def init_mlp_block(g: torch.Generator, dim: int, hidden: int) -> Params:
    return {"lin1": init_linear(g, dim, hidden),
            "lin2": init_linear(g, hidden, dim)}


def mlp_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    """lin2(GELU(lin1(x))), exact GELU."""
    return linear(p["lin2"], F.gelu(linear(p["lin1"], x)))


def init_mlp(g: torch.Generator, d_in: int, d_hidden: int, d_out: int,
             n_layers: int) -> Params:
    dims = [d_in] + [d_hidden] * (n_layers - 1) + [d_out]
    return {"layers": [init_linear(g, dims[i], dims[i + 1])
                       for i in range(n_layers)]}


def mlp(p: Params, x: torch.Tensor, sigmoid_output: bool = False
        ) -> torch.Tensor:
    """SAM's small MLP head, ReLU between layers."""
    n = len(p["layers"])
    for i, lp in enumerate(p["layers"]):
        x = linear(lp, x)
        if i < n - 1:
            x = torch.relu(x)
    if sigmoid_output:
        x = torch.sigmoid(x)
    return x
