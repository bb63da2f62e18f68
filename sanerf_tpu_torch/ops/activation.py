"""Density activations of the two field families
(JAX: sanerf_tpu/ops/activation.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """softplus(x - 1) in float32 (mip-NeRF 360's density parametrization;
    JAX: sanerf_tpu/ops/activation.py:shifted_softplus)."""
    return F.softplus(x.float() - 1.0)


class _TruncExp(torch.autograd.Function):
    """exp(clamp(x, -15, 15)) whose gradient is g * exp(clamp(x, -15, 15))
    everywhere: past +-15 the clamp's own gradient would be 0, the
    reference's is not (JAX: ops/activation.py:30-46)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.exp(torch.clamp(x.float(), -15.0, 15.0))
        ctx.save_for_backward(y)
        ctx.in_dtype = x.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return (g * y).to(ctx.in_dtype)


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp of the input clamped to [-15, 15], in float32: the hash-grid
    family's density activation, with the reference's backward
    g * exp(clamp(x, -15, 15))."""
    return _TruncExp.apply(x)
