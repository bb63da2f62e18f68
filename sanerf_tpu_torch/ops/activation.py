"""Density activations of the two field families
(JAX: sanerf_tpu/ops/activation.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """softplus(x - 1) in float32 (mip-NeRF 360's density parametrization;
    JAX: sanerf_tpu/ops/activation.py:shifted_softplus)."""
    return F.softplus(x.float() - 1.0)


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp of the input clamped to [-15, 15], in float32: the hash-grid
    family's density activation (JAX: ops/activation.py:30-46). Forward
    only; the clamped-gradient backward comes with training."""
    return torch.exp(torch.clamp(x.float(), -15.0, 15.0))
