"""Ray sampling math (JAX: sanerf_tpu/ops/sampling.py:23-172): AABB
intersection, contraction, spacing functions, the bisection and dense take
of the proposal loss, inverse-CDF resampling.

Random draws enter as tensors: a caller that perturbs passes uniform [0, 1)
draws (`jitter`), which is how the tests feed both frameworks the same
numbers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def contract(x: torch.Tensor) -> torch.Tensor:
    """mip-NeRF-360 L-inf contraction of [..., 3] points. The dominant
    coordinate is the FIRST maximum (x over y over z), as jnp.argmax. The
    tie-break is spelled out: the index that `max(dim)` returns for a tie
    is not specified on every device, and a tie (|x| == |y| on an image
    diagonal) is common. It is written as comparisons: PyTorch's CUDA scan
    along an innermost axis of 3 took 377 ms for the 58.7 M points of a
    512^2 frame at (128, 64, 32) on an H100 80GB HBM3 at 700 W
    (port_tools/hashgrid_breakdown.py)."""
    ax = x.abs()
    mag = ax.amax(dim=-1, keepdim=True)
    e0, e1, e2 = (ax == mag).unbind(dim=-1)
    first = torch.stack([e0, e1 & ~e0, e2 & ~(e0 | e1)], dim=-1)
    safe = torch.clamp(mag, min=1e-12)
    scale = torch.where(first, (2.0 - 1.0 / safe) / safe, 1.0 / safe)
    return torch.where(mag < 1.0, x, x * scale)


def near_far_from_aabb(rays_o: torch.Tensor, rays_d: torch.Tensor,
                       aabb: torch.Tensor, min_near: float = 0.05
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab test -> (near, far) [N, 1]; rays that miss get 1e9."""
    tmin = (aabb[:3] - rays_o) / (rays_d + 1e-15)
    tmax = (aabb[3:] - rays_o) / (rays_d + 1e-15)
    near = torch.minimum(tmin, tmax).max(dim=-1, keepdim=True).values
    far = torch.maximum(tmin, tmax).min(dim=-1, keepdim=True).values
    miss = far < near
    near = torch.where(miss, torch.full_like(near, 1e9), near)
    far = torch.where(miss, torch.full_like(far, 1e9), far)
    return torch.clamp(near, min=min_near), far


def spacing_fn(x: torch.Tensor) -> torch.Tensor:
    """Mixed linear + lindisp warp."""
    return torch.where(x < 1.0, x / 2.0,
                       1.0 - 1.0 / (2.0 * torch.clamp(x, min=1e-12)))


def spacing_fn_inv(x: torch.Tensor) -> torch.Tensor:
    """Inverse of spacing_fn."""
    return torch.where(x < 0.5, 2.0 * x,
                       1.0 / torch.clamp(2.0 - 2.0 * x, min=1e-12))


def searchsorted_right(sorted_seq: torch.Tensor,
                       values: torch.Tensor) -> torch.Tensor:
    """Batched right bisection: how many of sorted_seq[..., :] are <=
    values[..., t]. sorted_seq [..., K], values [..., T] -> int32 [..., T],
    as the JAX broadcast compare-and-sum."""
    cmp = sorted_seq[..., None, :] <= values[..., :, None]
    return cmp.sum(dim=-1, dtype=torch.int32)


def take_by_index_dense(values: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """values [..., K] taken at idx [..., T] -> [..., T], as the JAX one-hot
    contraction (its gradient reaches every selected value)."""
    K = values.shape[-1]
    onehot = (idx[..., :, None] == torch.arange(
        K, device=values.device)).to(values.dtype)
    return (onehot * values[..., None, :]).sum(dim=-1)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, T: int,
               jitter: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF resampling of bin edges.

    bins [N, T0+1], weights [N, T0] -> [N, T] new edges. `jitter` is an
    optional [N, T] uniform draw; u moves by (jitter - 0.5) / T. The inverse
    CDF is the affine-clamp sum F^-1(u) = b0 + sum_k db_k clamp((u - c_k) /
    dc_k, 0, 1), with pdf = (w + 0.01) / sum."""
    N, T0 = weights.shape
    w = weights + 0.01
    pdf = w / w.sum(dim=-1, keepdim=True)
    cdf = torch.clamp(torch.cumsum(pdf, dim=-1), max=1.0)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    u = torch.linspace(0.5 / T, 1.0 - 0.5 / T, T, dtype=torch.float32,
                       device=weights.device).expand(N, T)
    if jitter is not None:
        u = u + (jitter - 0.5) / T
    c_lo = cdf[:, :-1]
    recip = 1.0 / torch.clamp(cdf[:, 1:] - c_lo, min=1e-12)
    db = bins[:, 1:] - bins[:, :-1]
    frac = torch.clamp((u[:, :, None] - c_lo[:, None, :]) * recip[:, None, :],
                       0.0, 1.0)
    return bins[:, 0:1] + (frac * db[:, None, :]).sum(dim=-1)


def uniform_bins(N: int, T: int, jitter: Optional[torch.Tensor] = None,
                 device=None) -> torch.Tensor:
    """Uniform [0, 1] edges [N, T+1]; `jitter` ([N, T+1] uniform draws)
    moves each edge by (jitter - 0.5) / T, clipped back into [0, 1]."""
    bins = torch.linspace(0.0, 1.0, T + 1, dtype=torch.float32,
                          device=device).expand(N, T + 1)
    if jitter is not None:
        bins = torch.clamp(bins + (jitter - 0.5) / T, 0.0, 1.0)
    return bins
