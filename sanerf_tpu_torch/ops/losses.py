"""Stage-1 rendering regularizers (JAX: sanerf_tpu/ops/losses.py:22-83).

- `distort_loss`: mip-NeRF 360's distortion, by the O(T) exclusive-prefix
  identity;
- `proposal_loss`: the histogram bound loss of every proposal level against
  the final level, whose bins and weights are detached;
- `entropy_loss`: the binary entropy of per-ray opacity.
The stage-3 mask losses (`label_regularization`, `rgb_similarity_loss`)
come with that stage.
"""

from __future__ import annotations

from typing import Sequence

import torch

from sanerf_tpu_torch.ops.sampling import (searchsorted_right,
                                           take_by_index_dense)


def distort_loss(bins: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """mean_n [sum_ij w_i w_j |m_i - m_j| + 1/3 sum_i w_i^2 d_i] over bins
    [N, T+1] (s-space edges) and weights [N, T]; the pairwise term is
    2 sum_i w_i (m_i W_<i - (wm)_<i)."""
    intervals = bins[..., 1:] - bins[..., :-1]
    mids = bins[..., :-1] + intervals / 2.0
    wm = weights * mids
    w_cum = torch.cumsum(weights, dim=-1) - weights
    wm_cum = torch.cumsum(wm, dim=-1) - wm
    loss_bi = 2.0 * (weights * (mids * w_cum - wm_cum)).sum(dim=-1)
    loss_uni = (1.0 / 3.0) * (weights * weights * intervals).sum(dim=-1)
    return (loss_bi + loss_uni).mean()


def _loss_interlevel(t0: torch.Tensor, w0: torch.Tensor, t1: torch.Tensor,
                     w1: torch.Tensor) -> torch.Tensor:
    """Bound loss of one proposal level (t1 [N, T1+1], w1 [N, T1]) against
    the final level (t0, w0), per sample [N, T0]."""
    cw1 = torch.cat([torch.zeros_like(w1[..., :1]),
                     torch.cumsum(w1, dim=-1)], dim=-1)
    T1 = w1.shape[-1]
    lo = torch.clamp(searchsorted_right(t1[..., :-1], t0[..., :-1]) - 1,
                     0, T1 - 1)
    hi = torch.clamp(searchsorted_right(t1[..., 1:], t0[..., 1:]), 0, T1 - 1)
    w = (take_by_index_dense(cw1[..., 1:], hi)
         - take_by_index_dense(cw1[..., :-1], lo))
    return torch.clamp(w0 - w, min=0.0) ** 2 / (w0 + 1e-8)


def proposal_loss(all_bins: Sequence[torch.Tensor],
                  all_weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum over the proposal levels of the mean interlevel loss against
    the final level, whose histogram is detached."""
    bins_ref = all_bins[-1].detach()
    weights_ref = all_weights[-1].detach()
    loss = 0.0
    for bins, weights in zip(all_bins[:-1], all_weights[:-1]):
        loss = loss + _loss_interlevel(bins_ref, weights_ref, bins,
                                       weights).mean()
    return loss


def entropy_loss(weights_sum: torch.Tensor) -> torch.Tensor:
    """Mean binary entropy (bits) of the per-ray opacity."""
    w = torch.clamp(weights_sum, 1e-5, 1.0 - 1e-5)
    return (-w * torch.log2(w) - (1.0 - w) * torch.log2(1.0 - w)).mean()
