"""Rendering regularizers and the stage-3 mask losses (JAX:
sanerf_tpu/ops/losses.py).

- `distort_loss`: mip-NeRF 360's distortion, by the O(T) exclusive-prefix
  identity;
- `proposal_loss`: the histogram bound loss of every proposal level against
  the final level, whose bins and weights are detached;
- `entropy_loss`: the binary entropy of per-ray opacity.
- `label_regularization`: depth-weighted smoothness of mask
  probabilities over square patches;
- `rgb_similarity_loss`: within-patch mask agreement of pixels whose
  colour is close to sampled anchors; the anchors' Gumbel noise comes in
  as a tensor (`gumbel`), as the JAX function draws it from its key.
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


def label_regularization(depth: torch.Tensor, pred_masks: torch.Tensor,
                         patch_size: int, n_inst: int) -> torch.Tensor:
    """Depth-weighted spatial smoothness of mask probabilities (JAX
    losses.py:85-126): depth [B*P*P] and pred_masks [..., n_inst] over
    the same pixels, cut into B patches of P x P; neighbour differences
    weighted by exp(-(depth difference)^2), normalised by the weights.
    0 when patch_size < 2 (no neighbours in a patch)."""
    pm = pred_masks.reshape(-1, patch_size, patch_size, n_inst)
    pm = pm.permute(0, 3, 1, 2)
    diff_x = pm[:, :, :, 1:] - pm[:, :, :, :-1]
    diff_y = pm[:, :, 1:, :] - pm[:, :, :-1, :]
    d = depth.reshape(-1, patch_size, patch_size)
    ddx = d[:, :, 1:] - d[:, :, :-1]
    ddy = d[:, 1:, :] - d[:, :-1, :]
    wx = torch.exp(-(ddx * ddx))[:, None].expand_as(diff_x)
    wy = torch.exp(-(ddy * ddy))[:, None].expand_as(diff_y)
    nx, dx_ = (diff_x * diff_x * wx).sum(), wx.sum()
    ny, dy_ = (diff_y * diff_y * wy).sum(), wy.sum()
    return (nx / torch.clamp(dx_, min=1e-12)
            + ny / torch.clamp(dy_, min=1e-12))


def rgb_similarity_loss(gumbel: torch.Tensor, rgb: torch.Tensor,
                        inst_masks: torch.Tensor, incoherent: torch.Tensor,
                        *, threshold: float = 0.3, exp_weight: float = 10.0,
                        epsilon: float = 1e-6, num_sample: int = 1,
                        redundant_instance: int = 0,
                        use_pred_logistics: bool = False) -> torch.Tensor:
    """Within-patch mask agreement of RGB-similar pixels (JAX
    losses.py:129-188). rgb [S, P, 3], inst_masks [S, P, I] softmax
    probabilities, incoherent [S, P] in [0, 1], gumbel [S, P] standard
    Gumbel noise. Per patch `num_sample` anchors are drawn without
    replacement from the coherent pixels (1 - incoherent > 0.8; all pixels
    where none is) by the Gumbel top-k; every pixel within `threshold` of
    an anchor's colour is penalised by exp(-exp_weight cos - epsilon), cos
    the cosine of its mask and the anchor's (one-hot argmax unless
    use_pred_logistics); with redundant_instance > 0 a BCE of that
    penalty against colour dissimilarity."""
    weights = ((1.0 - incoherent.float()) > 0.8).float()
    invalid = weights.sum(dim=-1) == 0
    weights = torch.where(invalid[:, None], torch.ones_like(weights), weights)
    scores = torch.where(weights > 0, gumbel,
                         torch.full_like(gumbel, -float("inf")))
    sample_index = torch.topk(scores, num_sample, dim=1).indices  # [S, K]

    def take(a):
        idx = sample_index[..., None].expand(-1, -1, a.shape[-1])
        return torch.gather(a, 1, idx)

    rgb_sample = take(rgb)[:, :, None, :]
    sample_mask = take(inst_masks).detach()[:, :, None, :]
    if not use_pred_logistics:
        sample_mask = torch.nn.functional.one_hot(
            sample_mask.argmax(dim=-1), inst_masks.shape[-1]).to(
                inst_masks.dtype)
    rgb_b = rgb[:, None]
    masks_b = inst_masks[:, None]
    similar = torch.linalg.norm(rgb_b - rgb_sample, dim=-1) < threshold
    num = (masks_b * sample_mask).sum(dim=-1)
    den = (torch.linalg.norm(masks_b, dim=-1)
           * torch.linalg.norm(sample_mask, dim=-1))
    cos_sim = num / torch.clamp(den, min=1e-8)
    penalty = torch.exp(-exp_weight * cos_sim - epsilon)
    if redundant_instance > 0:
        labels = 1.0 - similar.float()
        p = torch.clamp(penalty, epsilon, 1.0 - epsilon)
        return (-(labels * torch.log(p)
                  + (1.0 - labels) * torch.log(1.0 - p))).mean()
    num = (similar * penalty).sum(dim=-1)
    den = torch.clamp(similar.sum(dim=-1), min=1)
    return (num / den).mean()
