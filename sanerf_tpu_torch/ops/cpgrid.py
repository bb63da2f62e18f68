"""CP-factorized line features and their training side (JAX:
sanerf_tpu/ops/cpgrid.py: line_features_gather, level_resolutions,
line_features_multi, anneal_level_weights, linresize,
grad_total_variation).

    feat_k(x, y, z) = Lx[u(x), k] * Ly[u(y), k] * Lz[u(z), k]

with linear interpolation along each line: u = (x / bound / 2 + 1/2) (R - 1)
clipped to [0, R - 1], i0 = floor(u), i1 = min(i0 + 1, R - 1). A ladder
splits the rank over a coarse-to-fine list of levels, each its own table.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def line_features(lines: torch.Tensor, x: torch.Tensor,
                  bound: float) -> torch.Tensor:
    """lines [3, R, K], x [N, 3] in [-bound, bound] -> [N, K] float32."""
    R = lines.shape[1]
    u = torch.clamp((x.float() / bound * 0.5 + 0.5) * (R - 1), 0.0, R - 1)
    fl = torch.floor(u)
    f = u - fl
    i0 = fl.long()
    i1 = torch.clamp(i0 + 1, max=R - 1)
    feat = None
    for a in range(3):
        v0 = lines[a].float()[i0[:, a]]
        v1 = lines[a].float()[i1[:, a]]
        fa = v0 * (1.0 - f[:, a:a + 1]) + v1 * f[:, a:a + 1]
        feat = fa if feat is None else feat * fa
    return feat


def level_resolutions(res: int, levels: int, min_res: int = 16):
    """Coarse-to-fine geometric ladder ending at `res`: levels=4, res=512
    -> (64, 128, 256, 512)."""
    return tuple(max(min_res, res >> (levels - 1 - i)) for i in range(levels))


def line_features_multi(lines_list: Sequence[torch.Tensor], x: torch.Tensor,
                        bound: float,
                        level_weights: Optional[Sequence] = None
                        ) -> torch.Tensor:
    """Per-level CP features concatenated coarse -> fine, [N, sum K_i];
    `level_weights` ([L] scalars) scales each level (None = all 1)."""
    feats = [line_features(l, x, bound) for l in lines_list]
    if level_weights is not None:
        feats = [f * level_weights[i] for i, f in enumerate(feats)]
    return torch.cat(feats, dim=-1)


def anneal_level_weights(alpha: torch.Tensor, levels: int) -> torch.Tensor:
    """The cosine window over a ladder's levels: level i opens as alpha
    levels sweeps past i; level 0 is always open; all ones at alpha = 1."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32)
    i = torch.arange(levels, dtype=torch.float32, device=alpha.device)
    t = torch.clamp(alpha * levels - i, 0.0, 1.0)
    w = 0.5 * (1.0 - torch.cos(math.pi * t))
    w[0] = 1.0
    return w


def linresize(t: torch.Tensor, new_res: int, axis: int = 1) -> torch.Tensor:
    """Linear resample of a table along `axis` to `new_res` under the
    align-corners lookup of this module: new[j] samples the old table at
    u = j (R - 1) / (new_res - 1)."""
    R = t.shape[axis]
    if new_res == R:
        return t
    # jnp.linspace's float32 values: stop * (j / (n - 1)), the last = stop
    j = torch.arange(new_res, dtype=torch.float32, device=t.device)
    u = (R - 1.0) * (j / torch.full((), float(max(new_res - 1, 1)),
                                    device=t.device))
    u[-1] = R - 1.0
    i0 = torch.clamp(torch.floor(u).long(), 0, max(R - 2, 0))
    f = u - i0
    a = torch.index_select(t, axis, i0)
    b = torch.index_select(t, axis, torch.clamp(i0 + 1, max=R - 1))
    shape = [1] * t.dim()
    shape[axis] = new_res
    f = f.reshape(shape)
    return a * (1.0 - f) + b * f


def grad_total_variation(lines: torch.Tensor, weight: float) -> torch.Tensor:
    """Gradient of weight * sum_i (L[i+1] - L[i])^2 over every line and
    rank of lines [3, R, K]: 2w ((L[i] - L[i-1]) + (L[i] - L[i+1]))."""
    d = lines[:, 1:, :] - lines[:, :-1, :]
    g = torch.zeros_like(lines)
    g[:, 1:, :] += 2.0 * weight * d
    g[:, :-1, :] += -2.0 * weight * d
    return g
