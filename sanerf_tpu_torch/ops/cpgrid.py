"""CP-factorized line features (JAX: sanerf_tpu/ops/cpgrid.py:
line_features_gather, level_resolutions, line_features_multi).

    feat_k(x, y, z) = Lx[u(x), k] * Ly[u(y), k] * Lz[u(z), k]

with linear interpolation along each line: u = (x / bound / 2 + 1/2) (R - 1)
clipped to [0, R - 1], i0 = floor(u), i1 = min(i0 + 1, R - 1). A ladder
splits the rank over a coarse-to-fine list of levels, each its own table.
"""

from __future__ import annotations

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
