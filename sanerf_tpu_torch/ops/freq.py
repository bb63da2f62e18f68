"""Sin/cos positional encoding and its annealing window
(JAX: sanerf_tpu/ops/freq.py).

Column order, frequency-major per input dim:
`[x, sin(2^0 x), cos(2^0 x), ..., sin(2^{L-1} x), cos(2^{L-1} x)]`, each
block D wide. cos is evaluated as sin(z + pi/2), as the JAX encode does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

HALF_PI = math.pi / 2


def freq_output_dim(input_dim: int, degree: int) -> int:
    return input_dim + input_dim * 2 * degree


def freq_encode(x: torch.Tensor, degree: int = 4,
                out_dtype: Optional[torch.dtype] = None,
                band_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[..., D] -> [..., D * (1 + 2*degree)], computed in float32.
    `band_weights` ([degree]) scales band f's sin and cos columns by
    band_weights[f] (the training-time annealing window); the identity
    columns stay."""
    x = x.float()
    cols = [x]
    for f in range(degree):
        z = x * (2.0 ** f)
        s, c = torch.sin(z), torch.sin(z + HALF_PI)
        if band_weights is not None:
            s, c = s * band_weights[f], c * band_weights[f]
        cols += [s, c]
    out = torch.cat(cols, dim=-1)
    return out if out_dtype is None else out.to(out_dtype)


def anneal_band_weights(alpha: torch.Tensor, degree: int) -> torch.Tensor:
    """BARF's cosine window (arXiv:2104.06405 eq. 14): band j opens as
    alpha in [0, 1] sweeps past j / degree, w_j = (1 - cos(pi clip(alpha
    degree - j, 0, 1))) / 2; all ones at alpha = 1."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32)
    j = torch.arange(degree, dtype=torch.float32, device=alpha.device)
    t = torch.clamp(alpha * degree - j, 0.0, 1.0)
    return 0.5 * (1.0 - torch.cos(math.pi * t))
