"""Encoder factory: name -> (params, apply_fn, out_dim)
(JAX: sanerf_tpu/ops/encoding.py:23-77; reference encoding.py:47-79).

'hashgrid' / 'tiledgrid' give a table drawn from `generator` (seed 0 when
None) and an apply over it; 'frequency', 'sh' and 'None' have no params.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from sanerf_tpu_torch.config import HashGridConfig
from sanerf_tpu_torch.ops import hashgrid
from sanerf_tpu_torch.ops.freq import freq_encode, freq_output_dim
from sanerf_tpu_torch.ops.sh import sh_encode, sh_output_dim


def get_encoder(encoding: Optional[str] = "hashgrid", input_dim: int = 3, *,
                multires: int = 6, degree: int = 4, num_levels: int = 16,
                level_dim: int = 2, base_resolution: int = 16,
                log2_hashmap_size: int = 19,
                desired_resolution: Optional[int] = 2048,
                interpolation: str = "linear", align_corners: bool = False,
                generator: Optional[torch.Generator] = None, device=None
                ) -> Tuple[Any, Callable, int]:
    """-> (params, apply(params, x, bound=1), output_dim)."""
    if encoding is None or encoding == "None":
        return None, lambda p, x, bound=1.0: x, input_dim
    if encoding in ("frequency", "frequency_torch"):
        return (None, lambda p, x, bound=1.0: freq_encode(x, multires),
                freq_output_dim(input_dim, multires))
    if encoding == "sh":
        return (None, lambda p, x, bound=1.0: sh_encode(x, degree),
                sh_output_dim(degree))
    if encoding in ("hashgrid", "tiledgrid"):
        spec = hashgrid.build_spec(HashGridConfig(
            input_dim=input_dim, num_levels=num_levels, level_dim=level_dim,
            base_resolution=base_resolution,
            log2_hashmap_size=log2_hashmap_size,
            desired_resolution=desired_resolution,
            gridtype="hash" if encoding == "hashgrid" else "tiled",
            interpolation=interpolation, align_corners=align_corners))
        g = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        params = hashgrid.init_params(g, spec, device=device)

        def apply_grid(p, x, bound=1.0):
            return hashgrid.hash_encode(x, p, spec, bound)

        return params, apply_grid, spec.output_dim
    raise ValueError(f"unknown encoding {encoding!r}")
