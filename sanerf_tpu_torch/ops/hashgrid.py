"""Multiresolution hash-grid encoder (instant-ngp), inference half
(JAX: sanerf_tpu/ops/hashgrid.py:48-251).

Per level, the 2^D corners of each point's cell are hashed (xor of
per-dim prime products) or indexed densely, their table rows gathered and
interpolated (multilinear or smoothstep); points outside the unit cube give
zeros. The level metadata is static (`build_spec`). The math is the JAX
package's, operation by operation:
  - the index math is uint32 with wrap-around, emulated in int64 with a
    mask to 32 bits after every product and sum, then `% size`;
  - the corner order is the reference's bit order (bit d of the corner
    number picks the cell's upper face in dim d) and the corner sum runs
    sequentially in that order;
  - each level's 2^D corner rows are one `gather_rows` launch (the CUDA
    kernel of ops/gather.py) on that level's slice of the table.
The TV and weight-decay gradient terms (JAX :260-327) come with training.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from sanerf_tpu_torch.config import HashGridConfig
from sanerf_tpu_torch.ops.gather import gather_rows

# xor-hash primes; primes[0] = 1 keeps the x dim coherent (gridencoder.cu:49)
_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437,
           2165219737)
_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class HashGridSpec:
    """Static metadata of one multiresolution grid."""

    input_dim: int
    level_dim: int
    resolutions: Tuple[int, ...]  # per-level resolution
    offsets: Tuple[int, ...]  # per-level start row in the combined table
    sizes: Tuple[int, ...]  # per-level number of rows
    hashed: Tuple[bool, ...]  # per level: spatial hash vs dense/tiled index
    gridtype: str
    interpolation: str
    align_corners: bool
    per_level_scale: float
    base_resolution: int

    @property
    def num_levels(self) -> int:
        return len(self.resolutions)

    @property
    def total_params(self) -> int:
        return self.offsets[-1] + self.sizes[-1]

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim


def build_spec(cfg: HashGridConfig) -> HashGridSpec:
    """Resolve the per-level metadata (JAX: hashgrid.py:77-127). The table
    is sized by ceil(base * scale^l) in float64 and indexed at
    ceil(2^(l*S) * base) in float32, as the reference does; the two differ
    by 1 on some levels."""
    scale = cfg.per_level_scale
    if cfg.desired_resolution is not None and cfg.num_levels > 1:
        scale = float(np.exp2(np.log2(cfg.desired_resolution
                                      / cfg.base_resolution)
                              / (cfg.num_levels - 1)))
    S = np.log2(scale)
    max_params = 2 ** cfg.log2_hashmap_size
    resolutions, offsets, sizes, hashed = [], [], [], []
    offset = 0
    for lvl in range(cfg.num_levels):
        res_table = int(np.ceil(cfg.base_resolution * scale ** lvl))
        res_kernel = int(np.ceil(np.exp2(np.float32(lvl) * np.float32(S))
                                 * cfg.base_resolution))
        params_in_level = min(max_params, res_table ** cfg.input_dim)
        params_in_level = int(np.ceil(params_in_level / 8) * 8)
        # hashed iff the dense stride overflows the table (gridencoder.cu:67-75)
        stride = 1
        for _ in range(cfg.input_dim):
            if stride > params_in_level:
                break
            stride *= res_kernel
        resolutions.append(res_kernel)
        offsets.append(offset)
        sizes.append(params_in_level)
        hashed.append(cfg.gridtype == "hash" and stride > params_in_level)
        offset += params_in_level
    return HashGridSpec(
        input_dim=cfg.input_dim, level_dim=cfg.level_dim,
        resolutions=tuple(resolutions), offsets=tuple(offsets),
        sizes=tuple(sizes), hashed=tuple(hashed), gridtype=cfg.gridtype,
        interpolation=cfg.interpolation, align_corners=cfg.align_corners,
        per_level_scale=scale, base_resolution=cfg.base_resolution)


def init_params(generator: torch.Generator, spec: HashGridSpec,
                std: float = 1e-4, device=None) -> torch.Tensor:
    """U(-std, std) table [total_params, level_dim], float32, drawn from
    `generator` on the CPU and moved to `device` (grid.py:144-146)."""
    u = torch.rand((spec.total_params, spec.level_dim), generator=generator)
    return ((u * 2.0 - 1.0) * std).to(device)


def _fast_hash(pos_grid: Sequence[torch.Tensor]) -> torch.Tensor:
    """xor of per-dim prime products, uint32 wrap (gridencoder.cu:45-58);
    int64 tensors in, int64 values in [0, 2^32) out (broadcast)."""
    result = None
    for d, pg in enumerate(pos_grid):
        term = ((pg & _U32) * _PRIMES[d]) & _U32
        result = term if result is None else result ^ term
    return result


def _grid_index(spec: HashGridSpec, level: int,
                pos_grid: Sequence[torch.Tensor]) -> torch.Tensor:
    """Dense/tiled linear index or spatial hash, mod the level's size, as
    int32 (gridencoder.cu:61-79). pos_grid: one integer tensor per dim,
    broadcast against each other."""
    res, size = spec.resolutions[level], spec.sizes[level]
    pos_grid = [pg.long() for pg in pos_grid]
    if spec.hashed[level]:
        index = _fast_hash(pos_grid)
    else:
        index = pos_grid[0] * 0
        stride = 1
        for d in range(spec.input_dim):
            if stride > size:
                break
            index = (index + (((pos_grid[d] & _U32) * (stride & _U32))
                              & _U32)) & _U32
            stride *= res
        # a tiled level may consume fewer dims than the corner tensor has
        index = index.expand(torch.broadcast_shapes(
            *(pg.shape for pg in pos_grid)))
    return (index % size).to(torch.int32)


def _corner_view(v: torch.Tensor, d: int, D: int) -> torch.Tensor:
    """[2, B] (lower, upper) values of dim d -> the axis of bit d in a
    corner-major [2, ..., 2, B] tensor whose flat corner number is
    sum bit_d 2^d, the reference's corner order (gridencoder.cu:170-184):
    axis 0 holds bit D-1, axis D-1 bit 0."""
    shape = [1] * D + [v.shape[1]]
    shape[D - 1 - d] = 2
    return v.reshape(shape)


def hash_encode_01(x: torch.Tensor, table: torch.Tensor, spec: HashGridSpec,
                   max_level: Optional[int] = None) -> torch.Tensor:
    """Encode unit-cube coordinates.

    x [..., D] float (a point outside [0, 1]^D gives zeros); table
    [total_params, C] float32 or bfloat16; `max_level` encodes the first
    levels only, the rest are zero. -> [..., L*C] float32, level-major per
    point (grid.py:63)."""
    prefix = x.shape[:-1]
    D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
    x = x.reshape(-1, D).float()
    B = x.shape[0]
    K = 1 << D
    n_active = L if max_level is None else min(max_level, L)
    oob = ((x < 0.0) | (x > 1.0)).any(dim=-1)

    level_feats = []
    for level in range(n_active):
        res = spec.resolutions[level]
        if spec.align_corners:
            pos = x * (res - 1)
            pos_grid = torch.clamp(torch.floor(pos), max=res - 2)
        else:
            # x * res - 0.5 rounded once, as a fused multiply-add: the
            # reference kernel (gridencoder.cu, nvcc) and XLA both contract
            # it, and at fine levels one rounding of pos moves frac by
            # 2^-12 (the float64 product of a float32 and res is exact)
            pos = torch.clamp((x.double() * res - 0.5).float(), 0.0, res - 1)
            pos_grid = torch.floor(pos)
        frac = pos - pos_grid
        if spec.interpolation == "smoothstep":
            frac = frac * frac * (3.0 - 2.0 * frac)  # gridencoder.cu:34-37
        lo = pos_grid.to(torch.int64)
        # [2, B, D]: (lower, upper) weight factor and cell coordinate
        wf = torch.stack([1.0 - frac, frac])
        pg = torch.stack([lo, torch.clamp(lo + 1, max=res - 1)])
        # weights and indices of all 2^D corners at once, corner-major so
        # that each corner's rows are contiguous; the weight products run
        # in dim order, as the JAX loop's
        w, pgs = None, []
        for d in range(D):
            a = _corner_view(wf[..., d], d, D)
            w = a if w is None else w * a
            pgs.append(_corner_view(pg[..., d], d, D))
        idx = _grid_index(spec, level, pgs).reshape(K, B)
        o, s = spec.offsets[level], spec.sizes[level]
        rows = gather_rows(table[o:o + s], idx)  # [K, B, C]
        prod = w.reshape(K, B, 1) * rows
        acc = prod[0]
        for c in range(1, K):
            acc = acc + prod[c]
        level_feats.append(acc)

    out = torch.stack(level_feats, dim=1) if level_feats else x.new_zeros(
        (B, 0, C))
    out = out.masked_fill(oob[:, None, None], 0.0)
    if n_active < L:
        out = torch.cat([out, out.new_zeros((B, L - n_active, C))], dim=1)
    return out.reshape(*prefix, L * C)


def hash_encode(x: torch.Tensor, table: torch.Tensor, spec: HashGridSpec,
                bound: float = 1.0, max_level: Optional[int] = None
                ) -> torch.Tensor:
    """Encode world coordinates in [-bound, bound] (grid.py:151-168)."""
    x = x.float()
    # one true division, as XLA's (a CUDA division by a Python number
    # multiplies by its rounded reciprocal)
    x01 = (x + bound) / torch.full((), 2.0 * bound, dtype=x.dtype,
                                   device=x.device)
    return hash_encode_01(x01, table, spec, max_level)
