"""Multiresolution hash-grid encoder (instant-ngp) and its regularizer
gradients (JAX: sanerf_tpu/ops/hashgrid.py:48-327).

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
  - the encode is one `hash_grid_forward` launch a grid (csrc/hashgrid.cu),
    which computes every level's corners, reads their rows and sums them;
    its plain version, the level route, makes each level's taps and reads
    its 2^D corner rows with one `gather_rows` launch (the CUDA kernel of
    ops/gather.py) on that level's slice of the table;
  - in training (the table needs a gradient, the points do not), the
    table's gradient is one `hash_grid_backward` launch a grid
    (csrc/hashgrid.cu), which recomputes the corners from the points; the
    forward saves the points only. Where the points need a gradient too,
    every level's taps are kept and the table's gradient is one
    `gather_rows_backward` launch a level (ops/gather.py:
    gather_row_ranges).
Past the kernels' limits (D 2-3, C 1-8, 32 levels) the encode takes the
level route.
The TV and weight-decay gradient terms (JAX :255-327) are gradient
contributions the train step adds to autograd's (train/state.py).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from sanerf_tpu_torch.config import HashGridConfig
from sanerf_tpu_torch.ops import _build
from sanerf_tpu_torch.ops.gather import (gather_row_ranges, gather_rows,
                                         gather_rows_backward)

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


def _cell(x: torch.Tensor, spec: HashGridSpec, level: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (pos, pos_grid) [B, D] float32 of unit-cube points at a level."""
    res = spec.resolutions[level]
    if spec.align_corners:
        pos = x * (res - 1)
        return pos, torch.clamp(torch.floor(pos), max=res - 2)
    # x * res - 0.5 rounded once, as a fused multiply-add: the reference
    # kernel (gridencoder.cu, nvcc) and XLA both contract it, and at fine
    # levels one rounding of pos moves frac by 2^-12 (the float64 product
    # of a float32 and res is exact)
    pos = torch.clamp((x.double() * res - 0.5).float(), 0.0, res - 1)
    return pos, torch.floor(pos)


def _level_taps(x: torch.Tensor, spec: HashGridSpec, level: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (weights [K, B] float32, level-local row indices [K, B] int32) of
    the 2^D corners of each point's cell, corner-major so that each
    corner's rows are contiguous; the weight products run in dim order, as
    the JAX loop's."""
    D, B = spec.input_dim, x.shape[0]
    res = spec.resolutions[level]
    pos, pos_grid = _cell(x, spec, level)
    frac = pos - pos_grid
    if spec.interpolation == "smoothstep":
        frac = frac * frac * (3.0 - 2.0 * frac)  # gridencoder.cu:34-37
    lo = pos_grid.to(torch.int64)
    # [2, B, D]: (lower, upper) weight factor and cell coordinate
    wf = torch.stack([1.0 - frac, frac])
    pg = torch.stack([lo, torch.clamp(lo + 1, max=res - 1)])
    w, pgs = None, []
    for d in range(D):
        a = _corner_view(wf[..., d], d, D)
        w = a if w is None else w * a
        pgs.append(_corner_view(pg[..., d], d, D))
    K = 1 << D
    return w.reshape(K, B), _grid_index(spec, level, pgs).reshape(K, B)


def _corner_sum(w: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """sum_c w[c] rows[c], sequentially in corner order -> [B, C] float32."""
    prod = w[..., None] * rows
    acc = prod[0]
    for c in range(1, prod.shape[0]):
        acc = acc + prod[c]
    return acc


def _assemble(level_feats, x: torch.Tensor, spec: HashGridSpec
              ) -> torch.Tensor:
    """The active levels' [B, C] features at points x [B, D] -> [B, L*C],
    zeros outside the cube and past the active levels."""
    B, L, C = x.shape[0], spec.num_levels, spec.level_dim
    n_active = len(level_feats)
    oob = ((x < 0.0) | (x > 1.0)).any(dim=-1)
    out = torch.stack(level_feats, dim=1) if level_feats else x.new_zeros(
        (B, 0, C))
    out = out.masked_fill(oob[:, None, None], 0.0)
    if n_active < L:
        out = torch.cat([out, out.new_zeros((B, L - n_active, C))], dim=1)
    return out.reshape(B, L * C)


def _forward(x: torch.Tensor, table: torch.Tensor, spec: HashGridSpec,
             n_active: int) -> torch.Tensor:
    """The encode without a gradient, [B, D] float32 points -> [B, L*C]
    float32: one hash_grid_forward launch where the kernel takes the grid,
    else the level route (bit for bit the same function)."""
    if forward_takes(spec, n_active):
        return hash_grid_forward(x, table, spec, n_active)
    return hash_grid_forward_plain(x, table, spec, n_active)


class _HashEncode(torch.autograd.Function):
    """The encode differentiable in the table alone: the forward is
    `_forward` (bit for bit the encode without a gradient) and saves the
    points; the backward is one `hash_grid_backward` launch."""

    @staticmethod
    def forward(ctx, x, table, spec, n_active):
        ctx.save_for_backward(x)
        ctx.spec, ctx.n_active = spec, n_active
        return _forward(x, table, spec, n_active)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        grad = None
        if ctx.needs_input_grad[1]:
            grad = hash_grid_backward(x, g, ctx.spec, ctx.n_active)
        return None, grad, None, None


def hash_encode_01(x: torch.Tensor, table: torch.Tensor, spec: HashGridSpec,
                   max_level: Optional[int] = None) -> torch.Tensor:
    """Encode unit-cube coordinates.

    x [..., D] float (a point outside [0, 1]^D gives zeros); table
    [total_params, C] float32 or bfloat16; `max_level` encodes the first
    levels only, the rest are zero. -> [..., L*C] float32, level-major per
    point (grid.py:63). Without a gradient to take, one hash_grid_forward
    launch (past its limits the level route: each level's taps made,
    gathered and summed before the next level's, peak memory one
    level's). With a float32 table that needs a gradient and points that
    do not (training), the same forward, and the backward one
    `hash_grid_backward` launch (_HashEncode). With points that need a
    gradient too, every level's taps first and then one
    `gather_row_ranges` call, whose backward fills one gradient of the
    whole table, and autograd takes the points' gradient through the
    weights."""
    prefix = x.shape[:-1]
    D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
    x = x.reshape(-1, D).float()
    n_active = L if max_level is None else min(max_level, L)

    if not (torch.is_grad_enabled() and table.requires_grad):
        out = _forward(x, table, spec, n_active)
    elif not x.requires_grad and table.dtype == torch.float32 and \
            backward_takes(spec, n_active):
        out = _HashEncode.apply(x.contiguous(), table, spec, n_active)
    else:
        ranges = [(spec.offsets[l], spec.sizes[l]) for l in range(n_active)]
        taps = [_level_taps(x, spec, level) for level in range(n_active)]
        rows = gather_row_ranges(table, ranges, [i for _, i in taps])
        out = _assemble([_corner_sum(w, r) for (w, _), r in zip(taps, rows)],
                        x, spec)
    return out.reshape(*prefix, L * C)


# ---------------------------------------------------------------------------
# the encode and the table's gradient in one launch a grid (csrc/hashgrid.cu)
# ---------------------------------------------------------------------------

#: the kernels' limits (csrc/hashgrid.cu): input dims, row widths, levels
BACKWARD_DIMS, BACKWARD_MAX_C, BACKWARD_MAX_LEVELS = (2, 3), 8, 32


def _kernel_takes(spec: HashGridSpec, n_active: int) -> bool:
    return (spec.input_dim in BACKWARD_DIMS
            and 1 <= spec.level_dim <= BACKWARD_MAX_C
            and n_active <= BACKWARD_MAX_LEVELS
            and max(spec.sizes) < 2 ** 32)


def backward_takes(spec: HashGridSpec, n_active: int) -> bool:
    """Whether hash_grid_backward takes this grid's first n_active
    levels."""
    return _kernel_takes(spec, n_active)


def forward_takes(spec: HashGridSpec, n_active: int) -> bool:
    """Whether hash_grid_forward takes this grid's first n_active levels
    (the backward's limits)."""
    return _kernel_takes(spec, n_active)


def hash_grid_forward_plain(x01: torch.Tensor, table: torch.Tensor,
                            spec: HashGridSpec,
                            n_active: Optional[int] = None) -> torch.Tensor:
    """The encode at unit-cube points, the level route: each active level's
    taps made (`_level_taps`), its corner rows read with one `gather_rows`
    call on its slice of the table and summed in corner order
    (`_corner_sum`) before the next level's (peak memory: one level's);
    zeros outside the cube and past the active levels (`_assemble`). x01
    [B, D] float32, table [total_params, C] float32 | bfloat16 -> [B, L*C]
    float32."""
    n_active = spec.num_levels if n_active is None else n_active
    level_feats = []
    for level in range(n_active):
        o, s = spec.offsets[level], spec.sizes[level]
        w, idx = _level_taps(x01, spec, level)
        level_feats.append(_corner_sum(w, gather_rows(table[o:o + s], idx)))
    return _assemble(level_feats, x01, spec)


def hash_grid_backward_plain(x01: torch.Tensor, g: torch.Tensor,
                             spec: HashGridSpec,
                             n_active: Optional[int] = None) -> torch.Tensor:
    """The table's gradient of the encode: for every active level and
    every corner of each in-cube point's cell, grad[offset + idx] += w *
    g[point, level]; the same taps as the forward's (`_level_taps`), one
    `index_add_` a level into a zero gradient. x01 [B, D] float32, g
    [B, L*C] float32 -> [total_params, C] float32."""
    L, C = spec.num_levels, spec.level_dim
    n_active = L if n_active is None else n_active
    B = x01.shape[0]
    oob = ((x01 < 0.0) | (x01 > 1.0)).any(dim=-1)
    gl = g.reshape(B, L, C).masked_fill(oob[:, None, None], 0.0)
    grad = torch.zeros((spec.total_params, C), dtype=torch.float32,
                       device=g.device)
    for level in range(n_active):
        o, s = spec.offsets[level], spec.sizes[level]
        w, idx = _level_taps(x01, spec, level)
        grad[o:o + s].index_add_(0, idx.reshape(-1).long(),
                                 (w[..., None] * gl[None, :, level])
                                 .reshape(-1, C))
    return grad


_P = ctypes.c_void_p


@functools.cache
def _lib():
    lib = _build.load("hashgrid")
    _build.declare(lib, "hash_grid_backward_launch",
                   [_P, ctypes.c_int, _P, ctypes.c_int, _P, ctypes.c_long,
                    ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, ctypes.c_int,
                    ctypes.c_int, _P])
    _build.declare(lib, "hash_grid_forward_launch",
                   [_P, _P, ctypes.c_int, ctypes.c_int, _P, ctypes.c_int,
                    ctypes.c_long, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P,
                    ctypes.c_int, ctypes.c_int, _P])
    _build.declare(lib, "hash_backward_max_levels", [])
    if lib.hash_backward_max_levels() != BACKWARD_MAX_LEVELS:
        raise RuntimeError("hashgrid.cu: MAX_LEVELS differs from "
                           "BACKWARD_MAX_LEVELS")
    return lib


def _level_arrays(spec: HashGridSpec, n: int):
    """The first n levels' metadata as the C arrays the launch reads."""
    return ((ctypes.c_longlong * n)(*spec.offsets[:n]),
            (ctypes.c_uint * n)(*spec.sizes[:n]),
            (ctypes.c_int * n)(*spec.resolutions[:n]),
            (ctypes.c_int * n)(*(int(h) for h in spec.hashed[:n])))


def _refusal(name: str, spec: HashGridSpec, n: int) -> str:
    return (f"{name}: D={spec.input_dim}, C={spec.level_dim}, "
            f"{n} levels: past the kernel's limits (D in {BACKWARD_DIMS}, "
            f"C <= {BACKWARD_MAX_C}, <= {BACKWARD_MAX_LEVELS} levels, levels "
            f"under 2^32 rows; ROADMAP.md queue B)")


def hash_grid_forward(x01: torch.Tensor, table: torch.Tensor,
                      spec: HashGridSpec,
                      n_active: Optional[int] = None) -> torch.Tensor:
    """The encode (see hash_grid_forward_plain), one launch of
    csrc/hashgrid.cu on a CUDA tensor, the plain version on a CPU one.
    x01 [B, D] float32, table [total_params, C] float32 | bfloat16
    contiguous -> [B, L*C] float32, bit for bit the plain version's.
    Raises NotImplementedError past the kernel's limits (D 2-3, C <= 8, 32
    levels), ValueError on other operands."""
    D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
    n = L if n_active is None else n_active
    if not forward_takes(spec, n):
        raise NotImplementedError(_refusal("hash_grid_forward", spec, n))
    if x01.dim() != 2 or x01.shape[1] != D or x01.dtype != torch.float32:
        raise ValueError(f"hash_grid_forward: x01 must be [B, {D}] float32, "
                         f"got {tuple(x01.shape)} {x01.dtype}")
    if (tuple(table.shape) != (spec.total_params, C)
            or table.dtype not in (torch.float32, torch.bfloat16)
            or not table.is_contiguous()):
        raise ValueError(f"hash_grid_forward: table must be contiguous "
                         f"[{spec.total_params}, {C}] float32 or bfloat16, "
                         f"got {tuple(table.shape)} {table.dtype}")
    if x01.device != table.device:
        raise ValueError(f"hash_grid_forward: x01 on {x01.device}, table on "
                         f"{table.device}")
    if not table.is_cuda:
        return hash_grid_forward_plain(x01, table, spec, n)
    if table.device != torch.device("cuda", torch.cuda.current_device()):
        raise ValueError(f"hash_grid_forward: on {table.device}, not the "
                         f"current device")
    B = x01.shape[0]
    if not (B and n):
        return torch.zeros((B, L * C), dtype=torch.float32,
                           device=table.device)
    x01 = x01.contiguous()
    if table.data_ptr() % 16:
        table = table.clone()
    out = torch.empty((B, L * C), dtype=torch.float32, device=table.device)
    arrays = _level_arrays(spec, n)  # alive through the call
    code = _lib().hash_grid_forward_launch(
        out.data_ptr(), table.data_ptr(), table.element_size(), C,
        x01.data_ptr(), D, B, L, n, *(ctypes.addressof(a) for a in arrays),
        int(spec.align_corners), int(spec.interpolation == "smoothstep"),
        torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"hash_grid_forward: CUDA error {code} at launch")
    _HASH_GRID_FORWARD.launches += 1
    return out


hash_grid_forward.launches = 0
#: the function that holds hash_grid_forward's count, bound once here (as
#: ops/gather.py's _GATHER_ROWS)
_HASH_GRID_FORWARD = hash_grid_forward


def hash_grid_backward(x01: torch.Tensor, g: torch.Tensor,
                       spec: HashGridSpec,
                       n_active: Optional[int] = None) -> torch.Tensor:
    """The table's gradient of `hash_encode_01` (see
    hash_grid_backward_plain), one launch of csrc/hashgrid.cu on a CUDA
    tensor, the plain version on a CPU one. x01 [B, D] float32 contiguous,
    g [B, L*C] float32 -> [total_params, C] float32; the sums run in the
    order the atomics land, so the result differs from the plain version's
    by rounding. Raises NotImplementedError past the kernel's limits (D 2-3,
    C <= 8, 32 levels), ValueError on other operands."""
    D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
    n = L if n_active is None else n_active
    if not backward_takes(spec, n):
        raise NotImplementedError(
            _refusal("hash_grid_backward", spec, n))
    if x01.dim() != 2 or x01.shape[1] != D or x01.dtype != torch.float32:
        raise ValueError(f"hash_grid_backward: x01 must be [B, {D}] float32, "
                         f"got {tuple(x01.shape)} {x01.dtype}")
    B = x01.shape[0]
    if tuple(g.shape) != (B, L * C) or g.dtype != torch.float32:
        raise ValueError(f"hash_grid_backward: g must be [{B}, {L * C}] "
                         f"float32, got {tuple(g.shape)} {g.dtype}")
    if x01.device != g.device:
        raise ValueError(f"hash_grid_backward: x01 on {x01.device}, g on "
                         f"{g.device}")
    if not g.is_cuda:
        return hash_grid_backward_plain(x01, g, spec, n)
    if g.device != torch.device("cuda", torch.cuda.current_device()):
        raise ValueError(f"hash_grid_backward: on {g.device}, not the "
                         f"current device")
    x01 = x01.contiguous()
    g = g.contiguous()
    if g.data_ptr() % 16:
        g = g.clone()
    grad = torch.zeros((spec.total_params, C), dtype=torch.float32,
                       device=g.device)
    if B and n:
        arrays = _level_arrays(spec, n)  # alive through the call
        code = _lib().hash_grid_backward_launch(
            grad.data_ptr(), C, x01.data_ptr(), D, g.data_ptr(), B, L * C, n,
            *(ctypes.addressof(a) for a in arrays),
            int(spec.align_corners), int(spec.interpolation == "smoothstep"),
            torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"hash_grid_backward: CUDA error {code} at "
                               f"launch")
        _HASH_GRID_BACKWARD.launches += 1
    return grad


hash_grid_backward.launches = 0
#: the function that holds hash_grid_backward's count, bound once here (as
#: ops/gather.py's _GATHER_ROWS)
_HASH_GRID_BACKWARD = hash_grid_backward


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


def grad_total_variation(x01: torch.Tensor, table: torch.Tensor,
                         spec: HashGridSpec, weight: float) -> torch.Tensor:
    """The TV gradient at sample points x01 [..., D] (gridencoder.cu
    kernel_grad_tv, :525-631): at each point's floor corner, the sum of
    (center - neighbor) over the +-1 neighbors of every dim, divided by
    the root of its sum of squares + 1e-9, times weight / 2D, added at the
    center's row (one gather_rows_backward launch a level); points outside
    the unit cube add nothing. -> [total_params, C]."""
    D = spec.input_dim
    x01 = x01.reshape(-1, D).float()
    oob = ((x01 < 0.0) | (x01 > 1.0)).any(dim=-1)
    grad = torch.zeros_like(table)
    w_scale = weight / (2 * D)
    for level in range(spec.num_levels):
        res, off = spec.resolutions[level], spec.offsets[level]
        pos_grid = _cell(x01, spec, level)[1].to(torch.int64)
        cols = [pos_grid[:, d] for d in range(D)]
        center_idx = _grid_index(spec, level, cols) + off
        center = gather_rows(table, center_idx)
        results = torch.zeros((x01.shape[0], spec.level_dim),
                              dtype=torch.float32, device=table.device)
        idelta = torch.zeros_like(results)
        for d in range(D):
            for sign in (+1, -1):
                nb = cols[d] + sign
                # the reference's guards (gridencoder.cu:595, 608): on the
                # right it checks pos < res, not res - 1
                valid = (nb > -1) & ((cols[d] < res) if sign > 0
                                     else (cols[d] > 0))
                n_idx = _grid_index(spec, level,
                                    cols[:d] + [nb] + cols[d + 1:]) + off
                diff = torch.where(valid[:, None],
                                   center - gather_rows(table, n_idx),
                                   torch.zeros_like(results))
                results = results + diff
                idelta = idelta + diff * diff
        contrib = w_scale * results * torch.rsqrt(idelta + 1e-9)
        contrib = torch.where(oob[:, None], torch.zeros_like(contrib),
                              contrib)
        gather_rows_backward(grad, center_idx, contrib.contiguous())
    return grad


def grad_weight_decay(table: torch.Tensor, spec: HashGridSpec,
                      weight: float) -> torch.Tensor:
    """Level-meaned weight-decay gradient 2 w table / level_size
    (gridencoder.cu kernel_grad_wd, :670-703)."""
    inv_sizes = np.zeros((spec.total_params, 1), np.float32)
    for o, s in zip(spec.offsets, spec.sizes):
        inv_sizes[o:o + s] = 1.0 / s
    return 2.0 * weight * table * torch.as_tensor(inv_sizes,
                                                  device=table.device)
