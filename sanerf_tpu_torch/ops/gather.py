"""Row gather `table[idx]`: the hash encoder's per-level table lookup
(JAX: the `jnp.take` of sanerf_tpu/ops/hashgrid.py:229; the TPU kernels of
tools/probe_gather.py are formulations of the same function), and its
gradient, the scatter-add `grad_table[idx[i]] += grad_out[i]` (in the JAX
package XLA's own scatter-add: no Pallas kernel has it).

`gather_rows` and `gather_rows_backward` are CUDA kernels (csrc/gather.cu),
each with its plain PyTorch version beside it (`gather_rows_plain`,
`gather_rows_backward_plain`: `index_add_` on the same views). A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises. A
gather is a copy, so it agrees with its plain version bit for bit; the
scatter-add sums in the order its atomics land, so it agrees to rounding.
`gather_row_ranges` is the differentiable form the hash encoder trains
through: one gather a row range of one table, and a backward that adds
every range's gradient into a single gradient of the whole table.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from sanerf_tpu_torch.ops import _build

DTYPES = (torch.float32, torch.bfloat16)
BLOCK_ROWS = (1, 8)


def _view(table: torch.Tensor, block_rows: int) -> torch.Tensor:
    """[R, C] -> [R / block_rows, block_rows * C]."""
    R, C = table.shape
    return table.reshape(R // block_rows, block_rows * C)


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor,
                      block_rows: int = 1) -> torch.Tensor:
    """idx.shape + [block_rows * C]: row idx of the table viewed as
    [R / block_rows, block_rows * C]; an index outside that range gives a
    row of zeros (jnp.take's mode="fill", fill_value=0)."""
    t = _view(table, block_rows)
    i = idx.long()
    ok = (i >= 0) & (i < t.shape[0])
    rows = t[torch.where(ok, i, torch.zeros_like(i))]
    return torch.where(ok[..., None], rows, torch.zeros_like(rows))


def _check(table: torch.Tensor, idx: torch.Tensor, block_rows: int) -> None:
    if table.dim() != 2 or table.dtype not in DTYPES:
        raise ValueError(f"gather_rows: table must be [R, C] float32 or "
                         f"bfloat16, got {tuple(table.shape)} {table.dtype}")
    if not table.is_contiguous():
        raise ValueError("gather_rows: table must be contiguous")
    if idx.dtype != torch.int32:
        raise ValueError(f"gather_rows: idx must be int32, got {idx.dtype}")
    if not idx.is_contiguous():
        raise ValueError("gather_rows: idx must be contiguous")
    if block_rows not in BLOCK_ROWS:
        raise ValueError(f"gather_rows: block_rows={block_rows} not in "
                         f"{BLOCK_ROWS}")
    R = table.shape[0]
    if R == 0 or R % block_rows:
        raise ValueError(f"gather_rows: {R} rows are not a positive multiple "
                         f"of block_rows={block_rows}")
    if table.device != idx.device:
        raise ValueError(f"gather_rows: table on {table.device}, idx on "
                         f"{idx.device}")


_P = ctypes.c_void_p


@functools.cache
def _lib():
    lib = _build.load("gather")
    _build.declare(lib, "gather_rows_launch",
                   [_P, ctypes.c_long, ctypes.c_int, _P, ctypes.c_long, _P,
                    _P])
    _build.declare(lib, "gather_rows_backward_launch",
                   [_P, ctypes.c_long, ctypes.c_int, _P, ctypes.c_long, _P,
                    _P])
    return lib


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                block_rows: int = 1) -> torch.Tensor:
    """table [R, C] float32 | bfloat16 contiguous, idx int32 of any shape,
    block_rows 1 or 8 -> idx.shape + [block_rows * C] of the table's type:
    rows of the table viewed as [R / block_rows, block_rows * C], zeros
    where an index is outside that range."""
    _check(table, idx, block_rows)
    if not table.is_cuda:
        return gather_rows_plain(table, idx, block_rows)
    if table.device != torch.device("cuda", torch.cuda.current_device()):
        raise ValueError(f"gather_rows: on {table.device}, not the current "
                         f"device")
    t = _view(table, block_rows)
    out = torch.empty((*idx.shape, t.shape[1]), dtype=table.dtype,
                      device=table.device)
    if idx.numel():
        code = _lib().gather_rows_launch(
            t.data_ptr(), t.shape[0], t.shape[1] * t.element_size(),
            idx.data_ptr(), idx.numel(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"gather_rows: CUDA error {code} at launch")
        _GATHER_ROWS.launches += 1
    return out


gather_rows.launches = 0
#: the function that holds gather_rows' count, bound once here: a caller
#: that rebinds the module name (a recorder patched in) neither moves the
#: count nor breaks it
_GATHER_ROWS = gather_rows


def gather_rows_backward_plain(grad_table: torch.Tensor, idx: torch.Tensor,
                               grad_out: torch.Tensor) -> torch.Tensor:
    """grad_table[idx[i]] += grad_out[i] in place with `index_add_`; an
    index outside [0, R) adds nothing. -> grad_table."""
    R, C = grad_table.shape
    i = idx.reshape(-1).long()
    g = grad_out.reshape(-1, C)
    ok = (i >= 0) & (i < R)
    grad_table.index_add_(0, torch.where(ok, i, torch.zeros_like(i)),
                          torch.where(ok[:, None], g, torch.zeros_like(g)))
    return grad_table


def _check_backward(grad_table, idx, grad_out) -> None:
    if (grad_table.dim() != 2 or not grad_table.is_contiguous()
            or grad_out.dtype != grad_table.dtype):
        raise ValueError(f"gather_rows_backward: grad_table must be [R, C] "
                         f"contiguous of grad_out's type, got "
                         f"{tuple(grad_table.shape)} {grad_table.dtype}, "
                         f"grad_out {grad_out.dtype}")
    if idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError(f"gather_rows_backward: idx must be contiguous "
                         f"int32, got {idx.dtype}")
    if (tuple(grad_out.shape) != (*idx.shape, grad_table.shape[1])
            or not grad_out.is_contiguous()):
        raise ValueError(f"gather_rows_backward: grad_out must be contiguous "
                         f"{(*idx.shape, grad_table.shape[1])}, got "
                         f"{tuple(grad_out.shape)}")
    if not grad_table.device == idx.device == grad_out.device:
        raise ValueError("gather_rows_backward: operands on different "
                         "devices")


def gather_rows_backward(grad_table: torch.Tensor, idx: torch.Tensor,
                         grad_out: torch.Tensor) -> torch.Tensor:
    """The gather's gradient, added in place: grad_table [R, C] float32
    contiguous, idx int32 of any shape, grad_out idx.shape + [C] float32
    contiguous; grad_table[idx[i]] += grad_out[i], nothing where an index
    is outside [0, R). -> grad_table."""
    _check_backward(grad_table, idx, grad_out)
    if not grad_table.is_cuda:
        return gather_rows_backward_plain(grad_table, idx, grad_out)
    if grad_table.dtype != torch.float32:
        raise ValueError(f"gather_rows_backward: the kernel adds float32, "
                         f"got {grad_table.dtype}")
    if grad_table.device != torch.device("cuda",
                                         torch.cuda.current_device()):
        raise ValueError(f"gather_rows_backward: on {grad_table.device}, "
                         f"not the current device")
    if idx.numel():
        code = _lib().gather_rows_backward_launch(
            grad_table.data_ptr(), grad_table.shape[0], grad_table.shape[1],
            idx.data_ptr(), idx.numel(), grad_out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"gather_rows_backward: CUDA error {code} at "
                               f"launch")
        _GATHER_ROWS_BACKWARD.launches += 1
    return grad_table


gather_rows_backward.launches = 0
#: as _GATHER_ROWS, for gather_rows_backward
_GATHER_ROWS_BACKWARD = gather_rows_backward


class _GatherRowRanges(torch.autograd.Function):
    """Rows of several row ranges of one table; the backward adds each
    range's output gradient into one zero gradient of the whole table at
    the range's row offset (one allocation, not one full-size tensor a
    range, which autograd of `table[o:o + s]` would make)."""

    @staticmethod
    def forward(ctx, table, ranges, *idxs):
        ctx.ranges = ranges
        ctx.save_for_backward(*idxs)
        ctx.table_like = (table.shape, table.dtype, table.device)
        return tuple(gather_rows(table[o:o + s], i)
                     for (o, s), i in zip(ranges, idxs))

    @staticmethod
    def backward(ctx, *grads):
        idxs = ctx.saved_tensors
        g = None
        if ctx.needs_input_grad[0]:
            shape, dtype, device = ctx.table_like
            g = torch.zeros(shape, dtype=dtype, device=device)
            for (o, s), i, go in zip(ctx.ranges, idxs, grads):
                if go is not None:
                    gather_rows_backward(g[o:o + s], i, go.contiguous())
        return (g, None, *([None] * len(idxs)))


def gather_row_ranges(table: torch.Tensor, ranges: Sequence[Tuple[int, int]],
                      idxs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """[gather_rows(table[o:o + s], idx) for (o, s), idx], differentiable
    in `table`: one gather_rows launch a range forward, one
    gather_rows_backward launch a range backward."""
    return list(_GatherRowRanges.apply(table, tuple(ranges), *idxs))
