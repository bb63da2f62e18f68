"""Row gather `table[idx]`: the hash encoder's per-level table lookup
(JAX: the `jnp.take` of sanerf_tpu/ops/hashgrid.py:229; the TPU kernels of
tools/probe_gather.py are formulations of the same function).

`gather_rows` is a CUDA kernel (csrc/gather.cu) with its plain PyTorch
version `gather_rows_plain` beside it. A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. A gather is a copy,
so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

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
        gather_rows.launches += 1
    return out


gather_rows.launches = 0
