"""The table gather of the port (sanerf_tpu_torch/ops/gather.py): its plain
version against np.take, and the wrapper's checks. A gather is a copy, so
the comparisons are exact. The kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from sanerf_tpu_torch.ops.gather import gather_rows, gather_rows_plain

torch.set_num_threads(1)


def _take(table, idx, block_rows=1):
    """np.take with fill: rows of the table viewed as [R/b, b*C], zeros
    outside."""
    R, C = table.shape
    t = table.reshape(R // block_rows, block_rows * C)
    ok = (idx >= 0) & (idx < t.shape[0])
    out = np.take(t, np.where(ok, idx, 0), axis=0)
    out[~ok] = 0
    return out


@pytest.mark.parametrize("C,block_rows,idx_shape", [
    (2, 1, (1000,)), (8, 1, (37, 8)), (128, 1, (3, 5, 7)), (2, 8, (513,)),
    (3, 1, (999,)), (1, 8, (4, 4))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_matches_np_take(C, block_rows, idx_shape, dtype):
    rng = np.random.default_rng(C + block_rows)
    R = 8 * 64
    table = torch.from_numpy(rng.standard_normal((R, C)).astype(np.float32)
                             ).to(dtype)
    n_rows = R // block_rows
    idx = rng.integers(-3, n_rows + 3, idx_shape).astype(np.int32)
    idx.reshape(-1)[:2] = (-1, n_rows)  # out of range at both ends
    got = gather_rows_plain(table, torch.from_numpy(idx), block_rows)
    want = _take(table.float().numpy(), idx, block_rows)
    assert got.dtype == dtype and got.shape == (*idx_shape, block_rows * C)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert not got.reshape(-1, block_rows * C)[:2].any()


def test_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 64, (20, 8)).astype(np.int32))
    before = gather_rows.launches
    got = gather_rows(table, idx)
    assert torch.equal(got, gather_rows_plain(table, idx))
    assert torch.equal(got, table[idx.long()])
    assert gather_rows.launches == before  # no kernel on the CPU
    empty = gather_rows(table, idx[:0])
    assert empty.shape == (0, 8, 8)


@pytest.mark.parametrize("case", ["int64 idx", "strided table", "strided idx",
                                  "float64 table", "3-d table", "block 3",
                                  "rows not a multiple of 8"])
def test_wrapper_refuses(case):
    table = torch.zeros(64, 2)
    idx = torch.zeros(10, dtype=torch.int32)
    kw = {}
    if case == "int64 idx":
        idx = idx.long()
    elif case == "strided table":
        table = torch.zeros(64, 4)[:, ::2]
    elif case == "strided idx":
        idx = torch.zeros(20, dtype=torch.int32)[::2]
    elif case == "float64 table":
        table = table.double()
    elif case == "3-d table":
        table = table.reshape(8, 8, 2)
    elif case == "block 3":
        kw["block_rows"] = 3
    else:
        table, kw["block_rows"] = torch.zeros(60, 2), 8
    with pytest.raises(ValueError, match="gather_rows"):
        gather_rows(table, idx, **kw)
